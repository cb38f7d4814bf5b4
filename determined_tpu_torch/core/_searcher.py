"""The searcher off-cluster: one operation of a fixed length (port of
``determined_tpu/core/_searcher.py``'s ``SearcherOperation`` and
``DummySearcherContext``)."""
from __future__ import annotations

from typing import Iterator, List, Optional


class SearcherOperation:
    """Train to ``length`` batches, report progress, then complete with
    the searcher metric. Off-cluster the reports are kept, not sent."""

    def __init__(self, length: int) -> None:
        self.length = length
        self.progress: List[float] = []
        self.metric: Optional[float] = None

    def report_progress(self, length_completed: float) -> None:
        self.progress.append(float(length_completed))

    def report_completed(self, searcher_metric: float) -> None:
        self.metric = float(searcher_metric)


class DummySearcherContext:
    """Off-cluster mode: one op of `length` batches."""

    def __init__(self, length: int = 1) -> None:
        self._length = length

    def operations(self) -> Iterator[SearcherOperation]:
        yield SearcherOperation(self._length)
