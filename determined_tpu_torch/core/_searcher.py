"""SearcherContext: the trial side of the master's searcher operations.

Port of ``determined_tpu/core/_searcher.py``: the trial long-polls ``GET
/api/v1/trials/<id>/searcher/operation`` for its current operation
(``{"op": {"length": N}}``, ``{"completed": true}`` when the searcher
closes the trial, ``{"op": null}`` on a long-poll timeout), trains to the
op's length reporting ``searcher/progress``, and completes it with its
searcher metric (``searcher/completed``). In a gang the chief polls and
broadcasts each op's length (None: the searcher closed the trial), so
every rank iterates the same ops.

``DummySearcherContext`` is the off-cluster one: one op of a fixed
length, whose reports go nowhere.
"""
from __future__ import annotations

import logging
from typing import Any, Iterator, Optional

from determined_tpu_torch.common.api_session import Session

logger = logging.getLogger("determined_tpu_torch.core")


class SearcherOperation:
    def __init__(
        self,
        session: Optional[Session],
        trial_id: int,
        length: int,
        is_chief: bool = True,
    ) -> None:
        self._session = session
        self._trial_id = trial_id
        self.length = length
        self._is_chief = is_chief
        self._completed = False

    @property
    def completed(self) -> bool:
        return self._completed

    def report_progress(self, length_completed: float) -> None:
        if not self._is_chief:
            raise RuntimeError("only the chief reports searcher progress")
        if self._session is not None:
            self._session.post(
                f"/api/v1/trials/{self._trial_id}/searcher/progress",
                json_body={"progress": length_completed},
            )

    def report_completed(self, searcher_metric: float) -> None:
        if not self._is_chief:
            raise RuntimeError("only the chief completes searcher ops")
        self._completed = True
        if self._session is not None:
            self._session.post(
                f"/api/v1/trials/{self._trial_id}/searcher/completed",
                json_body={"length": self.length, "metric": searcher_metric},
            )


class SearcherContext:
    def __init__(self, session: Session, distributed: Any,
                 trial_id: int) -> None:
        self._session = session
        self._dist = distributed
        self._trial_id = trial_id

    def _get_current_op(self) -> Optional[SearcherOperation]:
        while True:
            resp = self._session.get(
                f"/api/v1/trials/{self._trial_id}/searcher/operation",
                params={"timeout_seconds": 60},
                timeout=70,
            )
            if resp.get("completed"):
                return None
            if resp.get("op") is not None:
                return SearcherOperation(
                    self._session, self._trial_id,
                    int(resp["op"]["length"]), self._dist.is_chief,
                )
            # op None + not completed: a long-poll timeout, the searcher
            # has issued no new work yet.

    def operations(self) -> Iterator[SearcherOperation]:
        """Yield the master's ops until the searcher closes the trial."""
        while True:
            if not self._dist.is_chief:
                length = self._dist.broadcast(None)
                if length is None:
                    return
                yield SearcherOperation(None, self._trial_id, int(length),
                                        False)
                continue
            op = self._get_current_op()
            self._dist.broadcast(None if op is None else op.length)
            if op is None:
                return
            yield op
            if not op.completed:
                raise RuntimeError(
                    "searcher op yielded but never completed; call "
                    "op.report_completed(metric) after training to op.length"
                )


class DummySearcherContext(SearcherContext):
    """Off-cluster mode: one op of `length` batches."""

    def __init__(self, distributed: Any = None,
                 length: int = 1) -> None:  # noqa: super not called
        self._dist = distributed
        self._length = length

    def operations(self) -> Iterator[SearcherOperation]:
        is_chief = self._dist is None or self._dist.is_chief
        yield SearcherOperation(None, 0, self._length, is_chief)
