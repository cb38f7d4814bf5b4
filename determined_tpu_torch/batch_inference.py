"""Sequence packing for the serving engine's prefill.

Copied from ``determined_tpu/batch_inference.py`` (``SequenceTooLongError``
and ``pack_sequences``); the rest of that module, the batch-inference
runner, is not part of the serving slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np


class SequenceTooLongError(ValueError):
    """A document exceeds the pack's seq_len under overflow="error".

    Named (rather than a bare ValueError) so admission layers — the
    serving engine packs every prefill batch through here — can rely on
    catching exactly this condition and answer with a client error
    instead of silently mis-packing a truncated prompt."""

    def __init__(self, doc_len: int, seq_len: int) -> None:
        super().__init__(
            f"document of {doc_len} tokens exceeds pack seq_len {seq_len} "
            '(overflow="error")'
        )
        self.doc_len = doc_len
        self.seq_len = seq_len


def pack_sequences(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    batch_size: int,
    *,
    pad_id: int = 0,
    drop_remainder: bool = False,
    overflow: str = "truncate",
) -> Iterator[Dict[str, np.ndarray]]:
    """Pack variable-length documents into fixed [B, S] batches for the
    flash kernels' segment-id masking.

    A document longer than seq_len follows `overflow`: "truncate" (the
    default — its head packs, the tail is dropped) or "error" (raise
    SequenceTooLongError — right for serving, where a silently-truncated
    prompt would generate from the wrong context). Any other value is
    rejected up front.

    Greedy first-fit: each doc goes into the first open row with room,
    rows close when full. Emitted batches carry

    - "tokens"       int32 [B, S] — docs back to back, pad_id after;
    - "segment_ids"  int32 [B, S] — 1, 2, ... per doc within a row, 0 on
      padding (so pads attend only pads and score nothing);
    - "loss_mask"    fp32 [B, S] — 1.0 on real tokens, 0.0 on padding.

    A short final batch is padded with empty rows (all pad_id / segment 0)
    unless drop_remainder.
    """
    if seq_len < 1 or batch_size < 1:
        raise ValueError("seq_len and batch_size must be >= 1")
    if overflow not in ("truncate", "error"):
        raise ValueError(
            f'overflow must be "truncate" or "error", got {overflow!r}'
        )

    def emit(rows, segs) -> Dict[str, np.ndarray]:
        tokens = np.full((batch_size, seq_len), pad_id, np.int32)
        segment = np.zeros((batch_size, seq_len), np.int32)
        mask = np.zeros((batch_size, seq_len), np.float32)
        for r, (toks, ids) in enumerate(zip(rows, segs)):
            tokens[r, : len(toks)] = toks
            segment[r, : len(ids)] = ids
            mask[r, : len(ids)] = 1.0
        return {"tokens": tokens, "segment_ids": segment, "loss_mask": mask}

    rows: List[List[int]] = []   # open token buffers, ≤ batch_size of them
    segs: List[List[int]] = []   # per-row segment-id buffers
    counts: List[int] = []       # docs packed per row (last id used)
    for doc in docs:
        toks = list(doc)
        if len(toks) > seq_len:
            if overflow == "error":
                raise SequenceTooLongError(len(toks), seq_len)
            toks = toks[:seq_len]
        if not toks:
            continue
        placed = False
        for r in range(len(rows)):
            if len(rows[r]) + len(toks) <= seq_len:
                counts[r] += 1
                segs[r].extend([counts[r]] * len(toks))
                rows[r].extend(toks)
                placed = True
                break
        if not placed:
            if len(rows) == batch_size:
                yield emit(rows, segs)
                rows, segs, counts = [], [], []
            rows.append(list(toks))
            segs.append([1] * len(toks))
            counts.append(1)
    if rows and not drop_remainder:
        yield emit(rows, segs)
