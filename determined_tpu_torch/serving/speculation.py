"""Prompt-lookup draft proposer for speculative decoding.

Copied from ``determined_tpu/serving/speculation.py``. No draft model, no
extra weights: a slot speculates its next tokens by finding the most
recent PRIOR occurrence of its trailing `min_match`-gram inside its own
token history (prompt + emitted tokens) and proposing the tokens that
followed it. On workloads with repeated n-grams (shared prefixes,
templated text, code) the model's greedy continuation often re-walks such
spans, so the verify step accepts multi-token prefixes and decode emits
several tokens per iteration.

The lookup is exact-match over int32 token ids. It runs on the host per
speculating slot per iteration, so it must be cheap: tokens are packed to
bytes once and the search is a single ``bytes.rfind``, with a 4-byte
alignment walk to discard matches that straddle token boundaries.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def propose_ngram_draft(
    history: Sequence[int], draft_len: int, min_match: int
) -> List[int]:
    """Propose up to `draft_len` tokens continuing `history`.

    Finds the most recent occurrence of history's trailing `min_match`
    tokens at an earlier position and returns the tokens that followed
    it (possibly fewer than `draft_len` if the match sits near the end).
    Returns [] when history is too short or the trailing gram never
    occurred before.
    """
    n = len(history)
    if draft_len < 1 or min_match < 1 or n < min_match + 1:
        return []
    arr = np.asarray(history, dtype=np.int32)
    buf = arr.tobytes()
    needle = arr[n - min_match:].tobytes()
    # The terminal occurrence of the gram starts at token n - min_match;
    # rfind's end bound is exclusive of the match END, so (n-1)*4 admits
    # aligned starts only up to token n - min_match - 1: strictly earlier.
    start = buf.rfind(needle, 0, (n - 1) * 4)
    while start >= 0 and start % 4:
        # Byte-level hit straddling token boundaries: step past it.
        start = buf.rfind(needle, 0, start + len(needle) - 1)
    if start < 0:
        return []
    follow = start // 4 + min_match
    return arr[follow:follow + draft_len].tolist()
