"""Token datasets: shard format, writer, and the TokenDataset iterator.

A copy of ``determined_tpu/data/tokens.py`` (numpy only): flat binary
token shards (uint16/int32 little-endian), read by the native C++ loader
(``data/native.py``, ``native/dataloader.cpp``) with a pure-python
fallback implementing the identical deterministic batch stream (same
splitmix64 offsets — bit-for-bit equal, asserted in tests).

Determinism contract: batch i depends only on (seed, i). Resume therefore
needs no data replay — ``skip(n)`` is O(1) — and every data-parallel host
can derive its disjoint slice by consuming interleaved batch indices.

The zigzag layout (``zigzag_ring = R > 1``, R the mesh's context axis):
batches pre-shifted then permuted into ring attention's zigzag device
order by ``parallel/ring.zigzag_indices`` (``zigzag_batch``), so the
model runs entirely in that order and each context rank's slice of the
sequence is its two chunks, on the synthetic stream and on
``TokenDataset`` alike.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

MAGIC_DTYPE = {2: np.uint16, 4: np.int32}


def zigzag_batch(raw: np.ndarray, perm: np.ndarray) -> Dict[str, np.ndarray]:
    """raw [B, S+1] contiguous rows → pre-shifted zigzag-layout batch.

    Shift first (targets are the next logical token), then permute both
    sides identically into zigzag device order."""
    return {
        "tokens": np.ascontiguousarray(raw[:, :-1][:, perm]),
        "targets": np.ascontiguousarray(raw[:, 1:][:, perm]),
        "positions": perm,
    }


def _zigzag_perm(seq_len: int, zigzag_ring: int) -> Optional[np.ndarray]:
    if zigzag_ring <= 1:
        return None
    from determined_tpu_torch.parallel.ring import zigzag_indices

    return zigzag_indices(seq_len, zigzag_ring).astype(np.int32)


def expand_shards(patterns: List[str]) -> List[str]:
    """Glob-expand shard path patterns (sorted, deduplicated)."""
    import glob as glob_mod

    out: List[str] = []
    for pattern in patterns:
        matches = sorted(glob_mod.glob(pattern))
        out.extend(matches if matches else [pattern])
    seen = set()
    return [p for p in out if not (p in seen or seen.add(p))]


def write_token_shard(path: str, tokens: np.ndarray, token_bytes: int = 2) -> None:
    """Write a flat little-endian token shard."""
    dtype = MAGIC_DTYPE[token_bytes]
    arr = np.ascontiguousarray(tokens.astype(dtype))
    if token_bytes == 2 and tokens.max(initial=0) >= 2 ** 16:
        raise ValueError("vocab too large for uint16 shard; use token_bytes=4")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr.tofile(path)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & mask
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & mask
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & mask
    return x ^ (x >> np.uint64(31))


class _PythonLoader:
    """Reference implementation of the native loader's batch stream."""

    def __init__(self, paths, token_bytes, batch, seq, seed, shuffle) -> None:
        dtype = MAGIC_DTYPE[token_bytes]
        self._data = np.concatenate(
            [np.fromfile(p, dtype=dtype) for p in paths]
        ).astype(np.int32)
        self.total_tokens = int(self._data.size)
        if self.total_tokens < seq + 1:
            raise ValueError("not enough tokens for one row")
        self.batch, self.seq, self.seed, self.shuffle = batch, seq, seed, shuffle
        self._next = 0

    def next_into(self, out: np.ndarray) -> None:
        i = self._next
        self._next += 1
        max_start = max(self.total_tokens - self.seq, 1)
        rows = np.arange(self.batch, dtype=np.uint64)
        if self.shuffle:
            starts = _splitmix64(
                np.uint64(self.seed) ^ (np.uint64(i) * np.uint64(self.batch) + rows)
            ) % np.uint64(max_start)
        else:
            starts = (
                (np.uint64(i) * np.uint64(self.batch) + rows) * np.uint64(self.seq)
            ) % np.uint64(max_start)
        idx = starts[:, None].astype(np.int64) + np.arange(self.seq)[None, :]
        out[:] = self._data[idx % self.total_tokens]

    def skip(self, n: int) -> None:
        self._next += n

    def close(self) -> None:
        pass


def lm_dataset(
    patterns: Optional[List[str]],
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    zigzag_ring: int = 0,
):
    """Shared trial-data helper: TokenDataset over glob-expanded shards when
    configured, else an infinite synthetic stream (smoke tests/dry runs).
    zigzag_ring > 1: emit pre-shifted zigzag-layout batches (TokenDataset
    docstring)."""
    if patterns:
        return TokenDataset(expand_shards(patterns), batch_size, seq_len,
                            seed=seed, zigzag_ring=zigzag_ring)
    rng = np.random.default_rng(seed)
    perm = _zigzag_perm(seq_len, zigzag_ring)

    def synthetic() -> Iterator[Dict[str, np.ndarray]]:
        while True:
            if perm is None:
                yield {
                    "tokens": rng.integers(
                        0, vocab_size, (batch_size, seq_len)
                    ).astype(np.int32)
                }
                continue
            raw = rng.integers(
                0, vocab_size, (batch_size, seq_len + 1)
            ).astype(np.int32)
            yield zigzag_batch(raw, perm)

    return synthetic()


class TokenDataset:
    """Iterator of {"tokens": int32 [B, S]} batches over token shards.

    use_native: True (require C++ loader) / False (python) / None (prefer
    native, fall back).
    """

    def __init__(
        self,
        paths: List[str],
        batch_size: int,
        seq_len: int,
        token_bytes: int = 2,
        seed: int = 0,
        shuffle: bool = True,
        use_native: Optional[bool] = None,
        n_threads: int = 2,
        zigzag_ring: int = 0,
    ) -> None:
        """zigzag_ring = R > 1: emit batches in zigzag device order for an
        R-way ring-attention mesh — {"tokens", "targets", "positions"}
        pre-shifted then permuted by `zigzag_indices` (each row reads S+1
        tokens)."""
        self.batch_size, self.seq_len = batch_size, seq_len
        self.zigzag_ring = int(zigzag_ring)
        self._perm = _zigzag_perm(seq_len, self.zigzag_ring)
        # Pre-shift needs the next token past the window: read S+1 per row.
        read_len = seq_len + 1 if self._perm is not None else seq_len
        self._loader = None
        if use_native is not False:
            try:
                from determined_tpu_torch.data.native import NativeLoader

                self._loader = NativeLoader(
                    paths, token_bytes, batch_size, read_len,
                    seed=seed, shuffle=shuffle, n_threads=n_threads,
                )
                self.native = True
            except (RuntimeError, ValueError):
                if use_native:
                    raise
        if self._loader is None:
            self._loader = _PythonLoader(
                paths, token_bytes, batch_size, read_len, seed, shuffle
            )
            self.native = False
        self._read_len = read_len
        self.batches_consumed = 0

    @property
    def total_tokens(self) -> int:
        return self._loader.total_tokens

    def skip(self, n_batches: int) -> None:
        """O(1) resume fast-forward (trainer data-stream contract)."""
        self._loader.skip(n_batches)
        self.batches_consumed += n_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        out = np.empty((self.batch_size, self._read_len), np.int32)
        self._loader.next_into(out)
        self.batches_consumed += 1
        if self._perm is None:
            return {"tokens": out}
        return zigzag_batch(out, self._perm)

    def close(self) -> None:
        self._loader.close()
