"""Paged KV cache bookkeeping: the host-side page allocator.

Copied from ``determined_tpu/serving/kv_cache.py`` (``PoolExhausted`` and
``PagePool``) without its fault site and metrics gauges, which arrive
with the port's observability slice, and without the prefix cache.

The engine owns two device tensors ``[L, num_pages, page_size, H, Dh]``
(K and V) allocated ONCE at startup; every request's context lives in
pages borrowed from that pool through this free list. Admission reserves
a request's full page budget (ceil((prompt + max_new) / page_size)) up
front, so decode never allocates mid-flight; completion returns the pages.
Page 0 is the scratch page: inactive batch slots write their (masked) K/V
there so the decode write stays unconditional.
"""
from __future__ import annotations

import threading
from typing import List


class PoolExhausted(Exception):
    """The page pool cannot satisfy an allocation right now.

    Admission maps this to a shed with Retry-After — pages free as soon
    as any in-flight request finishes, so the condition is transient.
    """

    def __init__(self, wanted: int, free: int) -> None:
        super().__init__(
            f"page pool exhausted: wanted {wanted} pages, {free} free"
        )
        self.wanted = wanted
        self.free = free


class PagePool:
    """Host-side free-list allocator over page ids 1..num_pages-1.

    Thread-safe (submitting threads and the engine loop both touch it).
    The device tensors themselves live in the engine; this class only
    tracks ownership.
    """

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError(
                "num_pages must be >= 2 (page 0 is the scratch page)"
            )
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        self._lock = threading.Lock()

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    def alloc(self, n: int) -> List[int]:
        """Take `n` pages or raise PoolExhausted (all-or-nothing — a
        request must never hold a partial context)."""
        if n < 1:
            raise ValueError(f"page allocation must be >= 1, got {n}")
        with self._lock:
            if n > len(self._free):
                raise PoolExhausted(n, len(self._free))
            taken = self._free[:n]
            del self._free[:n]
            return taken

    def free(self, pages: List[int]) -> None:
        with self._lock:
            for p in pages:
                if not 1 <= p < self.num_pages:
                    raise ValueError(f"page {p} is not a pool page")
                if p in self._free:
                    raise ValueError(f"double free of page {p}")
            self._free.extend(pages)

    def pages_for(self, total_tokens: int, page_size: int) -> int:
        """Pages a context of `total_tokens` needs (the admission math)."""
        return -(-max(1, total_tokens) // page_size)
