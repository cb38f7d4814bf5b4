"""Paged KV cache: a preallocated pool of fixed-size pages, and the
prefix cache over it.

Copied from ``determined_tpu/serving/kv_cache.py``. The engine owns two
device tensors ``[L, num_pages, page_size, H, Dh]`` (K and V) allocated
ONCE at startup; every request's context lives in pages borrowed from
that pool through this host-side free list. Admission reserves a
request's full page budget (ceil((prompt + max_new) / page_size)) up
front, so decode never allocates mid-flight; completion returns the
pages. Page 0 is the scratch page: inactive batch slots and dead query
rows write their (masked) K/V there so the decode write stays
unconditional.

Prefix cache (``serving.prefix_cache: on``): ``PrefixCache`` keeps a
finished request's full pages in a radix tree keyed by CHAIN-hashed
page-size token blocks (a node's key commits to its entire prefix),
refcounted so a page can be cached and mapped into any number of live
requests' page tables at once. Admission walks the tree and maps every
fully matched leading page of a new request onto the cached pages: no
prefill compute and no K/V writes for the hit span; both decode kernels
read them through the page table unchanged. Eviction is leaf-first LRU
over refcount-0 nodes and runs INSIDE ``PagePool.alloc`` before it can
fail (``PoolExhausted`` means "even after evicting everything
evictable"). ``prefix_block_hashes`` is byte-identical to the
reference's: the master's router hashes prompts with it to pick the
replica that holds the pages.
"""
from __future__ import annotations

import hashlib
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from determined_tpu_torch.common import faults
from determined_tpu_torch.common.metrics import REGISTRY as METRICS

PAGES_IN_USE = METRICS.gauge(
    "dtpu_serving_pages_in_use",
    "KV-cache pages currently allocated to live requests.",
)
PAGE_ALLOC_FAILURES = METRICS.counter(
    "dtpu_serving_page_alloc_failures_total",
    "Page allocations refused (pool exhausted or injected fault).",
)
PREFIX_HITS = METRICS.counter(
    "dtpu_serving_prefix_cache_hits_total",
    "Admissions that mapped >= 1 leading page out of the prefix cache.",
)
PREFIX_MISSES = METRICS.counter(
    "dtpu_serving_prefix_cache_misses_total",
    "Admissions that found no cached leading page (cache enabled).",
)
PREFIX_EVICTIONS = METRICS.counter(
    "dtpu_serving_prefix_cache_evictions_total",
    "Cached pages evicted (leaf-first LRU) to satisfy pool pressure.",
)
PREFIX_PAGES_REUSED = METRICS.counter(
    "dtpu_serving_prefix_pages_reused_total",
    "Pages mapped from the prefix cache into admitted requests — each is "
    "one page of prefill compute and K/V writes that never happened.",
)
PREFIX_FALLBACKS = METRICS.counter(
    "dtpu_serving_prefix_cache_fallbacks_total",
    "Cache lookups abandoned mid-admission (injected serving.prefix_cache "
    "fault or hash-collision verify failure): the request fell back to a "
    "normal full prefill — counted, never silent.",
)
PREFIX_CACHE_PAGES = METRICS.gauge(
    "dtpu_serving_prefix_cache_pages",
    "Pages currently held by the prefix-cache radix tree (shared pages "
    "also mapped into live requests included).",
)


def prefix_block_hashes(
    tokens: Sequence[int], block: int, max_blocks: Optional[int] = None
) -> List[str]:
    """Chain hashes of the leading FULL `block`-token pages of `tokens`.

    ``h[i] = sha256(h[i-1] || tokens[i*block:(i+1)*block])`` — each digest
    commits to the whole prefix through its page, so equal hashes at
    depth i mean equal leading ``(i+1) * block`` tokens (up to collision;
    the radix tree verifies tokens on match). The master's router uses
    the same function on the same token stream, which is what makes
    "same prefix lands on the same replica" line up with "that replica
    actually holds the prefix".
    """
    n = len(tokens) // block
    if max_blocks is not None:
        n = min(n, max_blocks)
    out: List[str] = []
    h = b""
    for i in range(n):
        chunk = tokens[i * block:(i + 1) * block]
        h = hashlib.sha256(
            h + struct.pack(f"<{block}q", *chunk)
        ).digest()
        out.append(h.hex())
    return out


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

    Thread-safe (the HTTP handlers' admission path and the engine loop
    both touch it). The device arrays themselves live in the engine; this
    class only tracks ownership.
    """

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError(
                "num_pages must be >= 2 (page 0 is the scratch page)"
            )
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        self._lock = threading.Lock()
        #: optional PrefixCache: alloc evicts refcount-0 cached pages
        #: through it BEFORE raising PoolExhausted.
        self._evictor: Optional["PrefixCache"] = None
        PAGES_IN_USE.set(0)

    def attach_evictor(self, evictor: "PrefixCache") -> None:
        self._evictor = evictor

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    def alloc(self, n: int) -> List[int]:
        """Take `n` pages or raise PoolExhausted (all-or-nothing — a
        request must never hold a partial context). Instrumented fault
        site ``serving.page_alloc``: an injected fault IS an exhaustion,
        so chaos drills exercise the shed path deterministically."""
        if n < 1:
            raise ValueError(f"page allocation must be >= 1, got {n}")
        try:
            faults.inject("serving.page_alloc")
        except faults.InjectedFault:
            PAGE_ALLOC_FAILURES.inc()
            raise PoolExhausted(n, self.free_pages) from None
        with self._lock:
            if n > len(self._free) and self._evictor is not None:
                # Cached-but-idle pages are reclaimable capacity: evict
                # leaf-first LRU until the request fits (or nothing
                # evictable remains). Runs under the pool lock — the
                # evictor only touches its own tree.
                self._free.extend(self._evictor.evict(n - len(self._free)))
            if n > len(self._free):
                PAGE_ALLOC_FAILURES.inc()
                raise PoolExhausted(n, len(self._free))
            taken = self._free[:n]
            del self._free[:n]
            PAGES_IN_USE.set((self.num_pages - 1) - len(self._free))
            return taken

    def free(self, pages: List[int]) -> None:
        with self._lock:
            for p in pages:
                if not 1 <= p < self.num_pages:
                    raise ValueError(f"page {p} is not a pool page")
                if p in self._free:
                    raise ValueError(f"double free of page {p}")
            self._free.extend(pages)
            PAGES_IN_USE.set((self.num_pages - 1) - len(self._free))

    def pages_for(self, total_tokens: int, page_size: int) -> int:
        """Pages a context of `total_tokens` needs (the admission math)."""
        return -(-max(1, total_tokens) // page_size)


class _Node:
    """One cached page: a full `page_size`-token block at a fixed depth.

    `key` is the CHAIN hash (commits to the whole prefix through this
    block); `tokens` keeps the block itself so a match can verify content
    instead of trusting the hash. `refs` counts live requests whose page
    tables currently map this page; only refs == 0 leaves are evictable.
    """

    __slots__ = ("key", "tokens", "page", "parent", "children", "refs",
                 "last_used")

    def __init__(self, key: str, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]) -> None:
        self.key = key
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[str, "_Node"] = {}
        self.refs = 0
        self.last_used = 0


class PrefixCache:
    """Radix tree over page-granular chain hashes, sharing pool pages.

    Threading: every mutation happens on the engine thread (admission,
    finish, recovery) or inside ``PagePool.alloc`` called FROM the engine
    thread — the tree itself needs no lock. The pool's free-list keeps
    its own lock; `evict` is invoked while the pool holds it and only
    returns page ids for the pool to reclaim.

    Page ownership: a page is owned by exactly one of (pool free-list,
    a live request, this tree). Tree-owned pages with ``refs > 0`` are
    ALSO mapped into live page tables — they are pinned: never evicted,
    never re-issued, so a cached page can never be overwritten under a
    request still reading it.
    """

    def __init__(self, pool: PagePool, page_size: int) -> None:
        self.pool = pool
        self.page_size = page_size
        self._root = _Node("", (), 0, None)  # sentinel; owns no page
        self._nodes = 0
        self._tick = 0
        # Instance-local stats (the REGISTRY counters are process-global;
        # /api/v1/stats wants THIS replica's hit rate).
        self.hits = 0
        self.misses = 0
        self.pages_reused = 0
        self.evictions = 0
        self.fallbacks = 0
        pool.attach_evictor(self)

    def __len__(self) -> int:
        return self._nodes

    @property
    def hit_rate(self) -> float:
        looked = self.hits + self.misses
        return self.hits / looked if looked else 0.0

    # -- lookup / pinning --------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[_Node]:
        """Longest cached prefix of `tokens`, as the node chain from the
        root. Matches only FULL pages and never the whole prompt — at
        least one tail token is always left to prefill, because the
        first generated token is sampled from the tail's logits. Pure
        lookup: no refcounts, no counters (admission may still abandon
        the request on page pressure)."""
        budget = (len(tokens) - 1) // self.page_size
        hashes = prefix_block_hashes(tokens, self.page_size, budget)
        out: List[_Node] = []
        node = self._root
        for i, h in enumerate(hashes):
            child = node.children.get(h)
            if child is None:
                break
            if child.tokens != tuple(
                int(t) for t in
                tokens[i * self.page_size:(i + 1) * self.page_size]
            ):
                # A chain-hash collision would serve another prompt's
                # K/V; verify and fall back to prefill instead.
                self.note_fallback()
                break
            out.append(child)
            node = child
        return out

    def acquire(self, nodes: List[_Node]) -> None:
        """Pin matched pages into a live request (refs++); pinned pages
        are invisible to eviction, so the alloc that follows cannot pull
        them out from under the admission that matched them."""
        self._tick += 1
        for n in nodes:
            n.refs += 1
            n.last_used = self._tick

    def release(self, nodes: List[_Node]) -> None:
        self._tick += 1
        for n in nodes:
            assert n.refs > 0, "refcount underflow on cached page"
            n.refs -= 1
            n.last_used = self._tick

    # -- admission bookkeeping --------------------------------------------
    def note_hit(self, pages: int) -> None:
        self.hits += 1
        self.pages_reused += pages
        PREFIX_HITS.inc()
        PREFIX_PAGES_REUSED.inc(pages)

    def note_miss(self) -> None:
        self.misses += 1
        PREFIX_MISSES.inc()

    def note_fallback(self) -> None:
        self.fallbacks += 1
        PREFIX_FALLBACKS.inc()

    # -- request retirement ------------------------------------------------
    def finish(
        self,
        tokens: Sequence[int],
        pages: List[int],
        matched: List[_Node],
        cacheable: bool,
    ) -> None:
        """Retire a request's pages: release its pins, then either adopt
        its full-token pages into the tree (normal completion — `tokens`
        is the K/V-written sequence, prompt + generated minus the final
        sampled token) or free everything it owned (error paths: the
        page contents are suspect and must not be served to anyone).
        Pages past the written span (unused reservation, partial tail
        page) always return straight to the pool."""
        self.release(matched)
        start = len(matched)
        if not cacheable:
            if pages[start:]:
                self.pool.free(pages[start:])
            return
        n_full = len(tokens) // self.page_size
        node = matched[-1] if matched else self._root
        hashes = prefix_block_hashes(tokens, self.page_size, n_full)
        self._tick += 1
        spill: List[int] = list(pages[n_full:])
        for i in range(start, n_full):
            block = tuple(
                int(t) for t in
                tokens[i * self.page_size:(i + 1) * self.page_size]
            )
            existing = node.children.get(hashes[i])
            if existing is not None:
                # Another request already cached this exact prefix page
                # (or a collision — either way this copy is redundant).
                spill.append(pages[i])
                if existing.tokens != block:
                    # Collision: stop descending, free the rest.
                    spill.extend(pages[i + 1:n_full])
                    break
                node = existing
                node.last_used = self._tick
                continue
            child = _Node(hashes[i], block, pages[i], node)
            child.last_used = self._tick
            node.children[hashes[i]] = child
            node = child
            self._nodes += 1
        PREFIX_CACHE_PAGES.set(self._nodes)
        if spill:
            self.pool.free(spill)

    # -- eviction (called by PagePool.alloc under the pool lock) -----------
    def evict(self, n: int) -> List[int]:
        """Remove up to `n` refcount-0 LEAF nodes in LRU order and return
        their page ids for the pool to reclaim. Leaf-first: an interior
        node's children would become unreachable (and their pages
        stranded) if the parent left the tree first."""
        freed: List[int] = []
        while len(freed) < n:
            victim: Optional[_Node] = None
            for node in self._iter_nodes():
                if node.refs or node.children:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            assert victim.parent is not None
            del victim.parent.children[victim.key]
            self._nodes -= 1
            freed.append(victim.page)
        if freed:
            self.evictions += len(freed)
            PREFIX_EVICTIONS.inc(len(freed))
            PREFIX_CACHE_PAGES.set(self._nodes)
        return freed

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def flush(self) -> None:
        """Drop the ENTIRE tree and return every cached page to the
        pool. Engine recovery calls this after a crashed iteration: the
        crash may have been mid-write (and a donated-buffer rebuild
        zeroes the pool), so all cached contents are suspect. Callers
        must have released every pin first (recovery retires all live
        requests before flushing)."""
        pages = []
        for node in self._iter_nodes():
            assert node.refs == 0, "flush with live pins would double-free"
            pages.append(node.page)
        self._root = _Node("", (), 0, None)
        self._nodes = 0
        PREFIX_CACHE_PAGES.set(0)
        if pages:
            self.pool.free(pages)

    def stats(self) -> Dict[str, float]:
        return {
            "pages": self._nodes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "pages_reused": self.pages_reused,
            "evictions": self.evictions,
            "fallbacks": self.fallbacks,
        }
