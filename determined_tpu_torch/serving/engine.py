"""Iteration-level continuous-batching generation engine (port).

Port of ``determined_tpu/serving/engine.py`` for the serving slice. ONE
engine thread owns all device state and drives admission → packed prefill
→ decode iterations; requests join and leave the batch BETWEEN iterations
without draining it:

- admission packs waiting prompts into a fixed-geometry prefill batch via
  ``batch_inference.pack_sequences`` (segment ids isolate prompts inside
  the flash kernel) and scatters each prompt's K/V into pages borrowed
  from the preallocated pool (``kv_cache.PagePool``), page by page;
- each decode iteration runs ``GPT.decode_kv`` over the whole static
  batch (``max_batch_size`` slots, page-table width
  ``max_pages_per_request``) with the paged-attention kernel, or with the
  gather + flash path under ``decode_kernel: gather`` /
  ``DTPU_PAGED_ATTN=0``;
- the SLO layer sheds at submit (queue bound, expired deadline) and
  finishes in-flight requests the moment their deadline passes.

Sampling is greedy argmax, or a categorical draw from a seeded
``torch.Generator`` when a request's temperature is > 0.

With ``serving.prefix_cache: on`` the pool grows a third page state:
finished requests' full-token pages stay CACHED in a radix tree
(``kv_cache.PrefixCache``), admission maps matched leading pages straight
into new requests' page tables, and only the tail is prefilled, through
``GPT.prefill_kv_cached`` (the tail attends to the gathered prefix K/V at
``kv_offset`` = the prefix width), so greedy streams are the cache-off
streams.

With ``serving.speculation.mode: ngram`` (or ``DTPU_SPEC_DECODE=1``;
``=0`` turns it off) greedy slots speculate: the prompt-lookup proposer
(``speculation.propose_ngram_draft``) drafts up to ``draft_len`` tokens
from the request's own history, ONE ``GPT.decode_kv_spec`` call scores
all ``draft_len + 1`` rows of every slot (plain and sampled slots ride
it with ``q_lens = 1``), the accepted prefix commits and the rejected
tail rolls back by not advancing ``length``: pages are pre-budgeted per
request, so rollback never touches the free list.

Fault sites (``common/faults.py``): ``serving.admission`` (shed),
``serving.decode`` (mid-stream failure: error event, pages freed),
``serving.page_alloc`` (pool exhaustion, in ``PagePool.alloc``),
``serving.prefix_cache`` (poisoned lookup → counted full prefill) and
``serving.speculation`` (→ counted plain one-token decode). The
``dtpu_serving_*`` metrics are the reference's, and so are the
per-request W3C spans: ``serving.request`` with its ``serving.queue`` /
``serving.prefill`` / ``serving.decode`` children, parented to the
submitting client's ``traceparent`` (a traceless request roots a fresh
trace, fixed at admission) and exported through ``common/trace.py``.
``UnsupportedServingFeature`` stays for options a later slice brings.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import math
import os
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.batch_inference import pack_sequences
from determined_tpu_torch.common import faults
from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.common.metrics import REGISTRY as METRICS
from determined_tpu_torch.models.gpt import load_jax_params
from determined_tpu_torch.ops.paged_attention import paged_pages_read
from determined_tpu_torch.serving.config import ServingConfig
from determined_tpu_torch.serving.kv_cache import (
    PagePool,
    PoolExhausted,
    PrefixCache,
)
from determined_tpu_torch.serving.speculation import propose_ngram_draft

logger = logging.getLogger("determined_tpu_torch.serving")

# -- observability plane (dtpu_serving_*, the reference's names) -------------
REQUESTS = METRICS.counter(
    "dtpu_serving_requests_total",
    "Generation requests by outcome (ok, shed, error, deadline).",
    labels=("outcome",),
)
SHED = METRICS.counter(
    "dtpu_serving_shed_total",
    "Requests shed by the admission layer, by reason.",
    labels=("reason",),
)
TOKENS = METRICS.counter(
    "dtpu_serving_tokens_total",
    "Tokens generated (streamed to clients).",
)
DECODE_ITERATIONS = METRICS.counter(
    "dtpu_serving_decode_iterations_total",
    "Iteration-level decode steps executed over the active batch.",
)
BATCH_JOINS = METRICS.counter(
    "dtpu_serving_batch_joins_total",
    "Requests admitted into an already-non-empty batch (late joiners "
    "never drain the batch).",
)
DECODE_FAILURES = METRICS.counter(
    "dtpu_serving_decode_failures_total",
    "Decode iterations lost to failure (injected or real); affected "
    "requests get an SSE error event and their pages return to the pool.",
)
QUEUE_DEPTH = METRICS.gauge(
    "dtpu_serving_queue_depth", "Requests waiting for admission.",
)
BATCH_OCCUPANCY = METRICS.gauge(
    "dtpu_serving_batch_occupancy", "Active decode-batch slots.",
)
KV_PAGES_READ = METRICS.counter(
    "dtpu_serving_kv_pages_read_total",
    "KV-cache pages decode iterations actually read. Paged kernel: live "
    "pages summed over active slots. Gather path: the full page window "
    "every iteration.",
)
SPEC_PROPOSED = METRICS.counter(
    "dtpu_serving_spec_proposed_tokens_total",
    "Draft tokens proposed by the prompt-lookup speculator (acceptance "
    "rate = accepted / proposed).",
)
SPEC_ACCEPTED = METRICS.counter(
    "dtpu_serving_spec_accepted_tokens_total",
    "Draft tokens the verify step accepted (each saved one decode "
    "iteration; the bonus token verify always emits is not counted).",
)
SPEC_ROLLBACK = METRICS.counter(
    "dtpu_serving_spec_rollback_tokens_total",
    "Draft tokens rejected and rolled back by rewinding lengths (host "
    "bookkeeping only; the free list is untouched).",
)
SPEC_FALLBACKS = METRICS.counter(
    "dtpu_serving_spec_fallbacks_total",
    "Decode iterations that degraded to plain one-token decode because "
    "the draft/verify path failed (injected or real).",
)
DECODE_ITER_LATENCY = METRICS.histogram(
    "dtpu_serving_decode_iteration_seconds",
    "Decode-iteration wall latency by kernel path (paged = in-kernel "
    "page-table attention, gather = contiguous-K/V path).",
    labels=("path",),
)
TTFT = METRICS.histogram(
    "dtpu_serving_ttft_seconds",
    "Submit-to-first-token latency (the serving SLO; p99 via buckets).",
)
E2E = METRICS.histogram(
    "dtpu_serving_e2e_seconds",
    "Submit-to-done latency of completed requests.",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0, 60.0, 120.0),
)


class UnsupportedServingFeature(NotImplementedError):
    """A serving option that a later slice of the port brings."""


def first_fit_layout(lens, seq_len, rows_cap):
    """(row, start) coordinates for docs of `lens` under pack_sequences'
    greedy first-fit over at most `rows_cap` rows of `seq_len`, or None
    when they don't fit ONE emitted batch. Admission AND the prefill
    scatter both use this one mirror of the packing algorithm (an assert
    in _prefill_packed keeps it honest against pack_sequences)."""
    rows: List[int] = []
    layout: List[Tuple[int, int]] = []
    for ln in lens:
        for i, used in enumerate(rows):
            if used + ln <= seq_len:
                layout.append((i, used))
                rows[i] = used + ln
                break
        else:
            if len(rows) == rows_cap:
                return None
            layout.append((len(rows), 0))
            rows.append(ln)
    return layout


def _scatter_kv(cache_k, cache_v, k_l, v_l, src_idx, dst_pages):
    """Move a whole prefill batch's K/V into the paged pool in ONE
    page-granular in-place update (``index_copy_`` — the counterpart of
    the reference's donated buffers). k_l/v_l are [L, B, S, H, Dh] from
    prefill_kv; src_idx [P, page_size] (int64) holds flat token
    coordinates into the packed [B·S] batch per destination page,
    dst_pages [P] (int64) the pool page each lands on. Unused entries
    target scratch page 0, whose contents are never read live."""
    n_layers, _, _, n_heads, head_dim = k_l.shape
    flat_k = k_l.reshape(n_layers, -1, n_heads, head_dim)
    flat_v = v_l.reshape(n_layers, -1, n_heads, head_dim)
    cache_k.index_copy_(1, dst_pages, flat_k[:, src_idx])
    cache_v.index_copy_(1, dst_pages, flat_v[:, src_idx])
    return cache_k, cache_v


class Shed(Exception):
    """Admission refused the request; retry after `retry_after` seconds."""

    def __init__(self, reason: str, retry_after: float) -> None:
        super().__init__(f"request shed: {reason}")
        self.reason = reason
        self.retry_after = retry_after


class PromptTooLong(ValueError):
    """The prompt (or prompt + max_new_tokens) exceeds what this replica's
    pool geometry / model context can ever hold — a client error, not a
    transient shed."""


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: List[int]
    max_new_tokens: int
    deadline: float                     # absolute wall time
    temperature: float = 0.0
    #: the submitting client's (trace_id, parent_span_id): the TTFT and
    #: latency exemplars name its trace id.
    trace: Optional[Tuple[str, str]] = None
    # -- engine-owned state --
    events: "queue_mod.Queue" = dataclasses.field(
        default_factory=queue_mod.Queue
    )
    tokens: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    #: prefix-cache hit state: the matched radix nodes (pinned for this
    #: request's lifetime) whose pages head `pages`.
    cached_nodes: List[Any] = dataclasses.field(default_factory=list)
    cached_pages: int = 0
    slot: int = -1
    length: int = 0                     # tokens in cache
    last_token: int = 0
    finish_reason: str = ""
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    def stream(
        self, timeout: Optional[float] = None
    ) -> Iterator[Tuple[str, Any]]:
        """Yield ("token", id) events then exactly one terminal
        ("done", info) or ("error", message) event. The default timeout
        derives from the request's deadline (+ slack for the terminal
        event)."""
        if timeout is None:
            timeout = max(30.0, self.deadline - time.time() + 30.0)
        deadline = time.time() + timeout
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                yield ("error", "client stream timeout")
                return
            try:
                kind, payload = self.events.get(timeout=min(remaining, 1.0))
            except queue_mod.Empty:
                continue
            yield (kind, payload)
            if kind in ("done", "error"):
                return

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Drain the stream and return the final summary."""
        toks: List[int] = []
        for kind, payload in self.stream(timeout=timeout):
            if kind == "token":
                toks.append(payload)
            elif kind == "done":
                return {"tokens": toks, **payload}
            else:
                return {"tokens": toks, "error": payload}
        return {"tokens": toks, "error": "stream ended unexpectedly"}


class GenerationEngine:
    """Continuous-batching engine over one model replica.

    Thread model: caller threads call submit(); ONE engine thread owns all
    device state (model, page pool tensors) and drives admission →
    prefill → decode iterations. Per-request event queues carry tokens
    back to the callers.

    ``model`` is a ``models.gpt.GPT`` on ``device``. ``params`` is None
    (serve the model's own weights) or the reference's parameter tree as
    nested dicts of numpy arrays, loaded with ``load_jax_params``. Either
    way the engine makes the model's compute-dtype serving copy once.
    ``device`` defaults to CUDA (``CudaUnavailableError`` without one);
    pass ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(self, model, params, config: ServingConfig,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine device is {self.device}"
            )
        self.model = model
        self.cfg = config
        c = model.config
        if config.prefill_seq > c.seq_len:
            raise ValueError(
                f"serving.prefill_seq ({config.prefill_seq}) exceeds the "
                f"model context ({c.seq_len})"
            )
        if params is not None:
            load_jax_params(model, params, serving_copy=True)
        else:
            model.cache_compute_weights()
        self.max_total = min(c.seq_len, config.max_context)
        self.pool = PagePool(config.num_pages)
        self.cache_k = torch.zeros(
            (c.n_layers, config.num_pages, config.page_size,
             c.n_heads, c.head_dim), dtype=c.dtype, device=self.device,
        )
        self.cache_v = torch.zeros_like(self.cache_k)
        # -- prefix cache (serving.prefix_cache: on) ---------------------
        # off keeps the return-to-free-list lifecycle exactly; on layers
        # the radix cache over the SAME pool (eviction hooks into alloc).
        self.prefix_cache: Optional[PrefixCache] = None
        if config.prefix_cache == "on":
            self.prefix_cache = PrefixCache(self.pool, config.page_size)
        #: static page-granular prefill budget: every admitted doc spans
        #: ceil(len/page_size) ≤ tokens/page_size + 1 pages, so one packed
        #: batch touches at most rows·seq/page_size + docs pages (docs ≤
        #: batch slots). Padding entries write scratch page 0.
        self._prefill_pages_max = (
            config.prefill_rows
            * math.ceil(config.prefill_seq / config.page_size)
            + config.max_batch_size
        )
        # Decode kernel, resolved once: DTPU_PAGED_ATTN=0 → gather, =1 →
        # paged; otherwise `gather` → gather and `auto`/`paged` → paged.
        env = os.environ.get("DTPU_PAGED_ATTN", "")
        if env == "0":
            self._decode_kernel = "gather"
        elif env == "1":
            self._decode_kernel = "paged"
        elif config.decode_kernel == "gather":
            self._decode_kernel = "gather"
        else:
            self._decode_kernel = "paged"
        self._decode_backend = "cuda" if self.device.type == "cuda" else "plain"
        # Speculative decoding, resolved once: DTPU_SPEC_DECODE=0 is the
        # kill switch back to one-token decode, =1 forces the ngram
        # proposer; otherwise serving.speculation.mode decides. When on,
        # every iteration runs decode_kv_spec at Q = draft_len + 1 rows.
        env_spec = os.environ.get("DTPU_SPEC_DECODE", "")
        self._spec_mode = {"0": "off", "1": "ngram"}.get(
            env_spec, config.spec_mode)
        self._spec_draft_len = config.spec_draft_len
        self._spec_min_match = config.spec_min_match
        # Heads per step of the paged kernel, from the autotuner (pool
        # geometry in its key) for the one-token step and, tuned apart,
        # for the speculative verify's draft_len + 1 rows; the CUDA
        # kernel validates it and runs one head per cluster.
        self._paged_block_h = self._spec_block_h = None
        if self._decode_kernel == "paged":
            from determined_tpu_torch.ops.flash_autotune import (
                tune_paged_block_h,
            )

            tune = functools.partial(
                tune_paged_block_h, n_heads=c.n_heads, head_dim=c.head_dim,
                page_size=config.page_size, num_pages=config.num_pages,
                pages_per_slot=config.max_pages_per_request,
                batch=config.max_batch_size, dtype=c.dtype)
            self._paged_block_h = self._spec_block_h = tune(q_rows=1)
            if self._spec_mode == "ngram":
                self._spec_block_h = tune(q_rows=self._spec_draft_len + 1)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._queue: deque = deque()
        self._slots: List[Optional[Request]] = [None] * config.max_batch_size
        self._lock = threading.Lock()
        # Stats counters get their own lock: _count_shed fires from paths
        # that already hold the queue lock.
        self._stats_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._counter = 0
        self._iter_count = 0
        self._prefill_count = 0
        self._decode_seconds = 0.0
        self._done_count = 0
        self._shed_count = 0
        self._tokens_emitted = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rollback = 0
        self._spec_fallbacks = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="serving-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            QUEUE_DEPTH.set(0)
        for req in pending:
            req.events.put(("error", "engine shutting down"))
        for i, req in enumerate(self._slots):
            if req is not None:
                self._slots[i] = None
                self._retire_pages(req, cacheable=False)
                req.events.put(("error", "engine shutting down"))
        BATCH_OCCUPANCY.set(0)

    # -- admission (SLO layer) ---------------------------------------------
    def submit(
        self,
        prompt: List[int],
        max_new_tokens: Optional[int] = None,
        deadline_s: Optional[float] = None,
        temperature: float = 0.0,
        trace: Optional[Tuple[str, str]] = None,
    ) -> Request:
        """Admit a request into the waiting queue, or refuse it.

        Raises PromptTooLong (client error — this replica can never serve
        it) or Shed (transient — queue full, expired deadline, injected
        ``serving.admission`` fault; carries retry_after).
        """
        cfg = self.cfg
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise PromptTooLong("prompt must be a non-empty token list")
        explicit = bool(max_new_tokens)
        mnt = int(max_new_tokens) if explicit else cfg.max_new_tokens
        mnt = max(1, min(mnt, cfg.max_new_tokens))
        if len(prompt) > cfg.prefill_seq:
            raise PromptTooLong(
                f"prompt is {len(prompt)} tokens; this replica packs "
                f"prefills at {cfg.prefill_seq}"
            )
        if not explicit:
            # The config-default token budget is a CAP, not a promise:
            # clamp it to the remaining context. An EXPLICIT ask that
            # cannot fit is still the client error below.
            mnt = max(1, min(mnt, self.max_total - len(prompt)))
        if len(prompt) + mnt > self.max_total:
            raise PromptTooLong(
                f"prompt + max_new_tokens = {len(prompt) + mnt} exceeds "
                f"the replica context ({self.max_total} = min(model "
                f"seq_len, {cfg.max_pages_per_request} pages × "
                f"{cfg.page_size}))"
            )
        try:
            faults.inject("serving.admission")
        except faults.InjectedFault:
            self._count_shed("fault")
            raise Shed("injected admission fault", cfg.shed_retry_after_s)
        now = time.time()
        deadline = now + float(deadline_s or cfg.default_deadline_s)
        if deadline <= now:
            self._count_shed("deadline")
            raise Shed("deadline already expired", cfg.shed_retry_after_s)
        with self._lock:
            if len(self._queue) >= cfg.max_queue_depth:
                self._count_shed("queue_full")
                raise Shed(
                    f"queue full ({cfg.max_queue_depth})",
                    cfg.shed_retry_after_s,
                )
            self._counter += 1
            req = Request(
                request_id=f"req-{self._counter}",
                prompt=prompt,
                max_new_tokens=mnt,
                deadline=deadline,
                temperature=float(temperature),
                # Trace identity is fixed at admission (traceless clients
                # get a fresh root), so the exemplars and the spans agree.
                trace=trace or (trace_mod.new_trace_id(), None),
                t_submit=now,
            )
            self._queue.append(req)
            QUEUE_DEPTH.set(len(self._queue))
        self._wake.set()
        return req

    def _count_shed(self, reason: str) -> None:
        SHED.labels(reason).inc()
        REQUESTS.labels("shed").inc()
        with self._stats_lock:
            self._shed_count += 1

    # -- engine loop --------------------------------------------------------
    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                progressed = False
                for _ in range(max(1, self.cfg.max_prefills_per_iter)):
                    admitted = self._admit()
                    if not admitted:
                        break
                    self._prefill(admitted)
                    progressed = True
                if any(r is not None for r in self._slots):
                    self._decode_iter()
                    progressed = True
                if not progressed:
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("serving engine iteration failed")
                self._recover()
                time.sleep(0.1)  # resilience-ok: crash-loop damper, not a remote retry

    def _fail_in_flight(self, message: str) -> None:
        """Evict every in-flight request, return its pages (never into
        the prefix cache: their contents are suspect) and close its
        stream with an error event."""
        DECODE_FAILURES.inc()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            self._slots[i] = None
            self._retire_pages(req, cacheable=False)
            req.finish_reason = "error"
            REQUESTS.labels("error").inc()
            req.events.put(("error", message))
        BATCH_OCCUPANCY.set(0)

    def _recover(self) -> None:
        """A real prefill/decode failure behaves like the injected
        serving.decode drill; the crash may have been mid-write, so every
        cached page goes too."""
        self._fail_in_flight(
            "engine iteration failed; partial stream, pages freed")
        if self.prefix_cache is not None:
            self.prefix_cache.flush()

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _pack_fits(self, lens: List[int], new_len: int) -> bool:
        """True when `new_len` joins `lens` in ONE emitted prefill batch."""
        return first_fit_layout(
            lens + [new_len], self.cfg.prefill_seq, self.cfg.prefill_rows
        ) is not None

    def _admit(self) -> List[Request]:
        """Move queue heads into free slots for ONE prefill round. Stops
        at slot/pack/page capacity; expired deadlines shed here.

        With the prefix cache on, each head is first walked through the
        radix tree: a hit pins the matched pages (refs++ BEFORE the
        alloc, so the alloc's own eviction can never take them),
        allocates only the tail's pages and takes one row of the
        cached-tail prefill batch; misses pack into the full-prompt
        prefill. An injected ``serving.prefix_cache`` fault (or a
        hash-collision verify failure inside match) downgrades the head
        to a counted full-prefill fallback."""
        admitted: List[Request] = []
        miss_lens: List[int] = []
        hit_rows = 0
        occupied_before = sum(1 for r in self._slots if r is not None)
        while True:
            with self._lock:
                if not self._queue:
                    break
                req = self._queue[0]
            free = self._free_slots()
            if len(free) <= len(admitted):
                break
            if time.time() > req.deadline:
                with self._lock:
                    self._queue.popleft()
                    QUEUE_DEPTH.set(len(self._queue))
                self._count_shed("deadline")
                req.events.put(("error", "deadline expired in queue"))
                continue
            nodes: List[Any] = []
            if self.prefix_cache is not None:
                try:
                    faults.inject("serving.prefix_cache")
                    nodes = self.prefix_cache.match(req.prompt)
                except faults.InjectedFault:
                    self.prefix_cache.note_fallback()
                    nodes = []
            if nodes:
                if hit_rows >= self.cfg.prefill_rows:
                    break  # cached-tail batch full; next iteration
            elif not self._pack_fits(miss_lens, len(req.prompt)):
                break
            need = self.pool.pages_for(
                len(req.prompt) + req.max_new_tokens, self.cfg.page_size
            )
            if nodes:
                self.prefix_cache.acquire(nodes)
            try:
                # match stops short of the full prompt and max_new >= 1,
                # so at least one fresh page is always needed: decode
                # never writes into a shared cached page.
                fresh = self.pool.alloc(need - len(nodes))
            except PoolExhausted:
                if nodes:
                    self.prefix_cache.release(nodes)
                if not admitted and occupied_before == 0:
                    # Nothing in flight will ever free pages: shed rather
                    # than wedge the queue head forever.
                    with self._lock:
                        self._queue.popleft()
                        QUEUE_DEPTH.set(len(self._queue))
                    self._count_shed("pages")
                    req.events.put(
                        ("error", "page pool exhausted; retry later")
                    )
                    continue
                break  # pages free when an in-flight request finishes
            with self._lock:
                self._queue.popleft()
                QUEUE_DEPTH.set(len(self._queue))
            req.cached_nodes = nodes
            req.cached_pages = len(nodes)
            req.pages = [n.page for n in nodes] + fresh
            if nodes:
                self.prefix_cache.note_hit(len(nodes))
                hit_rows += 1
            else:
                if self.prefix_cache is not None:
                    self.prefix_cache.note_miss()
                miss_lens.append(len(req.prompt))
            req.t_admit = time.time()
            slot = free[len(admitted)]
            req.slot = slot
            self._slots[slot] = req
            admitted.append(req)
            if occupied_before > 0:
                BATCH_JOINS.inc()
        return admitted

    # -- prefill ------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill(self, reqs: List[Request]) -> None:
        """One admission round's prefills: cache misses through the packed
        full-prompt prefill, cache hits through the prefix-aware tail
        prefill (one row per request: each row has its own prefix)."""
        misses = [r for r in reqs if not r.cached_pages]
        hits = [r for r in reqs if r.cached_pages]
        if misses:
            self._prefill_packed(misses)
        if hits:
            self._prefill_cached(hits)

    def _prefill_packed(self, reqs: List[Request]) -> None:
        cfg = self.cfg
        layout = first_fit_layout(
            [len(r.prompt) for r in reqs], cfg.prefill_seq, cfg.prefill_rows
        )
        assert layout is not None, "admission sized the pack to one batch"
        batches = list(pack_sequences(
            [r.prompt for r in reqs], cfg.prefill_seq, cfg.prefill_rows,
            overflow="error",
        ))
        assert len(batches) == 1, "admission sized the pack to one batch"
        batch = batches[0]
        tokens = batch["tokens"]
        segs = batch["segment_ids"]
        # Per-token position within its own document, plus PAGE-GRANULAR
        # scatter coordinates: one (source token window, destination
        # page) pair per pool page the admitted prompts own. A partial
        # last page clamps its source tail onto the doc's final token —
        # those positions sit past the slot's live length and are masked
        # by both decode paths. Unused entries (src 0 → dst scratch page
        # 0) keep the shapes static.
        ps = cfg.page_size
        seq = tokens.shape[1]
        positions = np.zeros_like(tokens)
        src_idx = np.zeros((self._prefill_pages_max, ps), np.int64)
        dst_pages = np.zeros((self._prefill_pages_max,), np.int64)
        slot_i = 0
        for (row, start), req in zip(layout, reqs):
            ln = len(req.prompt)
            positions[row, start:start + ln] = np.arange(ln)
            assert tokens[row, start] == req.prompt[0], "pack layout drift"
            for pi in range(-(-ln // ps)):
                idx = start + pi * ps + np.arange(ps)
                src_idx[slot_i] = row * seq + np.minimum(idx, start + ln - 1)
                dst_pages[slot_i] = req.pages[pi]
                slot_i += 1
        assert slot_i <= self._prefill_pages_max, "prefill page budget"
        logits, k_l, v_l = self.model.prefill_kv(
            self._to_device(tokens), self._to_device(positions),
            self._to_device(segs),
        )
        _scatter_kv(self.cache_k, self.cache_v, k_l, v_l,
                    self._to_device(src_idx), self._to_device(dst_pages))
        self._emit_prefill(
            reqs, logits, [r for r, _ in layout],
            [s + len(q.prompt) - 1 for (_, s), q in zip(layout, reqs)],
        )

    def _prefill_cached(self, reqs: List[Request]) -> None:
        """Prefix-cache hit path: prefill ONLY each request's tail (the
        tokens past its matched pages), attending through the cached
        prefix K/V gathered from the pool. The tail's K/V scatters into
        the request's fresh pages exactly like the packed path, and both
        decode kernels then read the mixed cached/fresh page table."""
        cfg = self.cfg
        ps = cfg.page_size
        rows, seq = cfg.prefill_rows, cfg.prefill_seq
        tokens = np.zeros((rows, seq), np.int64)
        positions = np.zeros((rows, seq), np.int64)
        segs = np.zeros((rows, seq), np.int32)
        prefix_pt = np.zeros((rows, cfg.max_pages_per_request), np.int64)
        prefix_len = np.zeros((rows,), np.int64)
        src_idx = np.zeros((self._prefill_pages_max, ps), np.int64)
        dst_pages = np.zeros((self._prefill_pages_max,), np.int64)
        slot_i = 0
        for row, req in enumerate(reqs):
            m = req.cached_pages
            cached = m * ps
            tail = req.prompt[cached:]
            ln = len(tail)
            assert ln >= 1, "match always leaves a tail token to prefill"
            tokens[row, :ln] = tail
            # Absolute positions: the pos_embed index a full prefill
            # would have used for these tokens.
            positions[row, :ln] = cached + np.arange(ln)
            segs[row, :ln] = 1
            prefix_pt[row, :m] = req.pages[:m]
            prefix_len[row] = cached
            # The tail starts ON a page boundary, so its pages align
            # with the scatter granule like any packed doc's.
            for pi in range(-(-ln // ps)):
                idx = pi * ps + np.arange(ps)
                src_idx[slot_i] = row * seq + np.minimum(idx, ln - 1)
                dst_pages[slot_i] = req.pages[m + pi]
                slot_i += 1
        assert slot_i <= self._prefill_pages_max, "prefill page budget"
        # Each row's cached pages gathered contiguous (read-only: the
        # pages keep serving other requests).
        n_layers, _, _, h, hd = self.cache_k.shape
        pt = self._to_device(prefix_pt)
        pk = self.cache_k[:, pt].reshape(n_layers, rows, -1, h, hd)
        pv = self.cache_v[:, pt].reshape(n_layers, rows, -1, h, hd)
        sp = pk.shape[2]
        prefix_seg = (
            torch.arange(sp, device=self.device)[None, :]
            < self._to_device(prefix_len)[:, None]
        ).to(torch.int32)
        logits, k_l, v_l = self.model.prefill_kv_cached(
            self._to_device(tokens), self._to_device(positions),
            self._to_device(segs), pk, pv, prefix_seg,
        )
        _scatter_kv(self.cache_k, self.cache_v, k_l, v_l,
                    self._to_device(src_idx), self._to_device(dst_pages))
        self._emit_prefill(
            reqs, logits, list(range(len(reqs))),
            [len(r.prompt) - r.cached_pages * ps - 1 for r in reqs],
        )

    def _emit_prefill(self, reqs: List[Request], logits: torch.Tensor,
                      rows: List[int], cols: List[int]) -> None:
        """Sample each request's first token from its prompt's last
        prefill row (only those rows leave the device) and stream it."""
        firsts = self._sample(
            logits[self._to_device(np.array(rows, np.int64)),
                   self._to_device(np.array(cols, np.int64))].float(),
            [r.temperature for r in reqs],
        )
        self._prefill_count += 1
        now = time.time()
        for req, first in zip(reqs, firsts):
            req.length = len(req.prompt)
            self._emit_first(req, first, now)
        BATCH_OCCUPANCY.set(sum(1 for r in self._slots if r is not None))

    def _emit_first(self, req: Request, first: int, now: float) -> None:
        """Stream a request's first token (sampled from its prefill
        logits)."""
        req.last_token = first
        req.tokens.append(first)
        req.t_first_token = now
        # Exemplar: only a trace whose spans the head-sample will ship (a
        # pure function of the trace id) — a sampled-out one would dangle.
        TTFT.observe(
            now - req.t_submit,
            trace_id=(req.trace[0]
                      if trace_mod._keep_span(req.trace[0], False, 0.0)
                      else None),
        )
        TOKENS.inc()
        with self._stats_lock:
            self._tokens_emitted += 1
        req.events.put(("token", first))
        # a 1-token request is complete at prefill
        if len(req.tokens) >= req.max_new_tokens or (
            self.cfg.eos_id >= 0 and first == self.cfg.eos_id
        ):
            self._finish(req, "length" if len(req.tokens)
                         >= req.max_new_tokens else "eos")

    def _sample(self, logits: torch.Tensor,
                temps: Sequence[float]) -> List[int]:
        """[n, V] fp32 logits → n tokens: argmax where the temperature is
        0, else a categorical draw at that temperature from the engine's
        seeded generator."""
        out = logits.argmax(dim=-1)
        if any(t > 0 for t in temps):
            t = torch.tensor(temps, dtype=torch.float32, device=logits.device)
            probs = torch.softmax(logits / t.clamp_min(1e-6)[:, None], dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            out = torch.where(t > 0, drawn, out)
        return out.tolist()

    # -- decode -------------------------------------------------------------
    def _propose_drafts(self) -> List[List[int]]:
        """Per slot, the prompt-lookup draft for this iteration ([] for
        empty, sampled and capped-out slots). The cap keeps every written
        position inside the request's pre-budgeted pages, so rollback is
        pure ``length`` bookkeeping. An injected ``serving.speculation``
        fault degrades the WHOLE iteration to one-token decode."""
        b = self.cfg.max_batch_size
        drafts: List[List[int]] = [[] for _ in range(b)]
        try:
            faults.inject("serving.speculation")
            for i, req in enumerate(self._slots):
                if req is None or req.temperature > 0:
                    continue
                m_cap = min(
                    self._spec_draft_len,
                    req.max_new_tokens - len(req.tokens) - 1,
                    self.max_total - 2 - req.length,
                )
                if m_cap < 1:
                    continue
                drafts[i] = propose_ngram_draft(
                    req.prompt + req.tokens, m_cap, self._spec_min_match,
                )
        except faults.InjectedFault:
            SPEC_FALLBACKS.inc()
            with self._stats_lock:
                self._spec_fallbacks += 1
            drafts = [[] for _ in range(b)]
        return drafts

    def _decode_iter(self) -> None:
        cfg = self.cfg
        try:
            faults.inject("serving.decode")
        except faults.InjectedFault:
            self._fail_in_flight("decode step failed; partial stream, "
                                 "pages freed")
            return
        b = cfg.max_batch_size
        spec_on = self._spec_mode == "ngram"
        last = np.zeros((b,), np.int64)
        lengths = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        temps = [0.0] * b
        pt = np.zeros((b, cfg.max_pages_per_request), np.int32)
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            last[i] = req.last_token
            lengths[i] = req.length
            active[i] = True
            temps[i] = req.temperature
            pt[i, : len(req.pages)] = req.pages
        drafts = self._propose_drafts() if spec_on else [[]] * b
        q_lens = np.ones((b,), np.int32)
        self._iter_count += 1
        t_iter = time.perf_counter()
        greedy = None
        if spec_on:
            # Every slot rides the same verify call; plain, sampled and
            # draft-less slots keep q_lens = 1.
            toks = np.zeros((b, self._spec_draft_len + 1), np.int64)
            toks[:, 0] = last
            for i, d in enumerate(drafts):
                if d:
                    toks[i, 1:1 + len(d)] = d
                    q_lens[i] = 1 + len(d)
            logits, self.cache_k, self.cache_v = self.model.decode_kv_spec(
                self._to_device(toks), self._to_device(lengths),
                self._to_device(q_lens), self._to_device(active),
                self.cache_k, self.cache_v, self._to_device(pt), q_pad=1,
                kernel=self._decode_kernel, block_h=self._spec_block_h,
            )
            greedy = logits.argmax(dim=-1).cpu().numpy()      # [B, Q]
            nxt = self._sample(logits[:, 0], temps)
        else:
            logits, self.cache_k, self.cache_v = self.model.decode_kv(
                self._to_device(last), self._to_device(lengths),
                self._to_device(active), self.cache_k, self.cache_v,
                self._to_device(pt), q_pad=1, kernel=self._decode_kernel,
                block_h=self._paged_block_h,
            )
            nxt = self._sample(logits, temps)  # waits for the device step
        elapsed = time.perf_counter() - t_iter
        self._decode_seconds += elapsed
        DECODE_ITER_LATENCY.labels(self._decode_kernel).observe(elapsed)
        # Pages this iteration read: the paged kernel's live pages (draft
        # rows extend liveness by q_lens - 1), or the gather path's full
        # window.
        if self._decode_kernel == "paged":
            KV_PAGES_READ.inc(paged_pages_read(
                lengths, active, cfg.page_size,
                q_lens=q_lens if spec_on else None,
            ))
        else:
            KV_PAGES_READ.inc(b * cfg.max_pages_per_request)
        DECODE_ITERATIONS.inc()
        now = time.time()
        for i, req in enumerate(list(self._slots)):
            if req is None:
                continue
            m = len(drafts[i])
            if m:
                # Verify row r scored position length + r + 1: walk the
                # accepted prefix (draft token r == greedy row r) and
                # emit greedy rows 0..n, the tokens n + 1 plain
                # iterations would have produced. The rejected tail rolls
                # back by not advancing req.length past the accepted
                # span: its K/V sits beyond every kernel's length mask.
                g = greedy[i]
                n = 0
                while n < m and drafts[i][n] == int(g[n]):
                    n += 1
                emitted = [int(g[r]) for r in range(n + 1)]
                SPEC_PROPOSED.inc(m)
                SPEC_ACCEPTED.inc(n)
                SPEC_ROLLBACK.inc(m - n)
                with self._stats_lock:
                    self._spec_proposed += m
                    self._spec_accepted += n
                    self._spec_rollback += m - n
            else:
                emitted = [int(nxt[i])]
            for tok in emitted:
                req.length += 1      # the processed token entered the cache
                req.last_token = tok
                req.tokens.append(tok)
                TOKENS.inc()
                with self._stats_lock:
                    self._tokens_emitted += 1
                req.events.put(("token", tok))
                if cfg.eos_id >= 0 and tok == cfg.eos_id:
                    self._finish(req, "eos")
                    break
                elif len(req.tokens) >= req.max_new_tokens:
                    self._finish(req, "length")
                    break
                elif req.length + 1 >= self.max_total:
                    self._finish(req, "length")
                    break
                elif now > req.deadline:
                    self._finish(req, "deadline")
                    break
        BATCH_OCCUPANCY.set(sum(1 for r in self._slots if r is not None))

    def _retire_pages(self, req: Request, cacheable: bool) -> None:
        """Return a request's pages. Cache off: straight to the free
        list. Cache on: release the request's pins and (on clean
        completion) adopt its full K/V-written pages into the radix
        tree, freeing only the partial tail and unused reservation.
        Error paths free everything the request owned."""
        if req.pages:
            if self.prefix_cache is None:
                self.pool.free(req.pages)
            else:
                written = (req.prompt + req.tokens)[:req.length]
                self.prefix_cache.finish(
                    written, req.pages, req.cached_nodes, cacheable
                )
        req.pages = []
        req.cached_nodes = []
        req.cached_pages = 0

    def _finish(self, req: Request, reason: str) -> None:
        """Request leaves the batch between iterations: pages return to
        the pool (or the prefix cache) immediately, counters are bumped
        and the terminal event closes the client stream."""
        self._slots[req.slot] = None
        # Every _finish reason (length/eos/deadline) leaves valid K/V in
        # the pages: a deadline cut is an SLO decision, not corruption.
        self._retire_pages(req, cacheable=True)
        req.finish_reason = reason
        req.t_done = time.time()
        REQUESTS.labels("ok" if reason in ("length", "eos") else reason).inc()
        # Errored requests ship their spans (tail policy), so their trace
        # ids are safe exemplars; head-sampled-out healthy ones would not.
        e2e_linkable = reason not in ("length", "eos") or trace_mod._keep_span(
            req.trace[0], False, 0.0
        )
        E2E.observe(req.t_done - req.t_submit,
                    trace_id=req.trace[0] if e2e_linkable else None)
        with self._stats_lock:
            self._done_count += 1
        self._emit_spans(req)
        req.events.put(("done", {
            "reason": reason,
            "request_id": req.request_id,
            "prompt_tokens": len(req.prompt),
            "generated": len(req.tokens),
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3),
            "total_ms": round((req.t_done - req.t_submit) * 1e3, 3),
        }))

    def _emit_spans(self, req: Request) -> None:
        """Per-request W3C spans: submit → queue → prefill → first token →
        done, parented to the submitting client's traceparent."""
        trace_id, parent = req.trace
        root = trace_mod.new_span_id()
        trace_mod.export_span(
            "serving.request", trace_id=trace_id, span_id=root,
            parent_span_id=parent, start=req.t_submit, end=req.t_done,
            attributes={
                "serving.request_id": req.request_id,
                "serving.reason": req.finish_reason,
                "serving.prompt_tokens": len(req.prompt),
                "serving.generated": len(req.tokens),
            },
            error=req.finish_reason not in ("length", "eos"),
        )
        for name, start, end in (
            ("serving.queue", req.t_submit, req.t_admit),
            ("serving.prefill", req.t_admit, req.t_first_token),
            ("serving.decode", req.t_first_token, req.t_done),
        ):
            if end >= start > 0:
                trace_mod.export_span(
                    name, trace_id=trace_id, span_id=trace_mod.new_span_id(),
                    parent_span_id=root, start=start, end=end,
                )

    # -- bench support ------------------------------------------------------
    def decode_latency_compare(self, iters: int = 5) -> Dict[str, float]:
        """Per-iteration decode latency of BOTH kernel paths over the
        SAME pool state (full batch at max context: the regime the paged
        kernel exists for), best of `iters` wall times after one warm-up
        call. Runs on copies of the pool, so the live engine state is
        untouched. Call from the engine's own thread or while the engine
        is stopped."""
        cfg = self.cfg
        b = cfg.max_batch_size
        per = cfg.max_pages_per_request
        # Distinct live pages per slot, wrapped over the allocatable pool
        # (slots may share pages under oversubscription; harmless for a
        # timing probe).
        pt = (
            np.arange(b * per, dtype=np.int32) % (cfg.num_pages - 1) + 1
        ).reshape(b, per)
        s_max = per * cfg.page_size
        lengths = np.full((b,), min(s_max, self.max_total) - 2, np.int32)
        args = [self._to_device(a) for a in (
            np.full((b,), 1, np.int64), lengths, np.ones((b,), bool))]
        out: Dict[str, float] = {"s_max": float(s_max), "batch": float(b)}
        for kernel in ("paged", "gather"):
            ck, cv = self.cache_k.clone(), self.cache_v.clone()

            def step():
                logits, _, _ = self.model.decode_kv(
                    *args, ck, cv, self._to_device(pt), q_pad=1,
                    kernel=kernel,
                )
                return logits.argmax(dim=-1).tolist()  # waits for the step

            step()  # warm-up outside timing
            best = float("inf")
            for _ in range(max(1, iters)):
                t0 = time.perf_counter()
                step()
                best = min(best, time.perf_counter() - t0)
            out[f"decode_iter_ms_{kernel}"] = best * 1e3
            del ck, cv
        return out

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The reference's snapshot keys, plus the port's
        ``decode_iterations``, ``decode_seconds`` and
        ``prefill_batches``."""
        with self._lock:
            queued = len(self._queue)
        with self._stats_lock:
            done = self._done_count
            shed = self._shed_count
            emitted = self._tokens_emitted
            spec_proposed = self._spec_proposed
            spec_accepted = self._spec_accepted
            spec_rollback = self._spec_rollback
            spec_fallbacks = self._spec_fallbacks
        out = {
            "queued": queued,
            "active": sum(1 for r in self._slots if r is not None),
            "done": done,
            "shed": shed,
            "tokens_emitted": emitted,
            "pages_in_use": self.pool.pages_in_use,
            "pages_free": self.pool.free_pages,
            "decode_backend": self._decode_backend,
            "decode_kernel": self._decode_kernel,
            "max_batch_size": self.cfg.max_batch_size,
            "max_context": self.max_total,
            "cache_hit_rate": 0.0,
            "speculation": {
                "mode": self._spec_mode,
                "draft_len": self._spec_draft_len,
                "min_match": self._spec_min_match,
                "proposed_tokens": spec_proposed,
                "accepted_tokens": spec_accepted,
                "rollback_tokens": spec_rollback,
                "fallbacks": spec_fallbacks,
                "acceptance_rate": (
                    round(spec_accepted / spec_proposed, 4)
                    if spec_proposed else 0.0
                ),
            },
            "decode_iterations": self._iter_count,
            "decode_seconds": self._decode_seconds,
            "prefill_batches": self._prefill_count,
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
            out["cache_hit_rate"] = round(self.prefix_cache.hit_rate, 4)
        return out
