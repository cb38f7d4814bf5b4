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

Not in this slice, and refused by name (``UnsupportedServingFeature``):
``prefix_cache: on`` and ``speculation.mode: ngram``. The reference's
metrics, trace spans and fault sites arrive with the observability slice.
"""
from __future__ import annotations

import dataclasses
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
from determined_tpu_torch.models.gpt import load_jax_params
from determined_tpu_torch.serving.config import ServingConfig
from determined_tpu_torch.serving.kv_cache import PagePool, PoolExhausted

logger = logging.getLogger("determined_tpu_torch.serving")


class UnsupportedServingFeature(NotImplementedError):
    """A serving option that a later slice of the port brings (prefix
    cache, speculative decoding, checkpoint loading, the fixture model)."""


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
    #: the submitting client's (trace_id, parent_span_id); carried for
    #: the trace plane of a later slice.
    trace: Optional[Tuple[str, str]] = None
    # -- engine-owned state --
    events: "queue_mod.Queue" = dataclasses.field(
        default_factory=queue_mod.Queue
    )
    tokens: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
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
        if config.prefix_cache == "on":
            raise UnsupportedServingFeature(
                "serving.prefix_cache: on is not ported yet (later serving "
                "slice); use prefix_cache: off"
            )
        env_spec = os.environ.get("DTPU_SPEC_DECODE", "")
        spec_mode = {"0": "off", "1": "ngram"}.get(env_spec, config.spec_mode)
        if spec_mode == "ngram":
            raise UnsupportedServingFeature(
                "serving.speculation.mode: ngram is not ported yet (later "
                "serving slice); use speculation.mode: off"
            )
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
        for req in pending:
            req.events.put(("error", "engine shutting down"))
        for i, req in enumerate(self._slots):
            if req is not None:
                self._slots[i] = None
                self._retire_pages(req)
                req.events.put(("error", "engine shutting down"))

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
        it) or Shed (transient — queue full or expired deadline; carries
        retry_after).
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
        now = time.time()
        deadline = now + float(deadline_s or cfg.default_deadline_s)
        if deadline <= now:
            self._count_shed()
            raise Shed("deadline already expired", cfg.shed_retry_after_s)
        with self._lock:
            if len(self._queue) >= cfg.max_queue_depth:
                self._count_shed()
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
                trace=trace,
                t_submit=now,
            )
            self._queue.append(req)
        self._wake.set()
        return req

    def _count_shed(self) -> None:
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
                    self._prefill_packed(admitted)
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

    def _recover(self) -> None:
        """A prefill/decode failure evicts the in-flight requests, returns
        their pages, and closes their streams with an error event."""
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            self._slots[i] = None
            self._retire_pages(req)
            req.finish_reason = "error"
            req.events.put(
                ("error", "engine iteration failed; partial stream, "
                 "pages freed")
            )

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _pack_fits(self, lens: List[int], new_len: int) -> bool:
        """True when `new_len` joins `lens` in ONE emitted prefill batch."""
        return first_fit_layout(
            lens + [new_len], self.cfg.prefill_seq, self.cfg.prefill_rows
        ) is not None

    def _admit(self) -> List[Request]:
        """Move queue heads into free slots for ONE prefill round. Stops
        at slot/pack/page capacity; expired deadlines shed here."""
        admitted: List[Request] = []
        lens: List[int] = []
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
                self._count_shed()
                req.events.put(("error", "deadline expired in queue"))
                continue
            if not self._pack_fits(lens, len(req.prompt)):
                break
            need = self.pool.pages_for(
                len(req.prompt) + req.max_new_tokens, self.cfg.page_size
            )
            try:
                pages = self.pool.alloc(need)
            except PoolExhausted:
                if not admitted and occupied_before == 0:
                    # Nothing in flight will ever free pages: shed rather
                    # than wedge the queue head forever.
                    with self._lock:
                        self._queue.popleft()
                    self._count_shed()
                    req.events.put(
                        ("error", "page pool exhausted; retry later")
                    )
                    continue
                break  # pages free when an in-flight request finishes
            with self._lock:
                self._queue.popleft()
            req.pages = pages
            lens.append(len(req.prompt))
            req.t_admit = time.time()
            slot = free[len(admitted)]
            req.slot = slot
            self._slots[slot] = req
            admitted.append(req)
        return admitted

    # -- prefill ------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        # Only each document's last row leaves the device.
        rows = self._to_device(np.array([r for r, _ in layout], np.int64))
        cols = self._to_device(np.array(
            [s + len(q.prompt) - 1 for (_, s), q in zip(layout, reqs)],
            np.int64,
        ))
        firsts = self._sample(
            logits[rows, cols].float(), [r.temperature for r in reqs]
        )
        self._prefill_count += 1
        now = time.time()
        for req, first in zip(reqs, firsts):
            req.length = len(req.prompt)
            self._emit_first(req, first, now)

    def _emit_first(self, req: Request, first: int, now: float) -> None:
        """Stream a request's first token (sampled from its prefill
        logits)."""
        req.last_token = first
        req.tokens.append(first)
        req.t_first_token = now
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
    def _decode_iter(self) -> None:
        cfg = self.cfg
        b = cfg.max_batch_size
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
        self._iter_count += 1
        t_iter = time.perf_counter()
        logits, self.cache_k, self.cache_v = self.model.decode_kv(
            self._to_device(last), self._to_device(lengths),
            self._to_device(active), self.cache_k, self.cache_v,
            self._to_device(pt), q_pad=1, kernel=self._decode_kernel,
        )
        nxt = self._sample(logits, temps)  # waits for the device step
        self._decode_seconds += time.perf_counter() - t_iter
        now = time.time()
        for i, req in enumerate(list(self._slots)):
            if req is None:
                continue
            tok = int(nxt[i])
            req.length += 1      # the processed token entered the cache
            req.last_token = tok
            req.tokens.append(tok)
            with self._stats_lock:
                self._tokens_emitted += 1
            req.events.put(("token", tok))
            if cfg.eos_id >= 0 and tok == cfg.eos_id:
                self._finish(req, "eos")
            elif len(req.tokens) >= req.max_new_tokens:
                self._finish(req, "length")
            elif req.length + 1 >= self.max_total:
                self._finish(req, "length")
            elif now > req.deadline:
                self._finish(req, "deadline")

    def _retire_pages(self, req: Request) -> None:
        if req.pages:
            self.pool.free(req.pages)
        req.pages = []

    def _finish(self, req: Request, reason: str) -> None:
        """Request leaves the batch between iterations: pages return to
        the pool immediately (an early finisher frees capacity while its
        batch-mates keep decoding) and the terminal event closes the
        client stream."""
        self._slots[req.slot] = None
        self._retire_pages(req)
        req.finish_reason = reason
        req.t_done = time.time()
        with self._stats_lock:
            self._done_count += 1
        req.events.put(("done", {
            "reason": reason,
            "request_id": req.request_id,
            "prompt_tokens": len(req.prompt),
            "generated": len(req.tokens),
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3),
            "total_ms": round((req.t_done - req.t_submit) * 1e3, 3),
        }))

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            queued = len(self._queue)
        with self._stats_lock:
            done = self._done_count
            shed = self._shed_count
            emitted = self._tokens_emitted
        return {
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
            "decode_iterations": self._iter_count,
            "decode_seconds": self._decode_seconds,
            "prefill_batches": self._prefill_count,
        }
