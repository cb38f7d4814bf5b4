"""Serving load generator: concurrent streaming requests + SLO accounting.

Port of ``determined_tpu/serving/loadgen.py``. Fires N streaming generate
requests at `concurrency` against a service URL and records per-request
TTFT and token timing; the aggregate report carries
``serving_tokens_per_sec`` and ``p99_ttft_ms``. The reference's client is
``requests``; this one is the standard library's ``http.client``, with
the same SSE parsing (events read as they arrive, never a buffered
chunk, so TTFT is not falsified). Each trace also keeps the streamed
token ids (``RequestTrace.token_ids``), so a run can be checked, not
only timed.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from typing import Any, Dict, List, Optional
from urllib.parse import urlparse


@dataclasses.dataclass
class RequestTrace:
    ok: bool = False
    shed: bool = False
    error: str = ""
    status: int = 0
    tokens: int = 0
    t_start: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    #: the streamed token ids, in order.
    token_ids: List[int] = dataclasses.field(default_factory=list)

    @property
    def ttft_ms(self) -> float:
        return (self.t_first_token - self.t_start) * 1e3


@dataclasses.dataclass
class LoadReport:
    traces: List[RequestTrace]
    wall_s: float

    @property
    def completed(self) -> int:
        return sum(1 for t in self.traces if t.ok)

    @property
    def shed(self) -> int:
        return sum(1 for t in self.traces if t.shed)

    @property
    def total_tokens(self) -> int:
        return sum(t.tokens for t in self.traces)

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / self.wall_s if self.wall_s > 0 else 0.0

    def ttft_percentile_ms(self, pct: float) -> float:
        samples = sorted(
            t.ttft_ms for t in self.traces if t.ok and t.t_first_token > 0
        )
        if not samples:
            return float("nan")
        idx = min(len(samples) - 1,
                  int(round(pct / 100.0 * (len(samples) - 1))))
        return samples[idx]

    def summary(self) -> Dict[str, Any]:
        return {
            "requests": len(self.traces),
            "completed": self.completed,
            "shed": self.shed,
            "serving_tokens_per_sec": round(self.tokens_per_sec, 2),
            "p50_ttft_ms": round(self.ttft_percentile_ms(50), 3),
            "p99_ttft_ms": round(self.ttft_percentile_ms(99), 3),
            "total_tokens": self.total_tokens,
            "wall_s": round(self.wall_s, 3),
        }


def _iter_sse_lines(resp):
    """Lines from a streaming response as they arrive: ``read1`` returns
    whatever bytes are in, where a plain ``read(n)`` would wait for n of
    them on a close-delimited SSE body and delay every event."""
    buf = b""
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            yield line.decode("utf-8", "replace").rstrip("\r")
    if buf:
        yield buf.decode("utf-8", "replace")


def _read_sse(resp, trace: RequestTrace) -> None:
    """Consume one SSE generate stream, stamping first-token time when the
    first `event: token` block arrives."""
    event = ""
    for line in _iter_sse_lines(resp):
        if line.startswith("event: "):
            event = line[len("event: "):]
            continue
        if not line.startswith("data: "):
            continue
        payload = json.loads(line[len("data: "):])
        if event == "token":
            if trace.tokens == 0:
                trace.t_first_token = time.time()
            trace.tokens += 1
            trace.token_ids.append(int(payload["token"]))
        elif event == "done":
            trace.ok = True
            return
        elif event == "error":
            trace.error = str(payload.get("error", "stream error"))
            return


def zipf_prefix_prompts(
    n_requests: int,
    *,
    corpus_size: int = 8,
    prefix_len: int = 16,
    suffix_len: int = 4,
    skew: float = 1.1,
    seed: int = 0,
    vocab: int = 200,
) -> List[List[int]]:
    """A zipfian shared-prefix workload: `corpus_size` distinct prefixes
    with popularity ~ 1/rank^skew (the few-hot-system-prompts shape real
    serving traffic has), each request appending a unique suffix. This is
    what makes a prefix cache (and the cache-aware router keying on the
    SAME leading block) earn its keep: the hot prefixes repeat, the
    suffixes never do. Deterministic in `seed` — bench runs compare
    cache-on vs cache-off over the IDENTICAL request list."""
    import random

    rng = random.Random(seed)
    prefixes = [
        [(rng.randrange(vocab)) + 1 for _ in range(prefix_len)]
        for _ in range(corpus_size)
    ]
    weights = [1.0 / (rank + 1) ** skew for rank in range(corpus_size)]
    picks = rng.choices(range(corpus_size), weights=weights, k=n_requests)
    return [
        prefixes[p] + [(rng.randrange(vocab)) + 1 for _ in range(suffix_len)]
        for p in picks
    ]


def corpus_ngram_prompts(
    n_requests: int,
    phrases: List[List[int]],
    *,
    skew: float = 1.1,
    seed: int = 0,
    lead_len: int = 3,
) -> List[List[int]]:
    """Corpus-derived prompts with REPEATED n-grams: each request picks a
    zipfian-hot context phrase (the shared-prefix shape the prefix cache
    keys on) plus a distinct body phrase, then re-opens the body with its
    first `lead_len` tokens — so the prompt's trailing n-gram already
    occurred earlier in the prompt, and both consumers fire: the
    prompt-lookup speculator finds the gram and drafts the body's
    continuation, and a corpus-trained model's greedy decode actually
    WALKS that continuation, so drafts verify. Deterministic in `seed` —
    spec-on vs spec-off bench passes replay the IDENTICAL list."""
    import random

    rng = random.Random(seed)
    weights = [1.0 / (rank + 1) ** skew for rank in range(len(phrases))]
    prompts = []
    for _ in range(n_requests):
        ctx = rng.choices(range(len(phrases)), weights=weights, k=1)[0]
        body = rng.randrange(len(phrases))
        prompts.append(
            phrases[ctx] + phrases[body] + phrases[body][:lead_len]
        )
    return prompts


def drive(
    url: str,
    n_requests: int,
    concurrency: int,
    *,
    prompt_len: int = 16,
    max_new_tokens: int = 16,
    deadline_ms: Optional[int] = None,
    stagger_s: float = 0.0,
    timeout_s: float = 300.0,
    prompts: Optional[List[List[int]]] = None,
) -> LoadReport:
    """POST `n_requests` streaming generates at `concurrency` against
    `url` (the service root). `stagger_s` delays each worker's start, to
    force late joins into a non-empty batch. `prompts` overrides the
    default distinct-prompt stream with an explicit list (one per
    request, e.g. `zipf_prefix_prompts` for the shared-prefix cache
    workload)."""
    if prompts is not None and len(prompts) != n_requests:
        raise ValueError(
            f"prompts carries {len(prompts)} entries for "
            f"{n_requests} requests"
        )
    target = urlparse(url)
    traces = [RequestTrace() for _ in range(n_requests)]
    sem = threading.Semaphore(concurrency)

    def one(i: int) -> None:
        trace = traces[i]
        body = {
            "prompt": (
                list(prompts[i]) if prompts is not None
                else [(7 * i + j) % 200 + 1 for j in range(prompt_len)]
            ),
            "max_new_tokens": max_new_tokens,
            "stream": True,
        }
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        with sem:
            trace.t_start = time.time()
            conn = http.client.HTTPConnection(
                target.hostname, target.port, timeout=timeout_s)
            try:
                conn.request(
                    "POST", f"{target.path.rstrip('/')}/api/v1/generate",
                    body=json.dumps(body),
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                trace.status = resp.status
                if resp.status == 503:
                    trace.shed = True
                    return
                if resp.status != 200:
                    trace.error = resp.read().decode(
                        "utf-8", "replace")[:200]
                    return
                _read_sse(resp, trace)
            except (OSError, http.client.HTTPException) as e:
                trace.error = str(e)
            finally:
                conn.close()
                trace.t_done = time.time()

    t0 = time.time()
    threads = []
    for i in range(n_requests):
        if stagger_s and i:
            time.sleep(stagger_s)
        t = threading.Thread(target=one, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout_s)
    return LoadReport(traces=traces, wall_s=time.time() - t0)
