"""The generation service: ``build_engine`` and its HTTP surface.

Port of ``determined_tpu/serving/service.py``. ``build_engine`` makes the
model (``tiny``, ``small``, ``medium`` or the pre-trained ``fixture``)
with weights from ``DTPU_SERVING_CHECKPOINT`` (a manifest-verified
checkpoint directory in ``save_pytree``'s layout) or a seeded random
init, and the engine over it. ``GenerationServer`` serves the engine on
the standard library's ``ThreadingHTTPServer`` with the reference's wire
protocol; every route flows through one instrumented dispatch:

- ``POST /api/v1/generate`` — body ``{"prompt": [ids]}`` (or ``"text"``,
  byte-tokenized) plus ``max_new_tokens`` / ``deadline_ms`` /
  ``temperature`` / ``stream``. ``stream: true`` (default) answers
  Server-Sent Events::

      event: token    data: {"token": 17, "index": 0}
      ...
      event: done     data: {"reason": "length", "ttft_ms": ..., ...}

  a mid-flight failure ends the stream with ``event: error``. Shed
  requests answer 503 with a ``Retry-After`` header; impossible ones
  (prompt exceeds the replica context) answer 400.
- ``GET /api/v1/stats`` — the engine snapshot.
- ``GET /healthz`` — liveness.
- ``GET /metrics`` — the process-global registry, Prometheus text format
  with exemplars.

A W3C ``traceparent`` header (``common/trace.parse_traceparent``) parents
the request's spans (``serving.request`` → queue / prefill / decode) and
names its trace in the TTFT and latency exemplars.

``main`` (``python -m determined_tpu_torch.serving.service``) serves off
the cluster until SIGINT or SIGTERM, and as a task of the master when
``DTPU_MASTER`` and ``DTPU_ALLOCATION_ID`` are set (a SERVING command):
it registers its port on the allocation's proxy route, starts the
profile and log shippers when the task env enables them (identity
``serving:<task>``), and polls the allocation's preemption signal — a
capture directive on the poll runs a bounded ``torch.profiler`` capture,
``preempt: true`` drains the engine and exits 0.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.common.metrics import REGISTRY as METRICS
from determined_tpu_torch.common.trace import parse_traceparent
from determined_tpu_torch.models import gpt as gpt_mod
from determined_tpu_torch.serving.config import ServingConfig
from determined_tpu_torch.serving.engine import (
    GenerationEngine,
    PromptTooLong,
    Request,
    Shed,
)
from determined_tpu_torch.serving.fixture import fixture_model_config
from determined_tpu_torch.storage.base import verify_checkpoint_dir
from determined_tpu_torch.trainer import _checkpoint as ckpt_io

logger = logging.getLogger("determined_tpu_torch.serving")

_MODEL_CONFIGS = {
    "tiny": gpt_mod.tiny, "small": gpt_mod.small, "medium": gpt_mod.medium,
    "fixture": fixture_model_config,
}

SERVING_REQUESTS = METRICS.counter(
    "dtpu_serving_api_requests_total",
    "Serving HTTP requests by method, route pattern, and status.",
    labels=("method", "route", "status"),
)
SERVING_LATENCY = METRICS.histogram(
    "dtpu_serving_api_request_duration_seconds",
    "Serving HTTP latency by method and route pattern (SSE generate "
    "streams are observed at stream start: their duration is the "
    "generation, not the route).",
    labels=("method", "route"),
)

#: generous default body cap — prompts are token lists, not uploads.
MAX_BODY_BYTES = 8 * 1024 * 1024

Handler = Callable[[Dict[str, Any], Dict[str, List[str]]], Any]

#: The client's (trace_id, parent_span_id) of the request a handler
#: thread is serving (from its ``traceparent`` header), or None.
_REQUEST_TRACE = threading.local()


class _SSEGenerate(Exception):
    """Control flow: answer with the request's SSE token stream."""

    def __init__(self, req: Request) -> None:
        super().__init__("sse stream")
        self.req = req


class _PlainText(Exception):
    def __init__(self, text: str, content_type: str) -> None:
        super().__init__("plaintext")
        self.text = text
        self.content_type = content_type


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None) -> None:
        super().__init__(message)
        self.status = status
        self.headers = headers or {}


def tokenize(body: Dict[str, Any]) -> List[int]:
    """Prompt tokens from a request body: explicit ``prompt`` ids win;
    ``text`` falls back to byte-level ids (every model vocab here is
    >= 256, so bytes are always in-vocab — a demo tokenizer, not BPE)."""
    if "prompt" in body:
        prompt = body["prompt"]
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) and not isinstance(t, bool) for t in prompt
        ):
            raise _HttpError(400, "prompt must be a list of token ids")
        return prompt
    if "text" in body:
        if not isinstance(body["text"], str):
            raise _HttpError(400, "text must be a string")
        return list(body["text"].encode("utf-8"))
    raise _HttpError(400, "body must carry prompt (token ids) or text")


def _num_field(body: Dict[str, Any], key: str) -> Optional[float]:
    """Optional numeric body field; a non-numeric value is a 400 client
    error, never a 500."""
    v = body.get(key)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _HttpError(400, f"{key} must be a number")
    return float(v)


def build_serving_routes(
    engine: GenerationEngine,
) -> List[Tuple[str, re.Pattern, Handler]]:
    """The routes as (method, compiled path pattern, handler(body,
    query)); a handler returns a JSON payload or raises one of the
    control-flow exceptions above."""
    def generate(body: Dict[str, Any], query: Dict[str, List[str]]):
        prompt = tokenize(body)
        deadline_ms = _num_field(body, "deadline_ms")
        max_new = _num_field(body, "max_new_tokens")
        temperature = _num_field(body, "temperature")
        try:
            req = engine.submit(
                prompt,
                max_new_tokens=int(max_new) if max_new is not None else None,
                deadline_s=(
                    deadline_ms / 1e3 if deadline_ms is not None else None
                ),
                temperature=temperature or 0.0,
                trace=getattr(_REQUEST_TRACE, "value", None),
            )
        except PromptTooLong as e:
            raise _HttpError(400, str(e))
        except Shed as e:
            # Under saturation the client backs off for Retry-After
            # seconds instead of queueing into a deadline it cannot make.
            raise _HttpError(
                503, str(e),
                headers={"Retry-After": f"{e.retry_after:g}"},
            )
        if body.get("stream", True):
            raise _SSEGenerate(req)
        return req.result()

    def stats(body, query):
        return engine.stats()

    def healthz(body, query):
        return {"status": "ok", **engine.stats()}

    def metrics(body, query):
        raise _PlainText(
            METRICS.render(exemplars=True), "text/plain; version=0.0.4"
        )

    def route(method, pat, h):
        return method, re.compile(f"^{pat}$"), h

    return [
        route("POST", r"/api/v1/generate", generate),
        route("GET", r"/api/v1/stats", stats),
        route("GET", r"/healthz", healthz),
        route("GET", r"/metrics", metrics),
    ]


class GenerationServer:
    """Standard-library ThreadingHTTPServer front end over a
    GenerationEngine: one dispatch path carries the metrics; SSE
    responses own their socket and close it when the stream ends."""

    def __init__(self, engine: GenerationEngine, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        routes = build_serving_routes(engine)

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Nagle × delayed-ACK stalls small writes ~40 ms: fatal to
            # SSE token TTFT on a keep-alive socket.
            disable_nagle_algorithm = True

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("serving http: " + fmt, *args)

            def _dispatch(self, method: str) -> None:
                parsed = urlparse(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_BODY_BYTES:
                    self._send(413, {"error": "request body too large"},
                               close=True)
                    return
                body: Dict[str, Any] = {}
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw or b"{}")
                    except json.JSONDecodeError:
                        self._send(400, {"error": "bad json"})
                        return
                    if not isinstance(body, dict):
                        self._send(400, {"error": "body must be an object"})
                        return
                _REQUEST_TRACE.value = parse_traceparent(
                    self.headers.get("traceparent"))
                for m_, pat, handler in routes:
                    if m_ != method or not pat.match(parsed.path):
                        continue
                    t_start = time.monotonic()
                    finished = False

                    def finish(status: int) -> None:
                        # ONE observation per request wherever it
                        # completes, SSE streams at stream start.
                        nonlocal finished
                        if finished:
                            return
                        finished = True
                        SERVING_LATENCY.labels(method, pat.pattern).observe(
                            time.monotonic() - t_start
                        )
                        SERVING_REQUESTS.labels(
                            method, pat.pattern, str(status)
                        ).inc()

                    status_code = 200
                    try:
                        try:
                            outcome = (
                                "json",
                                handler(body, parse_qs(parsed.query)),
                            )
                        except _SSEGenerate as es:
                            outcome = ("sse", es.req)
                        except _PlainText as pt:
                            outcome = ("plain", pt)
                        except _HttpError as e:
                            outcome = ("http_error", e)
                        kind, payload = outcome
                        if kind == "sse":
                            finish(200)
                            self._stream_sse(payload)
                            return
                        if kind == "json":
                            self._send(
                                200, payload if payload is not None else {}
                            )
                        elif kind == "plain":
                            data = payload.text.encode()
                            self.send_response(200)
                            self.send_header(
                                "Content-Type", payload.content_type
                            )
                            self.send_header(
                                "Content-Length", str(len(data))
                            )
                            self.end_headers()
                            self.wfile.write(data)
                        else:
                            status_code = payload.status
                            self._send(
                                payload.status, {"error": str(payload)},
                                headers=payload.headers,
                            )
                    except (BrokenPipeError, ConnectionResetError):
                        status_code = 0
                    except Exception as e:  # noqa: BLE001
                        status_code = 500
                        logger.exception(
                            "serving handler error %s %s", method, parsed.path
                        )
                        self._send(500, {"error": str(e)})
                    finally:
                        finish(status_code)
                    return
                self._send(404, {"error": f"no route {method} {parsed.path}"})

            def _stream_sse(self, req: Request) -> None:
                """Token events as they leave the engine; the stream owns
                the socket (no keep-alive reuse after an open-ended
                response)."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                try:
                    for i, (kind, payload) in enumerate(req.stream()):
                        if kind == "token":
                            data = json.dumps({"token": payload, "index": i})
                        elif kind == "done":
                            data = json.dumps(payload)
                        else:
                            data = json.dumps({"error": payload})
                        self.wfile.write(
                            f"id: {i}\nevent: {kind}\ndata: {data}\n\n"
                            .encode()
                        )
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away; the engine finishes regardless

            def _send(self, status: int, payload: Dict[str, Any],
                      close: bool = False,
                      headers: Optional[Dict[str, str]] = None) -> None:
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                if close:
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:  # noqa: N802
                self._dispatch("GET")

            def do_POST(self) -> None:  # noqa: N802
                self._dispatch("POST")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def build_engine(serving_cfg: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0) -> GenerationEngine:
    """Model + engine from a config's `serving:` section. Weights come
    from DTPU_SERVING_CHECKPOINT when it is set, else from a seeded
    random init (``seed``). Runs on CUDA unless the caller passes
    ``device="cpu"``."""
    cfg = ServingConfig.from_dict(serving_cfg or {})
    dev = resolve_device(device)
    model = gpt_mod.GPT(_MODEL_CONFIGS[cfg.model](), device=dev, seed=seed)
    if cfg.prefill_seq > model.config.seq_len:
        # A small model with the default prefill geometry must come up
        # serving (shorter prompts), not refuse to start.
        cfg = dataclasses.replace(cfg, prefill_seq=model.config.seq_len)
    params = None
    ckpt_dir = os.environ.get("DTPU_SERVING_CHECKPOINT", "")
    if ckpt_dir:
        # Verification BEFORE the weights go live: a torn or bit-flipped
        # checkpoint is a named refusal at startup (CorruptCheckpointError).
        # The names are the parameter tree's own (`blocks__wqkv`), as
        # save_pytree(params) writes them.
        verify_checkpoint_dir(ckpt_dir)
        params = ckpt_io.load_pytree(
            ckpt_dir, ckpt_io.nest(dict(model.named_parameters())))
        logger.info("serving params restored from %s", ckpt_dir)
    return GenerationEngine(model, params, cfg, device=dev)


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point: ``python -m determined_tpu_torch.serving.service
    [--host H] [--port P] [--config JSON] [--device cpu]``.

    Reads the serving section from ``--config`` or DTPU_SERVING_CONFIG
    (JSON, injected by the master's SERVING task launch) and serves on the
    given port (0: an OS-assigned one, printed). Off the cluster it serves
    until SIGINT or SIGTERM; as a task of the master it registers the port
    through the allocation's proxy route and polls the allocation's
    preemption signal until it fires (or SIGTERM). Either way it drains
    and exits 0."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--config", default="", help="serving config JSON")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    raw = args.config or os.environ.get("DTPU_SERVING_CONFIG", "") or "{}"
    engine = build_engine(json.loads(raw), device=args.device)
    engine.start()
    server = GenerationServer(engine, host=args.host, port=args.port)
    server.start()
    logger.info("generation service on %s", server.url)
    print(f"generation service on {server.url}", flush=True)
    from determined_tpu_torch.common import logship as logship_mod
    from determined_tpu_torch.common import profiling as profiling_mod
    from determined_tpu_torch.exec.proxy_util import register_proxy

    register_proxy(server.port)
    task_id = os.environ.get("DTPU_TASK_ID") or "serving"
    # Continuous profiling of this replica's threads (decode loop, SSE
    # writers) and its structured log lines, when the task env enables
    # them.
    profiling_mod.maybe_start_from_env(target=f"serving:{task_id}")
    logship_mod.maybe_start_from_env(
        target=f"serving:{task_id}", labels={"task": task_id},
    )
    master = os.environ.get("DTPU_MASTER")
    alloc = os.environ.get("DTPU_ALLOCATION_ID")
    session = None
    if master and alloc:
        from determined_tpu_torch.common.api_session import Session

        session = Session(
            master, token=os.environ.get("DTPU_SESSION_TOKEN", ""),
            max_retries=1,
        )
    done = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        while not done.is_set():
            if session is None:
                done.wait()
                continue
            # The idle loop is the replica's control channel: a short
            # long-poll (a capture directive rides back on its return).
            try:
                resp = session.get(
                    f"/api/v1/allocations/{alloc}/signals/preemption",
                    params={"timeout_seconds": 5}, timeout=15,
                ) or {}
            except Exception:  # noqa: BLE001 — master away; keep serving
                done.wait(5)  # fixed-cadence signal poll, not a retry
                continue
            cap = resp.get("profile_capture")
            if cap:
                from determined_tpu_torch.profiler import run_bounded_capture

                run_bounded_capture(session, cap)
            if resp.get("preempt"):
                logger.info("preemption signal; draining and exiting")
                break
    except KeyboardInterrupt:
        pass
    finally:
        profiling_mod.flush_profiler()
        logship_mod.flush_shipping()
        server.stop()
        engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
