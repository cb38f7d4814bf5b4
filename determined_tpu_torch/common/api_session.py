"""HTTP session for the master's REST API, on the standard library.

Port of ``determined_tpu/common/api_session.py`` (which rides
``requests``) onto ``http.client``, with the same contract:

- ``Authorization: Bearer <token>`` on every request;
- one ``X-Request-Id`` per *logical* mutating request (POST, PATCH,
  DELETE), shared by its retries, so the master replays a mutation whose
  first attempt landed instead of applying it twice;
- ``traceparent`` from the ambient span (``common/trace.py``), else the
  session's own root, rotated every ``TRACE_ROOT_MAX_USES`` uses;
- every request under a ``RetryPolicy`` (``common/resilience.py``):
  retried on 502/503/504 and on transport errors; a 429 is retried with
  its ``Retry-After`` honoured and counts as a breaker success (a healthy
  endpoint shedding load); any other 4xx raises at once and counts as a
  breaker success too;
- a ``CircuitBreaker`` per endpoint, keyed by the route shape
  (``_endpoint_key``), so a wedged route fails fast while healthy ones
  keep flowing;
- fault sites ``api.get`` / ``api.post`` / ``api.patch`` / ``api.delete``
  per attempt (``common/faults.py``).

Transport: one ``HTTPConnection`` (``HTTPSConnection`` for an https
master, verified as ``common/tls.py`` says) per thread, with
``TCP_NODELAY`` as ``requests`` sets it, kept alive across requests —
the preemption long-poll and the shipper threads each hold their own. A kept-alive connection the server has closed is reconnected
once, transparently. ``http.client``'s own errors (``IncompleteRead``,
``BadStatusLine``) surface as ``ApiConnectionError``, a
``ConnectionError``, as ``requests`` wraps them, so the retry predicate
sees a transport failure; ``HTTPError`` subclasses ``OSError`` and
carries ``.response.status_code``, as ``requests.HTTPError`` does.
"""
from __future__ import annotations

import http.client
import json
import re
import socket
import threading
import uuid
from typing import Any, Dict, Optional
from urllib.parse import urlencode, urlsplit

from determined_tpu_torch.common import faults
from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.common.resilience import (
    API_RETRY,
    CircuitBreakerRegistry,
    CircuitOpenError,
    RetryPolicy,
)

RETRY_STATUSES = (502, 503, 504)

#: Admission shed: retried under the policy (which honours Retry-After)
#: but recorded as a breaker SUCCESS — opening the circuit would turn
#: deliberate load-shedding into an outage.
SHED_STATUS = 429

#: Methods that carry the idempotency header (GET is naturally idempotent).
MUTATING_METHODS = ("POST", "PATCH", "DELETE")

__all__ = [
    "ApiConnectionError", "CircuitOpenError", "HTTPError", "Response",
    "Session",
]


class Response:
    """A finished HTTP response: ``status_code``, ``headers`` (case-
    insensitive ``get``), ``content`` bytes, ``text`` and ``json()``."""

    def __init__(self, status_code: int, headers: Any,
                 content: bytes) -> None:
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.content)


class HTTPError(OSError):
    """A response with an error status; ``.response`` is the Response."""

    def __init__(self, message: str, response: Optional[Response] = None):
        super().__init__(message)
        self.response = response


class ApiConnectionError(ConnectionError):
    """A transport failure ``http.client`` reports as its own exception
    class (``IncompleteRead``, ``BadStatusLine``)."""


def _endpoint_key(method: str, path: str) -> str:
    """Breaker key: the route shape, not the instance — any digit-bearing
    segment is an id (`/trials/7/metrics` → `/trials/{id}/metrics`),
    except version segments like `v1`."""
    shape = re.sub(r"/(?!v\d+(?:/|$))[^/]*\d[^/]*", "/{id}", path)
    return f"{method} {shape}"


class _NoDelay:
    """Connect with TCP_NODELAY: a request whose headers and body leave in
    two writes must not wait out the peer's delayed ACK."""

    def connect(self) -> None:
        super().connect()  # type: ignore[misc]
        self.sock.setsockopt(  # type: ignore[attr-defined]
            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _HTTPConnection(_NoDelay, http.client.HTTPConnection):
    pass


class _HTTPSConnection(_NoDelay, http.client.HTTPSConnection):
    pass


#: A kept-alive connection the server closed fails the next request with
#: one of these before any byte of it was read: reconnect once.
_STALE_CONNECTION = (http.client.RemoteDisconnected, BrokenPipeError,
                     ConnectionResetError, ConnectionAbortedError)


class Session:
    def __init__(
        self,
        master_url: str,
        token: str = "",
        max_retries: int = 5,
        timeout: float = 60.0,
        cert: Optional[str] = None,
        retry_policy: Optional[RetryPolicy] = None,
        breakers: Optional[CircuitBreakerRegistry] = None,
    ) -> None:
        self.master_url = master_url.rstrip("/")
        self._token = token
        self._timeout = timeout
        self._policy = retry_policy or RetryPolicy(
            max_attempts=max_retries + 1,
            base_delay=API_RETRY.base_delay,
            max_delay=API_RETRY.max_delay,
        )
        self._breakers = breakers or CircuitBreakerRegistry()
        # With no ambient span every call of this Session shares one trace
        # root, rotated for long-lived owners (see _session_root).
        self._trace_root = (trace_mod.new_trace_id(), trace_mod.new_span_id())
        self._trace_root_uses = 0
        parts = urlsplit(self.master_url)
        self._https = parts.scheme == "https"
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or (443 if self._https else 80)
        self._prefix = parts.path.rstrip("/")
        self._ssl = None
        if self._https:
            from determined_tpu_torch.common.tls import client_context

            self._ssl = client_context(cert)
        self._local = threading.local()
        self._headers: Dict[str, str] = {}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"

    #: Fallback-root rotation period: well under the trace store's
    #: per-trace span cap (512).
    TRACE_ROOT_MAX_USES = 256

    def _session_root(self) -> tuple:
        self._trace_root_uses += 1
        if self._trace_root_uses > self.TRACE_ROOT_MAX_USES:
            # Benign under concurrency: the worst case is two fresh roots.
            self._trace_root = (
                trace_mod.new_trace_id(), trace_mod.new_span_id()
            )
            self._trace_root_uses = 1
        return self._trace_root

    @property
    def token(self) -> str:
        return self._token

    # -- transport -----------------------------------------------------------
    def _connection(self, timeout: float) -> "tuple[http.client.HTTPConnection, bool]":
        """This thread's connection (→ it, and whether it was reused)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        if self._https:
            conn = _HTTPSConnection(self._host, self._port, timeout=timeout,
                                    context=self._ssl)
        else:
            conn = _HTTPConnection(self._host, self._port, timeout=timeout)
        self._local.conn = conn
        return conn, False

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            conn.close()

    def _send(self, method: str, target: str, body: Optional[bytes],
              headers: Dict[str, str], timeout: float) -> Response:
        for _ in range(2):
            conn, reused = self._connection(timeout)
            try:
                conn.request(method, target, body=body, headers=headers)
                resp = conn.getresponse()
                content = resp.read()
            except _STALE_CONNECTION:
                self._drop_connection()
                if reused:
                    continue  # the server closed an idle kept-alive socket
                raise
            except http.client.HTTPException as e:
                self._drop_connection()
                raise ApiConnectionError(
                    f"{method} {target}: {type(e).__name__}: {e}") from e
            except BaseException:
                self._drop_connection()
                raise
            if resp.will_close:
                self._drop_connection()
            return Response(resp.status, resp.headers, content)
        raise AssertionError("unreachable")

    # -- requests ------------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        json_body: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
        data: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Response:
        target = f"{self._prefix}{path}"
        if params:
            target += ("&" if "?" in target else "?") + urlencode(
                {k: v for k, v in params.items() if v is not None},
                doseq=True)
        site = f"api.{method.lower()}"
        breaker = self._breakers.get(_endpoint_key(method, path))
        req_headers = dict(self._headers)
        req_headers.update(headers or {})
        # W3C trace propagation: the ambient span context, else this
        # Session's own root.
        ctx = trace_mod.current() or self._session_root()
        req_headers.setdefault(
            "traceparent", trace_mod.format_traceparent(*ctx)
        )
        if method in MUTATING_METHODS:
            # One id per LOGICAL request, shared by all its retries.
            req_headers.setdefault("X-Request-Id", uuid.uuid4().hex)
        body = data
        if json_body is not None:
            body = json.dumps(json_body).encode()
            req_headers.setdefault("Content-Type", "application/json")
        elif body is None and method in MUTATING_METHODS:
            body = b""  # Content-Length: 0, as requests sends
        wait = timeout or self._timeout

        def attempt() -> Response:
            def wire() -> Response:
                faults.inject(site)
                resp = self._send(method, target, body, req_headers, wait)
                if (
                    resp.status_code in RETRY_STATUSES
                    or resp.status_code == SHED_STATUS
                ):
                    raise HTTPError(
                        f"retryable status {resp.status_code}", response=resp
                    )
                if resp.status_code >= 400:
                    raise HTTPError(
                        f"{resp.status_code} error for {method} {path}: "
                        f"{resp.text[:500]}", response=resp)
                return resp

            # The breaker sees transport failures and retryable statuses;
            # a non-retryable 4xx is a healthy endpoint refusing.
            if not breaker.allow():
                raise CircuitOpenError(breaker.key, breaker.open_until())
            try:
                result = wire()
            except HTTPError as e:
                if (
                    e.response is not None
                    and e.response.status_code not in RETRY_STATUSES
                ):
                    breaker.record_success()
                else:
                    breaker.record_failure()
                raise
            except Exception:
                breaker.record_failure()
                raise
            breaker.record_success()
            return result

        def retryable(e: BaseException) -> bool:
            if isinstance(e, HTTPError):
                return (
                    e.response is None
                    or e.response.status_code in RETRY_STATUSES
                    or e.response.status_code == SHED_STATUS
                )
            return self._policy.should_retry(e)

        return self._policy.call(attempt, key=site, retry_if=retryable)

    def get(self, path: str, **kw: Any) -> Any:
        return self._request("GET", path, **kw).json()

    def get_bytes(self, path: str, **kw: Any) -> bytes:
        return self._request("GET", path, **kw).content

    def post_bytes(self, path: str, data: bytes, **kw: Any) -> Any:
        resp = self._request(
            "POST", path, data=data,
            headers={"Content-Type": "application/octet-stream"}, **kw,
        )
        return resp.json()

    def post(self, path: str, json_body: Optional[Dict[str, Any]] = None,
             **kw: Any) -> Any:
        resp = self._request("POST", path, json_body=json_body, **kw)
        return resp.json() if resp.content else None

    def patch(self, path: str, json_body: Optional[Dict[str, Any]] = None,
              **kw: Any) -> Any:
        resp = self._request("PATCH", path, json_body=json_body, **kw)
        return resp.json() if resp.content else None

    def delete(self, path: str, **kw: Any) -> Any:
        resp = self._request("DELETE", path, **kw)
        return resp.json() if resp.content else None
