"""Client-side TLS for the port's master session.

A copy of what the port needs from ``determined_tpu/common/tls.py``: the
CA bundle a client verifies the master against comes from the ``cert``
argument or the ``DTPU_MASTER_CERT`` variable every process of a cluster
inherits:

- a path to a PEM bundle: verify against exactly that CA (the self-signed
  bootstrap pins the master's own certificate);
- ``"noverify"``: encrypt but skip verification;
- unset: the system trust store.

The master side (certificate generation, the server context) stays in
the reference.
"""
from __future__ import annotations

import os
import ssl
from typing import Optional

CERT_ENV = "DTPU_MASTER_CERT"
NOVERIFY = "noverify"


def resolve_cert(cert: Optional[str] = None) -> Optional[str]:
    """Explicit argument wins; else the variable every process in the
    cluster inherits."""
    return cert if cert is not None else os.environ.get(CERT_ENV) or None


def client_context(cert: Optional[str] = None) -> ssl.SSLContext:
    """The ``ssl.SSLContext`` an HTTPS client of the master uses."""
    cert = resolve_cert(cert)
    if cert == NOVERIFY:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if cert:
        return ssl.create_default_context(cafile=cert)
    return ssl.create_default_context()
