"""Task-side proxy registration (port of
``determined_tpu/exec/proxy_util.py``)."""
from __future__ import annotations

import os


def register_proxy(port: int) -> None:
    """Expose `port` through the master's ``/proxy/<task_id>/`` route.

    The host is omitted on purpose: the master defaults the target to the
    request's source address.
    """
    master = os.environ.get("DTPU_MASTER")
    alloc = os.environ.get("DTPU_ALLOCATION_ID")
    if not master or not alloc:
        return
    from determined_tpu_torch.common.api_session import Session

    Session(master, token=os.environ.get("DTPU_SESSION_TOKEN", "")).post(
        f"/api/v1/allocations/{alloc}/proxy", json_body={"port": port}
    )
