"""Task startup: rendezvous with the master, then run the entrypoint.

Port of ``determined_tpu/exec/prep_and_run.py`` on the port's master
``Session`` (the reference's rides ``requests``):

1. ``prepare_context``: the experiment's shipped code directory
   (``GET /api/v1/files/<DTPU_CONTEXT_ID>``) is extracted and made the
   working directory and import root;
2. ``rendezvous``, the reference's protocol: every process of the gang
   posts its address to the allocation's rendezvous route (rank 0's
   carries two free ports: the coordinator's, where ``core.init()``
   joins ``torch.distributed``, and the chief's), waits for the published
   table, and writes ``DTPU_RENDEZVOUS_INFO`` and ``DTPU_CHIEF_PORT`` for
   the entrypoint. The rendezvous generation fences stale identities: a
   409 from the master carries the resize directive that re-maps this
   rank (and the round is retried under the new generation), or drops it
   (exit 0). A gang of one publishes nothing and clears stale variables.
   ``apply_resize`` re-enters the rendezvous for an elastic resize, in the
   same process: the harness's resize loop calls it;
3. the entrypoint runs: ``pkg.module:TrialClass`` through the trial
   harness in this process, with SIGTERM translated into a preemption
   request (``POST .../signals/preemption_from_task``), so the trainer
   checkpoints and exits 0; anything else as a shell command, with the
   task environment inherited and SIGTERM forwarded.

Run as ``python -m determined_tpu_torch.exec.prep_and_run`` with the task
environment the agent sets.
"""
from __future__ import annotations

import json
import logging
import os
import shlex
import signal
import socket
import subprocess
import sys

from determined_tpu_torch.common import faults
from determined_tpu_torch.common.api_session import HTTPError, Session

logger = logging.getLogger("determined_tpu_torch.exec")

#: The rendezvous generation this process belongs to (0 at launch).
GENERATION_ENV = "DTPU_ALLOC_GENERATION"


def _my_ip(master_url: str) -> str:
    """The address the gang's other processes reach this one at."""
    host = master_url.split("//")[-1].split(":")[0]
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect((host, 80))  # no packet leaves: a UDP connect picks a route
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def rendezvous(master_url: str, alloc_id: str, rank: int, num_procs: int,
               generation: int = 0) -> None:
    """Run the rendezvous protocol; mutates os.environ for the entrypoint.

    A 409 (this process's generation is stale: the gang was resized while
    it arrived or waited) re-maps the rank through the rejection's
    directive and retries under the new generation; a rank the directive
    dropped exits 0 (the master ignores resized-away members' exits)."""
    for _ in range(8):
        try:
            _rendezvous_round(master_url, alloc_id, rank, num_procs,
                              generation)
            return
        except HTTPError as e:
            resp = getattr(e, "response", None)
            if resp is None or resp.status_code != 409:
                raise
            try:
                body = resp.json()
            except ValueError:
                raise e from None
            directive = body.get("resize")
            if not directive:
                raise  # fenced without a directive: an error, not a drop
            new_rank = (directive.get("rank_map") or {}).get(str(rank))
            if new_rank is None:
                if directive.get("resync_only"):
                    raise
                logger.info(
                    "rendezvous fenced at generation %s and this rank was "
                    "dropped; exiting for re-sync", body.get("generation"))
                raise SystemExit(0)
            rank = int(new_rank)
            num_procs = int(directive["num_processes"])
            generation = int(directive["generation"])
            os.environ["DTPU_ALLOC_RANK"] = str(rank)
            os.environ["DTPU_ALLOC_NUM_PROCS"] = str(num_procs)
            logger.info("rendezvous fenced; retrying as rank %d of %d "
                        "(generation %d)", rank, num_procs, generation)
    raise RuntimeError(
        f"rendezvous for {alloc_id} could not settle within 8 resize "
        "generations"
    )


def _rendezvous_round(master_url: str, alloc_id: str, rank: int,
                      num_procs: int, generation: int) -> None:
    os.environ[GENERATION_ENV] = str(generation)
    if num_procs <= 1:
        # A one-process allocation has no table to publish; stale
        # rendezvous variables must not leak into core.init().
        os.environ.pop("DTPU_RENDEZVOUS_INFO", None)
        os.environ.pop("DTPU_CHIEF_PORT", None)
        return
    session = _task_session(master_url)
    ip = _my_ip(master_url)
    addr = f"{ip}:{_free_port()}:{_free_port()}" if rank == 0 else ip
    session.post(
        f"/api/v1/allocations/{alloc_id}/rendezvous",
        json_body={"rank": rank, "addr": addr, "generation": generation},
    )
    info = session.get(
        f"/api/v1/allocations/{alloc_id}/rendezvous",
        params={"timeout_seconds": 600, "generation": generation},
        timeout=610,
    )
    chief_ip, coord_port, chief_port = info["container_addrs"][0].split(":")
    os.environ["DTPU_RENDEZVOUS_INFO"] = json.dumps({
        "container_addrs": [a.split(":")[0] for a in info["container_addrs"]],
        "container_rank": rank,
        "coordinator_address": f"{chief_ip}:{coord_port}",
        "num_processes": num_procs,
    })
    os.environ["DTPU_CHIEF_PORT"] = chief_port


def apply_resize(master_url: str, directive: dict) -> bool:
    """Re-enter the rendezvous under a resize directive's generation:
    this process's rank re-numbered through ``rank_map``, the identity
    variables (rank, size, generation, rendezvous table) rewritten, and
    the protocol run again, so the survivors (and any newcomers) form
    the new gang in the same allocation and process. A 409 on the way
    (a newer resize) re-maps again, or exits 0 when it drops this rank.

    Returns False when the directive dropped this rank (the caller exits
    cleanly); raises when it could not map it (``resync_only``). The
    ``resize.rendezvous`` fault site fails the re-entry in drills."""
    old_rank = int(os.environ.get("DTPU_ALLOC_RANK", "0"))
    new_rank = (directive.get("rank_map") or {}).get(str(old_rank))
    if new_rank is None:
        if directive.get("resync_only"):
            raise RuntimeError(
                f"resize directive could not map rank {old_rank} (history "
                "gap); erroring out for re-sync")
        logger.info("resize to generation %s dropped rank %d; exiting",
                    directive.get("generation"), old_rank)
        return False
    num_procs = int(directive["num_processes"])
    generation = int(directive["generation"])
    os.environ["DTPU_ALLOC_RANK"] = str(new_rank)
    os.environ["DTPU_ALLOC_NUM_PROCS"] = str(num_procs)
    faults.inject("resize.rendezvous")
    logger.info("elastic resize: rank %d -> %d of %d (generation %d); "
                "re-entering the rendezvous", old_rank, int(new_rank),
                num_procs, generation)
    rendezvous(master_url, os.environ.get("DTPU_ALLOCATION_ID", ""),
               int(new_rank), num_procs, generation)
    return True


def _task_session(master_url: str) -> Session:
    """Session carrying the task's credential; the high retry budget
    rides out master restarts."""
    return Session(
        master_url,
        token=os.environ.get("DTPU_SESSION_TOKEN", ""),
        max_retries=12,
    )


def prepare_context(master_url: str) -> None:
    """Download and extract the experiment's shipped code directory and
    make it the working directory and import root."""
    context_id = os.environ.get("DTPU_CONTEXT_ID")
    if not context_id:
        return
    import tempfile

    from determined_tpu_torch.common.context_dir import extract

    session = _task_session(master_url)
    data = session.get_bytes(f"/api/v1/files/{context_id}")
    dest = tempfile.mkdtemp(prefix="dtpu-context-")
    extract(data, dest)
    os.chdir(dest)
    sys.path.insert(0, dest)
    # Child processes (shell entrypoints) resolve imports there too.
    os.environ["PYTHONPATH"] = (
        dest + os.pathsep + os.environ.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    logger.info("context %s extracted to %s", context_id, dest)


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    master_url = os.environ["DTPU_MASTER"]
    alloc_id = os.environ.get("DTPU_ALLOCATION_ID", "")
    rank = int(os.environ.get("DTPU_ALLOC_RANK", "0"))
    num_procs = int(os.environ.get("DTPU_ALLOC_NUM_PROCS", "1"))
    entrypoint = os.environ.get("DTPU_ENTRYPOINT", "")

    prepare_context(master_url)
    rendezvous(master_url, alloc_id, rank, num_procs,
               generation=int(os.environ.get(GENERATION_ENV, "0")))

    if ":" in entrypoint and " " not in entrypoint:
        # Trial-class entrypoint: run in this process through the harness.
        # SIGTERM → a preemption request, so the trainer checkpoints and
        # exits 0.
        def on_sigterm(signum, frame):  # noqa: ANN001
            logger.info("SIGTERM: requesting preemption")
            try:
                _task_session(master_url).post(
                    f"/api/v1/allocations/{alloc_id}"
                    "/signals/preemption_from_task",
                    json_body={
                        "rank": int(os.environ.get("DTPU_ALLOC_RANK", "0")),
                    },
                )
            except Exception:  # noqa: BLE001
                os._exit(143)

        signal.signal(signal.SIGTERM, on_sigterm)
        from determined_tpu_torch.exec import harness

        return harness.run(entrypoint)

    # Shell entrypoint: exec as a child, forward SIGTERM.
    proc = subprocess.Popen(shlex.split(entrypoint), env=os.environ)
    signal.signal(signal.SIGTERM, lambda s, f: proc.terminate())
    return proc.wait()


if __name__ == "__main__":
    sys.exit(main())
