"""Task startup: rendezvous with the master, then run the entrypoint.

Port of ``determined_tpu/exec/prep_and_run.py`` on the port's master
``Session`` (the reference's rides ``requests``):

1. ``prepare_context``: the experiment's shipped code directory
   (``GET /api/v1/files/<DTPU_CONTEXT_ID>``) is extracted and made the
   working directory and import root;
2. ``rendezvous`` for a gang of one: no address table to publish, the
   generation is recorded and stale rendezvous variables are cleared. A
   gang of more than one process is refused by name: it comes with the
   multi-device slice (ROADMAP queue 1, item 4);
3. the entrypoint runs: ``pkg.module:TrialClass`` through the trial
   harness in this process, with SIGTERM translated into a preemption
   request (``POST .../signals/preemption_from_task``), so the trainer
   checkpoints and exits 0; anything else as a shell command, with the
   task environment inherited and SIGTERM forwarded.

Run as ``python -m determined_tpu_torch.exec.prep_and_run`` with the task
environment the agent sets.
"""
from __future__ import annotations

import logging
import os
import shlex
import signal
import subprocess
import sys

from determined_tpu_torch.common.api_session import Session

logger = logging.getLogger("determined_tpu_torch.exec")

#: The rendezvous generation this process belongs to (0 at launch).
GENERATION_ENV = "DTPU_ALLOC_GENERATION"


def rendezvous(master_url: str, alloc_id: str, rank: int, num_procs: int,
               generation: int = 0) -> None:
    """The rendezvous protocol for a gang of one; mutates os.environ for
    the entrypoint."""
    if num_procs > 1:
        raise NotImplementedError(
            f"rendezvous of {num_procs} processes for {alloc_id}: a "
            "multi-process gang comes with the multi-device slice (ROADMAP "
            "queue 1, item 4)"
        )
    os.environ[GENERATION_ENV] = str(generation)
    # A one-process allocation has no table to publish; stale rendezvous
    # variables must not leak into core.init().
    os.environ.pop("DTPU_RENDEZVOUS_INFO", None)
    os.environ.pop("DTPU_CHIEF_PORT", None)


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
