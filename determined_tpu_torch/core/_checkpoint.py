"""CheckpointContext: checkpoint upload/download + metadata.

Port of ``determined_tpu/core/_checkpoint.py``: ``upload`` writes the
data files, then ``metadata.json``, then commits ONE manifest over all of
them (the commit point), under a fresh uuid ``storage_id``, and — on a
cluster — registers the committed checkpoint with the master (``POST
/api/v1/checkpoints``: uuid, task, allocation, trial, resources,
metadata, state ``COMPLETED``). ``restore_path`` yields a verified local
directory; ``restore_candidates`` lists the fallback chain, on a cluster
the trial's earlier completed checkpoints newest first (``GET
/api/v1/trials/<id>/checkpoints``).

In a gang ``upload(shard=True)`` is a collective, on the ``checkpoint``
channel so that the async writer thread may run it beside the step
loop's collectives: the chief picks the uuid and broadcasts it, every
rank uploads its own files, the chief gathers the ranks' files, metadata
and digests, writes the merged ``metadata.json``, commits the one
manifest and reports, and a closing barrier returns the same
``storage_id`` on every rank — after the commit, or with the chief's
error raised on the chief. An unsharded upload from a worker raises: it
would write a second, unreported checkpoint under another uuid.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional

from determined_tpu_torch.common.api_session import Session
from determined_tpu_torch.core._distributed import CHANNEL_CHECKPOINT
from determined_tpu_torch.storage.base import MANIFEST_FILE, StorageManager

logger = logging.getLogger("determined_tpu_torch.core")

METADATA_FILE = "metadata.json"


def merge_metadata(all_metadata: List[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Merge per-rank metadata dicts; later ranks must not conflict."""
    merged: Dict[str, Any] = {}
    for rank, md in enumerate(all_metadata):
        if not md:
            continue
        for k, v in md.items():
            if k in merged and merged[k] != v:
                raise ValueError(
                    f"conflicting checkpoint metadata key {k!r} from rank {rank}"
                )
            merged[k] = v
    return merged


class CheckpointContext:
    def __init__(
        self,
        distributed: Any,
        storage_manager: StorageManager,
        session: Optional[Session] = None,
        task_id: str = "",
        allocation_id: str = "",
        trial_id: Optional[int] = None,
    ) -> None:
        self._dist = distributed
        self._storage = storage_manager
        self._session = session
        self._task_id = task_id
        self._allocation_id = allocation_id
        self._trial_id = trial_id

    # -- save --------------------------------------------------------------
    def upload(
        self,
        ckpt_dir: str,
        metadata: Optional[Dict[str, Any]] = None,
        *,
        shard: bool = False,
        paths: Optional[List[str]] = None,
    ) -> str:
        """Upload `ckpt_dir` (or only `paths` in it) as a new checkpoint;
        returns its storage_id. Data files first, then ``metadata.json``,
        then the manifest over all of them, then the report to the
        master. With ``shard=True`` in a gang, a collective (see the
        module docstring)."""
        dist = self._dist
        gang = shard and dist.size > 1
        if gang:
            storage_id = dist.broadcast(
                str(uuid.uuid4()) if dist.is_chief else None,
                channel=CHANNEL_CHECKPOINT)
        else:
            if not dist.is_chief:
                raise RuntimeError(
                    "upload(shard=False) is chief-only; use shard=True for "
                    "collective sharded uploads"
                )
            storage_id = str(uuid.uuid4())
        my_files = paths if paths is not None else StorageManager._list_dir(ckpt_dir)
        my_files = [f for f in my_files if f not in (METADATA_FILE, MANIFEST_FILE)]
        # Data files only: the chief commits ONE manifest below, after
        # every rank's files.
        digests = self._storage.upload(
            ckpt_dir, storage_id, paths=my_files, manifest=False,
            want_digests=True,
        )
        if gang:
            files = dist.gather(my_files, channel=CHANNEL_CHECKPOINT)
            mds = dist.gather(metadata, channel=CHANNEL_CHECKPOINT)
            all_digests = dist.gather(digests, channel=CHANNEL_CHECKPOINT)
        else:
            files, mds, all_digests = [my_files], [metadata], [digests]
        chief_err: Optional[BaseException] = None
        if dist.is_chief:
            # A chief-side failure must still reach the barrier below,
            # where the workers wait.
            try:
                self._commit(storage_id, files, mds, all_digests)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                chief_err = e
        if gang:
            dist.barrier(channel=CHANNEL_CHECKPOINT)
        if chief_err is not None:
            raise chief_err
        return storage_id

    def _commit(self, storage_id: str, files: List[List[str]],
                mds: List[Optional[Dict[str, Any]]],
                digests: List[Dict[str, Any]]) -> None:
        """The chief's half: the merged ``metadata.json``, then the one
        manifest over every rank's files (the commit point), then the
        report — the master only ever hears of committed checkpoints."""
        merged_md = merge_metadata(mds)
        merged: Dict[str, Any] = {}
        for d in digests:
            merged.update(d or {})
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                json.dump(merged_md, f)
            merged.update(self._storage.upload(
                tmp, storage_id, paths=[METADATA_FILE], manifest=False,
                want_digests=True,
            ))
        self._storage.commit_manifest(storage_id, merged)
        resources = sorted({f for fs in files for f in fs})
        self._report(storage_id, resources + [METADATA_FILE, MANIFEST_FILE],
                     merged_md)

    def _report(self, storage_id: str, resources: List[str],
                metadata: Dict[str, Any]) -> None:
        if self._session is None:
            return
        self._session.post(
            "/api/v1/checkpoints",
            json_body={
                "uuid": storage_id,
                "task_id": self._task_id,
                "allocation_id": self._allocation_id,
                "trial_id": self._trial_id,
                "resources": resources,
                "metadata": metadata,
                "state": "COMPLETED",
            },
        )

    # -- load --------------------------------------------------------------
    @contextlib.contextmanager
    def restore_path(
        self, storage_id: str, selector: Optional[Callable[[str], bool]] = None
    ) -> Iterator[str]:
        """Verified restore: every file is checked against the manifest;
        a torn or tampered checkpoint raises CorruptCheckpointError."""
        with self._storage.restore_path(storage_id, selector=selector) as path:
            yield path

    def restore_candidates(self, storage_id: Optional[str]) -> List[str]:
        """Restore order: `storage_id`, then (on a cluster) the trial's
        earlier COMPLETED checkpoints newest first — the fallback chain
        when the newest turns out corrupt. Off-cluster there is nothing to
        fall back to: just the requested id."""
        candidates = [storage_id] if storage_id else []
        if self._session is None or self._trial_id is None:
            return candidates
        try:
            rows = self._session.get(
                f"/api/v1/trials/{self._trial_id}/checkpoints"
            ).get("checkpoints", [])
        except Exception as e:  # noqa: BLE001 — discovery is best-effort
            logger.warning("could not list fallback checkpoints: %s", e)
            return candidates
        rows = [r for r in rows if r.get("state", "COMPLETED") == "COMPLETED"]
        rows.sort(key=lambda r: float(r.get("report_time") or 0), reverse=True)
        for row in rows:
            uuid_ = row.get("uuid")
            if uuid_ and uuid_ not in candidates:
                candidates.append(uuid_)
        return candidates

    def download(
        self, storage_id: str, dst: str, selector: Optional[Callable[[str], bool]] = None
    ) -> None:
        self._storage.download(storage_id, dst, selector=selector)

    def get_metadata(self, storage_id: str) -> Dict[str, Any]:
        with self._storage.restore_path(
            storage_id, selector=lambda p: p == METADATA_FILE
        ) as path:
            md_path = os.path.join(path, METADATA_FILE)
            if not os.path.exists(md_path):
                return {}
            with open(md_path) as f:
                return json.load(f)

    def delete(self, storage_id: str) -> None:
        self._storage.delete(storage_id)


class DummyCheckpointContext(CheckpointContext):
    """Off-cluster mode: local storage, no master."""

    def __init__(self, distributed: Any,
                 storage_manager: StorageManager) -> None:
        super().__init__(distributed, storage_manager, session=None)
