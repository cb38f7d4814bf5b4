"""CheckpointContext: checkpoint upload/download + metadata, off-cluster.

Port of ``determined_tpu/core/_checkpoint.py`` for a gang of one with no
master session: ``upload`` writes the data files, then ``metadata.json``,
then commits ONE manifest over all of them (the commit point), under a
fresh uuid ``storage_id``; ``restore_path`` yields a verified local
directory. ``shard=True`` is accepted with a gang of one (it is then the
same upload); a multi-process gang comes with the multi-device slice, and
reporting to the master (the ``Session``) with the exec slice.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional

from determined_tpu_torch.core._distributed import DummyDistributedContext
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
        distributed: DummyDistributedContext,
        storage_manager: StorageManager,
    ) -> None:
        self._dist = distributed
        self._storage = storage_manager

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
        then the manifest over both."""
        if self._dist.size > 1:
            raise NotImplementedError(
                "checkpoint upload from a multi-process gang comes with the "
                "multi-device slice"
            )
        del shard  # a gang of one: the sharded upload is the plain one
        storage_id = str(uuid.uuid4())
        my_files = paths if paths is not None else StorageManager._list_dir(ckpt_dir)
        my_files = [f for f in my_files if f not in (METADATA_FILE, MANIFEST_FILE)]
        digests = self._storage.upload(
            ckpt_dir, storage_id, paths=my_files, manifest=False,
            want_digests=True,
        )
        merged_md = merge_metadata([metadata])
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, METADATA_FILE), "w") as f:
                json.dump(merged_md, f)
            digests.update(self._storage.upload(
                tmp, storage_id, paths=[METADATA_FILE], manifest=False,
                want_digests=True,
            ))
        self._storage.commit_manifest(storage_id, digests)
        return storage_id

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
        """Restore order: `storage_id`, then (on a cluster) earlier
        checkpoints newest first. Off-cluster there is nothing to fall
        back to: just the requested id."""
        return [storage_id] if storage_id else []

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
