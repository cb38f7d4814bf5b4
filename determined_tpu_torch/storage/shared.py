"""Shared-filesystem storage: a copy of ``determined_tpu/storage/
shared.py``.

The default local backend for off-cluster runs and tests (and NFS mounts
on a cluster). Directory-level logic, retries, manifest commit/verify all
live in ``base.StorageManager``; this class is the per-file copy
primitives.
"""
from __future__ import annotations

import contextlib
import os
import shutil
from typing import Callable, Iterator, List, Optional

from determined_tpu_torch.storage.base import StorageManager, verify_checkpoint_dir


class SharedFSStorageManager(StorageManager):
    def _dir(self, storage_id: str) -> str:
        return os.path.join(self.base_path, storage_id)

    def _upload_file(self, local_path: str, storage_id: str, rel: str) -> None:
        target = os.path.join(self._dir(storage_id), rel)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        shutil.copy2(local_path, target)

    def _download_file(self, storage_id: str, rel: str, target: str) -> None:
        src = os.path.join(self._dir(storage_id), rel)
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"checkpoint {storage_id} has no file {rel} under {self.base_path}"
            )
        shutil.copy2(src, target)

    def delete(self, storage_id: str, paths: Optional[List[str]] = None) -> List[str]:
        root = self._dir(storage_id)
        if not os.path.isdir(root):
            return []
        if paths is None:
            deleted = self._list_dir(root)
            shutil.rmtree(root)
            return deleted
        for rel in paths:
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(root, rel))
        self._prune_manifest(storage_id, list(paths))
        return list(paths)

    def list_files(self, storage_id: str) -> List[str]:
        root = self._dir(storage_id)
        if not os.path.isdir(root):
            return []
        return self._list_dir(root)

    @contextlib.contextmanager
    def restore_path(
        self, storage_id: str, selector: Optional[Callable[[str], bool]] = None
    ) -> Iterator[str]:
        # Served in place, no copy, and verified against the manifest right
        # here, since no download pass will see the files.
        root = self._dir(storage_id)
        if not os.path.isdir(root):
            raise FileNotFoundError(f"checkpoint {storage_id} not found under {self.base_path}")
        verify_checkpoint_dir(root, selector=selector)
        yield root
