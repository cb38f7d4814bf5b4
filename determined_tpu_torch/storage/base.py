"""StorageManager interface + factory + checkpoint integrity layer.

A copy of ``determined_tpu/storage/base.py``. A checkpoint is a directory
addressed by a uuid ``storage_id``; managers upload/download/delete whole
directories and support partial (selector'd) downloads.

Crash safety + integrity (this layer, the same for every backend):

- every upload records a ``manifest.json`` mapping each file to its sha256
  and size; **data files upload before the manifest**: the manifest is
  the commit point, so a crash mid-upload leaves an uncommitted directory
  rather than a torn checkpoint that restore would load;
- ``download`` / ``restore_path`` verify checksums against the manifest
  and raise ``CorruptCheckpointError`` on any mismatch, truncation, or
  manifest-listed-but-missing file. Checkpoints without a manifest
  (pre-manifest, hand-built directories) load with a warning;
- per-file transfers run under ``STORAGE_RETRY`` and are fault sites
  (``storage.upload``, ``storage.download``), including torn-write
  injection: a scheduled torn write uploads truncated bytes then raises,
  which the retry overwrites.

The manifest format is the reference's, so either package verifies the
other's checkpoints. Concrete managers implement only the per-file
primitives (``_upload_file`` / ``_download_file``) plus ``list_files`` /
``delete``. The port has the shared-filesystem manager; the GCS, S3 and
Azure managers need their SDKs and are refused by name in ``from_config``.
"""
from __future__ import annotations

import abc
import contextlib
import hashlib
import json
import logging
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Iterator, List, Optional

from determined_tpu_torch.common import faults
from determined_tpu_torch.common.resilience import STORAGE_RETRY, RetryPolicy

logger = logging.getLogger("determined_tpu_torch.storage")

MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1


class CorruptCheckpointError(ValueError):
    """Checkpoint failed integrity verification: torn write, checksum or
    size mismatch, a manifest-listed file missing, or (at the pytree
    layer) incomplete shard coverage / shape drift."""


def file_digest(path: str) -> Dict[str, Any]:
    """{"sha256": hex, "size": bytes} of a local file."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            size += len(chunk)
    return {"sha256": h.hexdigest(), "size": size}


def verify_local_file(path: str, entry: Dict[str, Any], rel: str) -> None:
    """Raise CorruptCheckpointError unless `path` matches its manifest
    entry (size first via stat, the cheap torn-write tell, then sha256)."""
    try:
        size = os.stat(path).st_size
    except OSError as e:
        raise CorruptCheckpointError(
            f"checkpoint file {rel} unreadable during verification: {e}"
        ) from e
    if size != entry.get("size"):
        raise CorruptCheckpointError(
            f"checkpoint file {rel} is {size} bytes, manifest "
            f"says {entry.get('size')} — torn write"
        )
    try:
        actual = file_digest(path)
    except OSError as e:
        raise CorruptCheckpointError(
            f"checkpoint file {rel} unreadable during verification: {e}"
        ) from e
    if actual["sha256"] != entry.get("sha256"):
        raise CorruptCheckpointError(
            f"checkpoint file {rel} sha256 mismatch — corrupt content"
        )


def verify_checkpoint_dir(
    root: str, selector: Optional[Callable[[str], bool]] = None
) -> bool:
    """Verify a local checkpoint directory against its manifest.

    Returns True when a manifest was present and every selected entry
    verified; False when the directory has no manifest (verified
    nothing). Raises CorruptCheckpointError on any violation.
    """
    md_path = os.path.join(root, MANIFEST_FILE)
    if not os.path.exists(md_path):
        logger.warning(
            "checkpoint at %s has no %s; loading UNVERIFIED (pre-manifest "
            "checkpoint)", root, MANIFEST_FILE,
        )
        return False
    try:
        with open(md_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(f"unreadable checkpoint manifest: {e}") from e
    for rel, entry in manifest.get("files", {}).items():
        if selector is not None and not selector(rel):
            continue
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            raise CorruptCheckpointError(
                f"checkpoint file {rel} is in the manifest but missing on disk"
            )
        verify_local_file(path, entry, rel)
    return True


class StorageManager(abc.ABC):
    #: Fault-site names (fixed: FaultPlans key on them).
    SITE_UPLOAD = "storage.upload"
    SITE_DOWNLOAD = "storage.download"

    def __init__(
        self, base_path: str, retry_policy: Optional[RetryPolicy] = None
    ) -> None:
        self.base_path = base_path
        self._retry = retry_policy or STORAGE_RETRY

    # -- per-file primitives (implemented by each backend) ------------------
    @abc.abstractmethod
    def _upload_file(self, local_path: str, storage_id: str, rel: str) -> None:
        """Store one local file as `rel` inside checkpoint `storage_id`."""

    @abc.abstractmethod
    def _download_file(self, storage_id: str, rel: str, target: str) -> None:
        """Fetch `rel` of checkpoint `storage_id` into local path `target`
        (parent directory already exists)."""

    @abc.abstractmethod
    def delete(self, storage_id: str, paths: Optional[List[str]] = None) -> List[str]:
        """Delete a checkpoint (or some paths within it); return deleted rel-paths."""

    @abc.abstractmethod
    def list_files(self, storage_id: str) -> List[str]:
        """Relative paths of all files in the checkpoint."""

    # -- directory-level API -------------------------------------------------
    def upload(
        self,
        src: str,
        storage_id: str,
        paths: Optional[List[str]] = None,
        *,
        manifest: bool = True,
        want_digests: Optional[bool] = None,
    ) -> Dict[str, Dict[str, Any]]:
        """Upload directory `src` as checkpoint `storage_id` (optionally
        only `paths`). Returns {rel: {"sha256", "size"}} for the uploaded
        files.

        Data files go first; with ``manifest=True`` the manifest commits
        last. ``CheckpointContext.upload`` passes ``manifest=False,
        want_digests=True`` and commits one manifest for the data files
        and ``metadata.json`` together. ``want_digests`` defaults to
        ``manifest``.
        """
        rels = [
            r for r in (paths if paths is not None else self._list_dir(src))
            if r != MANIFEST_FILE
        ]
        want = manifest if want_digests is None else (want_digests or manifest)
        digests = (
            {rel: file_digest(os.path.join(src, rel)) for rel in rels}
            if want else {}
        )
        for rel in rels:
            self._retry.call(
                lambda rel=rel: self._upload_one(
                    os.path.join(src, rel), storage_id, rel
                ),
                key=self.SITE_UPLOAD,
            )
        if manifest:
            self.commit_manifest(storage_id, digests)
        return digests

    def _upload_one(self, local: str, storage_id: str, rel: str) -> None:
        """One upload attempt: fault injection + torn-write simulation."""
        keep = faults.torn_write(self.SITE_UPLOAD)
        if keep is not None:
            with open(local, "rb") as f:
                data = f.read()
            torn = data[: max(1, int(len(data) * keep))] if data else b""
            fd, tmp = tempfile.mkstemp(prefix="dtpu-torn-")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(torn)
                self._upload_file(tmp, storage_id, rel)
            finally:
                with contextlib.suppress(OSError):
                    os.remove(tmp)
            # The partial bytes landed, THEN the transfer died: that is a
            # torn write. The retry re-uploads in full; a process crash
            # instead leaves the tear for the manifest check.
            raise faults.InjectedFault(self.SITE_UPLOAD, "torn write")
        faults.inject(self.SITE_UPLOAD)
        self._upload_file(local, storage_id, rel)

    def commit_manifest(
        self, storage_id: str, entries: Dict[str, Dict[str, Any]]
    ) -> None:
        """Merge `entries` into the checkpoint's manifest and upload it:
        the commit point, strictly after the data files it describes."""
        merged = dict(self.read_manifest(storage_id) or {})
        merged.update(entries)
        self._write_manifest(storage_id, merged)

    def _write_manifest(
        self, storage_id: str, files: Dict[str, Dict[str, Any]]
    ) -> None:
        doc = {"version": MANIFEST_VERSION, "files": files}
        fd, tmp = tempfile.mkstemp(prefix="dtpu-manifest-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=0, sort_keys=True)
            self._retry.call(
                lambda: self._upload_one(tmp, storage_id, MANIFEST_FILE),
                key=self.SITE_UPLOAD,
            )
        finally:
            with contextlib.suppress(OSError):
                os.remove(tmp)

    def _prune_manifest(self, storage_id: str, removed: List[str]) -> None:
        """Drop `removed` rels from the manifest after a deliberate
        partial delete: stale entries would make every later restore
        refuse the checkpoint as 'missing manifest-listed files'."""
        gone = set(removed)
        if not gone or MANIFEST_FILE in gone:
            return  # whole-checkpoint (or manifest) delete: nothing to fix
        manifest = self.read_manifest(storage_id)
        if not manifest:
            return
        kept = {k: v for k, v in manifest.items() if k not in gone}
        if kept != manifest:
            self._write_manifest(storage_id, kept)

    def read_manifest(self, storage_id: str) -> Optional[Dict[str, Dict[str, Any]]]:
        """The checkpoint's {rel: digest} map, or None when uncommitted."""
        if MANIFEST_FILE not in self.list_files(storage_id):
            return None
        with tempfile.TemporaryDirectory(prefix="dtpu-mf-") as tmp:
            target = os.path.join(tmp, MANIFEST_FILE)
            try:
                self._retry.call(
                    lambda: self._download_one(storage_id, MANIFEST_FILE, target),
                    key=self.SITE_DOWNLOAD,
                )
                with open(target) as f:
                    doc = json.load(f)
            except FileNotFoundError:
                return None
            except ValueError as e:
                raise CorruptCheckpointError(
                    f"checkpoint {storage_id} manifest is unreadable: {e}"
                ) from e
        files = doc.get("files")
        return files if isinstance(files, dict) else None

    def download(
        self,
        storage_id: str,
        dst: str,
        selector: Optional[Callable[[str], bool]] = None,
        *,
        verify: bool = True,
    ) -> None:
        """Download checkpoint into `dst`; `selector` filters relative
        paths. With `verify` every downloaded file is checked against the
        manifest and every selected manifest entry must arrive, else
        CorruptCheckpointError."""
        rels = self.list_files(storage_id)
        if not rels:
            raise FileNotFoundError(
                f"checkpoint {storage_id} not found under {self.base_path}"
            )
        manifest = None
        if verify and MANIFEST_FILE in rels:
            target = os.path.join(dst, MANIFEST_FILE)
            os.makedirs(dst, exist_ok=True)
            self._retry.call(
                lambda: self._download_one(storage_id, MANIFEST_FILE, target),
                key=self.SITE_DOWNLOAD,
            )
            try:
                with open(target) as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                raise CorruptCheckpointError(
                    f"checkpoint {storage_id} manifest is unreadable: {e}"
                ) from e
            manifest = doc.get("files") if isinstance(doc, dict) else None
        elif verify:
            logger.warning(
                "checkpoint %s has no %s; downloading UNVERIFIED "
                "(pre-manifest checkpoint)", storage_id, MANIFEST_FILE,
            )
        fetched = set()
        for rel in rels:
            if rel == MANIFEST_FILE and manifest is not None:
                continue  # already fetched above
            if selector is not None and not selector(rel):
                continue
            target = os.path.join(dst, rel)
            os.makedirs(os.path.dirname(target) or dst, exist_ok=True)
            self._retry.call(
                lambda rel=rel, target=target: self._download_one(
                    storage_id, rel, target
                ),
                key=self.SITE_DOWNLOAD,
            )
            fetched.add(rel)
            if manifest is not None and rel in manifest:
                verify_local_file(target, manifest[rel], rel)
        if manifest is not None:
            missing = [
                rel for rel in manifest
                if rel not in fetched
                and (selector is None or selector(rel))
            ]
            if missing:
                raise CorruptCheckpointError(
                    f"checkpoint {storage_id} is missing manifest-listed "
                    f"files: {sorted(missing)[:5]}"
                )

    def _download_one(self, storage_id: str, rel: str, target: str) -> None:
        faults.inject(self.SITE_DOWNLOAD)
        self._download_file(storage_id, rel, target)

    @contextlib.contextmanager
    def restore_path(
        self, storage_id: str, selector: Optional[Callable[[str], bool]] = None
    ) -> Iterator[str]:
        """Yield a local directory with the (verified) checkpoint: a
        download into a temporary directory, removed afterwards (the
        shared-filesystem manager serves its directory in place)."""
        tmp = tempfile.mkdtemp(prefix="dtpu-ckpt-")
        try:
            self.download(storage_id, tmp, selector=selector)
            yield tmp
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    @staticmethod
    def _list_dir(root: str) -> List[str]:
        out = []
        for dirpath, _, filenames in os.walk(root):
            for f in filenames:
                out.append(os.path.relpath(os.path.join(dirpath, f), root))
        return sorted(out)


#: Backends of the reference that need a cloud SDK.
_CLOUD_TYPES = ("gcs", "s3", "azure")


def from_config(config: Optional[dict], base_dir: Optional[str] = None) -> StorageManager:
    """Build a manager from an expconf `checkpoint_storage` block."""
    from determined_tpu_torch.storage.shared import SharedFSStorageManager

    if not config:
        return SharedFSStorageManager(base_dir or os.path.expanduser("~/.dtpu/checkpoints"))
    typ = config.get("type", "shared_fs")
    if typ == "shared_fs":
        return SharedFSStorageManager(
            os.path.expanduser(config.get("host_path", base_dir or "~/.dtpu/checkpoints"))
        )
    if typ in _CLOUD_TYPES:
        raise NotImplementedError(
            f"checkpoint storage type {typ!r} is not ported yet: its SDK is "
            "not on the card's machine (a later slice); use shared_fs"
        )
    raise ValueError(f"unknown checkpoint storage type: {typ}")
