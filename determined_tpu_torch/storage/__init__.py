"""Checkpoint storage managers of the port (copy of
``determined_tpu/storage``): the shared-filesystem manager and the
manifest integrity layer."""
from determined_tpu_torch.storage.base import (
    CorruptCheckpointError,
    StorageManager,
    from_config,
    verify_checkpoint_dir,
)
from determined_tpu_torch.storage.shared import SharedFSStorageManager

__all__ = [
    "CorruptCheckpointError",
    "StorageManager",
    "SharedFSStorageManager",
    "from_config",
    "verify_checkpoint_dir",
]
