"""Data layer of the port: the native (C++) token loader + shard tooling
(port of ``determined_tpu/data``).

See ``native/dataloader.cpp`` (prefetch engine), ``native.py`` (its
ctypes binding) and ``tokens.py`` (format + python fallback +
TokenDataset iterator).
"""
from determined_tpu_torch.data.tokens import (
    TokenDataset,
    expand_shards,
    lm_dataset,
    write_token_shard,
    zigzag_batch,
)

__all__ = ["TokenDataset", "expand_shards", "lm_dataset", "write_token_shard",
           "zigzag_batch"]
