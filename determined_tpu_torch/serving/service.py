"""Building a generation engine from a config's `serving:` section.

Port of ``determined_tpu/serving/service.py:build_engine``: the model
table (``tiny``, ``small``, ``medium`` and the pre-trained ``fixture``),
weights from ``DTPU_SERVING_CHECKPOINT`` (a manifest-verified checkpoint
directory in ``save_pytree``'s layout, as the reference reads it) or a
seeded random init. The HTTP surface (``GenerationServer``) and the task
entry point arrive with the next serving slice.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional, Union

import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models import gpt as gpt_mod
from determined_tpu_torch.serving.config import ServingConfig
from determined_tpu_torch.serving.engine import GenerationEngine
from determined_tpu_torch.serving.fixture import fixture_model_config
from determined_tpu_torch.storage.base import verify_checkpoint_dir
from determined_tpu_torch.trainer import _checkpoint as ckpt_io

logger = logging.getLogger("determined_tpu_torch.serving")

_MODEL_CONFIGS = {
    "tiny": gpt_mod.tiny, "small": gpt_mod.small, "medium": gpt_mod.medium,
    "fixture": fixture_model_config,
}


def build_engine(serving_cfg: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0) -> GenerationEngine:
    """Model + engine from a config's `serving:` section. Weights come
    from DTPU_SERVING_CHECKPOINT when it is set, else from a seeded
    random init (``seed``). Runs on CUDA unless the caller passes
    ``device="cpu"``."""
    cfg = ServingConfig.from_dict(serving_cfg or {})
    dev = resolve_device(device)
    model = gpt_mod.GPT(_MODEL_CONFIGS[cfg.model](), device=dev, seed=seed)
    if cfg.prefill_seq > model.config.seq_len:
        # A small model with the default prefill geometry must come up
        # serving (shorter prompts), not refuse to start.
        cfg = dataclasses.replace(cfg, prefill_seq=model.config.seq_len)
    params = None
    ckpt_dir = os.environ.get("DTPU_SERVING_CHECKPOINT", "")
    if ckpt_dir:
        # Verification BEFORE the weights go live: a torn or bit-flipped
        # checkpoint is a named refusal at startup (CorruptCheckpointError).
        # The names are the parameter tree's own (`blocks__wqkv`), as
        # save_pytree(params) writes them.
        verify_checkpoint_dir(ckpt_dir)
        params = ckpt_io.load_pytree(
            ckpt_dir, ckpt_io.nest(dict(model.named_parameters())))
        logger.info("serving params restored from %s", ckpt_dir)
    return GenerationEngine(model, params, cfg, device=dev)
