"""Building a generation engine from a config's `serving:` section.

Port of ``determined_tpu/serving/service.py:build_engine``. The HTTP
surface (``GenerationServer``) and the task entry point arrive with the
next serving slice; checkpoint loading (``DTPU_SERVING_CHECKPOINT``) and
the pre-trained ``fixture`` model with the checkpoint-interchange slice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Union

import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models import gpt as gpt_mod
from determined_tpu_torch.serving.config import ServingConfig
from determined_tpu_torch.serving.engine import (
    GenerationEngine,
    UnsupportedServingFeature,
)

_MODEL_CONFIGS = {
    "tiny": gpt_mod.tiny, "small": gpt_mod.small, "medium": gpt_mod.medium,
}


def build_engine(serving_cfg: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0) -> GenerationEngine:
    """Model + engine from a config's `serving:` section, with weights
    drawn from a seeded random init (``seed``). Runs on CUDA unless the
    caller passes ``device="cpu"``."""
    cfg = ServingConfig.from_dict(serving_cfg or {})
    if cfg.model not in _MODEL_CONFIGS:
        raise UnsupportedServingFeature(
            f"serving.model {cfg.model!r} needs checkpoint loading, which is "
            "not ported yet (checkpoint-interchange slice)"
        )
    if os.environ.get("DTPU_SERVING_CHECKPOINT", ""):
        raise UnsupportedServingFeature(
            "DTPU_SERVING_CHECKPOINT is set, but checkpoint loading is not "
            "ported yet (checkpoint-interchange slice); unset it to serve a "
            "seeded random init"
        )
    dev = resolve_device(device)
    model = gpt_mod.GPT(_MODEL_CONFIGS[cfg.model](), device=dev, seed=seed)
    if cfg.prefill_seq > model.config.seq_len:
        # A small model with the default prefill geometry must come up
        # serving (shorter prompts), not refuse to start.
        cfg = dataclasses.replace(cfg, prefill_seq=model.config.seq_len)
    return GenerationEngine(model, None, cfg, device=dev)
