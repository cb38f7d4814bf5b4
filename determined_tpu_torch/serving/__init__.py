"""Serving: the continuous-batching generation engine of the port.

- ``config``    — validated serving knobs (copied from the reference);
- ``kv_cache``  — the page pool's host-side free list;
- ``engine``    — iteration-level continuous batching over packed prefill
  and paged decode, with SLO-aware admission and load shedding;
- ``service``   — ``build_engine`` from a config's `serving:` section,
  with weights from a checkpoint (``DTPU_SERVING_CHECKPOINT``);
- ``fixture``   — the pre-trained ``fixture`` model's checkpoint
  (``ensure_fixture``).
"""
from determined_tpu_torch.serving.config import ServingConfig  # noqa: F401
from determined_tpu_torch.serving.engine import (  # noqa: F401
    GenerationEngine,
    PromptTooLong,
    Shed,
    UnsupportedServingFeature,
)
from determined_tpu_torch.serving.kv_cache import (  # noqa: F401
    PagePool,
    PoolExhausted,
)
from determined_tpu_torch.serving.service import build_engine  # noqa: F401
