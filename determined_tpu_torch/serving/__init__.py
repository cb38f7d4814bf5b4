"""Serving: the continuous-batching generation service of the port.

- ``config``      — validated serving knobs (copied from the reference);
- ``kv_cache``    — the page pool's free list and the radix-tree prefix
  cache over it;
- ``speculation`` — the prompt-lookup draft proposer;
- ``engine``      — iteration-level continuous batching over packed
  prefill (and the cached-tail prefill of prefix-cache hits) and paged
  decode (and the speculative verify), with SLO-aware admission and load
  shedding;
- ``service``     — ``build_engine`` (weights from a checkpoint with
  ``DTPU_SERVING_CHECKPOINT``), the HTTP surface ``GenerationServer`` and
  the off-cluster entry point ``main``;
- ``loadgen``     — the load generator (streaming clients, TTFT and
  tokens/s);
- ``fixture``     — the pre-trained ``fixture`` model's checkpoint
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
    PrefixCache,
)

_SERVICE_NAMES = ("GenerationServer", "build_engine")


def __getattr__(name):
    # The service's names load on first use, so that ``python -m
    # determined_tpu_torch.serving.service`` runs a module the package
    # has not imported already.
    if name in _SERVICE_NAMES:
        from determined_tpu_torch.serving import service

        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
