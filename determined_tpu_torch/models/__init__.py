"""Models of the port (the serving slice: GPT)."""
from determined_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    load_jax_params,
)
