"""Models of the port: GPT (serving and training)."""
from determined_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    load_jax_params,
)
