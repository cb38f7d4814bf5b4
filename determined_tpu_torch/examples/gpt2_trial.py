"""GPT-2 pretraining trial: the flagship recipe (port of
``examples/gpt2_trial.py``).

The GPT of ``model_config`` (``GPTConfig`` fields) over token shards
(``token_shards``: glob patterns of ``data.write_token_shard`` files, read
by the native loader), or a seeded synthetic stream without them; AdamW
with b2 0.95 and weight decay 0.1 after a global-norm clip of 1.0, on a
warmup + cosine schedule when ``warmup_steps`` is set. Entrypoint:
``determined_tpu_torch.examples.gpt2_trial:GPT2PretrainTrial``.

The global batch is ``microbatch`` × the mesh's batch-sharding degree
(data × fsdp, as the reference's trial: the ranks of a tensor group take
the same rows; 1 without a mesh) when ``microbatch`` is set, else
``batch_size``. ``sequence_layout="zigzag"`` (ring attention over a
sharded context axis) asks the loader for ``zigzag_ring`` = the mesh's
context size: pre-shifted batches in zigzag order.
"""
from __future__ import annotations

import torch

from determined_tpu_torch.data import lm_dataset
from determined_tpu_torch.models.gpt import GPT, GPTConfig
from determined_tpu_torch.trainer import TorchTrial, optim


class GPT2PretrainTrial(TorchTrial):
    def _config(self) -> GPTConfig:
        return GPTConfig(**self.hparams.get("model_config", {}))

    def build_model(self, device, mesh=None):
        self._mesh = mesh
        # the trial seed: Trainer seeds torch just before build_model
        return GPT(self._config(), device, seed=torch.initial_seed(),
                   mesh=mesh)

    def build_optimizer(self):
        lr = float(self.hparams.get("lr", 3e-4))
        warmup = int(self.hparams.get("warmup_steps", 0))
        if warmup:
            schedule = optim.warmup_cosine_decay_schedule(
                0.0, lr, warmup,
                int(self.hparams.get("decay_steps", 100_000)),
                end_value=lr * 0.1,
            )
        else:
            schedule = lr
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(schedule, b2=0.95, weight_decay=0.1),
        )

    def _dataset(self, seed: int):
        from determined_tpu_torch.parallel.mesh import (
            context_size,
            data_parallel_size,
        )

        cfg = self._config()
        mesh = getattr(self, "_mesh", None)
        # Zigzag layout: the ring size is derived from the mesh's context
        # axis — a configured value could silently mismatch the mesh.
        ring = 0
        if cfg.sequence_layout == "zigzag":
            ring = context_size(mesh) if mesh is not None else 1
            if ring <= 1:
                raise ValueError(
                    "sequence_layout='zigzag' needs a sharded context axis "
                    "(build_model on a mesh with context > 1 first)")
        # the global batch is microbatch × the batch-sharding degree
        if self.hparams.get("microbatch"):
            deg = data_parallel_size(mesh) if mesh is not None else 1
            batch = int(self.hparams["microbatch"]) * deg
        else:
            batch = int(self.hparams.get("batch_size", 8))
        return lm_dataset(
            self.hparams.get("token_shards", []),
            batch,
            cfg.seq_len,
            cfg.vocab_size,
            seed=seed,
            zigzag_ring=ring,
        )

    def build_training_data(self):
        return self._dataset(seed=0)

    def build_validation_data(self):
        it = iter(self._dataset(seed=1))
        return [next(it) for _ in range(4)]
