"""HuggingFace integration: transformers models as platform trials (port
of ``determined_tpu/integrations/hf.py``).

The reference wraps transformers' Flax causal LMs and sequence
classifiers; the port wraps their PyTorch classes, under the reference's
class names so the examples' entrypoints map one to one. Each model is
built from a config (``AutoConfig.for_model(model_type, **overrides)``,
then ``from_config``: random init, offline). ``transformers`` is imported
inside the constructors, never when this module is imported.

The transformers module's children are registered under the wrapper, so
its parameters keep transformers' torch names (``transformer.wte.weight``)
and the Trainer's checkpoints are written under them; those do not
interchange with the reference's Flax-named ones. ``load_flax_params``
carries a reference Flax tree across by name and layout.

transformers' torch embeddings keep a padding row out of training
(``padding_idx``: BERT's pad token); the Flax ones the reference runs do
not, so the port drops it and the pad token's row trains as there.

``dtype`` is the compute type: parameters stay fp32 and, below fp32, the
forward runs under ``torch.autocast`` (the Flax modules' ``dtype`` over
fp32 params). The losses are taken in fp32.

hparams (via HFTrial):
  hf_model_type: "gpt2" | "opt" | ... (transformers model_type)
  hf_config:     dict of config overrides (n_layer, n_embd, ...)
  lr:            adamw learning rate
  batch_size / seq_len: synthetic-data shape (or use your own trial)
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.integrations.haiku import annotate
from determined_tpu_torch.models.base import Metrics, Model, _flatten, load_params
from determined_tpu_torch.trainer import TorchTrial, optim

Device = Optional[Union[str, torch.device]]


@contextlib.contextmanager
def _mode(module: nn.Module, training: bool) -> Iterator[None]:
    """`module` in train (dropout on) or eval mode, restored after."""
    was = module.training
    module.train(training)
    try:
        yield
    finally:
        module.train(was)


def _linear_like(module: nn.Module) -> bool:
    """A weight the Flax model holds transposed: ``nn.Linear`` ([out, in]
    here, a Flax ``Dense`` kernel is [in, out]) and transformers'
    ``Conv1D`` ([in, out] here, GPT-2's Flax kernels are [out, in])."""
    return isinstance(module, nn.Linear) or type(module).__name__ == "Conv1D"


class _HFModel(Model):
    """The shared wrapper: one transformers module, its children ours."""

    def __init__(self, hf: nn.Module, config: Any, dtype: torch.dtype,
                 mesh: Any, device: Device) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.mesh = mesh
        hf.to(dev)
        for module in hf.modules():
            if isinstance(module, nn.Embedding):
                # the Flax embeddings have no padding row: the pad token's
                # row trains there (BERT's pad_token_id 0 among them)
                module.padding_idx = None
        for name, child in hf.named_children():
            self.add_module(name, child)
        object.__setattr__(self, "_hf", hf)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _flax_layout(self) -> Dict[str, Tuple[str, bool]]:
        """{torch parameter name: (the reference's Flax path, whether the
        Flax leaf is this one transposed)}."""
        out = {}
        for mod_name, module in self.named_modules():
            for leaf, _ in module.named_parameters(recurse=False):
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                path, flip = name, False
                if leaf == "weight":
                    if isinstance(module, nn.Embedding):
                        path = f"{mod_name}.embedding"
                    elif isinstance(module, nn.LayerNorm):
                        path = f"{mod_name}.scale"
                    elif _linear_like(module):
                        path, flip = f"{mod_name}.kernel", True
                out[name] = (path, flip)
        # named_parameters names a tied weight once (GPT-2's lm_head is
        # wte, and the Flax tree has no leaf for it)
        return {n: out[n] for n, _ in self.named_parameters()}

    def logical_axes(self) -> Dict[str, Any]:
        """The reference's default FSDP annotation: each ≥2-D weight's
        largest dimension is "embed", unless the fsdp axis does not
        divide it (vocab 50257 stays replicated); taken on the Flax
        layout, so a transposed leaf names the same dimension."""
        fsdp = 1
        if self.mesh is not None:
            from determined_tpu_torch.parallel.mesh import _axis

            fsdp = _axis(self.mesh, "fsdp")
        layout = self._flax_layout()
        out: Dict[str, Any] = {}
        for name, p in self.named_parameters():
            shape = tuple(p.shape)
            largest = None
            if layout[name][1] and p.dim() == 2:
                # np.argmax over the Flax shape (shape reversed)
                largest = 1 - int(np.argmax(shape[::-1]))
            *parents, leaf = name.split(".")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = annotate(shape, fsdp, largest)
        return out

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits with dropout off (the reference's ``train=False``)."""
        with _mode(self._hf, False):
            return self._logits(tokens)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=self.dtype,
                              enabled=self.dtype != torch.float32)

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        hf = self._hf
        tied = None
        if getattr(self.config, "tie_word_embeddings", False):
            head = hf.get_output_embeddings()
            if head is not None:
                # a gathered embedding (fsdp) feeds the tied head too
                tied = head._parameters["weight"]
                head._parameters["weight"] = \
                    hf.get_input_embeddings()._parameters["weight"]
        try:
            with self._autocast():
                return hf(input_ids=tokens.long()).logits
        finally:
            if tied is not None:
                head._parameters["weight"] = tied


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> Metrics:
    logits = logits.float()
    targets = targets.long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None]).squeeze(-1)
    loss = (lse - tgt).mean()
    acc = (logits.argmax(-1) == targets).float().mean()
    return {"loss": loss, "accuracy": acc}


class HFFlaxModel(_HFModel):
    """A transformers causal LM (``AutoModelForCausalLM``) as a platform
    Model. Batches: {"tokens": int [B, S]}; next-token loss."""

    def __init__(
        self,
        model_type: str = "gpt2",
        config_overrides: Optional[Dict[str, Any]] = None,
        dtype: torch.dtype = torch.bfloat16,
        mesh: Any = None,
        device: Device = None,
    ) -> None:
        from transformers import AutoConfig, AutoModelForCausalLM

        config = AutoConfig.for_model(model_type, **(config_overrides or {}))
        super().__init__(AutoModelForCausalLM.from_config(config), config,
                         dtype, mesh, device)

    def loss(self, batch, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        del generator
        tokens = batch["tokens"]
        logits = self.apply(tokens).float()[:, :-1]
        metrics = _xent(logits, tokens[:, 1:])
        return metrics["loss"], metrics


class HFFlaxClassifier(_HFModel):
    """A transformers sequence classifier
    (``AutoModelForSequenceClassification``) as a platform Model.
    Batches: {"tokens": int [B, S], "label": int [B]}. ``loss`` runs with
    dropout on, drawn from the Trainer's per-step generator;
    ``eval_metrics`` with dropout off."""

    def __init__(
        self,
        model_type: str = "bert",
        config_overrides: Optional[Dict[str, Any]] = None,
        num_labels: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        mesh: Any = None,
        device: Device = None,
    ) -> None:
        from transformers import (
            AutoConfig,
            AutoModelForSequenceClassification,
        )

        config = AutoConfig.for_model(
            model_type, num_labels=num_labels, **(config_overrides or {}))
        super().__init__(
            AutoModelForSequenceClassification.from_config(config), config,
            dtype, mesh, device)

    @staticmethod
    def _metrics(logits: torch.Tensor, labels: torch.Tensor) -> Metrics:
        """Shared train/eval metric math: the fp32 logsumexp loss and the
        accuracy."""
        return _xent(logits, labels)

    def loss(self, batch, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        dev = self.device
        with contextlib.ExitStack() as stack:
            if generator is not None:
                # dropout's draws: a function of the Trainer's step seed
                seed = int(torch.randint(0, 2 ** 62, (1,), device=dev,
                                         generator=generator))
                stack.enter_context(torch.random.fork_rng(
                    devices=[dev] if dev.type == "cuda" else []))
                torch.manual_seed(seed)
            stack.enter_context(_mode(self._hf, True))
            logits = self._logits(batch["tokens"])
        metrics = self._metrics(logits, batch["label"])
        return metrics["loss"], metrics

    def eval_metrics(self, batch) -> Metrics:
        return self._metrics(self.apply(batch["tokens"]), batch["label"])


def load_flax_params(model: _HFModel, tree: Dict[str, Any]) -> _HFModel:
    """Fill `model` from a reference Flax parameter tree (nested dicts of
    numpy arrays): ``embedding`` and ``scale`` become ``weight``, and a
    ``kernel`` is transposed into its torch layout (``_linear_like``).
    Keys and shapes are checked before anything is written."""
    flat = dict(_flatten(tree))
    layout = model._flax_layout()
    mapped = {}
    for name, (path, flip) in layout.items():
        if path not in flat:
            raise KeyError(f"Flax tree has no {path!r} for {name!r}")
        arr = np.asarray(flat[path], dtype=np.float32)
        mapped[name] = np.ascontiguousarray(arr.T) if flip else arr
    unused = sorted(set(flat) - {p for p, _ in layout.values()})
    if unused:
        raise KeyError(f"Flax tree leaves with no parameter: {unused}")
    nested: Dict[str, Any] = {}
    for name, arr in mapped.items():
        *parents, leaf = name.split(".")
        node = nested
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    load_params(model, nested)
    return model


class HFClassifierTrial(TorchTrial):
    """BERT-class fine-tuning trial (the reference's synthetic separable
    stream by default; point ``build_training_data`` at a tokenized
    dataset for real work).

    hparams: hf_model_type ("bert"), hf_config overrides, num_labels,
    batch_size, seq_len, lr.
    """

    def build_model(self, device, mesh=None) -> HFFlaxClassifier:
        return HFFlaxClassifier(
            model_type=self.hparams.get("hf_model_type", "bert"),
            config_overrides=self.hparams.get("hf_config", {}),
            num_labels=int(self.hparams.get("num_labels", 2)),
            mesh=mesh, device=device,
        )

    def build_optimizer(self):
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(float(self.hparams.get("lr", 5e-5))),
        )

    def _stream(self, seed: int):
        b = int(self.hparams.get("batch_size", 8))
        s = int(self.hparams.get("seq_len", 64))
        vocab = int(self.hparams.get("hf_config", {}).get("vocab_size", 1024))
        n_labels = int(self.hparams.get("num_labels", 2))
        rng = np.random.default_rng(seed)

        def gen():
            while True:
                label = rng.integers(0, n_labels, (b,)).astype(np.int32)
                toks = rng.integers(2, vocab, (b, s)).astype(np.int32)
                # the learnable signal: the first token encodes the class
                toks[:, 0] = 2 + (label % max(1, vocab - 2))
                yield {"tokens": toks, "label": label}

        return gen()

    def build_training_data(self):
        return self._stream(seed=0)

    def build_validation_data(self):
        it = iter(self._stream(seed=1))
        return [next(it) for _ in range(2)]


class HFTrial(TorchTrial):
    """Plug-and-play trial for HF causal LMs on synthetic or token-shard
    data."""

    def build_model(self, device, mesh=None) -> HFFlaxModel:
        return HFFlaxModel(
            model_type=self.hparams.get("hf_model_type", "gpt2"),
            config_overrides=self.hparams.get("hf_config", {}),
            mesh=mesh, device=device,
        )

    def build_optimizer(self):
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(float(self.hparams.get("lr", 3e-4))),
        )

    def _vocab(self) -> int:
        return int(self.hparams.get("hf_config", {}).get("vocab_size", 50257))

    def _shape(self) -> Tuple[int, int]:
        return (
            int(self.hparams.get("batch_size", 8)),
            int(self.hparams.get("seq_len", 128)),
        )

    def _dataset(self, seed: int):
        from determined_tpu_torch.data import lm_dataset

        b, s = self._shape()
        return lm_dataset(
            self.hparams.get("token_shards"), b, s, self._vocab(), seed=seed
        )

    def build_training_data(self) -> Iterator[Dict[str, Any]]:
        return self._dataset(seed=0)

    def build_validation_data(self):
        # Same source as training (held-out seed).
        it = iter(self._dataset(seed=1))
        return [next(it) for _ in range(2)]
