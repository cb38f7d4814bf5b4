"""Deterministic pre-trained fixture checkpoint for serving.

Port of ``determined_tpu/serving/fixture.py``. A tiny GPT is pre-trained
on a deterministic phrase corpus with heavy n-gram repetition, saved
through the checkpoint chain real experiments use
(``trainer._checkpoint.save_pytree``, then a ``manifest.json`` committed
LAST, verified with ``storage.base.verify_checkpoint_dir`` on every load),
and cached on disk keyed by a content fingerprint of everything that
shaped it. A random model's greedy continuation correlates with nothing;
this one continues each phrase of the corpus, which is what speculative
decoding needs to show any acceptance.

The fingerprint, the corpus, the recipe and the on-disk names are the
reference's, so both packages share one cache directory and either loads
the other's fixture. The port draws its initial parameters from torch's
generator (the reference from ``jax.random``), so a fixture trained by
one package is not bitwise the other's; both learn the same cycles.

Train once, reuse (on the card unless ``device="cpu"``)::

    python -m determined_tpu_torch.serving.fixture          # prints the path
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models import gpt as gpt_mod
from determined_tpu_torch.storage.base import (
    MANIFEST_FILE,
    MANIFEST_VERSION,
    CorruptCheckpointError,
    file_digest,
    verify_checkpoint_dir,
)
from determined_tpu_torch.trainer import _checkpoint as ckpt_io
from determined_tpu_torch.trainer import optim

logger = logging.getLogger("determined_tpu_torch.serving")

#: Bump to invalidate every cached fixture (training recipe changes).
FIXTURE_VERSION = 2

#: Corpus shape: phrases long enough that a short n-gram anchors a unique
#: continuation, short enough that prompts stay inside a small prefill.
CORPUS_SEED = 7
N_PHRASES = 12
PHRASE_LEN = 10

#: Training recipe (fingerprinted: change these, get a new cache dir).
TRAIN_SEED = 0
TRAIN_STEPS = 300
TRAIN_BATCH = 8
TRAIN_LR = 3e-3
TRAIN_SEQ = 64


def fixture_phrases(
    *, vocab: int = 1024, n_phrases: int = N_PHRASES,
    phrase_len: int = PHRASE_LEN, seed: int = CORPUS_SEED,
) -> List[List[int]]:
    """The deterministic phrase corpus. Token ids stay in [1, vocab)
    (0 is conventionally padding) and each phrase is distinct, so a
    trailing n-gram of one phrase pins its continuation."""
    rng = np.random.default_rng(seed)
    phrases = []
    seen = set()
    while len(phrases) < n_phrases:
        p = rng.integers(1, vocab, size=phrase_len).tolist()
        key = tuple(p[:2])
        if key in seen:  # distinct leading bigrams keep lookups unambiguous
            continue
        seen.add(key)
        phrases.append([int(t) for t in p])
    return phrases


def fixture_model_config() -> gpt_mod.GPTConfig:
    """The fixture's geometry, fp32 so greedy argmax tie-breaks the same
    everywhere."""
    return gpt_mod.GPTConfig(
        vocab_size=1024, n_layers=2, n_heads=4, d_model=128, d_ff=512,
        seq_len=256, remat=False, dtype=torch.float32,
    )


def _fingerprint() -> str:
    spec = {
        "version": FIXTURE_VERSION,
        "corpus": [CORPUS_SEED, N_PHRASES, PHRASE_LEN],
        "train": [TRAIN_SEED, TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR],
        "model": [1024, 2, 4, 128, 512, 256, "float32"],
    }
    digest = hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()
    ).hexdigest()
    return digest[:12]


def default_cache_dir() -> str:
    base = os.environ.get("DTPU_FIXTURE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "determined_tpu", "fixtures"
    )
    return os.path.join(base, f"serving-spec-{_fingerprint()}")


def _corpus_batch(rng: np.random.Generator, phrases, batch: int, seq: int):
    """Training rows: ONE phrase tiled per row (random rotation). Every
    transition, the wrap from a phrase's last token back to its first
    included, is deterministic, so the trained model's greedy decode
    cycles a phrase indefinitely."""
    rows = np.zeros((batch, seq), np.int32)
    for b in range(batch):
        p = phrases[int(rng.integers(len(phrases)))]
        rot = int(rng.integers(len(p)))
        toks = (p[rot:] + p[:rot]) * (seq // len(p) + 2)
        rows[b] = toks[:seq]
    return rows


def _params(model: gpt_mod.GPT) -> Dict[str, Any]:
    """The model's parameters as the reference's nested tree."""
    return ckpt_io.nest(dict(model.named_parameters()))


def _fit(model: gpt_mod.GPT, steps: int) -> float:
    """The reference's recipe on `model`'s parameters, in place:
    ``optax.adam(TRAIN_LR)`` on ``model.loss`` over seeded corpus
    batches. Returns the last step's loss."""
    params = list(model.parameters())
    tx = optim.adam(TRAIN_LR)
    state = tx.init([p.detach() for p in params])
    phrases = fixture_phrases()
    rng = np.random.default_rng(TRAIN_SEED)
    loss = torch.full((), float("nan"))
    for _ in range(steps):
        tokens = torch.from_numpy(
            _corpus_batch(rng, phrases, TRAIN_BATCH, TRAIN_SEQ)
        ).to(model.device)
        loss, _metrics = model.loss({"tokens": tokens})
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            updates, state = tx.update(list(grads), state,
                                       [p.detach() for p in params])
            for p, u in zip(params, updates):
                p.add_(u)
    final = float(loss.detach())
    logger.info("serving fixture trained: %d steps, final loss %.3f",
                steps, final)
    return final


def train_fixture(
    steps: int = TRAIN_STEPS,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[gpt_mod.GPT, Dict[str, Any]]:
    """Pre-train the fixture model on the phrase corpus; returns
    (model, params), params being the model's own parameters as the
    reference's nested tree. On the card unless ``device="cpu"``."""
    model = gpt_mod.GPT(fixture_model_config(), device=resolve_device(device),
                        seed=TRAIN_SEED)
    _fit(model, steps)
    return model, _params(model)


def ensure_fixture(
    cache_dir: Optional[str] = None, *, steps: int = TRAIN_STEPS,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[gpt_mod.GPT, Dict[str, Any], str]:
    """Load the fixture checkpoint, training and saving it first when the
    cache is cold. Returns (model, params, checkpoint_dir).

    On disk: leaf files via ``save_pytree``, then ``manifest.json``
    (sha256 + size per file) written LAST through ``os.replace``: the
    commit point. Every load verifies the manifest; a corrupt or torn
    cache entry is named, discarded, and retrained rather than served.
    """
    dev = resolve_device(device)
    path = cache_dir or default_cache_dir()
    model = gpt_mod.GPT(fixture_model_config(), device=dev, seed=TRAIN_SEED)
    if os.path.exists(os.path.join(path, MANIFEST_FILE)):
        try:
            verify_checkpoint_dir(path)
            gpt_mod.load_jax_params(
                model, ckpt_io.load_pytree(path, _params(model)))
            return model, _params(model), path
        except CorruptCheckpointError as e:
            logger.warning(
                "serving fixture cache at %s failed verification (%s); "
                "retraining", path, e,
            )
            shutil.rmtree(path, ignore_errors=True)
    _fit(model, steps)
    params = _params(model)
    os.makedirs(path, exist_ok=True)
    written = ckpt_io.save_pytree(params, path)  # relative leaf-file names
    files = {
        rel: file_digest(os.path.join(path, rel)) for rel in written
    }
    # Manifest LAST: its presence IS the commit point; a crash between
    # save_pytree and here leaves a directory the next load retrains.
    tmp = os.path.join(path, MANIFEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": MANIFEST_VERSION, "files": files}, f,
                  indent=0, sort_keys=True)
    os.replace(tmp, os.path.join(path, MANIFEST_FILE))
    return model, params, path


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    _model, _params_tree, path = ensure_fixture()
    print(path)  # the path is the command's output
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
