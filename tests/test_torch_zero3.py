"""ZeRO-3 on an fsdp axis: a 4-process port gang on the CPU (gloo) against
the JAX package and against itself.

One gang, spawned once for the file as ``test_torch_gang.py`` spawns its
own (each rank runs this file as a script, ``worker``), while the JAX
reference runs in the test process:

- ``Trainer.fit`` of a tiny GPT with ``remat=True`` (each MLP half
  rematted, so its weights are gathered inside the checkpointed region
  and again in its recompute; the attention half's, saved by autograd as
  tokens, are gathered again where the backward reads them) on
  ``data=2 × fsdp=2`` against the JAX ``Trainer`` on the same layout:
  the gang file's tolerances (loss 1e-5, grad norm 1e-4 relative, every
  leaf but the key bias within 1e-4 of its own largest magnitude).
- Between steps each rank holds its blocks and nothing whole: every
  split parameter of the model is its block's region, and the trained
  state's bytes (the model's parameters and the AdamW moments) are three
  times the blocks' bytes.
- One step's collectives with ``remat=False``: each of the 4 block
  weights of a layer and the embedding, positional table and tied head
  gathered once in the forward (11), the 9 that matmuls keep gathered
  again in the backward, 11 reduce-scatters.
- A model that does not gather at use (a two-layer MLP whose weights the
  rules split over fsdp) gets its split leaves gathered whole at the
  step's start: 3 steps at ``fsdp=4`` against the same model on one
  device (the port), 1e-5.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
STEPS = 3
KW = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
          seq_len=32, remat=True)
CLIP = 0.82
LR = 1e-3
JOIN_S = 150


def _stream(seed=7):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}


def _mlp_stream():
    rng = np.random.default_rng(5)
    while True:
        yield {"x": rng.standard_normal((8, 16)).astype(np.float32),
               "y": rng.standard_normal((8, 16)).astype(np.float32)}


def _mlp_model(device):
    """A model that does not gather at use: its two weights are split
    over fsdp by their "embed" dimension."""
    import torch

    from determined_tpu_torch.models.base import Model

    class MLP(Model):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(1)
            self.w1 = torch.nn.Parameter(
                0.3 * torch.randn(16, 32, generator=gen).to(device))
            self.w2 = torch.nn.Parameter(
                0.3 * torch.randn(32, 16, generator=gen).to(device))
            self.b = torch.nn.Parameter(torch.zeros(16, device=device))

        def logical_axes(self):
            return {"w1": ("embed", "mlp"), "w2": ("mlp", "embed"),
                    "b": ("norm",)}

        def loss(self, batch, generator=None):
            x, y = (torch.as_tensor(batch[k]) for k in ("x", "y"))
            out = torch.tanh(x @ self.w1) @ self.w2 + self.b
            loss = ((out - y) ** 2).mean()
            return loss, {"loss": loss}

    return MLP()


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_zero3.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=WORLD)
    res, arrays = {}, {}
    nested = ckpt_io.nest(dict(np.load(os.path.join(out, "params.npz"))))

    class Trial(TorchTrial):
        def __init__(self, remat=True):
            super().__init__()
            self.remat = remat

        def build_model(self, device, mesh=None):
            cfg = gpt.GPTConfig(dtype=torch.float32,
                                **dict(KW, remat=self.remat))
            return gpt.load_jax_params(
                gpt.GPT(cfg, device=device, mesh=mesh), nested)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return _stream()

    class MLPTrial(TorchTrial):
        def build_model(self, device):
            return _mlp_model(device)

        def build_optimizer(self):
            return optim.adamw(1e-2)

        def build_training_data(self):
            return _mlp_stream()

    def fit(trainer, steps):
        seen = []
        flush = trainer._flush

        def recording(pending, t_start):
            agg, reason = flush(pending, t_start)
            seen.append(agg)
            return agg, reason

        trainer._flush = recording
        trainer.fit(max_length=Batch(steps), report_period=Batch(1))
        return seen

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # -- parity at data=2 x fsdp=2, rematted, and what stays resident --------
    mesh = make_mesh(MeshConfig(data=2, fsdp=2), device="cpu")
    trainer = Trainer(Trial(), core._dummy_init(distributed=dctx),
                      device="cpu", mesh=mesh)
    res["fit"] = fit(trainer, STEPS)
    layout = trainer._layout
    res["split"] = sorted(layout.split_dims)
    res["held"] = {n: list(p.shape)
                   for n, p in trainer.model.named_parameters()}
    res["blocks"] = {n: [hi - lo for lo, hi in b.region]
                     for n, b in zip(trainer._names, layout.blocks)}
    moments = [t for s in trainer._opt_state[1][0][1:] for t in s]
    res["state_bytes"] = nbytes(trainer.model.parameters()) + nbytes(moments)
    res["block_bytes"] = 4 * sum(int(np.prod(r))
                                 for r in res["blocks"].values())
    for n, p in trainer.full_parameters().items():
        arrays[f"fit/{n}"] = p.numpy().copy()

    # -- one step's collectives, remat off -----------------------------------
    calls = {}
    real = {n: getattr(tdist, n) for n in (
        "all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")}

    def counting(name):
        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kw)
        return call

    plain = Trainer(Trial(remat=False), core._dummy_init(distributed=dctx),
                    device="cpu", mesh=mesh)
    batch = plain._put_batch(next(_stream()))
    for name in real:
        setattr(tdist, name, counting(name))
    try:
        plain._train_step(batch)
    finally:
        for name, fn in real.items():
            setattr(tdist, name, fn)
    res["collectives"] = calls

    # -- a model that does not gather at use, at fsdp=4 ----------------------
    mesh4 = make_mesh(MeshConfig(data=1, fsdp=4), device="cpu")
    mlp = Trainer(MLPTrial(), core._dummy_init(distributed=dctx),
                  device="cpu", mesh=mesh4)
    res["mlp_held"] = {n: list(p.shape) for n, p in mlp.model.named_parameters()}
    res["mlp"] = fit(mlp, STEPS)
    for n, p in mlp.full_parameters().items():
        arrays[f"mlp/{n}"] = p.numpy().copy()

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The fixture: the gang, and the references meanwhile
# ---------------------------------------------------------------------------
def _numpy_tree():
    import torch

    from determined_tpu_torch.models import gpt

    rng = np.random.default_rng(3)
    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW), device="cpu")
    return {n: ((1.0 if "scale" in n else 0.0)
                + 0.02 * rng.standard_normal(p.shape)).astype(np.float32)
            for n, p in model.named_parameters()}


def _jax_fit(tree):
    import jax
    import jax.numpy as jnp
    import optax

    from determined_tpu import core as jcore
    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.mesh import MeshConfig, make_mesh
    from determined_tpu.trainer import Batch, JAXTrial, Trainer
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    class JTrial(JAXTrial):
        def build_model(self, mesh):
            return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW), mesh=mesh)

        def build_optimizer(self):
            return optax.chain(optax.clip_by_global_norm(CLIP),
                               optax.adamw(LR))

        def build_training_data(self):
            return _stream()

    mesh = make_mesh(MeshConfig(data=2, fsdp=2), devices=jax.devices()[:WORLD])
    ctx = jcore._context._dummy_init()
    trainer = Trainer(JTrial(), ctx, mesh=mesh, seed=0)
    params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                          nest(tree), trainer._param_shardings())
    trainer._state = {"step": jnp.zeros((), jnp.int32), "params": params,
                      "opt_state": trainer._tx.init(params)}
    trainer.fit(max_length=Batch(STEPS), report_period=Batch(1))
    reports = [m for g, _, m in ctx.train._reported if g == "training"]
    got = {n: np.asarray(a) for n, a in
           _flatten(jax.device_get(trainer.state["params"]))}
    return reports, got


def _mlp_one_device():
    """The MLP's 3 steps on one device (the port, no mesh)."""
    from determined_tpu_torch import core
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim

    class MLPTrial(TorchTrial):
        def build_model(self, device):
            return _mlp_model(device)

        def build_optimizer(self):
            return optim.adamw(1e-2)

        def build_training_data(self):
            return _mlp_stream()

    ctx = core._dummy_init()
    trainer = Trainer(MLPTrial(), ctx, device="cpu")
    trainer.fit(max_length=Batch(STEPS), report_period=Batch(1))
    reports = [m for g, _, m in ctx.train._reported if g == "training"]
    return reports, {n: p.detach().numpy().copy()
                     for n, p in trainer.model.named_parameters()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero3")
    tree = _numpy_tree()
    np.savez(tmp / "params.npz", **tree)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    procs = []
    for rank in range(WORLD):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(rank), str(tmp / "store"),
             str(tmp)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        ref = _jax_fit(tree)
        mlp_ref = _mlp_one_device()
        deadline = time.time() + JOIN_S
        while time.time() < deadline:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            assert not bad, (tmp / f"rank{bad[0]}.log").read_text()[-4000:]
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"the gang did not finish in {JOIN_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
            log.close()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "mlp_ref": mlp_ref}


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
def test_rematted_gang_matches_the_jax_trainer(gang):
    want_reports, want_params = gang["ref"]
    norms = [float(m["grad_norm"]) for m in want_reports]
    assert min(norms) < CLIP < max(norms), norms  # the clip engaged once
    for r, (res, arrays) in enumerate(gang["ranks"]):
        assert len(res["fit"]) == STEPS
        for step, (g, w) in enumerate(zip(res["fit"], want_reports), 1):
            np.testing.assert_allclose(g["loss"], float(w["loss"]),
                                       rtol=1e-5, err_msg=f"{r} @ {step}")
            np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]),
                                       rtol=1e-4, err_msg=f"{r} @ {step}")
        for name, want in want_params.items():
            got = arrays[f"fit/{name}"]
            scale = float(np.abs(want).max())
            if name == "blocks.bqkv":  # the key bias (test_torch_gang.py)
                got, want = np.delete(got, 1, axis=1), np.delete(want, 1, axis=1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"rank {r} {name}")


def test_between_steps_a_rank_holds_its_blocks_alone(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        assert res["split"] == [
            "blocks.wi", "blocks.wo", "blocks.wo_mlp", "blocks.wqkv",
            "pos_embed", "tok_embed"], r
        assert res["held"] == res["blocks"], r
        for name in res["split"]:
            assert res["held"][name] != KW_SHAPES[name], (r, name)
        # master, mu and nu: 12 bytes a parameter of the blocks
        assert res["state_bytes"] == 3 * res["block_bytes"], r


KW_SHAPES = {"blocks.wi": [2, 64, 128], "blocks.wo": [2, 4, 16, 64],
             "blocks.wo_mlp": [2, 128, 64], "blocks.wqkv": [2, 64, 3, 4, 16],
             "pos_embed": [32, 64], "tok_embed": [128, 64]}


def test_gathered_weights_are_gathered_again_in_the_backward(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        assert res["collectives"] == {
            # 2 layers x 4 weights, the embedding, the positional table and
            # the tied head in the forward; the 8 matmul weights and the
            # head again where the backward reads them
            "all_gather_into_tensor": 11 + 9,
            "reduce_scatter_tensor": 11,
            # the token count; each of the 6 split blocks' gradient over
            # data; the whole leaves' flat buffer; the norm's fsdp part
            # (the trainer's norm and the clip's); the metrics
            "all_reduce": 1 + 6 + 1 + 2 + 1}, r


def test_a_model_that_does_not_gather_at_use_matches_one_device(gang):
    want_reports, want_params = gang["mlp_ref"]
    for r, (res, arrays) in enumerate(gang["ranks"]):
        assert res["mlp_held"] == {"w1": [4, 32], "w2": [32, 4], "b": [16]}
        for step, (g, w) in enumerate(zip(res["mlp"], want_reports), 1):
            np.testing.assert_allclose(g["loss"], float(w["loss"]),
                                       rtol=1e-5, err_msg=f"{r} @ {step}")
        for name, want in want_params.items():
            np.testing.assert_allclose(arrays[f"mlp/{name}"], want,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {name}")


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
