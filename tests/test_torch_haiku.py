"""The haiku slot (``integrations/haiku.py``) and the DARTS benchmark trial
(``examples/darts_benchmark_trial.py``) against the reference's haiku
models.

Each net is built by both packages; the reference's haiku parameters
(``init``) are carried into the port by ``load_jax_params`` (the same
names and layouts, keys and shapes checked), then on one batch: the
logits within 1e-5 of the largest, the masked loss and accuracy within
1e-5, and one step's gradient within 1e-4 of each leaf's largest
magnitude (all fp32). ``logical_axes`` equal leaf for leaf at ``fsdp`` 1
and 8. ``HaikuVisionTrial`` beats chance after a short CPU fit, and a
2-process ``fsdp=2`` gang of the conv trial (each rank runs this file as
a script, ``worker``) trains the one-process port's losses within 1e-5.
"""
import json
import os
import random
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 150
GANG_STEPS = 4
#: the gang's trial: the conv net on the reference test's stream, cut to
#: 8 × 8 images
GANG_HP = {"arch": "conv", "channels": 8, "depth": 2, "batch_size": 16,
           "image_size": 8, "num_classes": 4, "lr": 3e-3}
OPS = ("conv3", "conv5", "maxpool", "avgpool", "skip")
#: the nets compared (``_nets``): the conv net, the mlp, a DARTS cell with
#: one op on all three edges for each op, and a mixed cell
NETS = ["conv", "mlp", *(f"darts-{op}" for op in OPS), "darts-mixed"]


def _nets(name):
    sys.path.insert(0, str(ROOT))
    from determined_tpu.integrations import haiku as ref
    from determined_tpu_torch.examples import darts_benchmark_trial as pdarts
    from determined_tpu_torch.integrations import haiku as port
    from examples import darts_benchmark_trial as rdarts

    if name == "conv":
        return ref._conv_net(8, 2, 4), port._conv_net(8, 2, 4)
    if name == "mlp":
        return ref._mlp_mixer_ish(12, 2, 4), port._mlp_mixer_ish(12, 2, 4)
    if name == "darts-mixed":
        g = {"op_0": "conv5", "op_1": "avgpool", "op_2": "conv3"}
    else:
        op = name.split("-", 1)[1]
        g = {"op_0": op, "op_1": op, "op_2": op}
    return rdarts.cell_forward(g, 8, 4), pdarts.cell_forward(g, 8, 4)


def _batch():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 4, (6,)).astype(np.int32)
    x = (rng.normal(0.0, 1.0, (6, 8, 8, 3))
         + y[:, None, None, None] * 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    return {"x": x, "y": y, "loss_mask": mask}


@pytest.fixture(scope="module")
def pairs():
    """Every net of ``NETS`` in both packages, the port holding the
    reference's parameters, and the reference's logits, loss, metrics and
    gradient on ``_batch`` (one JAX run per net)."""
    import jax

    from determined_tpu.integrations.haiku import HaikuModel as RefModel
    from determined_tpu_torch.integrations.haiku import (
        HaikuModel,
        load_jax_params,
    )

    batch = _batch()
    out = {}
    for name in NETS:
        ref_fwd, module = _nets(name)
        ref = RefModel(ref_fwd, example_input=batch["x"][:1])
        params = ref.init(jax.random.PRNGKey(3))
        port = load_jax_params(
            HaikuModel(module, batch["x"][:1], device="cpu"),
            jax.device_get(params))
        rng = jax.random.PRNGKey(0)
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: ref.loss(p, batch, rng), has_aux=True)(params)
        out[name] = dict(
            ref=ref, port=port, logits=np.asarray(ref.apply(params,
                                                            batch["x"])),
            loss=float(loss), metrics={k: float(v) for k, v in
                                       metrics.items()},
            eval={k: float(v) for k, v in
                  ref.eval_metrics(params, batch).items()},
            grads=jax.device_get(grads))
    return out


def _port_batch():
    import torch

    return {k: torch.as_tensor(v) for k, v in _batch().items()}


@pytest.mark.parametrize("name", NETS)
def test_logits_loss_and_gradient_match_the_reference(pairs, name):
    import torch

    case = pairs[name]
    port, batch = case["port"], _port_batch()
    with torch.no_grad():
        logits = port.apply(batch["x"]).numpy()
    want = case["logits"]
    assert np.abs(logits - want).max() <= 1e-5 * np.abs(want).max(), name
    loss, metrics = port.loss(batch)
    assert abs(loss.item() - case["loss"]) <= 1e-5 * abs(case["loss"])
    for k, v in case["metrics"].items():
        assert abs(metrics[k].item() - v) <= 1e-5 * max(abs(v), 1.0), k
    with torch.no_grad():
        evals = port.eval_metrics(batch)
    for k, v in case["eval"].items():
        assert abs(float(evals[k]) - v) <= 1e-5 * max(abs(v), 1.0), k
    grads = torch.autograd.grad(loss, list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    for n, g in zip(names, grads):
        module, leaf = n.rsplit(".", 1)
        ref_g = np.asarray(case["grads"][module][leaf])
        scale = max(np.abs(ref_g).max(), 1e-12)
        assert np.abs(g.numpy() - ref_g).max() <= 1e-4 * scale, (name, n)


def _ref_mesh(fsdp):
    return types.SimpleNamespace(shape={"fsdp": fsdp})


def _port_mesh(fsdp):
    from determined_tpu_torch.parallel.mesh import AXIS_NAMES

    return types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, device_type="cpu",
        shape=tuple(fsdp if a == "fsdp" else 1 for a in AXIS_NAMES),
        get_coordinate=lambda: (0,) * 6, get_group=lambda axis: None)


@pytest.mark.parametrize("fsdp", [1, 8])
@pytest.mark.parametrize("name", ["conv", "mlp", "darts-mixed"])
def test_logical_axes_equal_the_references(pairs, name, fsdp):
    from determined_tpu.integrations.haiku import HaikuModel as RefModel
    from determined_tpu_torch.integrations.haiku import HaikuModel

    ref_fwd, module = _nets(name)
    x = _batch()["x"][:1]
    want = RefModel(ref_fwd, x, mesh=_ref_mesh(fsdp)).logical_axes()
    got = HaikuModel(module, x, mesh=_port_mesh(fsdp),
                     device="cpu").logical_axes()
    assert got == {m: dict(leaves) for m, leaves in want.items()}
    if fsdp == 8 and name == "mlp":
        # 12 hidden units: the [12, 12] weight is indivisible, replicated
        assert got["linear_1"]["w"] == (None, None)
        assert got["linear"]["w"] == ("embed", None)


def test_darts_ops_and_space_are_the_references():
    sys.path.insert(0, str(ROOT))
    from determined_tpu.searcher.sample import sample
    from determined_tpu_torch.examples import darts_benchmark_trial as pdarts
    from examples import darts_benchmark_trial as rdarts

    assert pdarts.OPS == rdarts.OPS
    with open(ROOT / "examples" / "darts_benchmark.json") as f:
        cfg = json.load(f)
    rng = random.Random(0)
    for _ in range(10):
        hp = sample(cfg["hyperparameters"], rng)
        for k in ("op_0", "op_1", "op_2"):
            assert hp[k] in pdarts.OPS
    with pytest.raises(ValueError, match="unknown op"):
        pdarts.cell_forward({"op_0": "conv7", "op_1": "skip",
                             "op_2": "skip"}, 8, 4)


def _fit(trial, steps, **kw):
    from determined_tpu_torch import core
    from determined_tpu_torch.trainer import Batch, Trainer

    ctx = core._dummy_init()
    trainer = Trainer(trial, ctx, device="cpu", **kw)
    trainer.fit(max_length=Batch(steps), report_period=Batch(1))
    return trainer, [m["loss"] for g, _, m in ctx.train._reported
                     if g == "training"]


def test_vision_trial_beats_chance():
    """The reference test's recipe on one CPU process: a conv net on the
    class-conditioned stream beats chance (0.25) after 30 steps."""
    import torch

    from determined_tpu_torch.integrations.haiku import HaikuVisionTrial

    trial = HaikuVisionTrial({
        "arch": "conv", "channels": 8, "depth": 2, "batch_size": 64,
        "image_size": 16, "num_classes": 4, "lr": 3e-3})
    trainer, losses = _fit(trial, 30)
    assert trainer.steps_completed == 30 and np.isfinite(losses).all()
    batch = trainer._put_batch(trial.build_validation_data()[0])
    with torch.no_grad():
        metrics = trainer.model.eval_metrics(batch)
    assert float(metrics["accuracy"]) > 0.4


@pytest.mark.parametrize("genotype", [
    {"op_0": "conv3", "op_1": "skip", "op_2": "maxpool"},
    {"op_0": "avgpool", "op_1": "conv5", "op_2": "skip"},
])
def test_every_genotype_trains(genotype):
    from determined_tpu_torch.examples.darts_benchmark_trial import (
        DartsBenchmarkTrial,
    )

    trial = DartsBenchmarkTrial({**genotype, "lr": 1e-3, "channels": 8,
                                 "batch_size": 16, "image_size": 16,
                                 "num_classes": 4})
    trainer, losses = _fit(trial, 2)
    assert trainer.steps_completed == 2 and np.isfinite(losses).all()


def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.integrations.haiku import HaikuVisionTrial
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.trainer import Batch, Trainer

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=2)
    ctx = core._dummy_init(distributed=dctx)
    mesh = make_mesh(MeshConfig(fsdp=2), device="cpu")
    trainer = Trainer(HaikuVisionTrial(dict(GANG_HP)), ctx, device="cpu",
                      mesh=mesh)
    losses, step = [], trainer._train_step

    def recorded(batch, poison=1.0):  # the gang's loss, on every rank
        metrics = step(batch, poison)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer._train_step = recorded
    trainer.fit(max_length=Batch(GANG_STEPS), report_period=Batch(1))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses,
                   "split": sorted(trainer._layout.split_dims)}, f)
    dctx.close()
    tdist.destroy_process_group()


def test_fsdp2_gang_trains_the_one_process_losses(tmp_path):
    from determined_tpu_torch.integrations.haiku import HaikuVisionTrial

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    procs = []
    for rank in range(2):
        log = open(tmp_path / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(rank), str(tmp_path / "store"),
             str(tmp_path)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        _, want = _fit(HaikuVisionTrial(dict(GANG_HP)), GANG_STEPS)
        deadline = time.time() + JOIN_S
        while time.time() < deadline:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            assert not bad, (tmp_path / f"rank{bad[0]}.log").read_text()[
                -4000:]
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
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        # the conv weights' largest dimensions split over fsdp
        assert "conv2_d.w" in got["split"], got["split"]
        assert len(got["losses"]) == GANG_STEPS
        for a, b in zip(got["losses"], want):
            assert abs(a - b) <= 1e-5 * abs(b), (rank, got["losses"], want)


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
