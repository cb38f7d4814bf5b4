"""The port's mesh and sharding rules (determined_tpu_torch.parallel)
against the JAX package's, case by case, in one process.

- ``MeshConfig.resolve``, ``refit`` and ``axis_sizes``, ``batch_axes``,
  ``data_parallel_size`` and ``validate_divisibility`` against the
  reference functions, errors included.
- ``logical_to_spec`` and ``spec_for_pytree`` over ``GPT.logical_axes()``
  (tied and untied) against the reference's; the port GPT's
  ``logical_axes()`` equals the reference GPT's.
- ``local_region``: the block each device holds under the rules, on
  meshes of 8 devices laid out as the reference lays them out, against
  the reference ``NamedSharding``'s ``devices_indices_map`` — the
  regions the sharded checkpoint names its files by.
- ``make_multislice_mesh``'s axis sizes against the reference's mesh shape
  over its 8 virtual CPU devices.
- ``make_mesh`` builds a ``DeviceMesh`` with the reference's axis names
  and order on a one-process gloo group, which this module destroys at
  its end so that no later file on the worker inherits a default group;
  ``logical_to_sharding`` and ``shard_pytree_like`` place tensors on it.
- On that one-rank mesh the Trainer's blocks are its parameters (no
  copy), a step runs no collective, and three steps equal the mesh-less
  trainer's bit for bit.
- Refused by name: the expert axis beside a pipeline, tensor or context
  axis above 1 (in ``make_mesh``, ``GPT(mesh=)``); the pipeline functions
  run on one stage.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from determined_tpu.models import gpt as jgpt
from determined_tpu.parallel import mesh as jmesh
from determined_tpu.parallel import sharding as jsharding
from determined_tpu_torch import parallel as tparallel
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.parallel import mesh as tmesh
from determined_tpu_torch.parallel import sharding as tsharding

AXES = dict(data=-1, fsdp=1, tensor=1, pipeline=1, context=1, expert=1)


def _cfgs(kw):
    return jmesh.MeshConfig(**kw), tmesh.MeshConfig(**kw)


def _same(fn_ref, fn_port):
    """Both raise ValueError with the same message, or both return equal
    results."""
    try:
        want = fn_ref()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port()
        assert str(got.value) == str(e)
        return None
    got = fn_port()
    assert got == want
    return got


RESOLVE = [
    ({}, 8), ({"fsdp": 2}, 8), ({"fsdp": 4, "data": 2}, 8),
    ({"fsdp": -1}, 8), ({"tensor": 2, "fsdp": 2}, 8), ({"fsdp": 3}, 8),
    ({"data": -1, "fsdp": -1}, 8), ({"data": 2, "fsdp": 2}, 8),
    ({"data": 1, "fsdp": 1}, 1), ({"fsdp": 2}, 1), ({"context": 2}, 6),
]
REFIT = [
    ({"fsdp": 4, "data": 2}, 4), ({"fsdp": 4, "data": 2}, 6),
    ({"fsdp": -1}, 6), ({"tensor": 4, "data": 2}, 2),
    ({"tensor": 2, "fsdp": 2, "data": 2}, 4), ({"tensor": -1, "fsdp": 2}, 3),
    ({"data": 2}, 3), ({"fsdp": 8}, 12),
]


@pytest.mark.parametrize("kind,kw,n", [
    *(("resolve", kw, n) for kw, n in RESOLVE),
    *(("refit", kw, n) for kw, n in REFIT),
])
def test_mesh_config_arithmetic_matches_the_reference(kind, kw, n):
    ref, port = _cfgs(kw)
    got = _same(lambda: getattr(ref, kind)(n).axis_sizes(),
                lambda: getattr(port, kind)(n).axis_sizes())
    if got is not None:
        assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES
        assert tmesh.batch_axes() == jmesh.batch_axes()


def _ref_mesh(sizes):
    return jax.sharding.Mesh(
        np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes),
        jmesh.AXIS_NAMES)


def _port_mesh(sizes, coordinate=(0,) * 6):
    """A mesh-like with the port's accessors, for the arithmetic that
    needs no process group."""
    return types.SimpleNamespace(
        mesh_dim_names=tmesh.AXIS_NAMES, shape=tuple(sizes),
        get_coordinate=lambda: coordinate)


@pytest.mark.parametrize("kw,batch,seq", [
    ({"data": 2, "fsdp": 4}, 16, None), ({"data": 2, "fsdp": 4}, 12, None),
    ({"fsdp": 8}, 8, 128), ({"data": 4, "context": 2}, 8, 33),
    ({"data": 4, "context": 2}, 8, 64),
])
def test_divisibility_matches_the_reference(kw, batch, seq):
    ref, _ = _cfgs(kw)
    sizes = ref.resolve(8).axis_sizes()
    jm, tm = _ref_mesh(sizes), _port_mesh(sizes)
    assert tmesh.data_parallel_size(tm) == jmesh.data_parallel_size(jm)
    _same(lambda: jmesh.validate_divisibility(jm, global_batch=batch,
                                              seq_len=seq),
          lambda: tmesh.validate_divisibility(tm, global_batch=batch,
                                              seq_len=seq))


def _gpt_pair(tie):
    kw = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
              seq_len=32, tie_embeddings=tie)
    return (jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **kw)),
            tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **kw), device="cpu"))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


RULES = [
    ("default", {}),
    ("fsdp-mlp", {"mlp": "fsdp", "embed": None}),
    ("batch-data", {"batch": "data", "vocab": ("fsdp", "tensor")}),
]


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("rules", [name for name, _ in RULES])
def test_specs_over_gpt_logical_axes_match_the_reference(tie, rules):
    updates = dict(RULES)[rules]
    jrules = jsharding.DEFAULT_RULES.replace(**updates)
    trules = tsharding.DEFAULT_RULES.replace(**updates)
    assert trules.rules == jrules.rules
    jg, tg = _gpt_pair(tie)
    axes = tg.logical_axes()
    assert axes == jg.logical_axes()
    # keyed as named_parameters names the leaves
    assert sorted(n for n, _ in _leaves(axes)) == sorted(
        n for n, _ in tg.named_parameters())
    jspecs = dict(_leaves(jsharding.spec_for_pytree(axes, jrules)))
    tspecs = dict(_leaves(tsharding.spec_for_pytree(axes, trules)))
    assert set(tspecs) == set(jspecs)
    for name, spec in tspecs.items():
        assert tuple(spec) == tuple(jspecs[name]), name
        assert tuple(tsharding.logical_to_spec(dict(_leaves(axes))[name],
                                               trules)) == tuple(spec)


#: meshes whose rules split GPT leaves on two dimensions over two axes
#: ("embed" over fsdp, "heads" / "mlp" / "vocab" over tensor)
TWO_AXIS_MESHES = [
    {"data": 2, "fsdp": 2, "tensor": 2}, {"fsdp": 2, "tensor": 4},
    {"fsdp": 4, "tensor": 2}, {"fsdp": 2, "context": 2, "tensor": 2},
]


@pytest.mark.parametrize("kw", [
    {"data": 2, "fsdp": 4}, {"fsdp": 8}, {"data": 4, "fsdp": 2},
    *TWO_AXIS_MESHES,
])
def test_local_regions_match_the_reference_shard_indices(kw):
    """Every device's block of every GPT leaf (and of a batch) under the
    rules equals the index the reference's NamedSharding gives it."""
    ref, _ = _cfgs(kw)
    sizes = ref.resolve(8).axis_sizes()
    jm = _ref_mesh(sizes)
    jg, tg = _gpt_pair(True)
    shapes = {n: tuple(p.shape) for n, p in tg.named_parameters()}
    axes = dict(_leaves(tg.logical_axes()))
    axes["batch"], shapes["batch"] = ("batch", None), (16, 32)
    for name, shape in shapes.items():
        spec = jsharding.logical_to_spec(axes[name])
        indices = NamedSharding(jm, spec).devices_indices_map(shape)
        for coord in np.ndindex(*sizes):
            device = jm.devices[coord]
            want = [(s.start or 0, n if s.stop is None else s.stop)
                    for s, n in zip(indices[device], shape)]
            tm = _port_mesh(sizes, coord)
            placements = tsharding.spec_to_placements(
                tsharding.logical_to_spec(axes[name]), tm)
            assert tsharding.local_region(shape, placements, tm) == want, (
                name, coord)


@pytest.mark.parametrize("kw", TWO_AXIS_MESHES)
def test_replica_index_matches_the_reference_replica_ids(kw):
    """Every device's copy of its block of every GPT leaf: the port's
    ``replica_index`` is the reference's ``replica_id`` (0: the copy a
    checkpoint writes), leaves split on two dimensions included."""
    ref, _ = _cfgs(kw)
    sizes = ref.resolve(8).axis_sizes()
    jm = _ref_mesh(sizes)
    coords = {jm.devices[c]: c for c in np.ndindex(*sizes)}
    _, tg = _gpt_pair(True)
    axes = dict(_leaves(tg.logical_axes()))
    split_twice = 0
    for name, p in tg.named_parameters():
        spec = jsharding.logical_to_spec(axes[name])
        split_twice += sum(a is not None for a in spec) == 2
        arr = jax.device_put(np.zeros(p.shape, np.float32),
                             NamedSharding(jm, spec))
        for shard in arr.addressable_shards:
            tm = _port_mesh(sizes, coords[shard.device])
            placements = tsharding.spec_to_placements(
                tsharding.logical_to_spec(axes[name]), tm)
            assert tsharding.replica_index(placements, tm) == (
                shard.replica_id), (name, coords[shard.device])
    assert split_twice == 5  # wqkv, wo, wi, wo_mlp and tok_embed


@pytest.mark.parametrize("kw,dcn", [
    ({}, 2), ({"fsdp": 2}, 2), ({"fsdp": 2}, 4), ({"data": 1, "fsdp": 4}, 2),
    ({"fsdp": 2}, 3), ({"fsdp": 4}, 4), ({}, 1),
])
def test_multislice_axis_sizes_match_the_reference(kw, dcn):
    ref, port = _cfgs(kw)
    _same(lambda: jmesh.make_multislice_mesh(
              ref, dcn_data=dcn, devices=jax.devices()[:8]).devices.shape,
          lambda: tmesh.multislice_axis_sizes(port, 8, dcn))


@pytest.fixture(scope="module")
def one_process_group():
    """A one-process gloo group, destroyed at the module's end."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_has_the_reference_axes_on_one_process(one_process_group):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m = tparallel.make_mesh(device="cpu")
    ref = jmesh.make_mesh(devices=jax.devices()[:1])
    assert m.mesh_dim_names == ref.axis_names
    assert tuple(m.shape) == ref.devices.shape
    assert tmesh.data_parallel_index(m) == 0
    assert tuple(tparallel.make_multislice_mesh(device="cpu").shape) == (
        jmesh.make_multislice_mesh(devices=jax.devices()[:1]).devices.shape)
    placements = tparallel.logical_to_sharding(("vocab", "embed"), m)
    assert placements == (Replicate(), Replicate(), Shard(1), Replicate(),
                          Replicate(), Shard(0))
    tree = tparallel.shard_pytree_like(
        {"w": torch.ones(4, 6), "b": {"x": torch.zeros(6)}},
        {"w": ("vocab", "embed"), "b": {"x": ("norm",)}}, m)
    assert isinstance(tree["w"], DTensor) and tree["w"].placements == placements
    assert tree["b"]["x"].placements == (Replicate(),) * 6
    assert torch.equal(tree["w"].full_tensor(), torch.ones(4, 6))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tparallel.make_mesh(tparallel.MeshConfig(data=2), device="cpu")


def test_one_rank_mesh_step_is_the_one_device_step(one_process_group,
                                                   monkeypatch):
    import torch.distributed as dist

    from determined_tpu_torch import core
    from determined_tpu_torch.trainer import Trainer
    from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

    def steps(mesh, n=3):
        trial = RepeatedBatchTrial(4, 32, config=tgpt.tiny(32), lr=1e-2)
        trainer = Trainer(trial, core._dummy_init(), device="cpu", mesh=mesh)
        batch = trainer._put_batch(next(trial.build_training_data()))
        out = [trainer._train_step(batch) for _ in range(n)]
        return trainer, [(float(m["loss"]), float(m["grad_norm"]))
                         for m in out]

    plain, want = steps(None)
    meshed = Trainer(RepeatedBatchTrial(4, 32, config=tgpt.tiny(32)),
                     core._dummy_init(), device="cpu",
                     mesh=tparallel.make_mesh(device="cpu"))
    assert all(b.data_ptr() == p.data_ptr()
               for b, p in zip(meshed._params, meshed.model.parameters()))
    calls = []
    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast"):
        monkeypatch.setattr(dist, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    trainer, got = steps(tparallel.make_mesh(device="cpu"))
    assert calls == [] and got == want
    for a, b in zip(trainer.model.parameters(), plain.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("axis,kw", [
    ("pipeline", {"expert": 2}), ("tensor", {"expert": 2}),
    ("context", {"expert": 2}),
])
def test_later_axes_are_refused_by_name(axis, kw, monkeypatch):
    """What the port leaves out: the expert axis beside a pipeline axis
    above 1, as the reference leaves it out (each of those axes alone
    trains). Beside a tensor or context axis the layout is taken: the
    mesh then needs its gang, and an expert GPT builds on it."""
    cfg = tmesh.MeshConfig(**{axis: 2}, **kw)
    refused = axis == "pipeline"
    match = f"expert=2 and {axis}=2.*item 4"
    if refused:
        for call in (lambda: tmesh.make_mesh(cfg, device="cpu"),
                     lambda: tmesh.make_multislice_mesh(cfg, device="cpu")):
            with pytest.raises(NotImplementedError, match=match):
                call()
    else:
        tmesh.refuse_later_axes(cfg)
    tmesh.refuse_later_axes(tmesh.MeshConfig(**{axis: 2}))
    sizes = cfg.resolve(4).axis_sizes()
    mesh = types.SimpleNamespace(**vars(_port_mesh(sizes)),
                                 get_group=lambda a: None)
    experts = tgpt.GPTConfig(**{**tgpt.tiny().__dict__, "n_experts": 4})
    if refused:
        with pytest.raises(NotImplementedError, match=match):
            tgpt.GPT(tgpt.GPTConfig(**tgpt.tiny().__dict__), device="cpu",
                     mesh=mesh)
        return
    from determined_tpu_torch.parallel import experts as tmoe

    # the mesh-like has no process groups to make
    monkeypatch.setattr(tmoe, "_group", lambda mesh, axes: None)
    model = tgpt.GPT(experts, device="cpu", mesh=mesh)
    assert model.blocks["we_in"].shape[1] == 2  # 4 experts over expert=2


@pytest.mark.parametrize("name,part", [
    ("pipeline_apply", "part 3"), ("circular_pipeline_apply", "part 3"),
    ("stack_circular_stages", "part 3"),
])
def test_later_parallel_functions_are_refused_by_name(name, part):
    """The pipeline functions of item 4, part 3 are no longer refused: each
    is exported and runs on one stage (the schedules over a gang:
    tests/test_torch_pipeline.py)."""
    assert name in tparallel.__all__
    w = torch.arange(8.0).reshape(2, 1, 2, 2)  # two chunks of one layer
    x = torch.ones(3, 1, 2)

    def stage(p, a):
        return a @ p[0]

    if name == "stack_circular_stages":
        got = tparallel.stack_circular_stages(w, 1)
        assert torch.equal(got, w[None])
        return
    if name == "pipeline_apply":
        want = x @ w[0, 0]
        got = tparallel.pipeline_apply(stage, w[0], x)
    else:
        want = x @ w[0, 0] @ w[1, 0]
        got = tparallel.circular_pipeline_apply(stage, w, x)
    assert torch.equal(got, want), part
