"""The port's training loop (determined_tpu_torch.trainer, .core) against
the JAX package's, on the CPU at fp32.

- The optimizer chain (``trainer.optim``) against optax over 20 steps:
  ``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule))``
  with clipping engaged on some steps and not on others, ``adamw`` at a
  constant rate with optax's defaults, and the schedules themselves.
- The non-finite guard: a NaN step leaves the parameters, the moments AND
  the step counts untouched, so the trajectory continues exactly as if
  the step had never come (optax on the batches without it).
- ``Trainer.fit`` against the JAX ``Trainer`` (off-cluster core
  contexts) from the same ``GPT.init`` parameters carried over by
  ``load_jax_params``: every reported loss and grad norm, the skip
  accounting of a batch whose ``loss_mask`` is NaN, and the final
  parameters.
- Refusals by name: the orbax checkpoint format, a mesh, the replica
  audit, an elastic resume, ``core.init()`` on a cluster.

Tolerances: optimizer 1e-6 absolute on O(1) parameters (fp32, the same
operation order as optax; pow and the norm's sum may differ by an ulp);
trainer losses and grad norms 1e-5 relative; final parameters 5e-5
absolute. The fp32 gradients of the two packages differ by ~5e-8, and
after five Adam steps at lr 1e-2 most leaves agree to ~2e-6; the drift
is largest (measured 1.7e-5) on the key bias, whose true gradient is
identically zero — softmax ignores a shift shared by all keys of a row —
so each package updates it from its own ~1e-10 rounding noise divided by
Adam's eps of 1e-8. A wrong gradient or update moves parameters by ~lr.
"""
import itertools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu import core as jcore
from determined_tpu.models import gpt as jgpt
from determined_tpu.trainer import Batch as JBatch
from determined_tpu.trainer import JAXTrial, Trainer as JTrainer
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.trainer import Batch, Epoch, TorchTrial, Trainer
from determined_tpu_torch.trainer import _sentinel, optim, to_batches

SHAPES = [(7, 5), (3,), (2, 4, 3)]


def _grads(rng, step):
    """Gradients whose global norm crosses the clip threshold of 1.0:
    large on even steps, small on odd ones."""
    s = 3.0 if step % 2 == 0 else 0.05
    return [(s * rng.normal(size=sh)).astype(np.float32) for sh in SHAPES]


def _run_port(tx, params, grad_seq):
    ps = [torch.from_numpy(p.copy()) for p in params]
    state = tx.init(ps)
    out = []
    for g in grad_seq:
        updates, state = tx.update([torch.from_numpy(x) for x in g], state, ps)
        ps = torch._foreach_add(ps, updates)
        out.append([p.numpy().copy() for p in ps])
    return out


def _run_optax(tx, params, grad_seq):
    ps = [jnp.asarray(p) for p in params]
    state = tx.init(ps)
    out = []
    for g in grad_seq:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, ps)
        ps = optax.apply_updates(ps, updates)
        out.append([np.asarray(p) for p in ps])
    return out


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32) for sh in SHAPES]


@pytest.mark.parametrize("which", ["adamw-warmup-cosine-clipped",
                                   "adamw-constant"])
def test_optimizer_matches_optax_over_20_steps(which):
    rng = np.random.default_rng(1)
    grad_seq = [_grads(rng, i) for i in range(20)]
    if which == "adamw-constant":  # optax's defaults: wd 1e-4 on every leaf
        port, ref = optim.adamw(3e-2), optax.adamw(3e-2)
    else:
        kw = dict(init_value=0.0, peak_value=5e-2, warmup_steps=5,
                  decay_steps=20, end_value=1e-3)
        port = optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(optim.warmup_cosine_decay_schedule(**kw), b2=0.95,
                        weight_decay=0.1))
        ref = optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adamw(optax.warmup_cosine_decay_schedule(**kw), b2=0.95,
                        weight_decay=0.1))
        norms = [np.sqrt(sum(float((x ** 2).sum()) for x in g))
                 for g in grad_seq]
        assert min(norms) < 1.0 < max(norms)  # clipping on some steps only
    got = _run_port(port, _params(), grad_seq)
    want = _run_optax(ref, _params(), grad_seq)
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("name,port,ref", [
    ("warmup-cosine",
     optim.warmup_cosine_decay_schedule(0.0, 1.0, 10, 50, end_value=0.1),
     optax.warmup_cosine_decay_schedule(0.0, 1.0, 10, 50, end_value=0.1)),
    ("linear", optim.linear_schedule(1.0, 0.01, 30, transition_begin=5),
     optax.linear_schedule(1.0, 0.01, 30, transition_begin=5)),
    ("cosine", optim.cosine_decay_schedule(2.0, 40, alpha=0.2, exponent=2.0),
     optax.cosine_decay_schedule(2.0, 40, alpha=0.2, exponent=2.0)),
])
def test_schedules_match_optax(name, port, ref):
    counts = np.arange(0, 70, dtype=np.int32)
    got = np.array([float(port(torch.tensor(c))) for c in counts])
    want = np.array([float(ref(jnp.asarray(c))) for c in counts])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_clip_leaves_small_updates_alone_and_divides_by_the_norm():
    clip = optim.clip_by_global_norm(1.0)
    small = [torch.full((4,), 0.1)]
    assert torch.equal(clip.update(small, clip.init(small))[0][0], small[0])
    big = [torch.tensor([3.0, 4.0])]  # norm 5: exactly t / 5, no epsilon
    np.testing.assert_array_equal(clip.update(big, None)[0][0].numpy(),
                                  np.array([0.6, 0.8], np.float32))


def test_guard_keeps_params_moments_and_counts_on_a_skipped_step():
    rng = np.random.default_rng(2)
    grad_seq = [_grads(rng, i) for i in range(6)]
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(sched))
    params = [torch.from_numpy(p) for p in _params()]
    state = tx.init(params)
    skips = torch.zeros((), dtype=torch.int32)
    poisoned = list(grad_seq)
    poisoned.insert(3, [np.full(sh, np.nan, np.float32) for sh in SHAPES])
    history = []
    for g in poisoned:
        g = [torch.from_numpy(x) for x in g]
        gnorm = optim.global_norm(g)
        loss = torch.tensor(1.0) * gnorm  # the NaN rides the loss too
        updates, new_state = tx.update(g, state, params)
        before = [p.clone() for p in params]
        state_before = state
        state, ok, skips = _sentinel.guarded_update(
            params, torch._foreach_add(params, updates), state, new_state,
            loss, gnorm, skips)
        history.append(int(skips))
        if not bool(ok):
            assert all(torch.equal(a, b) for a, b in zip(params, before))
            leaves = jax.tree_util.tree_leaves
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(state), leaves(state_before)))
            adam_state, sched_state = state[1][0], state[1][2]
            assert int(adam_state.count) == 3 and int(sched_state.count) == 3
    assert history == [0, 0, 0, 1, 0, 0, 0]
    want = _run_optax(
        optax.chain(optax.clip_by_global_norm(1.0),
                    optax.adamw(optax.warmup_cosine_decay_schedule(
                        0.0, 1e-2, 2, 6))),
        _params(), grad_seq)[-1]
    for a, b in zip(params, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Trainer.fit against the JAX Trainer
# ---------------------------------------------------------------------------
KW = dict(vocab_size=128, n_layers=2, n_heads=2, d_model=32, d_ff=64,
          seq_len=32, remat=False)
N_STEPS, NAN_STEP = 6, 3


def _stream():
    rng = np.random.default_rng(7)
    for i in itertools.count():
        tokens = rng.integers(0, 128, (8, 32)).astype(np.int32)
        mask = np.ones((8, 32), np.float32)
        if i == NAN_STEP:
            mask[0, 5] = np.nan  # poisons the loss: both guards must skip
        yield {"tokens": tokens, "loss_mask": mask}


def _tx(lib):
    return lib.chain(lib.clip_by_global_norm(1.0), lib.adamw(1e-2))


class _JTrial(JAXTrial):
    def build_model(self, mesh):
        return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW), mesh=mesh)

    def build_optimizer(self):
        return _tx(optax)

    def build_training_data(self):
        return _stream()

    def build_validation_data(self):
        return [next(_stream())]


class _TTrial(TorchTrial):
    def __init__(self, tree=None):
        super().__init__()
        self.tree = tree

    def build_model(self, device):
        model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **KW),
                         device=device)
        if self.tree is not None:
            tgpt.load_jax_params(model, self.tree)
        return model

    def build_optimizer(self):
        return _tx(optim)

    def build_training_data(self):
        return _stream()

    def build_validation_data(self):
        return [next(_stream())]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    jctx = jcore._context._dummy_init(
        checkpoint_storage=str(tmp_path_factory.mktemp("ckpt")))
    jt = JTrainer(_JTrial(), jctx, seed=0)
    jval = jt.fit(max_length=JBatch(N_STEPS), report_period=JBatch(1))
    jparams = jax.device_get(jt.state["params"])
    tree = jax.device_get(
        jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW)).init(
            jax.random.PRNGKey(0)))
    tctx = tcore._dummy_init()
    tt = Trainer(_TTrial(tree), tctx, device="cpu", seed=0)
    tval = tt.fit(max_length=Batch(N_STEPS), report_period=Batch(1))
    return jctx, jt, jval, jparams, tctx, tt, tval


def _training(ctx):
    return [(s, m) for g, s, m in ctx.train._reported if g == "training"]


def test_fit_reports_the_reference_losses(fitted):
    jctx, jt, _, _, tctx, tt, _ = fitted
    jrep, trep = _training(jctx), _training(tctx)
    assert [s for s, _ in trep] == [s for s, _ in jrep] == \
        list(range(1, N_STEPS + 1))
    for (step, jm), (_, tm) in zip(jrep, trep):
        for key in ("loss", "grad_norm"):
            # the guarded step drops its non-finite values on both sides
            assert (key in tm) == (key in jm) == (step != NAN_STEP + 1)
            if key in jm:
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                           err_msg=f"{key} @ {step}")
        for key in ("accuracy", "tokens"):  # NaN at the poisoned step
            assert (key in tm) == (key in jm) == (step != NAN_STEP + 1)
            if key in jm:
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                           err_msg=f"{key} @ {step}")
        for key in ("sentinel_skipped", "sentinel_skips", "steps_skipped"):
            assert tm[key] == jm[key], (key, step)
        assert tm["batches_per_second"] > 0
    assert tt.steps_skipped == jt.steps_skipped == 1
    assert tt.steps_completed == jt.steps_completed == N_STEPS


def test_fit_ends_on_the_reference_parameters(fitted):
    _, _, jval, jparams, _, tt, tval = fitted
    want = dict(tgpt._flatten(jparams))
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=5e-5,
                                   rtol=0, err_msg=name)
    assert set(tval) == set(jval)
    for k in tval:
        np.testing.assert_allclose(tval[k], jval[k], rtol=1e-5, err_msg=k)


def test_fit_reports_validation_and_completes_the_searcher_op(fitted):
    _, _, _, _, tctx, _, tval = fitted
    groups = [g for g, _, _ in tctx.train._reported]
    assert groups.count("validation") == 1 and groups[-1] == "validation"
    assert tctx.train._heartbeats == list(range(N_STEPS + 1))
    assert tval["loss"] > 0


def test_validation_period_and_epoch_units():
    class Epochs(_TTrial):
        batches_per_epoch = 2

    ctx = tcore._dummy_init()
    trainer = Trainer(Epochs(), ctx, device="cpu")
    trainer.fit(max_length=Epoch(2), validation_period=Batch(1),
                report_period=Epoch(1))
    steps = [(g, s) for g, s, _ in ctx.train._reported]
    assert steps == [("validation", 1), ("training", 2), ("profiling", 2),
                     ("validation", 2), ("validation", 3), ("training", 4),
                     ("profiling", 4), ("validation", 4)]
    assert to_batches(Epoch(3), 2) == 6 and to_batches(5) == 5
    with pytest.raises(ValueError, match="batches_per_epoch"):
        to_batches(Epoch(1))


def test_trainer_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from determined_tpu_torch import CudaUnavailableError

    with pytest.raises(CudaUnavailableError):
        Trainer(_TTrial(), tcore._dummy_init())


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=object()), "multi-device slice"),
    (dict(smaller_is_better=False), "smaller_is_better"),
    (dict(health={"divergence_check_period": 10}),
     "divergence_check_period.*multi-device slice"),
    (dict(resume_event="resize"), "resize.*elastic slice"),
])
def test_trainer_refuses_later_slices_by_name(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer(_TTrial(), tcore._dummy_init(), device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(checkpoint_format="orbax"), dict(latest_checkpoint="orbax-ckpt"),
])
def test_fit_refuses_checkpoints_by_name(kwargs, tmp_path):
    """The orbax format needs JAX: refused by name, as a trainer option
    and as a checkpoint on disk (its ``orbax/`` directory), leaving the
    trainer untouched."""
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))
    if "checkpoint_format" in kwargs:
        with pytest.raises(NotImplementedError, match="orbax"):
            Trainer(_TTrial(), ctx, device="cpu", **kwargs)
        return
    (tmp_path / "orbax-ckpt" / "orbax").mkdir(parents=True)
    trainer = Trainer(_TTrial(), ctx, device="cpu")
    before = [p.detach().clone() for p in trainer.model.parameters()]
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.fit(max_length=Batch(1), **kwargs)
    assert trainer.steps_completed == 0
    assert all(torch.equal(a, b.detach())
               for a, b in zip(before, trainer.model.parameters()))


def test_core_init_refuses_a_cluster(monkeypatch, tmp_path):
    monkeypatch.setenv("DTPU_MASTER", "http://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="exec slice"):
        tcore.init()
    monkeypatch.delenv("DTPU_MASTER")
    ctx = tcore.init()
    assert ctx.distributed.is_chief
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))
    assert ctx.checkpoint._storage.base_path == str(tmp_path)


def test_poisoned_step_is_skipped_in_place():
    """A NaN poison factor rides the loss into every gradient: the step
    is skipped and the parameters stay bitwise where they were."""
    trainer = Trainer(_TTrial(), tcore._dummy_init(), device="cpu")
    batch = trainer._put_batch({"tokens": np.zeros((2, 32), np.int32)})
    before = [p.detach().clone() for p in trainer.model.parameters()]
    metrics = trainer._train_step(batch, poison=float("nan"))
    assert int(metrics["sentinel_skipped"]) == 1
    assert int(metrics["sentinel_skips"]) == 1
    assert all(torch.equal(a, b.detach())
               for a, b in zip(before, trainer.model.parameters()))
    metrics = trainer._train_step(batch)
    assert int(metrics["sentinel_skipped"]) == 0
    assert int(metrics["sentinel_skips"]) == 0


# ---------------------------------------------------------------------------
# Trainer.fit on packed documents through the chunked loss
# ---------------------------------------------------------------------------
LONG_KW = dict(KW, fused_loss=True, remat=True, remat_attention=True,
               attn_window=12)
PACKED_STEPS = 4


def _packed_stream():
    """pack_sequences of seeded random documents of 3-20 tokens."""
    from determined_tpu_torch.batch_inference import pack_sequences

    rng = np.random.default_rng(11)
    docs = (rng.integers(1, 128, int(n)).tolist()
            for n in rng.integers(3, 21, size=10_000))
    yield from pack_sequences(docs, 32, 8)


def test_fit_on_packed_documents_with_the_chunked_loss_matches_jax():
    """fused_loss, rematted attention and a window on packed batches:
    every reported loss and grad norm equals the JAX Trainer's."""
    class JPacked(_JTrial):
        def build_model(self, mesh):
            return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **LONG_KW),
                            mesh=mesh)

        def build_training_data(self):
            return _packed_stream()

    class TPacked(_TTrial):
        def build_model(self, device):
            model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **LONG_KW),
                             device=device)
            return tgpt.load_jax_params(model, self.tree)

        def build_training_data(self):
            return _packed_stream()

    tree = jax.device_get(
        jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **LONG_KW)).init(
            jax.random.PRNGKey(0)))
    jctx, tctx = jcore._context._dummy_init(), tcore._dummy_init()
    JTrainer(JPacked(), jctx, seed=0).fit(max_length=JBatch(PACKED_STEPS),
                                         report_period=JBatch(1))
    Trainer(TPacked(tree), tctx, device="cpu", seed=0).fit(
        max_length=Batch(PACKED_STEPS), report_period=Batch(1))
    jrep, trep = _training(jctx), _training(tctx)
    assert len(trep) == len(jrep) == PACKED_STEPS
    for (step, jm), (_, tm) in zip(jrep, trep):
        for key in ("loss", "grad_norm", "accuracy", "tokens"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       err_msg=f"{key} @ {step}")


@pytest.mark.parametrize("rung,batch,fields", [
    ("headline", 8, dict(remat=False)),
    ("long16k", 1, dict(seq_len=16384, remat=True, fused_loss=True)),
    ("long32k", 1, dict(seq_len=32768, remat=True, fused_loss=True)),
])
def test_profile_rungs_mirror_the_bench(rung, batch, fields):
    """trainer/profile.py's presets carry bench.py's GPTConfig fields
    (every field but the dtypes), and the trial keeps them."""
    import dataclasses

    from determined_tpu_torch.trainer import profile

    b, cfg = profile.RUNGS[rung]
    want = jgpt.GPTConfig(**fields)
    assert b == batch
    for f in dataclasses.fields(want):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    trial = profile.RepeatedBatchTrial(b, 64, config=cfg)
    assert trial.config == dataclasses.replace(cfg, seq_len=64)
    assert tgpt.remat_attention(cfg) == (rung == "long32k")
