"""The elastic resize in the port: a sharded checkpoint restored onto
another layout, and the in-place resize loop, against the reference.

- The reference's ``TestReshardRestore`` (``tests/test_elastic.py``) on
  the port's ``load_pytree(shardings=)``: a save of 8 row shards restored
  bitwise onto 4 and 2 ranks' regions, and a hole raising
  ``CorruptCheckpointError``.
- A gang of two port processes (gloo) saves at ``fsdp=2``, ``tensor=2``
  and ``context=2``, and resumes each save at the layout that wrote it;
  one rank (no mesh) restores the same checkpoints: the state the
  reference's ``load_pytree`` reads from the files, bitwise, and the next
  two losses of the resume at the saved layout within 1e-5 relative.
- The reference's acceptance drill (``TestElasticDrill.
  test_reclaim_one_rank_resizes_in_place``) with a port trial: a
  ``DevCluster`` of two agents runs a GPT-tiny trial on ``fsdp=2`` over
  gloo, ``agent.reclaim.rank1`` SIGKILLs rank 1 mid-training, and the
  survivor leaves its failed step by ``ElasticResizeExit``, re-enters the
  rendezvous under the new generation, refits the mesh to one rank,
  restores the last verified checkpoint onto it and trains to the
  target: the reference drill's assertions.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from determined_tpu_torch.storage.base import CorruptCheckpointError
from determined_tpu_torch.trainer import _checkpoint as ckpt_io

ROOT = Path(__file__).resolve().parent.parent
KW = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
          seq_len=32, remat=False)
LAYOUTS = {"fsdp2": dict(fsdp=2), "tensor2": dict(tensor=2),
           "context2": dict(context=2)}
JOIN_S = 150


# ---------------------------------------------------------------------------
# Reshard-on-restore: the reference's 8-way save onto fewer ranks
# ---------------------------------------------------------------------------
class TestReshardRestore:
    @staticmethod
    def _reference():
        rng = np.random.default_rng(7)
        return {
            "w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32),
            "scalar": np.float32(3.5),
        }

    @staticmethod
    def _write_8way(tree, directory):
        """An 8-host sharded save: each leaf split into 8 row shards named
        ``{leaf}.shard<starts>.npy``, as the reference's test writes it."""
        os.makedirs(directory, exist_ok=True)
        w, b = tree["w"], tree["b"]
        for i in range(8):
            np.save(os.path.join(directory, f"w.shard{i * 2}_0.npy"),
                    w[i * 2:(i + 1) * 2])
            np.save(os.path.join(directory, f"b.shard{i * 2}.npy"),
                    b[i * 2:(i + 1) * 2])
        np.save(os.path.join(directory, "scalar.npy"), tree["scalar"])
        with open(os.path.join(directory, "tree.json"), "w") as f:
            json.dump({"structure": "keypath-flat-v1"}, f)

    @staticmethod
    def _restore_on(directory, tree, n, rank):
        """Rank `rank` of `n` restores its rows of "w" and "b" (split
        over the data axis, as the reference's ``P("data")``) and the
        whole scalar."""
        like = {k: torch.zeros(np.shape(v)) for k, v in tree.items()}
        rows = 16 // n
        region = (rank * rows, (rank + 1) * rows)
        shardings = {
            "w": ckpt_io.Placement((16, 8), (region, (0, 8))),
            "b": ckpt_io.Placement((16,), (region,)),
            "scalar": None,
        }
        return ckpt_io.load_pytree(directory, like, shardings)

    @pytest.mark.parametrize("n_ranks", [4, 2])
    def test_8way_save_restores_onto_smaller_mesh(self, tmp_path, n_ranks):
        ref = self._reference()
        d = str(tmp_path / "ckpt")
        self._write_8way(ref, d)
        rows = 16 // n_ranks
        for rank in range(n_ranks):
            got = self._restore_on(d, ref, n_ranks, rank)
            lo, hi = rank * rows, (rank + 1) * rows
            # bitwise: the region reads stitch the shard files exactly
            assert np.array_equal(got["w"].numpy(), ref["w"][lo:hi])
            assert np.array_equal(got["b"].numpy(), ref["b"][lo:hi])
            assert got["scalar"].dtype == torch.float32
            assert float(got["scalar"]) == float(ref["scalar"])

    def test_incomplete_shard_set_raises(self, tmp_path):
        ref = self._reference()
        d = str(tmp_path / "ckpt")
        self._write_8way(ref, d)
        os.remove(os.path.join(d, "w.shard6_0.npy"))
        with pytest.raises(CorruptCheckpointError):
            self._restore_on(d, ref, 2, 0)
        # the other half of the rows does not need the missing file
        got = self._restore_on(d, ref, 2, 1)
        assert np.array_equal(got["w"].numpy(), ref["w"][8:])


# ---------------------------------------------------------------------------
# A gang's saves on three layouts, restored onto one rank
# ---------------------------------------------------------------------------
def _stream():
    rng = np.random.default_rng(7)
    while True:
        yield {"tokens": rng.integers(0, 128, (4, 32)).astype(np.int32)}


def _trial_class():
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer import TorchTrial, optim

    class Trial(TorchTrial):
        def build_model(self, device, mesh=None):
            return gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW),
                           device=device, mesh=mesh, seed=5)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(1.0),
                               optim.adamw(1e-3))

        def build_training_data(self):
            return _stream()

    return Trial


def _losses(trainer, steps, **kw):
    from determined_tpu_torch.trainer import Batch

    seen = []
    flush = trainer._flush

    def recording(pending, t_start):
        agg, reason = flush(pending, t_start)
        seen.append(agg["loss"])
        return agg, reason

    trainer._flush = recording
    trainer.fit(max_length=Batch(steps), report_period=Batch(1), **kw)
    return seen


def worker(rank: int, store: str, out: str) -> None:
    """One rank of the gang of two: per layout, 2 steps with a save at
    step 2, then a fresh trainer at the same layout resumes it to step
    4."""
    import datetime

    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.trainer import Batch, Trainer

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=2)
    Trial = _trial_class()
    res = {}
    for name, axes in LAYOUTS.items():
        storage = os.path.join(out, name)
        mesh = make_mesh(MeshConfig(data=1, **axes), device="cpu")
        ctx = core._dummy_init(distributed=dctx, checkpoint_storage=storage)
        saver = Trainer(Trial(), ctx, device="cpu", mesh=mesh)
        saver.fit(max_length=Batch(2), checkpoint_period=Batch(2))
        resumed = Trainer(Trial(), ctx, device="cpu", mesh=mesh)
        res[name] = {"id": saver._last_ckpt_id,
                     "resumed": _losses(resumed, 4,
                                        latest_checkpoint=saver._last_ckpt_id)}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic-saves")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    procs = []
    for rank in range(2):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(rank), str(tmp / "store"),
             str(tmp)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
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
    with open(tmp / "rank0.json") as fh:
        return tmp, json.load(fh)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_gang_save_restores_onto_one_rank(saves, layout):
    import jax

    from determined_tpu.trainer import _checkpoint as jckpt
    from determined_tpu_torch import core
    from determined_tpu_torch.trainer import Trainer

    tmp, res = saves
    storage = str(tmp / layout)
    ctx = core._dummy_init(checkpoint_storage=storage)
    one = Trainer(_trial_class()(), ctx, device="cpu")
    one._restore_with_fallback(res[layout]["id"])
    assert one.steps_completed == 2
    # the state is what the reference reads from the same files
    view = one._state_view()
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.asarray(t).dtype),
                        {k: v for k, v in view.items()},
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = jckpt.load_pytree(os.path.join(storage, res[layout]["id"]), like)
    for (path, got), (_, ref) in zip(
            ckpt_io._flatten_with_path(view),
            ckpt_io._flatten_with_path(jax.device_get(want))):
        assert np.array_equal(got.numpy(), np.asarray(ref)), path
    # and it trains on as the save's own layout does
    np.testing.assert_allclose(_losses(one, 4), res[layout]["resumed"],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The drill: reclaim one rank of a live gang of two
# ---------------------------------------------------------------------------
def _drill_config(tmp_path):
    return {
        "entrypoint": ("env DTPU_ENTRYPOINT=determined_tpu_torch.exec."
                       "builtin_trials:SyntheticTrial python -m "
                       "determined_tpu_torch.exec.harness"),
        "searcher": {"name": "single", "max_length": 24, "metric": "loss"},
        "hyperparameters": {"model": "gpt-tiny", "batch_size": 4,
                            "seq_len": 32, "lr": 1e-3, "sleep_s": 0.3,
                            "mesh": {"data": 1, "fsdp": 2}},
        "resources": {"slots_per_trial": 2},
        "scheduling_unit": 2,
        "min_checkpoint_period": {"batches": 2},
        "checkpoint_storage": {"type": "shared_fs",
                               "host_path": str(tmp_path / "ckpt")},
        "tensorboard": False,
        "environment": {"jax_platform": "cpu", "variables": {
            "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}},
        "max_restarts": 1,
        "elastic": {"enabled": True},
    }


def _wait_training_underway(dc, exp_id, timeout=240.0):
    """A verified checkpoint and two training reports: the reclaim must
    land mid-training, after a restore point exists."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        trials = dc.master.db.list_trials(exp_id)
        if trials:
            rows = dc.master.db.get_metrics(trials[0]["id"], "training")
            if trials[0].get("latest_checkpoint") and len(rows) >= 2:
                return trials[0]["id"]
        time.sleep(0.3)
    raise AssertionError("the trial never got training underway")


def test_reclaim_one_rank_resizes_in_place(tmp_path):
    from determined_tpu.common import faults
    from determined_tpu.devcluster import DevCluster

    faults.clear()
    try:
        with DevCluster(n_agents=2, slots_per_agent=1) as dc:
            exp_id = dc.create_experiment(_drill_config(tmp_path))
            trial_id = _wait_training_underway(dc, exp_id)
            faults.install(faults.FaultPlan(
                {"agent.reclaim.rank1": faults.FaultSpec(failures=1)}))
            state = dc.wait_experiment(exp_id, timeout=300)
            trial = dc.master.db.list_trials(exp_id)[0]
            alloc = dc.master.alloc_service.get(f"{exp_id}.{trial_id}.0")
            rows = dc.master.db.get_metrics(trial_id, "profiling")
            assert state == "COMPLETED", (state, trial)
            # the same run survived: no restart, no requeue
            assert trial["run_id"] == 0
            assert trial["restarts"] == 0
            assert trial["infra_requeues"] == 0
            assert trial["state"] == "COMPLETED"
            assert trial["steps_completed"] == 24
            assert alloc is not None
            assert alloc.generation >= 1       # a resize happened
            assert alloc.num_processes == 1    # on the shrunk mesh
            assert alloc.exit_code == 0
            ledger = rows[-1]["body"]
            assert ledger["ledger_resizes"] >= 1
            assert ledger["resize_lost_s"] > 0
            assert ledger["ledger_restarts"] == 0
            assert ledger["goodput_pct"] < 100.0
    finally:
        faults.clear()


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
