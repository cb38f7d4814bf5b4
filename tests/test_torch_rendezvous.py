"""A gang's launch: the rendezvous and the harness (the port's exec layer
for more than one process).

- ``prep_and_run.rendezvous`` for 2 processes against the reference
  master's own allocation routes (a ``DevCluster`` without agents, in
  this process): two port processes, and a port chief beside a reference
  worker (``determined_tpu.exec.prep_and_run``), each reading the same
  table: the chief's coordinator address and port, every rank its own.
- The generation fence: a 409 carrying a resize directive re-maps the
  rank and retries under the new generation; a dropped rank exits 0.
  ``apply_resize`` is refused by name (the elastic slice).
- A gang of 2 launched as ``python -m determined_tpu_torch.exec.harness``
  with the rendezvous variables, against ``chip_smoke.StandInMaster``:
  ``gpt-tiny`` on an ``fsdp=2`` mesh over gloo through the master's
  searcher operation, metrics, heartbeats from both ranks, sharded
  checkpoints registered by the chief and verified on disk, the audit
  every 2 steps; and the same with no ``mesh`` section (the Trainer's
  default mesh, data over the gang) under the ``train.divergence.rank1``
  drill: both ranks exit 1 and each POSTs the reference's divergence
  event (``{"event": "divergence", "detail": ...}``).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from determined_tpu.devcluster import DevCluster
from determined_tpu_torch import _info as tinfo
from determined_tpu_torch.common.api_session import HTTPError, Response
from determined_tpu_torch.exec import prep_and_run

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

RDZV_KEYS = ("DTPU_RENDEZVOUS_INFO", "DTPU_CHIEF_PORT", "DTPU_ALLOC_GENERATION")
ARRIVE = (
    "import json, os, sys\n"
    "from {pkg}.exec.prep_and_run import rendezvous\n"
    "rendezvous(sys.argv[1], sys.argv[2], int(sys.argv[3]), 2)\n"
    "print(json.dumps({{k: os.environ.get(k) for k in {keys!r}}}))\n"
)


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("DTPU_")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rendezvous_of_two_against_the_reference_master():
    with DevCluster(n_agents=0) as dc:
        url = dc.api.url
        runs = {"port-port": ("determined_tpu_torch", "determined_tpu_torch"),
                "port-reference": ("determined_tpu_torch", "determined_tpu")}
        procs = {}
        for alloc, pkgs in runs.items():
            dc.master.alloc_service.create(alloc, task_id=alloc, trial_id=None,
                                           num_processes=2, slots=2)
            procs[alloc] = [subprocess.Popen(
                [sys.executable, "-c", ARRIVE.format(pkg=pkg, keys=RDZV_KEYS),
                 url, alloc, str(rank)], cwd=ROOT, env=_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for rank, pkg in enumerate(pkgs)]
        outs = {alloc: [p.communicate(timeout=60) for p in ps]
                for alloc, ps in procs.items()}
    for alloc, ps in procs.items():
        assert [p.returncode for p in ps] == [0, 0], outs[alloc]
        envs = [json.loads(out.strip().splitlines()[-1])
                for out, _ in outs[alloc]]
        infos = [json.loads(e["DTPU_RENDEZVOUS_INFO"]) for e in envs]
        assert [i["container_rank"] for i in infos] == [0, 1]
        assert all(i["num_processes"] == 2 for i in infos)
        assert infos[0]["coordinator_address"] == \
            infos[1]["coordinator_address"]
        assert infos[0]["container_addrs"] == infos[1]["container_addrs"]
        assert len(infos[0]["container_addrs"]) == 2
        assert envs[0]["DTPU_CHIEF_PORT"] == envs[1]["DTPU_CHIEF_PORT"]
        assert {e["DTPU_ALLOC_GENERATION"] for e in envs} == {"0"}
        rdzv = tinfo.RendezvousInfo(**infos[1])
        assert rdzv.process_index == 1 and rdzv.local_rank == 1


def _fenced(directive):
    body = json.dumps({"resync": True, "generation": 1,
                       "resize": directive}).encode()
    return HTTPError("409 stale generation",
                     response=Response(409, {}, body))


def test_the_generation_fence_remaps_or_drops_the_rank(monkeypatch):
    rounds = []

    def round_(master_url, alloc_id, rank, num_procs, generation):
        rounds.append((rank, num_procs, generation))
        if len(rounds) == 1:
            raise _fenced({"rank_map": {"1": 0, "0": 1}, "num_processes": 3,
                           "generation": 1})

    monkeypatch.setattr(prep_and_run, "_rendezvous_round", round_)
    monkeypatch.setenv("DTPU_ALLOC_RANK", "1")
    monkeypatch.setenv("DTPU_ALLOC_NUM_PROCS", "2")
    prep_and_run.rendezvous("http://m", "a", 1, 2)
    assert rounds == [(1, 2, 0), (0, 3, 1)]
    assert os.environ["DTPU_ALLOC_RANK"] == "0"
    assert os.environ["DTPU_ALLOC_NUM_PROCS"] == "3"

    def dropped(*args):
        raise _fenced({"rank_map": {"0": 0}, "num_processes": 1,
                       "generation": 1})

    monkeypatch.setattr(prep_and_run, "_rendezvous_round", dropped)
    with pytest.raises(SystemExit) as exit_:
        prep_and_run.rendezvous("http://m", "a", 1, 2)
    assert exit_.value.code == 0

    # apply_resize: the harness's re-entry after an elastic resize
    rounds.clear()
    monkeypatch.setattr(prep_and_run, "_rendezvous_round", round_)
    rounds.append("primed")  # no fence this time
    monkeypatch.setenv("DTPU_ALLOC_RANK", "2")
    monkeypatch.setenv("DTPU_ALLOCATION_ID", "a")
    directive = {"generation": 4, "num_processes": 2,
                 "rank_map": {"0": 0, "2": 1}}
    assert prep_and_run.apply_resize("http://m", directive) is True
    assert rounds[1:] == [(1, 2, 4)]
    assert (os.environ["DTPU_ALLOC_RANK"],
            os.environ["DTPU_ALLOC_NUM_PROCS"]) == ("1", "2")
    monkeypatch.setenv("DTPU_ALLOC_RANK", "1")
    assert prep_and_run.apply_resize("http://m", directive) is False
    with pytest.raises(RuntimeError, match="could not map rank 1"):
        prep_and_run.apply_resize("http://m", dict(
            directive, rank_map={}, resync_only=True))
    from determined_tpu_torch.common import faults

    monkeypatch.setenv("DTPU_ALLOC_RANK", "0")
    with faults.plan_active(faults.FaultPlan(
            {"resize.rendezvous": faults.FaultSpec(failures=1)})):
        with pytest.raises(faults.InjectedFault):
            prep_and_run.apply_resize("http://m", directive)
    assert rounds[1:] == [(1, 2, 4)]  # the failed re-entry ran no round


def _gang_env(stand_in, tmp, trial_id, alloc, port, rank, mesh, **extra):
    hparams = {"model": "gpt-tiny", "batch_size": 4, "seq_len": 32}
    if mesh:
        hparams["mesh"] = mesh
    config = {"searcher": {"name": "single", "metric": "loss"},
              "min_checkpoint_period": {"batches": 2}, "scheduling_unit": 1,
              "tensorboard": False,
              "health": {"divergence_check_period": 2}}
    env = _env()
    env.update(tinfo.ClusterInfo(
        master_url=stand_in.url, cluster_id="c", agent_id="a",
        session_token="tok", task_id=f"trial-{trial_id}",
        allocation_id=alloc, task_type="TRIAL",
        rendezvous=tinfo.RendezvousInfo(
            container_addrs=["127.0.0.1", "127.0.0.1"], container_rank=rank,
            coordinator_address=f"127.0.0.1:{port}", num_processes=2),
        trial=tinfo.TrialInfo(trial_id=trial_id, experiment_id=1,
                              trial_seed=0, hparams=hparams, config=config,
                              latest_checkpoint=None),
        checkpoint_storage={"type": "shared_fs",
                            "host_path": str(tmp / "ckpt")}).to_env())
    env.update(DTPU_JAX_PLATFORM="cpu", DTPU_ALLOC_RANK=str(rank),
               DTPU_ALLOC_NUM_PROCS="2", TMPDIR=str(tmp), OMP_NUM_THREADS="1",
               DTPU_ENTRYPOINT="determined_tpu_torch.exec.builtin_trials"
                               ":SyntheticTrial", **extra)
    return env


def test_a_gang_of_two_through_the_harness(tmp_path):
    from determined_tpu_torch.storage.base import verify_checkpoint_dir

    stand_in = chip_smoke.StandInMaster(op_length=4)
    stand_in.rendezvous_size = 2
    drill = json.dumps({"train.divergence.rank1": {"failures": 1}})
    runs = {1: ("1.1.0", {"data": 1, "fsdp": 2}, {}),
            2: ("2.1.0", None, {"DTPU_FAULT_PLAN": drill})}
    procs = {}
    try:
        for trial_id, (alloc, mesh, extra) in runs.items():
            port = _free_port()
            procs[trial_id] = [subprocess.Popen(
                [sys.executable, "-m", "determined_tpu_torch.exec.harness"],
                cwd=ROOT, env=_gang_env(stand_in, tmp_path, trial_id, alloc,
                                        port, rank, mesh, **extra),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for rank in range(2)]
        outs = {t: [p.communicate(timeout=120)[1] for p in ps]
                for t, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        stand_in.stop()
    # the clean gang: exit 0 on both ranks, the searcher's op done
    assert [p.returncode for p in procs[1]] == [0, 0], outs[1][0][-3000:]
    assert stand_in.completed[1]["length"] == 4
    steps = [b["steps_completed"] for _, path, _, b in stand_in.requests
             if path == "/api/v1/trials/1/metrics"
             and b["group"] == "training"]
    assert steps == [1, 2, 3, 4]
    beats = {b["rank"] for _, path, _, b in stand_in.requests
             if path == "/api/v1/allocations/1.1.0/progress"}
    assert beats == {0, 1}
    ckpts = {u: b for u, b in stand_in.checkpoints.items()
             if b["trial_id"] == 1}
    assert sorted(b["metadata"]["steps_completed"]
                  for b in ckpts.values()) == [2, 4]
    for uuid_, body in ckpts.items():
        assert verify_checkpoint_dir(str(tmp_path / "ckpt" / uuid_))
        files = set(body["resources"])
        # wqkv is split over fsdp on its "embed" dimension: one file a rank
        assert {"params__blocks__wqkv.shard0_0_0_0_0.npy",
                "params__blocks__wqkv.shard0_32_0_0_0.npy",
                "params__blocks__bqkv.npy", "trainer_state.json",
                "metadata.json", "manifest.json"} <= files
    # the drill: both ranks exit 1 and report the divergence, naming rank 1
    assert [p.returncode for p in procs[2]] == [1, 1], outs[2][0][-3000:]
    events = [b for m, path, _, b in stand_in.requests
              if path == "/api/v1/trials/2/status"]
    assert len(events) == 2
    for body in events:
        # two holders of each replicated block: no majority, so both are
        # named (four ranks name the minority alone: test_torch_gang.py)
        assert body["event"] == "divergence"
        assert "across 2 replicas; suspect rank 0 device cpu, rank 1 " \
            "device cpu" in body["detail"]
    assert all("ReplicaDivergenceError" in err for err in outs[2])
