"""The port's checkpoint storage (determined_tpu_torch.storage, .common,
.core's CheckpointContext): the reference's shared-filesystem behaviour
(tests/test_fault_matrix.py), run on the port's copies.

- data files land before the manifest, which is the commit point: an
  upload that dies leaves no manifest;
- a torn-write drill through the port's ``faults`` (error rate + one torn
  write) is retried and the checkpoint then verifies byte-exact;
- a truncated, tampered or missing file is refused on every read path,
  and a checkpoint with no manifest loads unverified;
- ``delete`` with paths prunes the manifest;
- ``from_config`` builds shared_fs and refuses gcs, s3 and azure by name;
- the retry policy's deterministic delays match the reference's;
- ``CheckpointContext.upload`` commits one manifest over the data files
  and ``metadata.json``, and the reference's manager verifies it.
"""
import os

import pytest

from determined_tpu.common.resilience import RetryPolicy as JRetryPolicy
from determined_tpu.storage.shared import SharedFSStorageManager as JShared
from determined_tpu_torch import core as tcore
from determined_tpu_torch.common import faults
from determined_tpu_torch.common.faults import FaultPlan, FaultSpec, InjectedFault
from determined_tpu_torch.common.resilience import STORAGE_RETRY, RetryPolicy
from determined_tpu_torch.storage import (
    CorruptCheckpointError,
    SharedFSStorageManager,
    from_config,
    verify_checkpoint_dir,
)
from determined_tpu_torch.storage.base import MANIFEST_FILE

#: Fast retries for fault drills: plenty of attempts, microscopic sleeps.
FAST_RETRY = RetryPolicy(max_attempts=10, base_delay=0.002, max_delay=0.01,
                         jitter=0.0)

CKPT_FILES = {
    "w0.npy": b"A" * 256,
    "w1.npy": b"B" * 1024,
    "nested/opt.bin": b"C" * 64,
    "metadata.json": b'{"steps_completed": 3}',
}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _write_tree(root, files):
    for rel, content in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(content)


def _uploaded(tmp_path, files=CKPT_FILES):
    mgr = SharedFSStorageManager(str(tmp_path / "store"),
                                 retry_policy=FAST_RETRY)
    _write_tree(str(tmp_path / "src"), files)
    mgr.upload(str(tmp_path / "src"), "ck")
    return mgr


def test_data_files_land_before_the_manifest(tmp_path):
    order = []

    class Recording(SharedFSStorageManager):
        def _upload_file(self, local_path, storage_id, rel):
            order.append(rel)
            super()._upload_file(local_path, storage_id, rel)

    mgr = Recording(str(tmp_path / "store"), retry_policy=FAST_RETRY)
    _write_tree(str(tmp_path / "src"), CKPT_FILES)
    digests = mgr.upload(str(tmp_path / "src"), "ck")
    assert order[-1] == MANIFEST_FILE
    assert sorted(order[:-1]) == sorted(CKPT_FILES) == sorted(digests)
    assert mgr.read_manifest("ck") == digests
    assert verify_checkpoint_dir(str(tmp_path / "store" / "ck"))


@pytest.mark.parametrize("seed", [0, 1])
def test_torn_write_drill_is_retried_and_verifies(tmp_path, seed):
    plan = FaultPlan({
        "storage.upload": FaultSpec(error_rate=0.3, torn_writes=1,
                                    torn_fraction=0.5),
        "storage.download": FaultSpec(error_rate=0.3),
    }, seed=seed)
    mgr = SharedFSStorageManager(str(tmp_path / "store"),
                                 retry_policy=FAST_RETRY)
    _write_tree(str(tmp_path / "src"), CKPT_FILES)
    with faults.plan_active(plan):
        mgr.upload(str(tmp_path / "src"), "ck")
        mgr.download("ck", str(tmp_path / "dst"))
    assert plan.stats()["storage.upload"]["torn"] == 1
    for rel, content in CKPT_FILES.items():
        assert (tmp_path / "dst" / rel).read_bytes() == content
    with mgr.restore_path("ck") as path:
        assert verify_checkpoint_dir(path)


def test_crash_mid_upload_never_commits(tmp_path):
    plan = FaultPlan({"storage.upload": FaultSpec(failures=10_000)})
    mgr = SharedFSStorageManager(
        str(tmp_path / "store"),
        retry_policy=RetryPolicy(max_attempts=3, base_delay=0.001,
                                 jitter=0.0),
    )
    _write_tree(str(tmp_path / "src"), CKPT_FILES)
    with faults.plan_active(plan), pytest.raises(InjectedFault):
        mgr.upload(str(tmp_path / "src"), "ck")
    assert MANIFEST_FILE not in mgr.list_files("ck")
    assert mgr.read_manifest("ck") is None


@pytest.mark.parametrize("damage,match", [
    ("truncate", "torn write"), ("tamper", "sha256"), ("remove", "missing"),
])
def test_damaged_file_is_refused_on_every_read_path(tmp_path, damage, match):
    mgr = _uploaded(tmp_path)
    victim = tmp_path / "store" / "ck" / "w1.npy"
    if damage == "truncate":
        victim.write_bytes(victim.read_bytes()[:100])
    elif damage == "tamper":
        victim.write_bytes(b"Z" * 1024)
    else:
        victim.unlink()
    with pytest.raises(CorruptCheckpointError, match=match):
        mgr.download("ck", str(tmp_path / "dst"))
    with pytest.raises(CorruptCheckpointError):
        with mgr.restore_path("ck"):
            pass
    with pytest.raises(CorruptCheckpointError):
        verify_checkpoint_dir(str(tmp_path / "store" / "ck"))


def test_partial_delete_prunes_the_manifest(tmp_path):
    mgr = _uploaded(tmp_path)
    assert mgr.delete("ck", paths=["w1.npy", "nested/opt.bin"]) == [
        "w1.npy", "nested/opt.bin"]
    assert sorted(mgr.read_manifest("ck")) == ["metadata.json", "w0.npy"]
    mgr.download("ck", str(tmp_path / "dst"))
    assert not (tmp_path / "dst" / "w1.npy").exists()
    with mgr.restore_path("ck") as path:
        assert verify_checkpoint_dir(path)
    assert sorted(mgr.delete("ck")) == sorted(
        ["metadata.json", "w0.npy", MANIFEST_FILE])
    assert mgr.list_files("ck") == [] and mgr.delete("ck") == []


def test_checkpoint_without_manifest_loads_unverified(tmp_path, caplog):
    _write_tree(str(tmp_path / "store" / "ck"), {"w.bin": b"legacy"})
    mgr = SharedFSStorageManager(str(tmp_path / "store"),
                                 retry_policy=FAST_RETRY)
    mgr.download("ck", str(tmp_path / "dst"))
    assert (tmp_path / "dst" / "w.bin").read_bytes() == b"legacy"
    with mgr.restore_path("ck") as path:
        assert os.path.exists(os.path.join(path, "w.bin"))
    assert not verify_checkpoint_dir(str(tmp_path / "store" / "ck"))
    assert "UNVERIFIED" in caplog.text
    with pytest.raises(FileNotFoundError):
        mgr.download("absent", str(tmp_path / "dst2"))
    with pytest.raises(FileNotFoundError):
        with mgr.restore_path("absent"):
            pass


@pytest.mark.parametrize("typ", ["gcs", "s3", "azure"])
def test_from_config_refuses_cloud_storage_by_name(typ):
    with pytest.raises(NotImplementedError, match=typ):
        from_config({"type": typ, "bucket": "b", "container": "c"})


def test_from_config_builds_shared_fs(tmp_path):
    mgr = from_config({"type": "shared_fs", "host_path": str(tmp_path)})
    assert isinstance(mgr, SharedFSStorageManager)
    assert mgr.base_path == str(tmp_path)
    assert from_config(None, base_dir=str(tmp_path)).base_path == str(tmp_path)
    with pytest.raises(ValueError, match="unknown"):
        from_config({"type": "tape"})


def test_retry_delays_match_the_reference():
    ref = JRetryPolicy(max_attempts=8, base_delay=0.05, max_delay=2.0,
                       deadline_s=120.0)
    for attempt in range(10):
        assert STORAGE_RETRY.delay(attempt, key="storage.upload") == \
            ref.delay(attempt, key="storage.upload")
    sleeps = []
    calls = iter([OSError("flaky"), OSError("flaky"), "ok"])

    def fn():
        x = next(calls)
        if isinstance(x, Exception):
            raise x
        return x

    assert FAST_RETRY.call(fn, sleep=sleeps.append) == "ok"
    assert len(sleeps) == 2
    with pytest.raises(FileNotFoundError):  # deterministic: no retry
        FAST_RETRY.call(lambda: open("/nonexistent/x"), sleep=sleeps.append)
    assert len(sleeps) == 2


def test_checkpoint_context_commits_one_manifest(tmp_path):
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path / "store"))
    _write_tree(str(tmp_path / "src"), {"a.npy": b"a" * 10, "b.npy": b"b"})
    sid = ctx.checkpoint.upload(str(tmp_path / "src"),
                                metadata={"steps_completed": 7}, shard=True)
    root = tmp_path / "store" / sid
    assert sorted(os.listdir(root)) == ["a.npy", "b.npy", "manifest.json",
                                        "metadata.json"]
    assert ctx.checkpoint.get_metadata(sid) == {"steps_completed": 7}
    assert ctx.checkpoint.restore_candidates(sid) == [sid]
    assert ctx.checkpoint.restore_candidates(None) == []
    with JShared(str(tmp_path / "store")).restore_path(sid) as path:
        assert sorted(os.listdir(path)) == sorted(os.listdir(root))
    ctx.checkpoint.download(sid, str(tmp_path / "dst"))
    assert (tmp_path / "dst" / "a.npy").read_bytes() == b"a" * 10
    ctx.checkpoint.delete(sid)
    assert not root.exists()
    with pytest.raises(ValueError, match="conflicting"):
        tcore.merge_metadata([{"a": 1}, {"a": 2}])
