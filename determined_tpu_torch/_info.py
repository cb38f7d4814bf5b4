"""Container/process-side cluster contract: ``DTPU_*`` env vars → ClusterInfo.

A copy of ``determined_tpu/_info.py`` (the port imports nothing of the JAX
package). A task launched by the platform reads everything it needs —
master address, allocation/task identity, trial metadata, rendezvous
payload — from the environment; ``ClusterInfo.from_env()`` returns None
off-cluster, which is what routes ``core.init()`` into dummy mode.

The trial half is ``TrialInfo.from_env()``: the off-cluster harness
(``exec/harness.py``) reads the same trial variables that
``ClusterInfo.to_env()`` writes, without ``DTPU_MASTER``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RendezvousInfo:
    """Addresses + ranks for one multi-process allocation: the
    coordinator's address (``torch.distributed``'s rendezvous, one process
    per device) and this container's rank among ``num_processes``."""

    container_addrs: List[str]
    container_rank: int
    coordinator_address: str
    num_processes: int

    @property
    def process_index(self) -> int:
        return self.container_rank

    @property
    def local_rank(self) -> int:
        """This process's index among the gang's processes on its host
        (the ranks before it with the same address): the device it
        drives, ``cuda:<local_rank>``."""
        mine = self.container_addrs[self.container_rank]
        return sum(1 for a in self.container_addrs[:self.container_rank]
                   if a == mine)


@dataclasses.dataclass
class TrialInfo:
    trial_id: int
    experiment_id: int
    trial_seed: int
    hparams: Dict[str, Any]
    config: Dict[str, Any]
    latest_checkpoint: Optional[str]
    trial_run_id: int = 0

    @classmethod
    def from_env(cls) -> Optional["TrialInfo"]:
        """The trial's variables, or None without ``DTPU_TRIAL_ID``.
        ``DTPU_EXPERIMENT_ID`` defaults to 0: ``to_env`` always writes
        it, a hand-made off-cluster launch need not."""
        if "DTPU_TRIAL_ID" not in os.environ:
            return None
        return cls(
            trial_id=int(os.environ["DTPU_TRIAL_ID"]),
            experiment_id=int(os.environ.get("DTPU_EXPERIMENT_ID", "0")),
            trial_seed=int(os.environ.get("DTPU_TRIAL_SEED", "0")),
            hparams=json.loads(os.environ.get("DTPU_HPARAMS", "{}")),
            config=json.loads(os.environ.get("DTPU_EXPERIMENT_CONFIG", "{}")),
            latest_checkpoint=os.environ.get("DTPU_LATEST_CHECKPOINT") or None,
            trial_run_id=int(os.environ.get("DTPU_TRIAL_RUN_ID", "0")),
        )


@dataclasses.dataclass
class ClusterInfo:
    master_url: str
    cluster_id: str
    agent_id: str
    session_token: str
    task_id: str
    allocation_id: str
    task_type: str  # TRIAL | NOTEBOOK | SHELL | COMMAND | TENSORBOARD
    rendezvous: Optional[RendezvousInfo] = None
    trial: Optional[TrialInfo] = None
    checkpoint_storage: Optional[Dict[str, Any]] = None

    @classmethod
    def from_env(cls) -> Optional["ClusterInfo"]:
        master_url = os.environ.get("DTPU_MASTER")
        if master_url is None:
            return None
        rdzv = None
        if "DTPU_RENDEZVOUS_INFO" in os.environ:
            rdzv = RendezvousInfo(**json.loads(os.environ["DTPU_RENDEZVOUS_INFO"]))
        storage = None
        if "DTPU_CHECKPOINT_STORAGE" in os.environ:
            storage = json.loads(os.environ["DTPU_CHECKPOINT_STORAGE"])
        return cls(
            master_url=master_url,
            cluster_id=os.environ.get("DTPU_CLUSTER_ID", ""),
            agent_id=os.environ.get("DTPU_AGENT_ID", ""),
            session_token=os.environ.get("DTPU_SESSION_TOKEN", ""),
            task_id=os.environ.get("DTPU_TASK_ID", ""),
            allocation_id=os.environ.get("DTPU_ALLOCATION_ID", ""),
            task_type=os.environ.get("DTPU_TASK_TYPE", "TRIAL"),
            rendezvous=rdzv,
            trial=TrialInfo.from_env(),
            checkpoint_storage=storage,
        )

    def to_env(self) -> Dict[str, str]:
        """Inverse of from_env — used by the agent/launcher when spawning tasks."""
        env = {
            "DTPU_MASTER": self.master_url,
            "DTPU_CLUSTER_ID": self.cluster_id,
            "DTPU_AGENT_ID": self.agent_id,
            "DTPU_SESSION_TOKEN": self.session_token,
            "DTPU_TASK_ID": self.task_id,
            "DTPU_ALLOCATION_ID": self.allocation_id,
            "DTPU_TASK_TYPE": self.task_type,
        }
        if self.rendezvous is not None:
            env["DTPU_RENDEZVOUS_INFO"] = json.dumps(dataclasses.asdict(self.rendezvous))
        if self.trial is not None:
            t = self.trial
            env.update(
                DTPU_TRIAL_ID=str(t.trial_id),
                DTPU_EXPERIMENT_ID=str(t.experiment_id),
                DTPU_TRIAL_SEED=str(t.trial_seed),
                DTPU_HPARAMS=json.dumps(t.hparams),
                DTPU_EXPERIMENT_CONFIG=json.dumps(t.config),
                DTPU_TRIAL_RUN_ID=str(t.trial_run_id),
            )
            if t.latest_checkpoint:
                env["DTPU_LATEST_CHECKPOINT"] = t.latest_checkpoint
        if self.checkpoint_storage is not None:
            env["DTPU_CHECKPOINT_STORAGE"] = json.dumps(self.checkpoint_storage)
        return env


_info_cache: Optional[ClusterInfo] = None
_info_loaded = False


def get_cluster_info() -> Optional[ClusterInfo]:
    global _info_cache, _info_loaded
    if not _info_loaded:
        _info_cache = ClusterInfo.from_env()
        _info_loaded = True
    return _info_cache


def reset_cluster_info_cache() -> None:
    """Test hook: force re-read of env on next get_cluster_info()."""
    global _info_loaded
    _info_loaded = False
