"""Trainer: the training loop that drives a TorchTrial.

Port of ``determined_tpu/trainer/_trainer.py``. Same control shape — iterate searcher ops,
train to each op's length with periodic validation, checkpoint and
report boundaries — and the same step:

- loss × poison (1.0 outside fault drills, ``_sentinel.poison_factor``)
  → backward → the global norm of the RAW gradients → the trial's
  optimizer chain (``trainer.optim``) → the non-finite guard
  (``_sentinel.guarded_update``), which keeps the parameters and the
  optimizer state of a step whose loss or gradient norm is not finite;
- metrics stay on the device between report boundaries: a flush
  materializes the window's metrics in one transfer, runs the health
  sentinel over them (skip count, the consecutive-skip cap, the
  loss-spike detector) and reports each metric averaged over its FINITE
  values, with ``batches_per_second`` and the cumulative
  ``steps_skipped`` and ``rollbacks``;
- a sentinel verdict rolls back at the next report boundary: restore the
  last checkpoint that finished uploading and leave the data stream
  where it is, so the poisoned window is skipped for good
  (``_data_offset``, persisted in the checkpoint);
- the step-phase timeline and goodput ledger (``_timeline.py``) settle
  at each flush and ride the ``profiling`` report group; the
  ``ProfilerAgent`` (``profiling=True``) adds system and card-memory
  samples there, and ``tensorboard_dir`` gets the scalars as tfevents;
- validation runs ``model.eval_metrics`` under ``torch.no_grad()`` and
  averages over batches.

Checkpoints are the reference's on-disk format (``trainer/_checkpoint.py``):
``fit(checkpoint_period=...)`` saves the named state view (``step``,
``params``, ``opt_state``) plus ``trainer_state.json`` (seed, data offset,
the goodput ledger) at each period, at preemption and at the end; the
device→host snapshot blocks the step loop, the files and the upload run
on a background writer. ``fit(latest_checkpoint=...)`` verifies and
restores one (a JAX-written one too) and fast-forwards the data stream
past the batches it consumed.

On a cluster (``core.init()``'s live contexts) the loop also carries the
platform's telemetry, as the reference does: the ``trial.fit`` span
around the loop and the ``trial.first_step`` span (fit start → the first
step's return, the lifecycle trace's anchor); ``profiling.set_phase``
tags (``data_wait``, ``h2d_put``, ``step``, ``report``, ``checkpoint``)
for the sampling profiler; and the operator's profile capture, which
arrives on the heartbeat: at the next report boundary a bounded
``torch.profiler`` trace (``profiler.torch_profiler_trace``) starts,
covers the directive's ``steps``, is uploaded through the trial's storage
manager as ``profile-capture-<id>`` and reported on ``POST
/api/v1/profiles/captures/<id>/complete``.

On a device mesh (``mesh=``, a ``DeviceMesh`` over the reference's six
axes from ``parallel.make_mesh``; ``trainer/_mesh.py``; in
a gang of more than one process without one, as in the reference, the
default ``MeshConfig()``: data over the whole gang) every rank of the
gang runs this loop on its rows of each global batch, and on a context
axis its chunk of the sequence (attention by ring or Ulysses): the
parameters and the optimizer state are split over fsdp, over tensor
where the model holds tensor slices (``tensor_dims``, Megatron's splits
of ``parallel/tensor.py``) and over expert where it holds its experts'
(``expert_dims``, ``parallel/experts.py``), by the model's
``logical_axes()`` through the sharding ``rules``; a pipelined model's
stages (``parallel/pipeline.py``) compute their own parts of the
gradient, summed over the pipeline axis; the loss is the global token
mean, and
every decision (the guard, the spike detector, rollback-and-skip, the
reports, the searcher's progress, the checkpoint's ``storage_id``) is
taken from values that are equal on every rank. Checkpoints are sharded
as the reference's multi-host ones (``trainer/_checkpoint.py``), the
upload a collective that broadcasts one ``storage_id`` (the agreed
rollback target), and a restore is agreed by all ranks or by none
(``_restore_with_fallback``). ``health.divergence_check_period`` runs
the replica-divergence audit (``_divergence_audit``). Each rank draws
from its own generator, seeded before every step from (seed, rank,
step), as the reference's ``fold_in(base_rng, step)``.

An elastic resize (the master shrank or grew the gang in place: a
directive on the heartbeat's or the preemption poll's answer, folded into
the boundary's broadcast) leaves ``fit`` at the next report boundary by
``ElasticResizeExit``, carrying the directive and the last verified
checkpoint; so does a step whose collective failed because a peer died,
when the master has a directive pending (``directive_after_failure``). The
harness rebuilds the gang, the mesh and a Trainer with
``resume_event="resize"``, which restores that checkpoint onto its own
layout and charges the drain→resume gap to the ledger's
``resize_lost_s``.

The step runs on CUDA unless the caller passes ``device="cpu"``. Refused
by name: a mesh the port leaves out (an expert axis beside a pipeline
axis above 1, as the reference) and the orbax checkpoint format (it needs
JAX).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.common import faults
from determined_tpu_torch.common import logship as logship_mod
from determined_tpu_torch.common import profiling as profiling_mod
from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.core._searcher import DummySearcherContext
from determined_tpu_torch.models.base import Model
from determined_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from determined_tpu_torch.parallel.sharding import DEFAULT_RULES, ShardingRules
from determined_tpu_torch.profiler import ProfilerAgent, torch_profiler_trace
from determined_tpu_torch.storage.base import CorruptCheckpointError
from determined_tpu_torch.tensorboard import EventFileWriter, TensorboardManager
from determined_tpu_torch.trainer import _checkpoint as ckpt_io
from determined_tpu_torch.trainer import _sentinel, _timeline, optim
from determined_tpu_torch.trainer._mesh import MeshLayout, preshift, rank_seed
from determined_tpu_torch.trainer._trial import TorchTrial, build_model
from determined_tpu_torch.trainer._units import Batch, TrainUnit, to_batches

logger = logging.getLogger("determined_tpu_torch.trainer")

TRAINER_METADATA = "trainer_state.json"
ORBAX_SUBDIR = "orbax"  # presence marks an orbax/ocdbt-format checkpoint


class ElasticResizeExit(Exception):
    """Out of ``Trainer.fit``: the master resized the gang. The harness
    (``exec/harness.py``) catches it, re-enters the rendezvous under the
    directive's generation, rebuilds the gang, the mesh and the Trainer
    in the same process and resumes from `restore_from` onto the new
    layout.

    `dropped`: this rank is absent from the directive's ``rank_map``; it
    was resized away and exits cleanly instead of re-entering."""

    def __init__(self, directive: Dict[str, Any], *, dropped: bool,
                 restore_from: Optional[str]) -> None:
        super().__init__(
            f"elastic resize to generation {directive.get('generation')} "
            f"({directive.get('num_processes')} processes)")
        self.directive = directive
        self.dropped = dropped
        self.restore_from = restore_from


class Trainer:
    def __init__(
        self,
        trial: TorchTrial,
        core_context: Optional[core_mod.Context] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        searcher_metric: str = "loss",
        smaller_is_better: bool = True,
        profiling: bool = False,
        tensorboard_dir: Optional[str] = None,
        health: Optional[Dict[str, Any]] = None,
        resume_event: str = "restart",
        mesh: Any = None,
        rules: ShardingRules = DEFAULT_RULES,
        checkpoint_format: str = "npy",
    ) -> None:
        if checkpoint_format == "orbax":
            raise NotImplementedError(
                "checkpoint_format='orbax' needs orbax, a JAX library; the "
                "port writes the reference's 'npy' format"
            )
        if checkpoint_format != "npy":
            raise ValueError(
                f"checkpoint_format {checkpoint_format!r} (one of: npy, orbax)"
            )
        if mesh is not None:
            from determined_tpu_torch.parallel.mesh import refuse_later_axes

            refuse_later_axes(mesh)
        if resume_event not in ("restart", "resize"):
            raise ValueError(
                f"resume_event {resume_event!r} (one of: restart, resize)"
            )
        #: how the ledger classes the save→resume gap of the first
        #: restore: "restart" (a new process) or "resize" (the harness
        #: rebuilt this Trainer after an elastic resize)
        self._resume_event = resume_event
        self.sentinel = _sentinel.SentinelConfig.from_config(health)
        self.trial = trial
        self.device = resolve_device(device)
        self.core = core_context or core_mod.init()
        if mesh is None and self.core.distributed.size > 1:
            # As the reference: the default mesh (data over the whole gang).
            mesh = make_mesh(MeshConfig(), device=self.device.type)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh for a trainer on {self.device}")
        self.mesh = mesh
        self.rules = rules
        self.seed = seed
        self.searcher_metric = searcher_metric
        #: stored as the reference does; only the cluster's searcher
        #: ranks by it, and nothing in the loop reads it.
        self.smaller_is_better = smaller_is_better
        self._spike = _sentinel.SpikeDetector(self.sentinel)

        torch.manual_seed(seed)
        self.model: Model = build_model(trial, self.device, mesh)
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        self._names = [n for n, _ in named]
        #: the trained state: the model's parameters; on a mesh each holds
        #: this rank's block of itself (``MeshLayout.shard_parameters``).
        self._params = [p for _, p in named]
        for p in self._params:
            if p.device != self.device:
                raise ValueError(
                    f"build_model put a parameter on {p.device}; the "
                    f"trainer runs on {self.device}"
                )
        self._layout: Optional[MeshLayout] = None
        #: how the step sees the split parameters whole (``_gathering``)
        self._gathers_at_use = False
        rank = self.core.distributed.rank if mesh is not None else 0
        if mesh is not None:
            self._layout = MeshLayout(
                mesh, rules, self.model.logical_axes(), named,
                getattr(self.model, "tensor_dims", dict)(),
                getattr(self.model, "expert_dims", dict)(),
                bool(getattr(self.model, "pipelined", False)))
            # every rank starts from rank 0's parameters, then keeps its
            # blocks alone
            self._layout.broadcast_from_rank0(self._params)
            self._layout.shard_parameters(self._params)
            if self._layout.split_dims:
                self._gathers_at_use = self.model.gather_at_use(self._layout)
        self._tx = trial.build_optimizer()
        self._opt_state = self._tx.init([p.detach() for p in self._params])
        # Passed to model.loss (the generative models draw their noise
        # from it) and seeded anew before every step from (seed, step), on
        # a mesh (seed, rank, step): as the reference's step RNG,
        # fold_in(base_rng, step), the draws are a function of the step
        # alone, so a resumed run draws what the uninterrupted one drew
        # and a checkpoint holds no generator state.
        self._seed_parts = (seed, rank) if mesh is not None else (seed,)
        self._generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, rank) if mesh is not None else seed)
        self._step = 0
        self._ckpt_writer = ckpt_io.AsyncCheckpointWriter()
        self._steps_skipped = 0     # lifetime non-finite skips (host view)
        self._rollbacks = 0         # sentinel rollback-and-skip count
        self._skips = torch.zeros((), dtype=torch.int32, device=self.device)
        #: the last checkpoint that finished uploading or was restored —
        #: the rollback target. Set on the writer thread after the upload.
        self._last_ckpt_id: Optional[str] = None
        #: batches the data stream is ahead of the step counter: the
        #: poisoned windows that rollbacks skipped. Persisted in the
        #: trainer metadata, so a resumed run fast-forwards identically.
        self._data_offset = 0
        self._data_consumed = 0     # absolute batch cursor (fit-local)
        self._last_throughput = 0.0
        #: step phases + goodput ledger; the ledger rides the checkpoint.
        self.timeline = _timeline.Timeline()
        #: a rollback restore must NOT reload the checkpoint's ledger: the
        #: in-memory one is newer (it is about to record this rollback).
        self._restoring_for_rollback = False
        self._sentinel_reason: Optional[str] = None
        self._step_flops: Optional[float] = None
        # The operator-triggered torch.profiler capture in flight.
        self._capture_cm: Any = None
        self._capture_dir: Optional[str] = None
        self._capture_id: Optional[str] = None
        self._capture_until: Optional[int] = None
        self._capture_storage: Optional[Dict[str, Any]] = None

        # Observability (chief only): system and card-memory samples to
        # the profiling group, tfevents scalars for TensorBoard.
        self._profiler = None
        self._tb_writer = None
        self._tb_manager = None
        if self.core.distributed.is_chief:
            if profiling:
                self._profiler = ProfilerAgent(self.core.train)
            if tensorboard_dir:
                self._tb_writer = EventFileWriter(tensorboard_dir)
                # Off-cluster there is no task id: the reference's "local".
                task_id = getattr(self.core.checkpoint, "_task_id", "") or "local"
                self._tb_manager = TensorboardManager(
                    self.core.checkpoint._storage, task_id, tensorboard_dir
                )

    def _tb_scalars(self, step: int, metrics: Dict[str, Any],
                    prefix: str = "") -> None:
        if self._tb_writer is not None:
            self._tb_writer.add_scalars(
                step, {f"{prefix}{k}": v for k, v in metrics.items()}
            )

    def _tb_sync(self) -> None:
        if self._tb_writer is not None:
            self._tb_writer.flush()
        if self._tb_manager is not None:
            try:
                self._tb_manager.sync()
            except Exception:  # noqa: BLE001 — observability, not work
                logger.exception("tensorboard sync failed")

    # -- the operator-triggered profile capture ---------------------------
    def _begin_capture(self, cap: Dict[str, Any], step: int) -> None:
        """Start a bounded torch.profiler trace for a capture directive
        the master delivered on the heartbeat. Never raises: a failed
        capture reports its error and training goes on."""
        if self._capture_dir is not None:
            return  # one capture at a time; the directive stays delivered
        try:
            self._capture_dir = tempfile.mkdtemp(prefix="dtpu-torch-capture-")
            self._capture_cm = torch_profiler_trace(self._capture_dir)
            self._capture_cm.__enter__()
            self._capture_id = str(cap.get("id", ""))
            self._capture_storage = cap.get("storage")
            self._capture_until = step + max(1, int(cap.get("steps", 3)))
            logger.info(
                "profile capture %s: tracing steps %d..%d",
                self._capture_id, step + 1, self._capture_until,
            )
        except Exception:  # noqa: BLE001 — profiling never breaks training
            logger.exception("profile capture start failed")
            self._report_capture(str(cap.get("id", "")), error="start failed")
            self._capture_dir = self._capture_cm = None
            self._capture_until = None

    def _finish_capture(self, step: int) -> None:
        """Stop the bounded trace, upload the artifact through the trial's
        storage manager, register the link on the capture record."""
        import shutil

        from determined_tpu_torch.storage.base import from_config

        cid, logdir, cm = self._capture_id, self._capture_dir, self._capture_cm
        storage_cfg = self._capture_storage
        self._capture_dir = self._capture_id = self._capture_cm = None
        self._capture_until = self._capture_storage = None
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the trace covers the steps
            cm.__exit__(None, None, None)
        except Exception:  # noqa: BLE001
            logger.exception("profile capture stop failed")
            self._report_capture(cid, error="stop failed")
            shutil.rmtree(logdir, ignore_errors=True)
            return
        try:
            storage = getattr(self.core.checkpoint, "_storage", None)
            if storage is None or storage_cfg:
                storage = from_config(storage_cfg, base_dir=os.path.join(
                    tempfile.gettempdir(), "dtpu_captures"))
            storage_id = f"profile-capture-{cid}"
            storage.upload(logdir, storage_id)
            logger.info("profile capture %s uploaded as %s (step %d)",
                        cid, storage_id, step)
            self._report_capture(cid, artifact=storage_id)
        except Exception as e:  # noqa: BLE001
            logger.exception("profile capture upload failed")
            self._report_capture(cid, error=f"upload failed: {e}")
        finally:
            shutil.rmtree(logdir, ignore_errors=True)

    def _report_capture(self, cid: Optional[str], artifact: str = "",
                        error: str = "") -> None:
        if not cid:
            return
        session = getattr(self.core.train, "_session", None)
        if session is None:
            return
        try:
            session.post(
                f"/api/v1/profiles/captures/{cid}/complete",
                json_body={"artifact": artifact, "error": error},
            )
        except Exception:  # noqa: BLE001 — registration loss is survivable
            logger.warning("capture %s completion report failed", cid)

    def _compute_step_flops(self, batch: Dict[str, torch.Tensor]) -> float:
        """Per-step model FLOPs for the profiling group's ``step_flops``:
        the model's ``train_flops_per_token()`` × the batch's tokens; 0.0
        (the key is left out) when the model has no such method or the
        batch no ``tokens``. The reference takes XLA's cost_analysis of
        its compiled step, which counts every op of the step; this counts
        the model's matrix products and attention (PaLM's convention)."""
        per_token = getattr(self.model, "train_flops_per_token", None)
        tokens = batch.get("tokens")
        if per_token is None or tokens is None:
            return 0.0
        return float(per_token()) * tokens.numel()

    def _trial_id(self) -> int:
        """This run's trial identity (0 off-cluster) — the goodput
        ledger's ownership key across restarts."""
        if self.core.info is not None and self.core.info.trial is not None:
            return int(self.core.info.trial.trial_id)
        return 0

    @property
    def steps_completed(self) -> int:
        return self._step

    def full_parameters(self) -> Dict[str, torch.Tensor]:
        """{name: the parameter as one device holds it}: on a mesh the
        blocks gathered over fsdp (a collective of the gang; on a tensor
        axis the rank's slices)."""
        params = [p.detach() for p in self._params]
        if self._layout is not None:
            params = self._layout.gather_whole(params)
        return dict(zip(self._names, params))

    @property
    def steps_skipped(self) -> int:
        """Optimizer updates the non-finite guard skipped (host view;
        updated at report boundaries)."""
        return self._steps_skipped

    @property
    def rollbacks(self) -> int:
        """Sentinel rollback-and-skip events (consecutive-skip cap or
        loss spike)."""
        return self._rollbacks

    # -- the step ----------------------------------------------------------
    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch on the device; on a mesh this rank's block of it: its
        rows, and on a context axis its columns of the pre-shifted batch
        (``_mesh.preshift``; the trial's ``replicated_batch_keys``, default
        ``positions``, whole)."""
        layout = self._layout
        if layout is not None:
            replicated = frozenset(getattr(
                self.trial, "replicated_batch_keys", frozenset({"positions"})))
            if layout.cp > 1 and "tokens" in batch and "targets" not in batch:
                batch = preshift(batch)
            layout.check_batch(batch, replicated)
            batch = {k: v if k in replicated else layout.local(np.asarray(v))
                     for k, v in batch.items()}
        return {
            k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    def _train_step(self, batch: Dict[str, torch.Tensor],
                    poison: float = 1.0) -> Dict[str, torch.Tensor]:
        """One guarded optimizer step → the step's metrics, on the device."""
        self._generator.manual_seed(rank_seed(*self._seed_parts, self._step))
        if self._layout is not None:
            return self._mesh_step(batch, poison)
        loss, metrics = self.model.loss(batch, self._generator)
        # poison is 1.0 outside fault drills; a NaN rides the loss into
        # every gradient — the wire shape of a poisoned batch.
        loss = loss * poison
        grads = torch.autograd.grad(loss, self._params, materialize_grads=True)
        with torch.no_grad():
            gnorm = optim.global_norm(grads)
            params = [p.detach() for p in self._params]
            updates, new_opt = self._tx.update(list(grads), self._opt_state,
                                               params)
            new_params = torch._foreach_add(params, updates)
            self._opt_state, ok, self._skips = _sentinel.guarded_update(
                params, new_params, self._opt_state, new_opt, loss, gnorm,
                self._skips,
            )
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(
            loss=loss.detach(), grad_norm=gnorm,
            sentinel_skipped=(~ok).to(torch.int32), sentinel_skips=self._skips,
        )
        return metrics

    def _gathering(self) -> Any:
        """The context the model runs in on a mesh: its split parameters
        gathered at use (regathered where the backward reads them), or
        gathered whole for the block when the model does not gather."""
        layout = self._layout
        if layout is None or not layout.split_dims:
            return contextlib.nullcontext()
        if self._gathers_at_use:
            return layout.regather_saved()
        return layout.gathered_into(self.model)

    def _mesh_step(self, batch: Dict[str, torch.Tensor],
                   poison: float) -> Dict[str, torch.Tensor]:
        """The step on a mesh (``trainer/_mesh.py``): this rank's rows
        through its blocks, gathered at use, its loss weighted by its
        share of the gang's tokens, the gradients summed into this rank's
        blocks, the optimizer and the guard on the blocks against the
        global loss and norm."""
        layout = self._layout
        with self._gathering():
            loss, metrics = self.model.loss(batch, self._generator)
        loss = loss * poison
        weight = layout.loss_weight(metrics)
        grads = torch.autograd.grad(loss * weight, self._params,
                                    materialize_grads=True)
        with torch.no_grad():
            grads = layout.reduce_grads(grads)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            metrics = layout.reduce_metrics(metrics, weight)
            with optim.norm_reduction(layout.sum_of_squares):
                gnorm = optim.global_norm(grads)
                updates, new_opt = self._tx.update(grads, self._opt_state,
                                                   self._params)
            new_params = torch._foreach_add(self._params, updates)
            self._opt_state, ok, self._skips = _sentinel.guarded_update(
                self._params, new_params, self._opt_state, new_opt,
                metrics["loss"], gnorm, self._skips,
            )
        metrics.update(
            grad_norm=gnorm, sentinel_skipped=(~ok).to(torch.int32),
            sentinel_skips=self._skips,
        )
        return metrics

    # -- checkpoint --------------------------------------------------------
    def _state_view(self) -> Dict[str, Any]:
        """The train state under the reference's names (live tensors; on
        a mesh this rank's ``Shard`` blocks)."""
        params = [p.detach() for p in self._params]
        if self._layout is not None:
            return ckpt_io.sharded_state_view(
                self._step, self._names, params, self._opt_state,
                self._layout.shard_view_blocks())
        return ckpt_io.state_view(self._step, self._names, params,
                                  self._opt_state)

    def _save_checkpoint(self, *, sync: bool = False) -> Optional[str]:
        """Checkpoint the train state.

        Async by default: the step loop blocks only for joining any
        previous save and the device→host snapshot; the .npy files,
        ``trainer_state.json`` and the upload run on the writer thread.
        `sync=True` waits and returns the storage_id (preemption, exit).
        """
        # Join first: two host copies of the state at once could exhaust
        # host memory at scale.
        self._ckpt_writer.wait()
        steps = self._step
        chief = self.core.distributed.is_chief
        sharded = self.core.distributed.size > 1
        snapshot = ckpt_io.snapshot_pytree(self._state_view(), chief=chief)
        checkpoint_ctx = self.core.checkpoint
        md = {
            "steps_completed": steps,
            "seed": self.seed,
            # Rollbacks leave the data stream ahead of the step counter
            # (poisoned windows skipped); a resume fast-forwards as far.
            "data_offset": self._data_offset,
            # The goodput ledger at submit time: a resumed run continues
            # it and charges the save→resume gap as restart loss.
            "timeline": self.timeline.to_metadata(trial_id=self._trial_id()),
        }

        def work() -> str:
            with tempfile.TemporaryDirectory() as tmp:
                written = ckpt_io.write_snapshot(snapshot, tmp,
                                                 manifest=chief)
                if chief:
                    with open(os.path.join(tmp, TRAINER_METADATA), "w") as f:
                        json.dump(md, f)
                    written.append(TRAINER_METADATA)
                storage_id = checkpoint_ctx.upload(
                    tmp, metadata={"steps_completed": steps}, shard=sharded,
                    paths=written)
            logger.info("saved checkpoint %s at step %d", storage_id, steps)
            # The rollback target: only a save that finished uploading,
            # the same on every rank (the sharded upload broadcasts it).
            self._last_ckpt_id = storage_id
            return storage_id

        self._ckpt_writer.submit(work)
        if sync:
            return self._ckpt_writer.wait()
        return None

    def _restore_with_fallback(self, storage_id: str) -> None:
        """Restore `storage_id`; on CorruptCheckpointError or a storage
        failure try the next candidate of
        ``core.checkpoint.restore_candidates``. Off-cluster that list is
        just `storage_id`, so the failure propagates.

        In a gang this is a collective: the chief's candidate list is
        broadcast, and after each attempt the ranks agree — all restored,
        or all move to the next candidate, or all raise when any rank
        failed with an error that is not a checkpoint's. No rank trains on
        state its peers rejected."""
        dist = self.core.distributed
        gang = dist.size > 1
        if gang:
            candidates = dist.broadcast(
                self.core.checkpoint.restore_candidates(storage_id)
                if dist.is_chief else None)
        else:
            candidates = self.core.checkpoint.restore_candidates(storage_id)
        last_err: Optional[Exception] = None
        for uuid_ in candidates:
            my_err: Optional[Exception] = None
            # A failing rank must still reach the agreement round below.
            try:
                self._restore_checkpoint(uuid_)
                status = "ok"
            except (CorruptCheckpointError, OSError) as e:
                my_err, status = e, "fallback"
            except Exception as e:  # noqa: BLE001 — re-raised after agreeing
                if not gang:
                    raise
                my_err, status = e, "fatal"
            if gang:
                statuses = dist.gather(status)
                decision = dist.broadcast(
                    ("fatal" if "fatal" in statuses
                     else "ok" if all(s == "ok" for s in statuses)
                     else "fallback") if dist.is_chief else None)
            else:
                decision = status
            if decision == "ok":
                if uuid_ != storage_id:
                    logger.warning(
                        "resumed from older verified checkpoint %s (newest "
                        "%s was corrupt)", uuid_, storage_id,
                    )
                return
            if decision == "fatal":
                if my_err is not None and status == "fatal":
                    raise my_err
                raise RuntimeError(
                    f"a peer rank failed restoring checkpoint {uuid_} with "
                    "an error that is not the checkpoint's")
            last_err = my_err or CorruptCheckpointError(
                f"a peer rank failed verification of checkpoint {uuid_}")
            logger.error(
                "checkpoint %s failed verification (%s); %s", uuid_, last_err,
                "trying the previous verified checkpoint"
                if uuid_ != candidates[-1] else "no older checkpoint left",
            )
        assert last_err is not None
        raise last_err

    def _restore_checkpoint(self, storage_id: str) -> None:
        """Verify and read the whole checkpoint, then write it into the
        parameters (in place), the optimizer state and the step: a
        checkpoint that fails verification or has a drifted leaf leaves
        the trainer untouched. On a mesh each rank reads its own blocks at
        the layout it has now, whatever layout saved them. A restore that
        is not a rollback's also resumes the checkpoint's goodput
        ledger."""
        self._ckpt_writer.wait()  # never read while a save is in flight
        with self.core.checkpoint.restore_path(storage_id) as path:
            if os.path.isdir(os.path.join(path, ORBAX_SUBDIR)):
                raise NotImplementedError(
                    f"checkpoint {storage_id} is in the orbax format, which "
                    "needs JAX; the port reads the 'npy' format"
                )
            view = ckpt_io.load_pytree(path, self._state_view())
            data_offset, tl_md = 0, None
            md_path = os.path.join(path, TRAINER_METADATA)
            if os.path.exists(md_path):
                try:
                    with open(md_path) as f:
                        md = json.load(f)
                    data_offset = int(md.get("data_offset", 0) or 0)
                    tl_md = md.get("timeline")
                except (ValueError, OSError):
                    logger.warning(
                        "unreadable trainer metadata in %s; assuming no "
                        "data offset", storage_id,
                    )
        params = ckpt_io.unnest(view["params"])
        with torch.no_grad():
            for name, p in zip(self._names, self._params):
                p.copy_(params[name])
        self._opt_state = ckpt_io.opt_state_from_view(
            self._opt_state, view["opt_state"], self._names)
        self._step = int(view["step"])
        self._data_offset = data_offset
        if tl_md and not self._restoring_for_rollback:
            # load() keeps the fresh ledger for a foreign trial id and
            # never raises on corrupt metadata; only the first resume gap
            # is a resize's.
            self.timeline.load(tl_md, trial_id=self._trial_id(),
                               event=self._resume_event)
            self._resume_event = "restart"
        self._last_ckpt_id = storage_id  # verified by the restore above
        logger.info("restored checkpoint %s at step %d", storage_id, self._step)

    # -- validation --------------------------------------------------------
    @torch.no_grad()
    def _validate(self) -> Dict[str, float]:
        """The mean over the validation batches of each batch's metrics
        (on a mesh, each batch's over the gang, weighted as the step's)."""
        totals: Dict[str, float] = {}
        n = 0
        for batch in self.trial.build_validation_data():
            with self._gathering():
                metrics = self.model.eval_metrics(self._put_batch(batch))
            if self._layout is not None:
                metrics = self._layout.reduce_metrics(
                    metrics, self._layout.loss_weight(metrics))
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return {}
        return {k: v / n for k, v in totals.items()}

    # -- reporting and the health sentinel -----------------------------------
    def _flush(self, pending: List[Dict[str, torch.Tensor]],
               t_start: float) -> Tuple[Dict[str, float], Optional[str]]:
        """The window's metrics in one device→host transfer → (the
        report, the sentinel's rollback reason or None). Each scalar
        metric is averaged over its finite values (a window with none
        drops the key); batches_per_second is the window's steps over the
        host seconds from `t_start` to the end of that transfer, which
        waits for the window's last step."""
        keys = [k for k, v in pending[0].items() if v.dim() == 0]
        host = torch.stack([
            torch.stack([m[k].to(torch.float64) for k in keys])
            for m in pending
        ]).cpu().numpy()
        seconds = time.time() - t_start
        columns = {k: host[:, i] for i, k in enumerate(keys)}
        reason = self._sentinel_check(columns)
        agg: Dict[str, float] = {}
        for k, vals in columns.items():
            finite = vals[np.isfinite(vals)]
            if finite.size:
                agg[k] = float(finite.mean())
        agg["batches_per_second"] = len(pending) / seconds if seconds > 0 else 0.0
        self._last_throughput = agg["batches_per_second"]
        # Robustness tax, cumulative.
        agg["steps_skipped"] = float(self._steps_skipped)
        agg["rollbacks"] = float(self._rollbacks)
        return agg, reason

    def _sentinel_check(self, columns: Dict[str, np.ndarray]) -> Optional[str]:
        """The sentinel's pass over one window's host metrics: add the
        window's skips to the total, and return a rollback reason when
        the consecutive-skip cap or the loss-spike z-score trips (None
        otherwise)."""
        cfg = self.sentinel
        window_skips = int(columns["sentinel_skipped"].sum())
        if window_skips:
            self._steps_skipped += window_skips
            logger.warning(
                "non-finite guard skipped %d step(s) this window "
                "(%d total)", window_skips, self._steps_skipped,
            )
        consecutive = int(columns["sentinel_skips"][-1])
        if cfg.max_consecutive_skips and consecutive >= cfg.max_consecutive_skips:
            return (
                f"{consecutive} consecutive non-finite steps "
                f"(max_consecutive_skips={cfg.max_consecutive_skips})"
            )
        if self._spike.enabled:
            for loss in columns["loss"]:
                if self._spike.observe(float(loss)):
                    return (
                        f"loss spike {float(loss):.4g} beyond robust "
                        f"z-score {cfg.spike_zscore}"
                    )
        return None

    def _sentinel_rollback(self, reason: str, at_step: int) -> Optional[int]:
        """Rollback-and-skip: restore the last checkpoint that finished
        uploading and leave the data stream where it is — the batches
        between the restored step and `at_step` are the poisoned window,
        skipped for good through the data offset. Returns the restored
        step, or None when no checkpoint exists yet (the guard already
        kept the parameters clean; training goes on with the counters
        reset)."""
        try:
            self._ckpt_writer.wait()  # a save in flight may be the target
        except Exception:  # noqa: BLE001 — the rollback must still proceed
            logger.exception("in-flight checkpoint failed before rollback")
        target = self._last_ckpt_id
        if target is None:
            logger.error(
                "sentinel wants a rollback (%s) but no checkpoint exists "
                "yet; continuing with guarded params only", reason,
            )
            self._skips = torch.zeros_like(self._skips)
            self._spike.reset()
            return None
        logger.warning(
            "sentinel rollback at step %d: %s — restoring %s and skipping "
            "the poisoned data window", at_step, reason, target,
        )
        t0 = self.timeline.pc()
        self._restoring_for_rollback = True
        try:
            self._restore_with_fallback(target)
        finally:
            self._restoring_for_rollback = False
        # Ledger: the uncommitted window time trained state this restore
        # just discarded; the restore itself is overhead too.
        self.timeline.on_rollback(self.timeline.pc() - t0)
        self._rollbacks += 1
        restored = self._step
        # The stream is NOT rewound: what was consumed past the restored
        # step stays consumed, which is exactly "skip the batches".
        self._data_offset = self._data_consumed - restored
        self._skips = torch.zeros_like(self._skips)
        self._spike.reset()
        logger.warning(
            "sentinel rollback done: step %d, data stream fast-forwarded "
            "%d batch(es) ahead (rollback #%d)",
            restored, self._data_offset, self._rollbacks,
        )
        return restored

    def _exit_for_resize(self, directive: Dict[str, Any], step: int) -> None:
        """Leave the step loop for an elastic resize: raise
        ``ElasticResizeExit`` with the directive and the gang's last
        verified checkpoint (the restore's source; the window since it is
        lost, and the resumed ledger charges the drain→resume gap as
        resize loss)."""
        rank = self.core.distributed.rank
        dropped = str(rank) not in (directive.get("rank_map") or {})
        if dropped and directive.get("resync_only"):
            # The master could not map this rank (its directive history
            # rotated out): a clean exit would finish a trial that still
            # counts it, so fail for a re-sync.
            raise RuntimeError(
                "resize directive could not map this rank (generation "
                f"{directive.get('generation')}); erroring out for re-sync")
        logger.warning(
            "elastic resize at step %d: generation %s, %s process(es) (%s) "
            "— rank %d %s", step, directive.get("generation"),
            directive.get("num_processes"), directive.get("reason", ""),
            rank, "was dropped; exiting" if dropped
            else "leaves the step loop to restore on the new layout")
        if self._ckpt_writer.in_flight and self.core.distributed.size > 1:
            # A sharded save in flight runs collectives with peers that
            # may be dead: closing the control plane fails them fast. The
            # torn upload never verifies (its manifest is written last),
            # and restore_from is the last verified checkpoint.
            self.core.distributed.close()
            try:
                self._ckpt_writer.wait()
            except BaseException as e:  # noqa: BLE001 — expected abort
                logger.warning("in-flight checkpoint abandoned by the "
                               "resize: %s", e)
        raise ElasticResizeExit(directive, dropped=dropped,
                                restore_from=self._last_ckpt_id)

    def _divergence_audit(self) -> None:
        """The replica-divergence audit: the checksums of every parameter
        block each rank holds, compared by the chief across every holder
        of the same region; a mismatch raises ``ReplicaDivergenceError``
        on every rank, naming the offending rank and device."""
        dist = self.core.distributed
        blocks = [p.detach() for p in self._params]
        params = (self._layout.shards(self._names, blocks)
                  if self._layout is not None
                  else dict(zip(self._names, blocks)))
        sums = _sentinel.local_shard_checksums(params)
        if _sentinel.divergence_fault(dist.rank):
            # The drill (DTPU_FAULT_PLAN train.divergence.rank<r>): corrupt
            # this rank's checksum of the first block; the audit must
            # name exactly this holder.
            key = next(iter(sums), None)
            if key is not None:
                device, (a, b) = sums[key][-1]
                sums[key] = sums[key][:-1] + [(device, (a + 1.0, b))]
        gathered = dist.gather((dist.rank, sums))
        verdict = dist.broadcast(
            _sentinel.compare_checksums(gathered) if dist.is_chief else None)
        if verdict:
            raise _sentinel.ReplicaDivergenceError(verdict)

    # -- the loop ----------------------------------------------------------
    def fit(
        self,
        *,
        max_length: Optional[TrainUnit] = None,
        validation_period: Optional[TrainUnit] = None,
        checkpoint_period: Optional[TrainUnit] = None,
        report_period: TrainUnit = Batch(10),
        latest_checkpoint: Optional[str] = None,
    ) -> Dict[str, float]:
        """Run the trial until the searcher closes it (one op of
        max_length off-cluster), resuming from `latest_checkpoint` when
        given. Returns the last validation metrics."""
        bpe = self.trial.batches_per_epoch
        val_period = to_batches(validation_period, bpe) if validation_period else 0
        ckpt_period = to_batches(checkpoint_period, bpe) if checkpoint_period else 0
        rep_period = max(1, to_batches(report_period, bpe))

        # Off-cluster: one dummy op of max_length batches; on a cluster the
        # master's operations set the length.
        searcher = self.core.searcher
        if max_length is not None and isinstance(searcher, DummySearcherContext):
            searcher = DummySearcherContext(
                self.core.distributed, length=to_batches(max_length, bpe))
        if latest_checkpoint:
            if self._resume_event == "resize":
                # The drill's site (DTPU_FAULT_PLAN resize.restore): a
                # failure here fails this rank, which the master sheds as
                # another resize.
                faults.inject("resize.restore")
            self._restore_with_fallback(latest_checkpoint)

        # Fast-forward the stream past the batches consumed before this
        # step (steps trained + the windows rollbacks skipped), so a
        # resumed run sees the data an uninterrupted one sees: through
        # .skip(n) when the dataset has it (in place: it returns None or
        # itself), else by discarding batches.
        train_data = self.trial.build_training_data()
        fast_forward = self._step + self._data_offset
        skipped = False
        if fast_forward and hasattr(train_data, "skip"):
            result = train_data.skip(fast_forward)
            skipped = result is None or result is train_data
        train_iter = iter(train_data)
        if not skipped:
            for _ in range(fast_forward):
                next(train_iter)
        self._data_consumed = fast_forward

        chief = self.core.distributed.is_chief
        timeline = self.timeline
        pc = timeline.pc
        pending: List[Dict[str, torch.Tensor]] = []
        last_val: Dict[str, float] = {}
        t_report = time.time()
        step = self._step
        resume_steps = step
        # Profiling phase tag: the sampler reads this thread's phase on
        # every walk, so its windows split by data_wait / h2d_put / step /
        # report / checkpoint.
        set_phase = profiling_mod.set_phase
        last_ckpt_step = -1
        last_div_audit = step
        preempted = False
        self._skips = torch.zeros_like(self._skips)
        self._sentinel_reason = None
        self.core.train.heartbeat_step(step)

        def flush_report() -> None:
            """Sentinel pass + report of the window. Every window is
            checked (flushes also come at checkpoint and op-end
            boundaries); a verdict is latched for the next report
            boundary's rollback gate."""
            nonlocal pending, t_report
            set_phase("report")
            if pending:
                agg, reason = self._flush(pending, t_report)
                if reason and self._sentinel_reason is None:
                    self._sentinel_reason = reason
                if chief:
                    t0 = pc()
                    self.core.train.report_training_metrics(step, agg)
                    self._tb_scalars(step, agg)
                    if timeline.enabled:
                        timeline.window["report"] += pc() - t0
                if timeline.enabled:
                    # The flush's transfer waited for the window's last
                    # step, so the residual holds the device time.
                    prof = timeline.close_window()
                    if chief:
                        prof.update(timeline.snapshot())
                        if self._step_flops:
                            prof["step_flops"] = self._step_flops
                        self.core.train.report_metrics("profiling", step, prof)
                if self._profiler is not None:
                    self._profiler.set_steps_completed(step)
            pending = []
            t_report = time.time()
            set_phase("step")

        if self._profiler is not None:
            self._profiler.start()
        # Trial lifecycle span: a child of the launch chain's
        # DTPU_TRACEPARENT (ambient through common/trace.py), closed in the
        # finally below either way.
        fit_scope = contextlib.ExitStack()
        fit_scope.enter_context(
            trace_mod.span("trial.fit", {"resume_step": resume_steps}))
        # First-step anchor of the lifecycle trace: exported when the
        # first step returns.
        first_step_ctx = trace_mod.current()
        first_step_t0 = time.time()
        first_step_at = step + 1
        timeline.reset_window()
        set_phase("step")
        # The finally-join keeps a raising step loop from abandoning an
        # in-flight background save, and makes a failed save fail the run.
        fit_error: Optional[BaseException] = None
        try:
            for op in searcher.operations():
                target = to_batches(op.length, bpe)
                while step < target:
                    if timeline.enabled:
                        set_phase("data_wait")
                        t0 = pc()
                        raw = next(train_iter)
                        t1 = pc()
                        set_phase("h2d_put")
                        batch = self._put_batch(raw)
                        set_phase("step")
                        window = timeline.window
                        window["data_wait"] += t1 - t0
                        window["h2d_put"] += pc() - t1
                        timeline.step_done()
                    else:
                        set_phase("data_wait")
                        raw = next(train_iter)
                        set_phase("h2d_put")
                        batch = self._put_batch(raw)
                        set_phase("step")
                    self._data_consumed += 1
                    pending.append(
                        self._train_step(batch, _sentinel.poison_factor()))
                    step += 1
                    self._step = step
                    if (self._capture_until is not None
                            and step >= self._capture_until):
                        self._finish_capture(step)
                    if step == first_step_at and first_step_ctx is not None:
                        first_step_at = -1
                        trace_mod.export_span(
                            "trial.first_step",
                            trace_id=first_step_ctx[0],
                            span_id=trace_mod.new_span_id(),
                            parent_span_id=first_step_ctx[1],
                            start=first_step_t0, end=time.time(),
                            attributes={"step": step},
                        )
                    if step % rep_period == 0 or step == target:
                        flush_report()
                        rollback_reason = self._sentinel_reason
                        self._sentinel_reason = None
                        beat_resize = self.core.train.heartbeat_step(step)
                        if chief:
                            op.report_progress(float(step))
                            if self._step_flops is None:
                                self._step_flops = self._compute_step_flops(batch)
                            # The operator's capture rides the beat.
                            cap = self.core.train.take_profile_capture()
                            if cap is not None:
                                self._begin_capture(cap, step)
                        # The chief folds the beat's directive into the
                        # preemption broadcast, so every rank reaches the
                        # same verdict here; it is the boundary's first
                        # collective, before any that a dead peer would
                        # hang (a save's join, a rollback, the audit). A
                        # resize supersedes a latched rollback: both
                        # restore the last verified checkpoint.
                        preempt_now = self.core.preempt.should_preempt(
                            resize_hint=beat_resize)
                        directive = self.core.preempt.take_resize()
                        if directive is not None:
                            self._exit_for_resize(directive, step)
                        if preempt_now:
                            set_phase("checkpoint")
                            self._save_checkpoint(sync=True)
                            set_phase("step")
                            timeline.commit()
                            last_ckpt_step = step
                            logger.info("preempted at step %d; exiting "
                                        "cleanly", step)
                            preempted = True
                            break
                        if rollback_reason is not None:
                            restored = self._sentinel_rollback(
                                rollback_reason, step)
                            if restored is not None:
                                # The restored step is checkpointed.
                                step = last_ckpt_step = restored
                                last_div_audit = min(last_div_audit, step)
                                continue
                        if (self.sentinel.divergence_check_period
                                and step - last_div_audit
                                >= self.sentinel.divergence_check_period):
                            last_div_audit = step
                            self._divergence_audit()
                    if val_period and step % val_period == 0 and step < target:
                        last_val = self._validate()
                        if last_val and chief:
                            self.core.train.report_validation_metrics(step, last_val)
                            self._tb_scalars(step, last_val, prefix="val_")
                    if ckpt_period and step % ckpt_period == 0:
                        flush_report()
                        set_phase("checkpoint")
                        t0 = pc()
                        self._save_checkpoint()
                        set_phase("step")
                        if timeline.enabled:
                            # The blocking part only (writer join and
                            # snapshot); the upload overlaps training.
                            timeline.window["checkpoint"] += pc() - t0
                        # A durable checkpoint is the ledger's commit
                        # point: time since the last one is now goodput.
                        timeline.commit()
                        last_ckpt_step = step
                        self._tb_sync()
                if preempted:
                    break
                flush_report()
                last_val = self._validate()
                if chief:
                    if last_val:
                        self.core.train.report_validation_metrics(step, last_val)
                        self._tb_scalars(step, last_val, prefix="val_")
                    completion = {"batches_per_second": self._last_throughput,
                                  **last_val}
                    op.report_completed(
                        float(completion.get(self.searcher_metric, 0.0)))
            # On a cluster the trial always ends checkpointed: the master's
            # latest checkpoint is what a continued experiment resumes.
            if ((ckpt_period or preempted or self.core.info is not None)
                    and last_ckpt_step != step):
                set_phase("checkpoint")
                self._save_checkpoint(sync=True)
                timeline.commit()
        except RuntimeError as e:
            # In a gang, a collective whose peer died raises (on gloo; on
            # NCCL it times out): the master's pending resize directive
            # turns the failure into a resize; without one it stands.
            fit_error = e
            directive = (self.core.preempt.directive_after_failure(e)
                         if self.core.distributed.size > 1 else None)
            if directive is None:
                raise
            self._exit_for_resize(directive, step)
        except BaseException as e:
            fit_error = e
            raise
        finally:
            try:
                self._ckpt_writer.wait()
            except BaseException:
                if fit_error is None:
                    raise
                # The loop's own exception is the primary failure.
                logger.exception("background checkpoint failed during teardown")
            finally:
                set_phase(None)
                if self._capture_dir is not None:
                    # An exit mid-capture: stop and report it, so the
                    # master's capture record does not stay "delivered".
                    self._finish_capture(step)
                fit_scope.close()  # end the trial.fit span either way
                if self._profiler is not None:
                    self._profiler.stop()
        # The fit's tail records must survive a hard kill right after fit
        # returns: drain the structured log shipper now.
        logship_mod.flush_shipping()
        self._tb_sync()
        return last_val
