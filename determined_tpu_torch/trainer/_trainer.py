"""Trainer: the training loop that drives a TorchTrial on one device.

Port of ``determined_tpu/trainer/_trainer.py``, trimmed to one device and
the off-cluster core contexts. Same control shape — iterate searcher ops,
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

The step runs on CUDA unless the caller passes ``device="cpu"``. Refused
by name: a device mesh and ``health.divergence_check_period`` (the
replica audit; the multi-device slice), ``resume_event="resize"`` (the
elastic slice), ``smaller_is_better=False`` (read only by the cluster's
searcher: the exec slice) and the orbax checkpoint format (it needs JAX).
The operator-triggered profile capture arrives on the master's heartbeat,
which the off-cluster context never delivers.
"""
from __future__ import annotations

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
from determined_tpu_torch.core._searcher import DummySearcherContext
from determined_tpu_torch.models.base import Model
from determined_tpu_torch.profiler import ProfilerAgent
from determined_tpu_torch.storage.base import CorruptCheckpointError
from determined_tpu_torch.tensorboard import EventFileWriter, TensorboardManager
from determined_tpu_torch.trainer import _checkpoint as ckpt_io
from determined_tpu_torch.trainer import _sentinel, _timeline, optim
from determined_tpu_torch.trainer._trial import TorchTrial
from determined_tpu_torch.trainer._units import Batch, TrainUnit, to_batches

logger = logging.getLogger("determined_tpu_torch.trainer")

TRAINER_METADATA = "trainer_state.json"
ORBAX_SUBDIR = "orbax"  # presence marks an orbax/ocdbt-format checkpoint


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
            raise NotImplementedError(
                "a device mesh (sharded parameters and batches) comes with "
                "the multi-device slice; the Trainer runs on one device"
            )
        if not smaller_is_better:
            raise NotImplementedError(
                "smaller_is_better=False: only the cluster's searcher reads "
                "it, and the off-cluster searcher ranks nothing; it comes "
                "with the exec slice"
            )
        if resume_event == "resize":
            raise NotImplementedError(
                "resume_event='resize' (an elastic in-place resize resumed "
                "this trainer) comes with the elastic slice"
            )
        if resume_event != "restart":
            raise ValueError(
                f"resume_event {resume_event!r} (one of: restart, resize)"
            )
        self.sentinel = _sentinel.SentinelConfig.from_config(health)
        if self.sentinel.divergence_check_period:
            raise NotImplementedError(
                "health.divergence_check_period (the replica-divergence "
                "audit compares data-parallel replicas; one device has "
                "none) comes with the multi-device slice"
            )
        self.trial = trial
        self.device = resolve_device(device)
        self.core = core_context or core_mod.init()
        self.seed = seed
        self.searcher_metric = searcher_metric
        self._spike = _sentinel.SpikeDetector(self.sentinel)

        torch.manual_seed(seed)
        self.model: Model = trial.build_model(self.device)
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        for p in self._params:
            if p.device != self.device:
                raise ValueError(
                    f"build_model put a parameter on {p.device}; the "
                    f"trainer runs on {self.device}"
                )
        self._tx = trial.build_optimizer()
        self._opt_state = self._tx.init([p.detach() for p in self._params])
        # Seeded once and passed to model.loss; the port's models draw
        # nothing from it (no dropout), so a checkpoint holds no generator
        # state. (The reference's step RNG, fold_in(base_rng, step), is a
        # function of the step alone.)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
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
                self._tb_manager = TensorboardManager(
                    self.core.checkpoint._storage, "local", tensorboard_dir
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
        return {
            k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    def _train_step(self, batch: Dict[str, torch.Tensor],
                    poison: float = 1.0) -> Dict[str, torch.Tensor]:
        """One guarded optimizer step → the step's metrics, on the device."""
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

    # -- checkpoint --------------------------------------------------------
    def _state_view(self) -> Dict[str, Any]:
        """The train state under the reference's names (live tensors)."""
        return ckpt_io.state_view(self._step, self._names,
                                  [p.detach() for p in self._params],
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
        snapshot = ckpt_io.snapshot_pytree(self._state_view())
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
                written = ckpt_io.write_snapshot(snapshot, tmp)
                with open(os.path.join(tmp, TRAINER_METADATA), "w") as f:
                    json.dump(md, f)
                written.append(TRAINER_METADATA)
                storage_id = checkpoint_ctx.upload(
                    tmp, metadata={"steps_completed": steps}, paths=written)
            logger.info("saved checkpoint %s at step %d", storage_id, steps)
            # The rollback target: only a save that finished uploading.
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
        just `storage_id`, so the failure propagates."""
        candidates = self.core.checkpoint.restore_candidates(storage_id)
        last_err: Optional[Exception] = None
        for uuid_ in candidates:
            try:
                self._restore_checkpoint(uuid_)
            except (CorruptCheckpointError, OSError) as e:
                last_err = e
                logger.error(
                    "checkpoint %s failed verification (%s); %s", uuid_, e,
                    "trying the previous verified checkpoint"
                    if uuid_ != candidates[-1] else "no older checkpoint left",
                )
                continue
            if uuid_ != storage_id:
                logger.warning(
                    "resumed from older verified checkpoint %s (newest %s "
                    "was corrupt)", uuid_, storage_id,
                )
            return
        assert last_err is not None
        raise last_err

    def _restore_checkpoint(self, storage_id: str) -> None:
        """Verify and read the whole checkpoint, then write it into the
        parameters (in place), the optimizer state and the step: a
        checkpoint that fails verification or has a drifted leaf leaves
        the trainer untouched. A restore that is not a rollback's also
        resumes the checkpoint's goodput ledger."""
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
            # never raises on corrupt metadata.
            self.timeline.load(tl_md, trial_id=self._trial_id())
        self._last_ckpt_id = storage_id  # verified by the restore above
        logger.info("restored checkpoint %s at step %d", storage_id, self._step)

    # -- validation --------------------------------------------------------
    @torch.no_grad()
    def _validate(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        n = 0
        for batch in self.trial.build_validation_data():
            metrics = self.model.eval_metrics(self._put_batch(batch))
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

        searcher = self.core.searcher
        if max_length is not None:
            searcher = DummySearcherContext(length=to_batches(max_length, bpe))
        if latest_checkpoint:
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
        last_ckpt_step = -1
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

        if self._profiler is not None:
            self._profiler.start()
        timeline.reset_window()
        # The finally-join keeps a raising step loop from abandoning an
        # in-flight background save, and makes a failed save fail the run.
        fit_error: Optional[BaseException] = None
        try:
            for op in searcher.operations():
                target = to_batches(op.length, bpe)
                while step < target:
                    if timeline.enabled:
                        t0 = pc()
                        raw = next(train_iter)
                        t1 = pc()
                        batch = self._put_batch(raw)
                        window = timeline.window
                        window["data_wait"] += t1 - t0
                        window["h2d_put"] += pc() - t1
                        timeline.step_done()
                    else:
                        batch = self._put_batch(next(train_iter))
                    self._data_consumed += 1
                    pending.append(
                        self._train_step(batch, _sentinel.poison_factor()))
                    step += 1
                    self._step = step
                    if step % rep_period == 0 or step == target:
                        flush_report()
                        rollback_reason = self._sentinel_reason
                        self._sentinel_reason = None
                        self.core.train.heartbeat_step(step)
                        if chief:
                            op.report_progress(float(step))
                            if self._step_flops is None:
                                self._step_flops = self._compute_step_flops(batch)
                        if self.core.preempt.should_preempt():
                            self._save_checkpoint(sync=True)
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
                                continue
                    if val_period and step % val_period == 0 and step < target:
                        last_val = self._validate()
                        if last_val and chief:
                            self.core.train.report_validation_metrics(step, last_val)
                            self._tb_scalars(step, last_val, prefix="val_")
                    if ckpt_period and step % ckpt_period == 0:
                        flush_report()
                        t0 = pc()
                        self._save_checkpoint()
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
            if (ckpt_period or preempted) and last_ckpt_step != step:
                self._save_checkpoint(sync=True)
                timeline.commit()
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
                if self._profiler is not None:
                    self._profiler.stop()
        self._tb_sync()
        return last_val
