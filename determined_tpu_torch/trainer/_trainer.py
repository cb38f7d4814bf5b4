"""Trainer: the training loop that drives a TorchTrial on one device.

Port of ``determined_tpu/trainer/_trainer.py``, trimmed to one device and
the off-cluster core contexts. Same control shape — iterate searcher ops,
train to each op's length with periodic validation and report boundaries
— and the same step:

- loss × poison (1.0 outside fault drills) → backward → the global norm
  of the RAW gradients → the trial's optimizer chain (``trainer.optim``)
  → the non-finite guard (``_sentinel.guarded_update``), which keeps the
  parameters and the optimizer state of a step whose loss or gradient
  norm is not finite;
- metrics stay on the device between report boundaries: a report
  materializes the window's metrics in one transfer and averages each
  over its FINITE values (a skipped step leaves NaN in loss/grad_norm),
  adding ``batches_per_second`` and the cumulative ``steps_skipped``;
- validation runs ``model.eval_metrics`` under ``torch.no_grad()`` and
  averages over batches.

Checkpoints are the reference's on-disk format (``trainer/_checkpoint.py``):
``fit(checkpoint_period=...)`` saves the named state view (``step``,
``params``, ``opt_state``) plus ``trainer_state.json`` at each period, at
preemption and at the end; the device→host snapshot blocks the step loop,
the files and the upload run on a background writer.
``fit(latest_checkpoint=...)`` verifies and restores one (a JAX-written
one too) and fast-forwards the data stream past the batches it consumed.

The step runs on CUDA unless the caller passes ``device="cpu"``. A device
mesh (the multi-device slice), profiling, TensorBoard,
``smaller_is_better=False`` (read only by the cluster's searcher: the exec
slice) and the orbax checkpoint format (it needs JAX) are refused by name.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from determined_tpu_torch import core as core_mod
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.core._searcher import DummySearcherContext
from determined_tpu_torch.models.base import Model
from determined_tpu_torch.storage.base import CorruptCheckpointError
from determined_tpu_torch.trainer import _checkpoint as ckpt_io
from determined_tpu_torch.trainer import _sentinel, optim
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
        health: Optional[Dict[str, Any]] = None,
        mesh: Any = None,
        profiling: bool = False,
        tensorboard_dir: Optional[str] = None,
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
        if profiling or tensorboard_dir:
            raise NotImplementedError(
                "profiling / tensorboard reporting is not ported yet; use "
                "python -m determined_tpu_torch.trainer.profile for the "
                "train step's device breakdown"
            )
        if not smaller_is_better:
            raise NotImplementedError(
                "smaller_is_better=False: only the cluster's searcher reads "
                "it, and the off-cluster searcher ranks nothing; it comes "
                "with the exec slice"
            )
        self.trial = trial
        self.device = resolve_device(device)
        self.core = core_context or core_mod.init()
        self.seed = seed
        self.searcher_metric = searcher_metric
        self.sentinel = _sentinel.SentinelConfig.from_config(health)

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
        #: batches the data stream is ahead of the step counter: 0 until
        #: the sentinel's rollback (a later slice) skips poisoned windows.
        #: Persisted in the trainer metadata.
        self._data_offset = 0
        self._steps_skipped = 0     # lifetime non-finite skips (host view)
        self._skips = torch.zeros((), dtype=torch.int32, device=self.device)
        self._last_throughput = 0.0

    @property
    def steps_completed(self) -> int:
        return self._step

    @property
    def steps_skipped(self) -> int:
        """Optimizer updates the non-finite guard skipped (host view;
        updated at report boundaries)."""
        return self._steps_skipped

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
        seed = self.seed
        data_offset = self._data_offset

        def work() -> str:
            with tempfile.TemporaryDirectory() as tmp:
                written = ckpt_io.write_snapshot(snapshot, tmp)
                with open(os.path.join(tmp, TRAINER_METADATA), "w") as f:
                    json.dump({"steps_completed": steps, "seed": seed,
                               "data_offset": data_offset}, f)
                written.append(TRAINER_METADATA)
                storage_id = checkpoint_ctx.upload(
                    tmp, metadata={"steps_completed": steps}, paths=written)
            logger.info("saved checkpoint %s at step %d", storage_id, steps)
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
        the trainer untouched."""
        self._ckpt_writer.wait()  # never read while a save is in flight
        with self.core.checkpoint.restore_path(storage_id) as path:
            if os.path.isdir(os.path.join(path, ORBAX_SUBDIR)):
                raise NotImplementedError(
                    f"checkpoint {storage_id} is in the orbax format, which "
                    "needs JAX; the port reads the 'npy' format"
                )
            view = ckpt_io.load_pytree(path, self._state_view())
            data_offset = 0
            md_path = os.path.join(path, TRAINER_METADATA)
            if os.path.exists(md_path):
                # The reference also writes a goodput ledger ("timeline"),
                # which the port does not keep yet: ignored.
                try:
                    with open(md_path) as f:
                        data_offset = int(json.load(f).get("data_offset", 0) or 0)
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

    # -- reporting ---------------------------------------------------------
    def _flush(self, pending: List[Dict[str, torch.Tensor]],
               t_start: float) -> Dict[str, float]:
        """The window's metrics in one device→host transfer → the report:
        each scalar metric averaged over its finite values (a window with
        none drops the key), plus batches_per_second (the window's steps
        over the host seconds from `t_start` to the end of that transfer,
        which waits for the window's last step) and steps_skipped."""
        keys = [k for k, v in pending[0].items() if v.dim() == 0]
        host = torch.stack([
            torch.stack([m[k].to(torch.float64) for k in keys])
            for m in pending
        ]).cpu().numpy()
        seconds = time.time() - t_start
        agg: Dict[str, float] = {}
        for i, k in enumerate(keys):
            vals = host[:, i]
            finite = vals[np.isfinite(vals)]
            if finite.size:
                agg[k] = float(finite.mean())
        if "sentinel_skipped" in keys:
            window_skips = int(host[:, keys.index("sentinel_skipped")].sum())
            if window_skips:
                self._steps_skipped += window_skips
                logger.warning(
                    "non-finite guard skipped %d step(s) this window "
                    "(%d total)", window_skips, self._steps_skipped,
                )
            consecutive = int(host[-1, keys.index("sentinel_skips")])
            cap = self.sentinel.max_consecutive_skips
            if cap and consecutive >= cap:
                logger.error(
                    "%d consecutive non-finite steps (max_consecutive_skips"
                    "=%d) and no checkpoint to roll back to; continuing "
                    "with guarded params only", consecutive, cap,
                )
                self._skips = torch.zeros_like(self._skips)
        agg["batches_per_second"] = len(pending) / seconds if seconds > 0 else 0.0
        agg["steps_skipped"] = float(self._steps_skipped)
        self._last_throughput = agg["batches_per_second"]
        return agg

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
        # step, so a resumed run sees the data an uninterrupted one sees:
        # through .skip(n) when the dataset has it (in place: it returns
        # None or itself), else by discarding batches.
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

        chief = self.core.distributed.is_chief
        pending: List[Dict[str, torch.Tensor]] = []
        last_val: Dict[str, float] = {}
        t_report = time.time()
        step = self._step
        last_ckpt_step = -1
        preempted = False
        self.core.train.heartbeat_step(step)

        def flush_report() -> None:
            nonlocal pending, t_report
            if pending:
                agg = self._flush(pending, t_report)
                if chief:
                    self.core.train.report_training_metrics(step, agg)
            pending = []
            t_report = time.time()

        # The finally-join keeps a raising step loop from abandoning an
        # in-flight background save, and makes a failed save fail the run.
        fit_error: Optional[BaseException] = None
        try:
            for op in searcher.operations():
                target = to_batches(op.length, bpe)
                while step < target:
                    batch = self._put_batch(next(train_iter))
                    pending.append(self._train_step(batch))
                    step += 1
                    self._step = step
                    if step % rep_period == 0 or step == target:
                        flush_report()
                        self.core.train.heartbeat_step(step)
                        if chief:
                            op.report_progress(float(step))
                        if self.core.preempt.should_preempt():
                            self._save_checkpoint(sync=True)
                            last_ckpt_step = step
                            logger.info("preempted at step %d; exiting "
                                        "cleanly", step)
                            preempted = True
                            break
                    if val_period and step % val_period == 0 and step < target:
                        last_val = self._validate()
                        if last_val and chief:
                            self.core.train.report_validation_metrics(step, last_val)
                    if ckpt_period and step % ckpt_period == 0:
                        flush_report()
                        self._save_checkpoint()
                        last_ckpt_step = step
                if preempted:
                    break
                flush_report()
                last_val = self._validate()
                if chief:
                    if last_val:
                        self.core.train.report_validation_metrics(step, last_val)
                    completion = {"batches_per_second": self._last_throughput,
                                  **last_val}
                    op.report_completed(
                        float(completion.get(self.searcher_metric, 0.0)))
            if (ckpt_period or preempted) and last_ckpt_step != step:
                self._save_checkpoint(sync=True)
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
        return last_val
