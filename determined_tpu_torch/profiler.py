"""Trial profiler: system + device metrics batched to the trial's
``profiling`` metric group.

Port of ``determined_tpu/profiler.py``: a sampler thread collects system
metrics (CPU, memory and network from /proc) plus the card's memory from
the CUDA caching allocator, batches them, and reports them under the
"profiling" group. Same windowing: active from start() for at most
`max_reports` reports; a second start() after stop() does nothing.

`torch_profiler_trace` is the counterpart of the reference's
`jax_profiler_trace`: a ``torch.profiler`` capture of host and card
activity, written as a Chrome trace (TensorBoard's profile plugin and
Perfetto read it). The operator-triggered bounded capture
(`run_bounded_capture`) needs the master and comes with the exec slice.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("determined_tpu_torch.profiler")


def _read_proc_stat() -> Optional[List[int]]:
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        return [int(x) for x in parts[1:9]]
    except (OSError, ValueError):
        return None


def _read_meminfo() -> Dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                out[k] = int(v.strip().split()[0]) * 1024
    except OSError:
        pass
    return out


def _read_net_bytes() -> tuple:
    rx = tx = 0
    try:
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                iface, data = line.split(":", 1)
                if iface.strip() == "lo":
                    continue
                cols = data.split()
                rx += int(cols[0])
                tx += int(cols[8])
    except (OSError, ValueError, IndexError):
        pass
    return rx, tx


def _device_memory_metrics() -> Dict[str, float]:
    """Per-card memory from the CUDA caching allocator: bytes in use and
    their share of the card's memory. Host-side counters only (no CUDA
    call, no sync); absent on the CPU and before CUDA is initialized."""
    out: Dict[str, float] = {}
    try:
        import torch

        if not torch.cuda.is_initialized():
            return out
        for d in range(torch.cuda.device_count()):
            used = torch.cuda.memory_stats(d).get("allocated_bytes.all.current")
            if used is None:
                continue
            out[f"device{d}_bytes_in_use"] = float(used)
            total = torch.cuda.get_device_properties(d).total_memory
            if total:
                out[f"device{d}_hbm_util"] = float(used) / float(total)
    except Exception:  # noqa: BLE001 - profiling must never break training
        pass
    return out


class ProfilerAgent:
    def __init__(
        self,
        train_context,  # core TrainContext (chief only reports)
        *,
        sample_interval_s: float = 1.0,
        report_every: int = 10,
        max_reports: int = 100,
        enabled: bool = True,
    ) -> None:
        self._train = train_context
        self._interval = sample_interval_s
        self._report_every = report_every
        self._max_reports = max_reports
        self._enabled = enabled
        self._samples: List[Dict[str, float]] = []
        # Guards _samples: the sampler thread appends while stop() (the
        # trainer's thread) flushes — unsynchronized, the final flush could
        # read a list mid-append and the post-flush reset could drop a
        # sample the sampler was just adding.
        self._samples_lock = threading.Lock()
        self._reports_sent = 0
        self._steps_completed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_cpu: Optional[List[int]] = None
        self._prev_net = _read_net_bytes()
        self._prev_t = time.time()

    def start(self) -> None:
        if not self._enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="profiler"
        )
        self._thread.start()

    def set_steps_completed(self, steps: int) -> None:
        self._steps_completed = steps

    def _sample(self) -> Dict[str, float]:
        now = time.time()
        dt = max(now - self._prev_t, 1e-6)
        metrics: Dict[str, float] = {}
        cpu = _read_proc_stat()
        if cpu is not None and self._prev_cpu is not None:
            total = sum(cpu) - sum(self._prev_cpu)
            idle = (cpu[3] + cpu[4]) - (self._prev_cpu[3] + self._prev_cpu[4])
            if total > 0:
                metrics["cpu_util"] = 1.0 - idle / total
        self._prev_cpu = cpu
        mem = _read_meminfo()
        if "MemTotal" in mem and "MemAvailable" in mem:
            metrics["memory_used_bytes"] = float(mem["MemTotal"] - mem["MemAvailable"])
        rx, tx = _read_net_bytes()
        metrics["net_rx_bytes_per_s"] = (rx - self._prev_net[0]) / dt
        metrics["net_tx_bytes_per_s"] = (tx - self._prev_net[1]) / dt
        self._prev_net = (rx, tx)
        self._prev_t = now
        metrics.update(_device_memory_metrics())
        return metrics

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            if self._reports_sent >= self._max_reports:
                return  # hard cap, like the reference's auto-disable
            sample = self._sample()
            with self._samples_lock:
                self._samples.append(sample)
                full = len(self._samples) >= self._report_every
            if full:
                self._flush()

    def _flush(self) -> None:
        # Swap under the lock, aggregate outside it: a concurrent sampler
        # append lands in the fresh list instead of racing the one being
        # averaged (the old code mutated _samples from two threads).
        with self._samples_lock:
            samples, self._samples = self._samples, []
        if not samples:
            return
        keys = set().union(*(s.keys() for s in samples))
        avg = {
            k: sum(s.get(k, 0.0) for s in samples) / len(samples)
            for k in keys
        }
        try:
            self._train.report_metrics("profiling", self._steps_completed, avg)
            self._reports_sent += 1
        except Exception as e:  # noqa: BLE001
            logger.warning("profiler report failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._flush()


@contextlib.contextmanager
def torch_profiler_trace(logdir: str):
    """A ``torch.profiler`` capture of host (and, with a card, CUDA)
    activity around the block, written into `logdir` as a Chrome trace
    (``<host>.<pid>.pt.trace.json``) when the block ends: the
    counterpart of the reference's ``jax_profiler_trace``."""
    import socket

    import torch

    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"))
