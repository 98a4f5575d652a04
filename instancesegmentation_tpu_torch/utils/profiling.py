"""Profiling helpers: ``torch.profiler`` traces and step timing.

Port of ``instancesegmentation_tpu/utils/profiling.py``: ``trace`` writes a
Chrome / Perfetto trace (``chrome://tracing``, ui.perfetto.dev) of the
enclosed block, with the card's kernels when CUDA is available;
``StepTimer`` keeps an EMA of the step time; ``time_fn`` takes the median
wall time of a call whose CUDA results it waits for.  The trainer's
``--profile-steps`` uses ``start_trace`` / ``stop_trace``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch


def start_trace(device: torch.device) -> torch.profiler.profile:
    """Start a ``torch.profiler`` of the host and, for a CUDA ``device``,
    the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_trace(profiler: torch.profiler.profile, path: str, device: torch.device) -> None:
    """Wait for a CUDA ``device``, stop ``profiler`` and write its Chrome
    trace to ``path``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    profiler.export_chrome_trace(path)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/traceNNNN.pt.trace.json`` (the next free number), with the
    card's kernels when CUDA is available."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    os.makedirs(log_dir, exist_ok=True)
    n = sum(f.endswith(".pt.trace.json") for f in os.listdir(log_dir))
    profiler = start_trace(device)
    try:
        yield
    finally:
        stop_trace(profiler, os.path.join(log_dir, f"trace{n:04d}.pt.trace.json"), device)


class StepTimer:
    """Images/sec + step-time EMA for the training loop."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.step_time: float | None = None
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (
                dt
                if self.step_time is None
                else self.ema * self.step_time + (1 - self.ema) * dt
            )
        self._last = now
        return self.step_time

    def images_per_sec(self, batch_size: int) -> float | None:
        if self.step_time is None:
            return None
        return batch_size / self.step_time


def _wait(result) -> None:
    """Synchronise every CUDA device a tensor of ``result`` (a tensor or a
    tuple, list or dict of them) lies on."""
    stack, devices = [result], set()
    while stack:
        r = stack.pop()
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, (tuple, list)):
            stack.extend(r)
        elif isinstance(r, dict):
            stack.extend(r.values())
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall time of ``fn(*args)`` in seconds, each call ended by a
    synchronise of the devices its CUDA results lie on."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
