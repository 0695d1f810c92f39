"""Tracing and profiling hooks: the port of
``oxide_control_tpu/utils/profiling.py``.

``trace`` captures a ``torch.profiler`` trace of the host and the CUDA
device (Chrome trace format, viewable in Perfetto), ``annotate`` names a
span in it, and ``StepRateMeter`` counts env-steps/s, timed between CUDA
events on a CUDA device and with the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .. import default_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block over the CPU and, when present, CUDA activities;
    yields the profiler (``key_averages()`` sums by operation) and writes
    ``trace.json`` into ``log_dir`` at the end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepRateMeter:
    """Env-steps/s since the last ``reset``: between CUDA events on a
    CUDA ``device`` (the rate synchronizes with the device), on the host
    clock only when the caller passes ``device="cpu"``.  ``None`` is the
    current CUDA device, as for every entry point of the package."""

    def __init__(self, device=None):
        self.cuda = default_device(device).type == "cuda"
        self.reset()

    def reset(self):
        self._steps = 0
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def add(self, env_steps: int):
        self._steps += env_steps

    @property
    def seconds(self) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self._t0.elapsed_time(end) * 1e-3
        return time.perf_counter() - self._t0

    @property
    def rate(self) -> float:
        dt = self.seconds
        return self._steps / dt if dt > 0 else 0.0
