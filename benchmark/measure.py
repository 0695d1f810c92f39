"""Host clock, set-up stages and the benchmark's own spans.

Times on the host are ``time.perf_counter()`` seconds.  A process's age
is read from ``/proc/self/stat`` against ``/proc/uptime`` (clock ticks),
so that ``setup_s`` counts the interpreter's start and the imports too.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time

clock = time.perf_counter


def process_age_s() -> float:
    """Seconds since this process started, to a clock tick."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    # the command name (field 2) may hold spaces: count from its end
    start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Stages:
    """Set-up stages: ``mark(name)`` closes the stage that ended now.  The
    first stage starts when the process did."""

    def __init__(self):
        self.t_start = clock() - process_age_s()
        self.last = self.t_start
        self.seconds = {}

    def mark(self, name: str):
        now = clock()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        self.last = now

    def since_start(self, t: float) -> float:
        return t - self.t_start


class Spans:
    """The benchmark's host spans: ``torch.profiler.record_function`` in
    a traced run, nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


def percentile(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) of ``values`` by the nearest rank:
    the smallest value that at least a share ``q`` of them do not
    exceed."""
    v = sorted(values)
    return v[max(1, math.ceil(q * len(v) - 1e-9)) - 1]


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)
