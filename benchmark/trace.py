"""The traced run: ``torch.profiler`` over the host and the device, its
Chrome trace read back, and the arithmetic over it.

What the device did is every event of the categories in
:data:`DEVICE_CATEGORIES` (kernels, copies and memsets); what the host did
is the benchmark's own spans (``bench.*`` annotations).  The traced window
is the span ``bench.window``; device time outside it is cut off.
"""

from __future__ import annotations

import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"


class Tracer:
    """Start and stop ``torch.profiler`` around the traced calls, then
    read its Chrome trace (written to ``path``, removed once read)."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None

    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def pause(self):
        """Stop recording (the trace is read by :meth:`stop`)."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def stop(self) -> dict:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with open(self.path) as f:
            events = json.load(f)
        os.remove(self.path)
        return summarize(events)


def summarize(trace) -> dict:
    """The traced window ``(start, end)`` in microseconds, the device
    events ``[(name, category, start, duration)]`` and the benchmark's
    spans ``[(name, start, end)]`` of a Chrome trace (a dict with
    ``traceEvents`` or a list of events)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATEGORIES:
            device.append((e.get("name", ""), cat, ts, dur))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                "bench."):
            spans.append((e["name"], ts, ts + dur))
    window = [(a, b) for name, a, b in spans if name == WINDOW_SPAN]
    if not window:
        raise ValueError(f"the trace holds no span {WINDOW_SPAN}")
    return {"window": window[0], "device": device,
            "spans": [s for s in spans if s[0] != WINDOW_SPAN]}


def busy_intervals(summary: dict):
    """The union of the device events inside the window, as sorted,
    disjoint ``(start, end)`` pairs (microseconds)."""
    a, b = summary["window"]
    cut = sorted((max(ts, a), min(ts + dur, b))
                 for _, _, ts, dur in summary["device"]
                 if ts < b and ts + dur > a)
    merged = []
    for s, e in cut:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(x) for x in merged]


def busy_s(summary: dict) -> float:
    return sum(e - s for s, e in busy_intervals(summary)) * 1e-6


def window_s(summary: dict) -> float:
    a, b = summary["window"]
    return (b - a) * 1e-6


def idle_gaps(summary: dict):
    """Each stretch of the window with nothing on the device, as
    ``(label, seconds)``, labelled by the benchmark span that holds its
    middle on the host (``host`` where none does), longest first."""
    a, b = summary["window"]
    edges = [a]
    for s, e in busy_intervals(summary):
        edges += [s, e]
    edges.append(b)
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        holders = [(end - start, name) for name, start, end in
                   summary["spans"] if start <= mid <= end]
        label = min(holders)[1] if holders else "host"
        gaps.append((label, (e - s) * 1e-6))
    return sorted(gaps, key=lambda g: -g[1])


def device_ops(summary: dict):
    """Device time by operation name inside the window, as ``(name,
    seconds, count)``, most time first."""
    a, b = summary["window"]
    by = {}
    for name, _, ts, dur in summary["device"]:
        t = min(ts + dur, b) - max(ts, a)
        if t > 0:
            sec, n = by.get(name, (0.0, 0))
            by[name] = (sec + t * 1e-6, n + 1)
    return sorted(((n, s, c) for n, (s, c) in by.items()),
                  key=lambda x: -x[1])


def kernels(summary: dict, part: str = ""):
    """(seconds, count) of the kernels inside the window whose name holds
    ``part`` (all kernels for ``""``)."""
    a, b = summary["window"]
    sec, n = 0.0, 0
    for name, cat, ts, dur in summary["device"]:
        if cat == "kernel" and part in name and a <= ts < b:
            sec += dur * 1e-6
            n += 1
    return sec, n
