"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The run sets
the cell up (the program's imports, model, kernel emission and load,
reset and warm-up calls: ``setup_s``), then one caller works a closed loop
of calls for ``--seconds``: each call is issued and its mean return read
on the host before the next.  With ``--trace 1`` the profiler records the
traffic's ``trace_calls`` calls and the per-layer metrics are read from
it; without, the end-to-end metrics from the host clock.  Once the window
has closed and the peak memory is read, the program's state is freed and
a sample of the calls, drawn from the seed, is compared with the plain
reference under ``benchmark/reference``.  The last line of standard
output is one JSON object; the last lines of standard error give each
compared number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys

from .measure import Spans, Stages, clock, log
from .spec import ROOT, driver, load_cell, metric_reader
from .trace import Tracer, busy_s, device_ops, idle_gaps, window_s

FORBIDDEN = ("jax", "jaxlib", "flax", "oxide_control_tpu")
WARM_CALLS = 2


class Reservoir:
    """A uniform sample of ``size`` calls of one class, decided before
    each call (so that a driver keeps only what it will check)."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.seen, self.kept = size, rng, 0, []

    def offer(self, index: int):
        """(keep this call, the call it replaces or None)."""
        j, self.seen = self.seen, self.seen + 1
        if j < self.size:
            self.kept.append(index)
            return True, None
        r = self.rng.randrange(j + 1)
        if r >= self.size:
            return False, None
        old, self.kept[r] = self.kept[r], index
        return True, old


def start_step(cell, seed: int, steps: int) -> int:
    """The step of their episodes at which every env starts, drawn from
    the seed: the time limit then falls in the middle of a timed call
    whose index the traffic's ``limit_at_call`` bounds (and every
    episode's length later), so that a window of any machine holds a call
    that crosses it."""
    lo, hi = cell.traffic["limit_at_call"]
    call = random.Random(f"start {seed}").randint(int(lo), int(hi))
    episode = int(cell.config["episode_steps"])
    return (episode - ((WARM_CALLS + call) * steps + steps // 2)) % episode


def crosses(index: int, steps: int, episode: int, start: int) -> bool:
    """True if timed call ``index`` reaches the time limit of the
    episodes that all stood at step ``start`` at the first warm-up
    call."""
    s = start + (WARM_CALLS + index) * steps
    return (s + steps) // episode > s // episode


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def pin_process(index: int):
    """Keep this process, and every thread it starts, on one CPU: the
    ``index``-th that it may use.  A cell whose rate the host's launches
    pace (the traffic's ``host_cpu``) runs at a speed that differs from
    process to process when the scheduler moves it between cores, and
    steadily on one core."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[index % len(cpus)]})


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_window(drv, cell, seconds: float, seed: int, tracer, spans,
               start: int):
    """The measured window: calls until ``seconds`` have passed since the
    first was issued.  Returns the calls' host stamps, the window's start,
    how many calls the trace holds and the sample of calls kept for the
    check, by class."""
    traffic = cell.traffic
    rng = random.Random(seed)
    pools = {c: Reservoir(n, rng)
             for c, n in traffic["check_calls"].items()}
    episode = int(cell.config["episode_steps"])
    trace_calls = traffic.get("trace_calls") if tracer else 0
    calls, window_span = [], None
    if tracer:
        tracer.start()
        window_span = spans("bench.window")
        window_span.__enter__()
    t_start = clock()
    while True:
        i = len(calls)
        pool = pools["crossing" if crosses(i, drv.K, episode, start)
                     else "other"]
        keep, old = pool.offer(i)
        if old is not None:
            drv.drop(old)
        calls.append(drv.call(keep, i))
        if tracer and window_span is not None and (
                trace_calls is not None and len(calls) == trace_calls):
            window_span.__exit__(None, None, None)
            window_span = None
            tracer.pause()
        if calls[-1][2] - t_start >= seconds:
            break
    if window_span is not None:
        window_span.__exit__(None, None, None)
        tracer.pause()
    traced = len(calls) if trace_calls is None else min(trace_calls,
                                                        len(calls))
    return calls, t_start, traced, {c: list(p.kept)
                                    for c, p in pools.items()}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             sizes=None, stages=None, judge_control: bool = False):
    """Set the cell up on ``device``, run its window, free the program's
    state and compare a sample of its calls with the reference; returns
    the result line's object.  ``sizes`` (B, K) replaces the cell's sizes
    (for a rehearsal on the CPU); ``judge_control`` judges the control
    (the reference in bfloat16) in the program's place."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stages = stages or Stages()
    spans = Spans(trace)
    start = start_step(cell, seed, sizes[1] if sizes else cell.steps)
    drv = driver(cell.traffic["kind"]).Driver(cell, seed, device, stages,
                                               spans, sizes=sizes,
                                               start=start)
    drv.warm(WARM_CALLS)
    sync()
    stages.mark("warm-up")
    tracer = (Tracer(str(ROOT / "build" / "bench" / f"{cell.name}.json"))
              if trace else None)
    setup_s = stages.since_start(clock())
    calls, t_start, traced, kept = run_window(drv, cell, seconds, seed,
                                              tracer, spans, start)
    sync()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda \
        else 0
    summary = tracer.stop() if tracer else None
    failed = drv.release()
    if cuda:
        torch.cuda.empty_cache()
    n_samples = len(drv.samples)
    t_ref = clock()
    numbers, gap_notes = drv.judge(drv.reference(device), cell.limits,
                                   control=judge_control)
    sync()
    ref_s = clock() - t_ref

    episode = int(cell.config["episode_steps"])
    record = {"cell": cell, "kind": cell.traffic["kind"], "B": drv.B,
              "K": drv.K, "calls": calls, "t_start": t_start,
              "setup_s": setup_s, "trace": summary, "traced_calls": traced,
              "crossing_calls": sum(crosses(i, drv.K, episode, start)
                                    for i in range(traced))}
    metrics, notes = {}, {}
    for m in cell.metrics(trace):
        value = metric_reader(m["name"])(record)
        if value is None:
            continue
        if isinstance(value, tuple):
            value, notes[m["name"]] = value
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = {name: {"value": value,
                     "limit": cell.limits.get(name, {}).get("limit")}
              for name, value in numbers.items()}
    # a run whose window held no call that crosses the time limit has not
    # checked the auto-reset, and is not correct
    correct = bool(checks) and bool(kept.get("crossing")) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": int(cell.cell["chips"]),
                   "memory_peak_bytes": memory_peak,
                   "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": drv.B * len(calls),
              "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = busy_s(summary)
        device_info["window_s"] = window_s(summary)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s, _ in device_ops(summary)[:10]],
            "idle_gaps": [[n, s] for n, s in idle_gaps(summary)[:10]]}
    result["setup_stages_s"] = stages.seconds
    result["notes"] = dict(notes, calls=len(calls), checked_calls=n_samples,
                           checked=kept, start_step=start,
                           reference_s=ref_s,
                           team=getattr(drv, "team", None), gaps=gap_notes)
    result["check"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    stages = Stages()
    cell = load_cell(args.workload)
    if cell.traffic.get("host_cpu") is not None:
        pin_process(int(cell.traffic["host_cpu"]))
    import torch
    chips = int(cell.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: the cell needs {chips} CUDA device(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    # builds and caches stay inside the checkout, at fixed paths
    cache = ROOT / "build" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, stages=stages)
    found = forbidden_modules()
    if found:
        log("benchmark: modules loaded that the port must not load: "
            + ", ".join(found))
        return 3
    log(f"setup stages (s): {json.dumps(result['setup_stages_s'])}")
    log(f"notes: {json.dumps(result['notes'])}")
    for name, c in result["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
