"""Each metric's arithmetic on a synthetic run record and trace."""

import pytest

from benchmark import compare, roofline, spec, trace
from benchmark.measure import percentile


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic_trace():
    """A 100 us window: kernels at 10-30 and 25-40 (overlapping), a copy at
    60-70, a memset outside the window; host spans bench.call 0-50 and
    bench.read 50-95."""
    return {"traceEvents": [
        event("bench.window", "user_annotation", 0, 100),
        event("bench.call", "user_annotation", 0, 50),
        event("bench.read", "user_annotation", 50, 45),
        event("oxc_rollout_kernel(float*)", "kernel", 10, 20),
        event("other_kernel", "kernel", 25, 15),
        event("Memcpy DtoH", "gpu_memcpy", 60, 10),
        event("Memset", "gpu_memset", 120, 5),
        event("aten::add", "cpu_op", 0, 5),
        {"ph": "i", "name": "marker", "ts": 3},
    ]}


def test_busy_is_the_union_of_device_events_in_the_window():
    s = trace.summarize(synthetic_trace())
    assert trace.busy_intervals(s) == [(10, 40), (60, 70)]
    assert trace.busy_s(s) == pytest.approx(40e-6)
    assert trace.window_s(s) == pytest.approx(100e-6)


def test_idle_gaps_are_labelled_by_the_host_span():
    gaps = trace.idle_gaps(trace.summarize(synthetic_trace()))
    assert gaps == [("bench.read", pytest.approx(30e-6)),
                    ("bench.read", pytest.approx(20e-6)),
                    ("bench.call", pytest.approx(10e-6))]
    assert sum(g for _, g in gaps) == pytest.approx(60e-6)


def test_device_ops_and_kernels():
    s = trace.summarize(synthetic_trace())
    ops = trace.device_ops(s)
    assert ops[0] == ("oxc_rollout_kernel(float*)", pytest.approx(20e-6), 1)
    assert [o[0] for o in ops] == ["oxc_rollout_kernel(float*)",
                                   "other_kernel", "Memcpy DtoH"]
    assert trace.kernels(s, "oxc_rollout_kernel") == (
        pytest.approx(20e-6), 1)
    assert trace.kernels(s)[1] == 2


def record(kind, traced=True):
    cell = spec.load_cell("cheetah-run.policy-obs" if kind == "fast_rollout"
                          else "cheetah-run.general")
    calls = [(1.0 + i, 1.001 + i, 1.5 + i) for i in range(20)]
    calls[7] = (8.0, 8.001, 9.4)       # two slow calls
    calls[12] = (13.0, 13.001, 14.4)
    return {"cell": cell, "kind": kind, "B": 4096, "K": 200, "calls": calls,
            "t_start": 1.0, "setup_s": 12.5,
            "trace": trace.summarize(synthetic_trace()) if traced else None,
            "traced_calls": 1, "crossing_calls": 0}


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_rates_p95_and_setup():
    rec = record("fast_rollout")
    assert read("env_steps_per_s", rec) == pytest.approx(
        4096 * 200 * 20 / (20.5 - 1.0))
    assert read("general_env_steps_per_s", rec) is None
    # 20 calls: the 95th percentile by the nearest rank is the 19th,
    # the faster of the two slow calls
    assert read("call_ms_p95", rec) == pytest.approx(1400.0)
    assert read("setup_s", rec) == 12.5
    assert read("driver_host_ms", rec) == pytest.approx(1.0)
    gen = record("jit_rollout")
    assert read("general_env_steps_per_s", gen) == pytest.approx(
        4096 * 200 * 20 / 19.5)
    assert read("env_steps_per_s", gen) is None


def test_percentile_takes_every_call():
    assert percentile(list(range(1, 101)), 0.95) == 95
    assert percentile([5.0], 0.95) == 5.0
    assert compare.quantile(__import__("torch").arange(1., 101.),
                            0.99) == 99.0


def test_trace_metrics_and_silence_without_a_trace():
    rec = record("fast_rollout")
    assert read("kernel_ms", rec) == pytest.approx(0.02)
    assert read("device_idle_pct.kernel", rec) == pytest.approx(60.0)
    assert read("device_idle_pct.general", rec) is None
    bare = record("fast_rollout", traced=False)
    for name in ("kernel_ms", "kernel_roofline_pct",
                 "device_idle_pct.kernel"):
        assert read(name, bare) is None
    gen = record("jit_rollout")
    assert read("general_launches_per_step", gen) == pytest.approx(2 / 200)
    busy = 40e-6
    least, by = roofline.least_time(roofline.call_work(
        gen["cell"].config, gen["cell"].traffic, 4096, 200, 0))
    value, note = read("general_roofline_pct", gen)
    assert value == pytest.approx(100 * least / busy)
    assert note == f"bound by {by}"


def test_roofline_reads_the_frozen_counts():
    cell = spec.load_cell("cheetah-run.ctrl")
    cfg, w = cell.config, cell.config["work"]
    work = roofline.call_work(cfg, cell.traffic, 4096, 200, 4096)
    ops = 4096 * 200 * (w["step_lane_ops"] + w["env_lane_ops"])
    n_draws = 9 + 2 * 18
    ops += 4096 * (w["reset_lane_ops"] + 25 * n_draws + 8 * 18)
    assert work["lane_ops"] == ops
    assert work["sfu_ops"] == 4096 * 200 * w["step_sfu_ops"] + 4096 * 54
    # state in and out, reward sum and divergence count, the ctrl input
    assert work["bytes"] == 4 * 4096 * (2 * (9 + 18 + 1 + 1) + 2) \
        + 4 * 200 * 6 * 4096
    t, by = roofline.least_time(work)
    assert by == "lane_ops" and t == pytest.approx(ops / 33.5e12)
    # the policy's MLP (17-64-64-6) and its noise are counted from shapes
    pol = spec.load_cell("cheetah-run.policy-obs")
    with_mlp = roofline.call_work(pol.config, pol.traffic, 1, 1, 0)
    bare = roofline.call_work(cfg, cell.traffic, 1, 1, 0)
    macs = 17 * 64 + 64 * 64 + 64 * 6
    assert with_mlp["lane_ops"] - bare["lane_ops"] == \
        2 * macs + 2 * 134 + 25 * 12 + 8 * 6
    assert with_mlp["sfu_ops"] - bare["sfu_ops"] == 134 + 18


def test_gaps():
    import torch
    got = {"qpos": torch.tensor([[1.0, 2.0], [0.0, 0.5]]),
           "obs": torch.zeros(3, 2, 2), "rewards": torch.zeros(3, 2)}
    want = {"qpos": torch.tensor([[1.0, 2.2], [0.0, 0.5]]),
            "obs": torch.zeros(3, 2, 2), "rewards": torch.zeros(3, 2)}
    got["obs"][1, 0, 1] = float("nan")
    steps = compare.step_gaps(got, want)
    assert steps.shape == (3, 2)
    assert steps[1, 1] == float("inf") and steps[2, 1] == 0.0
    assert compare.end_gaps(got, want).tolist() == pytest.approx(
        [0.0, 0.2 / 2.2])
    assert compare.env_gaps(got, want).tolist() == [0.0, float("inf")]
    assert compare.rel_gap_max((got["qpos"],), (want["qpos"],)) == \
        pytest.approx(0.2 / 2.2)
    # a share over a threshold counts an infinite gap as over it
    gaps = compare.step_gaps(got, want).flatten()
    assert compare.share_over(gaps, 1e-3) == pytest.approx(1 / 6)
    notes = compare.spread("step_gap", gaps)
    assert notes["step_gap_n"] == 6 and notes["step_gap_over_1e-3"] == \
        pytest.approx(1 / 6)


@pytest.mark.parametrize("name", ["humanoid-run.policy-obs",
                                  "cheetah-run.general",
                                  "cheetah-run.policy-obs"])
def test_every_window_meets_the_time_limit_at_the_drawn_call(name):
    from benchmark import run
    from benchmark.spec import load_cell
    cell = load_cell(name)
    lo, hi = cell.traffic["limit_at_call"]
    episode = int(cell.config["episode_steps"])
    seen = set()
    for seed in (0, 1, 2 ** 31 + 7, 3 * 10 ** 9, 12345):
        start = run.start_step(cell, seed, cell.steps)
        first = next(i for i in range(hi + 2)
                     if run.crosses(i, cell.steps, episode, start))
        assert lo <= first <= hi if episode > cell.steps * (
            run.WARM_CALLS + hi + 1) else first <= hi
        seen.add(first)
    assert len(seen) > 1 or episode <= cell.steps * (run.WARM_CALLS + 1)
