"""The benchmark's files: every part of every cell is found by its name,
and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_are_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.cell["config"]
    assert spec.driver(cell.traffic["kind"]).Driver
    for trace in (False, True):
        for m in cell.metrics(trace):
            assert callable(spec.metric_reader(m["name"]))
    assert cell.steps > 0


@pytest.mark.parametrize("name", CELLS)
def test_every_compared_number_has_a_limit_between_its_readings(name):
    limits = spec.load_cell(name).limits
    assert {"start_gap"} <= set(limits)
    for number, entry in limits.items():
        assert entry["lower"] < entry["limit"] < entry["upper"], number
        # a share over a threshold names the threshold
        assert number.endswith("_share") == ("over" in entry), number


def test_names_units_and_lengths():
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    named = BENCH["configs"] + BENCH["workloads"] + metrics
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert c["reduced"] == spec.load_cell(next(
            w["name"] for w in BENCH["workloads"]
            if w["config"] == c["name"])).config["reduced"]


def test_bounds_and_reporting():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in CELLS:
        cell = spec.load_cell(w)
        reported = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics(True)
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w]), (m["name"], w)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"rollout driver", "rollout kernel",
                           "general path", "device"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_files_hold_their_frozen_work(config):
    cfg = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert data["assumed"]
    # every departure from the published task is a key of the file
    for key in data["reduced"]:
        assert key in data and NAME.match(key), key
    work = data["work"]
    for key in ("step_lane_ops", "step_sfu_ops", "env_lane_ops",
                "reset_lane_ops"):
        assert isinstance(work[key], int) and work[key] >= 0
    assert "G = 1" in work["how"]
    assert (spec.ROOT / data["reference"]).exists()


def test_a_traffic_can_keep_the_process_on_one_cpu():
    import subprocess
    import sys
    code = ("import os\nfrom benchmark import run\nrun.pin_process(2)\n"
            "print(len(os.sched_getaffinity(0)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.split() == ["1"]
    assert spec.load_cell("cheetah-run.general").traffic["host_cpu"] == 2
