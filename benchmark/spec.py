"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic.  A configuration is
``benchmark/configs/<config>.json`` (the file ``BENCHMARK.json`` gives);
a traffic mix is ``benchmark/traffic/<traffic>.json``, whose ``kind``
names its driver, ``benchmark/drivers/<kind>.py``; a metric is
``benchmark/metrics/<metric>.py``, a module with ``read(record)``; a
cell's limits for ``correct`` are ``benchmark/limits/<cell>.json``.  A
later cell, mix or metric is a new file beside these.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def steps(self) -> int:
        """K: the traffic's steps per call, or the configuration's."""
        return int(self.traffic.get("steps_per_call")
                   or self.config["steps_per_call"])

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports in a run with or without the
        trace: those that list it, or that list no cells."""
        group = self.per_layer if trace else self.end_to_end
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{', '.join(sorted(cells))}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / "benchmark"
    return Cell(
        name=name, cell=cell,
        config=_json(root / configs[cell["config"]]["file"]),
        traffic=_json(here / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(here / "limits" / f"{name}.json"),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def driver(kind: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of the metric ``name``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
