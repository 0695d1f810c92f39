"""Read the numbers that ``correct`` compares over many seeds, for the
program and for its control, in one process (set-up is paid once).

    python3 -m benchmark.probe --workload <cell> --seconds <s> \\
        --seeds 11,12,... --control-seeds 21,22,23

Each seed runs the cell as ``benchmark.run`` does (set-up, a window of
``--seconds``, the comparison of a sample of its calls); a control seed
judges the reference computed in bfloat16 in the program's place.  The
last line is a JSON object: every reading, the largest reading of each
number over the program's seeds (``lower``) and the smallest over the
control's (``upper``), from which ``benchmark/limits/<cell>.json`` is set.
``--faults`` plants faults of :mod:`benchmark.faults` under the timed
path, each read on ``--fault-seeds``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from . import faults
from .measure import log
from .run import run_cell
from .spec import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="faults of benchmark.faults, comma-separated")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("probe: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    readings = {"program": {}, "control": {}}
    sides = [("program", args.seeds), ("control", args.control_seeds)]
    sides += [(f"fault:{k}", args.fault_seeds)
              for k in args.faults.split(",") if k]
    for side, seeds in sides:
        readings.setdefault(side, {})
        for seed in (int(s) for s in seeds.split(",") if s):
            with (faults.planted(side[6:]) if side.startswith("fault:")
                  else contextlib.nullcontext()):
                r = run_cell(cell, seed, args.seconds, False, device,
                             judge_control=side == "control")
            nums = {k: c["value"] for k, c in r["check"].items()}
            readings[side][seed] = dict(nums, correct=r["correct"],
                                        calls=r["notes"]["calls"],
                                        gaps=r["notes"]["gaps"],
                                        reference_s=r["notes"]["reference_s"])
            log(f"{side} seed {seed}: {json.dumps(readings[side][seed])}")
    names = sorted({k for r in readings["program"].values() for k in r}
                   - {"correct", "calls", "gaps", "reference_s"})
    least = {side: {n: min(r[n] for r in got.values()) for n in names}
             for side, got in readings.items()
             if side != "program" and got}
    out = {"workload": cell.name, "readings": readings,
           "lower": {n: max(r[n] for r in readings["program"].values())
                     for n in names},
           "upper": least.pop("control", {}), "faults": least}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
