"""Time the rollout kernel at team sizes G = 1, 2, 4, 8 on the smoke's rows.

``python3 tools/team_sweep.py [--teams 1,2,4,8] [--rows NAME,...]
[--out PATH]`` on a machine with one CUDA card, from the root of the
repository.  Builds every row's kernel source at each team size (one nvcc
per distinct source, all started at once), then times each row's builds
in turns on the row's own inputs (``chip_smoke.parity_inputs``): G
ascending, then descending, each time one warm-up and
``chip_smoke.N_TIMED`` calls between CUDA events.  Prints one line per
row and G -- kernel ms of both turns, registers, stack and spills,
per-lane step lane-ops and warps per SM -- and writes the table as JSON
to ``--out`` (``team_sweep.json``).  The table fixes the team rule of
``oxide_control_torch/ops/megakernel.py`` (``team_rule``); PERF.md holds
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from oxide_control_torch.ops import megakernel as mk  # noqa: E402
from oxide_control_torch.policy import MLPPolicy  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--teams", default="1,2,4,8")
    ap.add_argument("--rows", default=",".join(r[0] for r in cs.ROWS))
    ap.add_argument("--out", default="team_sweep.json")
    a = ap.parse_args()
    teams = [int(g) for g in a.teams.split(",")]
    rows = [r for r in cs.ROWS if r[0] in a.rows.split(",")]
    name, smi = cs.device_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    benvs = {key: cs.ENVS[key]() for key in {r[1] for r in rows}}
    policies = {key: MLPPolicy(
        benvs[key].task.kernel_hooks(benvs[key].model).n_obs,
        benvs[key].model.nu, hidden=(64, 64), generator=gen)
        for _, key, _, pol, _ in rows if pol}
    fns = {}
    for row, key, k, pol, push in rows:
        benv = benvs[key]
        for g in teams:
            fns[row, g] = mk.build_rollout(
                benv.model, benv.num_envs, k,
                benv.task.kernel_hooks(benv.model), emit_obs=pol,
                policy=policies[key] if pol else None, applied_forces=push,
                team=g)
    t0 = time.perf_counter()
    pool, futures = cs.start_builds(fns)
    built = cs.finish_builds(pool, futures, t0)

    table = []
    for row, key, k, pol, push in rows:
        benv = benvs[key]
        args, kw = cs.parity_inputs(benv, fns[row, teams[0]],
                                    "push" if push else "row")
        ms = {g: [] for g in teams}
        for g in teams + teams[::-1]:
            ms[g].append(cs.time_kernel(fns[row, g], args, kw)[0])
        for g in teams:
            b = built[row, g]
            line = dict(
                row=row, team=g, ms=ms[g], registers=b.registers,
                stack_bytes=b.stack_bytes, spill_stores=b.spill_stores,
                spill_loads=b.spill_loads, step_lane_ops=b.step_ops,
                work_step_lane_ops=b.work_step_ops,
                warps_per_sm=cs.warps_per_sm(fns[row, g], b))
            table.append(line)
            cs.log(f"{row} G={g}: {ms[g][0]:.4f} / {ms[g][1]:.4f} ms, "
                   f"{b.registers} registers, {b.stack_bytes} B stack, "
                   f"spills {b.spill_stores} / {b.spill_loads} B, step "
                   f"{b.step_ops} lane-ops per lane, "
                   f"{line['warps_per_sm']:.2f} warps per SM")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(dict(device=name, smi=smi, table=table), f, indent=1)
    cs.log(f"card: {smi}")


if __name__ == "__main__":
    main()
