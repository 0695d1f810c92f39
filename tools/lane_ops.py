"""Count the rollout kernel's emitted lane-ops per model, on the CPU.

``python3 tools/lane_ops.py`` from the root of the repository prints, for
the model of each of ``chip_smoke.ROWS``: the one-lane (G = 1) step's
lane-ops, the share of them in the line search and in Newton as a whole,
the line search's terms (rows + cone rows), the per-lane step lane-ops of
the team sources at G = 2, 4 and 8, and the team size
``megakernel.team_rule`` gives the model.  The counts are the emitter's
(``ops/emit.py``: one per emitted statement, times the trip counts of the
loops around it); the shares wrap ``_linesearch_scalar`` and ``_newton``
while the step is emitted and read the count before and after.  Needs no
card.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import oxide_control_torch.api.environment as environment  # noqa: E402

# the smoke's environments, built on the CPU
environment.default_device = lambda device=None: torch.device("cpu")

import chip_smoke as cs  # noqa: E402
from oxide_control_torch.ops import megakernel as mk  # noqa: E402
from oxide_control_torch.ops import scalar_graph as sg  # noqa: E402
from oxide_control_torch.ops.emit import Emitter  # noqa: E402


def shares(model, carry_qacc, applied):
    """(step lane-ops, line-search lane-ops, Newton lane-ops) of the G = 1
    step body."""
    em = Emitter("float")
    spent = {"ls": 0, "newton": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            before = em.ops
            out = fn(*a, **k)
            spent[key] += em.ops - before
            return out
        return wrapped

    ls, newton = sg._linesearch_scalar, sg._newton
    sg._linesearch_scalar = counted("ls", ls)
    sg._newton = counted("newton", newton)
    try:
        step = sg.build_step(model, em, want_qacc=carry_qacc)
        ld = em.load
        ext = {}
        if model.nmocap:
            ext["mocap"] = ld("mc", 7 * model.nmocap)
        if applied:
            ext.update(qfrc_ext=ld("qf", model.nv),
                       xfrc_ext=ld("xf", 6 * model.nbody))
        eq = ld("eq", model.neq, "b") if model.neq else None
        step(ld("q", model.nq), ld("v", model.nv), ld("a", model.na),
             ld("w", model.nv), ld("c", model.nu), eq, **ext)
    finally:
        sg._linesearch_scalar, sg._newton = ls, newton
    return em.ops, spent["ls"], spent["newton"]


def main():
    seen = set()
    for row, key, _, _, push in cs.ROWS:
        if (key, push) in seen:
            continue
        seen.add((key, push))
        benv = cs.ENVS[key]()
        hooks = benv.task.kernel_hooks(benv.model)
        spec = mk.env_spec(benv.model, hooks, push)
        ops, ls, newton = shares(benv.model, spec.carry_qacc, push)
        base = mk.kernel_source(benv.model, hooks, "float", push, team=1)
        per_lane = [mk.kernel_source(benv.model, hooks, "float", push,
                                     team=g).step_ops for g in (2, 4, 8)]
        print(f"{row}: G=1 step {base.step_ops} lane-ops (line search "
              f"{100 * ls / ops:.1f}%, Newton {100 * newton / ops:.1f}%), "
              f"{base.line_search_terms} line-search terms; per lane at "
              f"G=2/4/8: {' / '.join(str(n) for n in per_lane)}; "
              f"team_rule: G={mk.team_rule(base)}")


if __name__ == "__main__":
    main()
