"""Divergence detection: the port of
``oxide_control_tpu/utils/divergence.py``.

Per-env flags for masked auto-reset, the batched analog of MuJoCo's
mj_checkPos / mj_checkVel.
"""

from __future__ import annotations

import torch

from ..model import Model

MAXVAL = 1e10


def divergence_flags(model: Model, d) -> torch.Tensor:
    """(B,) bool: the env's state is non-finite or beyond MAXVAL."""
    bad_pos = ((~torch.isfinite(d.qpos)).any(-1)
               | (d.qpos.abs() > MAXVAL).any(-1))
    bad_vel = ((~torch.isfinite(d.qvel)).any(-1)
               | (d.qvel.abs() > MAXVAL).any(-1))
    bad_acc = (~torch.isfinite(d.qacc)).any(-1)
    return bad_pos | bad_vel | bad_acc
