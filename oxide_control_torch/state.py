"""Simulation state: the port's analog of MuJoCo's ``mjData``, core fields.

The rollout kernel carries only the core state of each env -- qpos, qvel,
act, the Newton warmstart and time -- so this slice ports those fields of
``oxide_control_tpu/state.py`` (``make_data``).  Arrays are torch tensors;
a batch is the same structure with a leading env axis.  The derived
quantities of the general path (frames, inertias, contacts, sensors) come
with ROADMAP Queue A item 11.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import Model


@dataclasses.dataclass
class Data:
    """Core per-env state (env-major when batched: ``qpos (B, nq)``)."""

    time: torch.Tensor            # () or (B,)
    qpos: torch.Tensor            # (nq,)
    qvel: torch.Tensor            # (nv,)
    act: torch.Tensor             # (na,)
    ctrl: torch.Tensor            # (nu,)
    qacc_warmstart: torch.Tensor  # (nv,)

    def replace(self, **updates) -> "Data":
        return dataclasses.replace(self, **updates)


def make_data(model: Model, device, dtype: torch.dtype | None = None,
              batch: int | None = None) -> Data:
    """mj_makeData + mj_resetData for the core fields: qpos = qpos0,
    everything else zero.  ``batch`` adds a leading env axis."""
    dtype = dtype or torch.from_numpy(np.asarray(model.qpos0)).dtype
    lead = () if batch is None else (batch,)

    def z(n):
        return torch.zeros(lead + (n,), dtype=dtype, device=device)

    qpos0 = torch.as_tensor(np.asarray(model.qpos0), dtype=dtype,
                            device=device)
    return Data(
        time=torch.zeros(lead, dtype=dtype, device=device),
        qpos=qpos0.expand(lead + (model.nq,)).clone(),
        qvel=z(model.nv),
        act=z(model.na),
        ctrl=z(model.nu),
        qacc_warmstart=z(model.nv),
    )
