"""Carry state and policy weights across from the reference's numpy form.

* ``policy_params_from_numpy``: the reference ``MLPPolicy.init_params``
  output (``[(W (out,in), b (out,1)), ...]`` as numpy) -> the port's
  ``MLPPolicy`` with those weights.
* ``state_from_numpy`` / ``state_to_numpy``: the coordinate-major kernel
  state in ``FastRollout.pack`` order, ``(qpos (nq,B), qvel (nv,B),
  act (max(na,1),B), warmstart (nv,B), time (1,B)[, qacc (nv,B)])``, both
  ways (qacc for a task that observes an accelerometer-family sensor).
* ``eq_active_to_kernel`` / ``eq_active_from_kernel``: ``Data.eq_active``
  rows ``(B, neq)`` <-> the kernel's coordinate-major ``(neq, B)``.
* ``mocap_to_kernel``: ``Data.mocap_pos (B, nmocap, 3)`` and
  ``mocap_quat (B, nmocap, 4)`` -> the kernel's ``(7*nmocap, B)``, (pos3,
  quat4) per mocap body.
* ``xfrc_to_kernel``: ``Data.xfrc_applied (B, nbody, 6)`` -> the kernel's
  ``(6*nbody, B)``; ``Data.qfrc_applied (B, nv)`` goes as ``.T``.
"""

from __future__ import annotations

import numpy as np
import torch

from .policy import MLPPolicy


def policy_params_from_numpy(params, device, dtype=torch.float32,
                             explore_sigma: float = 0.0) -> MLPPolicy:
    """An ``MLPPolicy`` holding the given (W, b) layers."""
    ws = [np.asarray(w) for w, _ in params]
    bs = [np.asarray(b) for _, b in params]
    n_obs, nu = ws[0].shape[1], ws[-1].shape[0]
    hidden = tuple(w.shape[0] for w in ws[:-1])
    pol = MLPPolicy(n_obs, nu, hidden=hidden, explore_sigma=explore_sigma,
                    device=device, dtype=dtype)
    with torch.no_grad():
        for layer, w, b in zip(pol.layers, ws, bs):
            layer.weight.copy_(torch.tensor(w, dtype=dtype))
            layer.bias.copy_(torch.tensor(b.reshape(-1), dtype=dtype))
    return pol


def state_from_numpy(arrays, device, dtype=torch.float32):
    """Coordinate-major numpy state -> contiguous tensors on ``device``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                 device=device) for a in arrays)


def state_to_numpy(state):
    """Kernel state tensors -> coordinate-major numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in state)


def eq_active_to_kernel(eq_active, dtype=torch.float32, device=None):
    """(B, neq) 0/1 or bool -> contiguous (neq, B) of ``dtype``."""
    t = torch.as_tensor(eq_active, device=device)
    return t.to(dtype).T.contiguous()


def eq_active_from_kernel(eq_active):
    """(neq, B) kernel rows -> (B, neq) bool, Data.eq_active's form."""
    return eq_active.T != 0


def mocap_to_kernel(mocap_pos, mocap_quat, dtype=torch.float32,
                    device=None):
    """(B, nmocap, 3) positions and (B, nmocap, 4) quaternions ->
    contiguous (7*nmocap, B) of ``dtype``."""
    pos = torch.as_tensor(mocap_pos, device=device).to(dtype)
    quat = torch.as_tensor(mocap_quat, device=device).to(dtype)
    b = pos.shape[0]
    return torch.cat([pos, quat], dim=2).reshape(b, -1).T.contiguous()


def xfrc_to_kernel(xfrc_applied, dtype=torch.float32, device=None):
    """(B, nbody, 6) force-torque rows -> contiguous (6*nbody, B)."""
    t = torch.as_tensor(xfrc_applied, device=device).to(dtype)
    return t.reshape(t.shape[0], -1).T.contiguous()
