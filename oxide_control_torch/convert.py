"""Carry state and policy weights across from the reference's numpy form.

* ``policy_params_from_numpy``: the reference ``MLPPolicy.init_params``
  output (``[(W (out,in), b (out,1)), ...]`` as numpy) -> the port's
  ``MLPPolicy`` with those weights.
* ``state_from_numpy`` / ``state_to_numpy``: the coordinate-major kernel
  state in ``FastRollout.pack`` order, ``(qpos (nq,B), qvel (nv,B),
  act (max(na,1),B), warmstart (nv,B), time (1,B))``, both ways.
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
