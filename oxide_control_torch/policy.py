"""Policies over observations: a tanh MLP as an ``nn.Module``.

The port of ``oxide_control_tpu/policy.py``.  Its weights are the runtime
inputs of the rollout kernel (``FastRollout`` packs them at each call), so
updating the module between calls needs no rebuild.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from . import default_device


class MLPPolicy(nn.Module):
    """Deterministic tanh MLP: obs -> tanh(W_n ... tanh(W_1 obs + b_1) +
    b_n).  The final tanh bounds actions in [-1, 1] (the step clips to the
    ctrlrange regardless).  ``explore_sigma`` adds N(0, sigma^2) noise to
    the ctrl inside the kernel (Philox + Box-Muller)."""

    def __init__(self, n_obs: int, nu: int, hidden: Sequence[int] = (64, 64),
                 explore_sigma: float = 0.0,
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.explore_sigma = float(explore_sigma)
        self.n_obs, self.nu = n_obs, nu
        device = default_device(device)
        dims = [n_obs, *self.hidden, nu]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device, dtype=dtype)
            for i in range(len(dims) - 1)
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Xavier-uniform weights, zero biases (the reference's
        ``init_params``), drawn from ``generator``."""
        with torch.no_grad():
            for layer in self.layers:
                out, inp = layer.weight.shape
                lim = math.sqrt(6.0 / (inp + out))
                layer.weight.uniform_(-lim, lim, generator=generator)
                layer.bias.zero_()

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., n_obs) -> ctrl (..., nu), without exploration."""
        x = obs
        for layer in self.layers:
            x = torch.tanh(x @ layer.weight.T + layer.bias)
        return x

    def kernel_params(self) -> list[torch.Tensor]:
        """(W_1, b_1, ..., W_L, b_L) with W (out, in) and b (out, 1): the
        rollout kernel's runtime inputs."""
        out = []
        for layer in self.layers:
            out.append(layer.weight.detach())
            out.append(layer.bias.detach().reshape(-1, 1))
        return out
