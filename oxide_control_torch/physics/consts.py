"""Model constants as device tensors, built once per (model, device, dtype).

The general path reads the model's numpy fields as torch tensors on the
batch's device.  Converting them at every call would copy from the host
inside the step, which a CUDA graph cannot capture, so each constant is
converted on first use and cached here: a step replayed from a graph reads
only tensors that already sit on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import Model

_CACHE: dict = {}


class Consts:
    """The constants of one model on one device in one float dtype."""

    def __init__(self, model: Model, device, dtype: torch.dtype):
        self.model = model
        self.device = device
        self.dtype = dtype
        self._c: dict = {}

    def _put(self, key, value, dtype):
        t = self._c.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(value), device=self.device)
            t = t.to(dtype)
            self._c[key] = t
        return t

    def f(self, name: str) -> torch.Tensor:
        """The model's numeric field ``name`` as a float tensor."""
        return self._put(("f", name), getattr(self.model, name), self.dtype)

    def t(self, key: str, fn) -> torch.Tensor:
        """A float tensor of ``fn()`` (numpy), cached under ``key``."""
        t = self._c.get(("t", key))
        return t if t is not None else self._put(("t", key), fn(), self.dtype)

    def i(self, key: str, fn) -> torch.Tensor:
        """An int64 index tensor of ``fn()``, cached under ``key``."""
        t = self._c.get(("i", key))
        return t if t is not None else self._put(("i", key), fn(),
                                                 torch.int64)

    def b(self, key: str, fn) -> torch.Tensor:
        """A bool mask tensor of ``fn()``, cached under ``key``."""
        t = self._c.get(("b", key))
        return t if t is not None else self._put(("b", key), fn(),
                                                 torch.bool)


def consts(model: Model, like: torch.Tensor) -> Consts:
    """The cached :class:`Consts` of ``model`` on ``like``'s device and
    float dtype."""
    key = (id(model), like.device, like.dtype)
    c = _CACHE.get(key)
    if c is None or c.model is not model:
        c = _CACHE[key] = Consts(model, like.device, like.dtype)
    return c
