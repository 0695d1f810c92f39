"""Reward shaping: dm_control's ``utils.rewards.tolerance`` family.

The port of ``oxide_control_tpu/suite/rewards.py``.  Every function takes
the backend ``bk`` first, as the kernel hooks do, so one reward expression
runs in the plain version (``scalar_graph.TorchBackend``) and is emitted
into the CUDA kernel (``ops.emit.Emitter``); ``bk=None`` evaluates it on
plain tensors of any shape (``physics.maths.TensorOps``).  Scales are
folded in double with ``math``, and squares are written as products, so
the plain version and the kernel evaluate the same operations.
"""

from __future__ import annotations

import math

from ..physics.maths import TensorOps

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoid(bk, x, value_at_1: float, sigmoid: str):
    if sigmoid in ("cosine", "linear", "quadratic"):
        if not 0 <= value_at_1 < 1:
            raise ValueError(f"`value_at_1` must be in [0, 1) for {sigmoid}, "
                             f"got {value_at_1}")
    elif not 0 < value_at_1 < 1:
        raise ValueError(f"`value_at_1` must be in (0, 1) for {sigmoid}, "
                         f"got {value_at_1}")

    if sigmoid == "gaussian":
        y = x * math.sqrt(-2.0 * math.log(value_at_1))
        return bk.exp(-0.5 * (y * y))
    if sigmoid == "hyperbolic":
        # 1 / cosh(y) = 2 / (e^y + e^-y)
        y = x * math.acosh(1.0 / value_at_1)
        return 2.0 / (bk.exp(y) + bk.exp(-y))
    if sigmoid == "long_tail":
        y = x * math.sqrt(1.0 / value_at_1 - 1.0)
        return 1.0 / (y * y + 1.0)
    if sigmoid == "reciprocal":
        return 1.0 / (bk.abs(x) * (1.0 / value_at_1 - 1.0) + 1.0)
    if sigmoid == "cosine":
        y = x * (math.acos(2.0 * value_at_1 - 1.0) / math.pi)
        return bk.where(bk.abs(y) < 1.0, (1.0 + bk.cos(math.pi * y)) / 2.0,
                        0.0)
    if sigmoid == "linear":
        y = x * (1.0 - value_at_1)
        return bk.where(bk.abs(y) < 1.0, 1.0 - y, 0.0)
    if sigmoid == "quadratic":
        y = x * math.sqrt(1.0 - value_at_1)
        return bk.where(bk.abs(y) < 1.0, 1.0 - y * y, 0.0)
    if sigmoid == "tanh_squared":
        t = bk.tanh(x * math.atanh(math.sqrt(1.0 - value_at_1)))
        return 1.0 - t * t
    raise ValueError(f"unknown sigmoid {sigmoid!r}")


def tolerance(bk, x, bounds=(0.0, 0.0), margin: float = 0.0,
              sigmoid: str = "gaussian",
              value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN):
    """1 when ``x`` is within ``bounds``, decaying to 0 outside through
    ``sigmoid`` (value ``value_at_margin`` at distance ``margin``)."""
    bk = TensorOps if bk is None else bk
    lower, upper = (float(b) for b in bounds)
    if lower > upper:
        raise ValueError("lower bound must be <= upper bound")
    if margin < 0:
        raise ValueError("margin must be non-negative")
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0:
        return bk.where(in_bounds, 1.0, 0.0)
    d = bk.where(x < lower, lower - x, x - upper) / float(margin)
    return bk.where(in_bounds, 1.0,
                    _sigmoid(bk, d, float(value_at_margin), sigmoid))
