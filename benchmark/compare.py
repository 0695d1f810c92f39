"""The arithmetic of the comparison that decides ``correct``.

Every output is compared with the reference's by its relative gap,
``|got - want| / max(1, |want|)`` (an absolute gap for values within 1 of
zero); a non-finite output where the reference is finite reads as an
infinite gap.  An env's gap is the largest over every output of the call
that belongs to it, with the env axis last in every tensor.
"""

from __future__ import annotations

import torch


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    got = got.to(want.device, torch.float64)
    want = want.to(torch.float64)
    gap = (got - want).abs() / want.abs().clamp_min(1.0)
    return torch.nan_to_num(gap, nan=float("inf"))


def rel_gap_max(got, want) -> float:
    """The largest relative gap over tensors paired up in two tuples."""
    return max(float(rel_gap(g, w).max()) for g, w in zip(got, want))


def abs_gap_max(got: torch.Tensor, want: torch.Tensor) -> float:
    gap = (got.to(want.device, torch.float64) - want.to(torch.float64))
    return float(torch.nan_to_num(gap.abs(), nan=float("inf")).max())


PER_STEP = ("obs", "rewards", "dones")
AT_END = ("qpos", "qvel", "time", "reward_sum")


def _rows(got: dict, want: dict, keys):
    """(rows, B) gaps of the outputs in ``keys``: one row per step of a
    per-step output, the largest over its other axes."""
    out = None
    for key in keys:
        if key not in got:
            continue
        gap = rel_gap(got[key], want[key])
        if key in PER_STEP and gap.dim() == 3:
            gap = gap.amax(1)
        elif key in AT_END:
            gap = gap.reshape(-1, gap.shape[-1]).amax(0, keepdim=True)
        out = gap if out is None else torch.maximum(out, gap)
    return out


def step_gaps(got: dict, want: dict) -> torch.Tensor:
    """(K, B): each env's largest relative gap at each step of the call
    (its observation, reward and done), every output with the env axis
    last."""
    return _rows(got, want, PER_STEP)


def end_gaps(got: dict, want: dict) -> torch.Tensor:
    """(B,): each env's largest relative gap at the call's end (its
    state, time and reward sum)."""
    return _rows(got, want, AT_END)[0]


def env_gaps(got: dict, want: dict) -> torch.Tensor:
    """(B,): each env's largest relative gap over every output of the
    call that ``got`` holds."""
    rows = [r for r in (_rows(got, want, PER_STEP),
                        _rows(got, want, AT_END)) if r is not None]
    return torch.cat(rows).amax(0)


def share_over(values: torch.Tensor, over: float) -> float:
    """The share of ``values`` above ``over`` (an infinite value is
    above)."""
    v = values.to(torch.float64).flatten()
    return float((v > over).sum()) / max(1, v.numel())


def spread(name: str, values: torch.Tensor) -> dict:
    """Notes on a set of gaps: its median, 99th, 99.9th percentile and
    largest value, how many there are, and the share above each power of
    ten from 1e-6 to 1e-1."""
    out = {f"{name}_{q}": quantile(values, f)
           for q, f in (("p50", 0.5), ("p99", 0.99), ("p999", 0.999),
                        ("max", 1.0))}
    out[f"{name}_n"] = int(values.numel())
    for e in range(1, 7):
        out[f"{name}_over_1e-{e}"] = share_over(values, 10.0 ** -e)
    return out


def quantile(values: torch.Tensor, q: float) -> float:
    """The ``q`` quantile of ``values`` by the nearest rank: the smallest
    value that at least ``q`` of them do not exceed (an infinite value
    counts as the largest)."""
    v = torch.sort(values.to(torch.float64).flatten()).values
    rank = max(1, -(-int(round(q * 1e6)) * v.numel() // 1_000_000))
    return float(v[rank - 1])
