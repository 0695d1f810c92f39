"""Quaternion and 6D spatial-vector algebra (MuJoCo conventions), batched.

The port of ``oxide_control_tpu/physics/maths.py``.  Every function works
on tensors with any leading axes (the env axis first), so the general path
calls them on whole batches where the reference ``vmap``s one env.

* Quaternions are ``(w, x, y, z)`` scalar-first unit quaternions.
* Rotation matrices map body frame -> world frame.
* 6D spatial vectors are ``[angular(3); linear(3)]``.
* Spatial inertias about an origin are ``(I0: 3x3, h: 3, m)`` with
  ``h = m * (com - origin)``.

The dense solves are torch's batched factorizations in their ``_ex``
forms, which return their error flags as tensors and so read nothing
back to the host: the step runs inside a captured CUDA graph.  A matrix
that is not positive definite gets a NaN factor, as in the reference.
"""

from __future__ import annotations

import torch


class TensorOps:
    """The backend ops of the scalar-graph helpers (``physics.muscle``,
    ``suite.rewards``) on plain tensors of any shape; a Python bool
    condition picks a branch."""

    @staticmethod
    def where(c, a, b):
        if isinstance(c, bool):
            return a if c else b
        return torch.where(c, a, b)

    abs = staticmethod(torch.abs)
    cos = staticmethod(torch.cos)
    exp = staticmethod(torch.exp)
    tanh = staticmethod(torch.tanh)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def maximum(x, c):
        return torch.clamp(x, min=c)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (broadcasting leading axes)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((a * a).sum(-1))


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v for (..., n, k) and (..., k)."""
    return (m * v[..., None, :]).sum(-1)


def matTvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m^T @ v for (..., k, n) and (..., k)."""
    return (m * v[..., :, None]).sum(-2)


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u * v."""
    w1, x1, y1, z1 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    w2, x2, y2, z2 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """q / |q|; the zero quaternion maps to the identity."""
    n = norm(q)[..., None]
    ok = n > eps
    out = q / torch.where(ok, n, torch.ones_like(n))
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    return torch.where(ok, out, ident)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (body -> world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion with w >= 0 (Shepperd: the
    candidate with the largest pivot)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    q0 = torch.stack([1.0 + tr, m[..., 2, 1] - m[..., 1, 2],
                      m[..., 0, 2] - m[..., 2, 0],
                      m[..., 1, 0] - m[..., 0, 1]], dim=-1)
    q1 = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                      1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                      m[..., 0, 1] + m[..., 1, 0],
                      m[..., 0, 2] + m[..., 2, 0]], dim=-1)
    q2 = torch.stack([m[..., 0, 2] - m[..., 2, 0],
                      m[..., 0, 1] + m[..., 1, 0],
                      1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                      m[..., 1, 2] + m[..., 2, 1]], dim=-1)
    q3 = torch.stack([m[..., 1, 0] - m[..., 0, 1],
                      m[..., 0, 2] + m[..., 2, 0],
                      m[..., 1, 2] + m[..., 2, 1],
                      1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]],
                     dim=-1)
    piv = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    idx = torch.argmax(piv, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor):
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, w_local: torch.Tensor, dt):
    """mju_quatIntegrate: q * exp(0.5 * w_local * dt), renormalized."""
    angle = norm(w_local)
    pos = angle > 0
    axis = w_local / torch.where(pos, angle, torch.ones_like(angle))[
        ..., None]
    dq = axis_angle_to_quat(axis, angle * dt)
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    dq = torch.where(pos[..., None], dq, ident)
    return quat_normalize(quat_mul(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """mju_subQuat: v with qb * exp(v/2) = qa (local frame)."""
    qdif = quat_mul(quat_conj(qb), qa)
    qdif = qdif * torch.where(qdif[..., :1] < 0, -1.0, 1.0).to(qdif.dtype)
    s = norm(qdif[..., 1:])
    angle = 2.0 * torch.atan2(s, qdif[..., 0])
    pos = s > 0
    axis = qdif[..., 1:] / torch.where(pos, s, torch.ones_like(s))[..., None]
    return torch.where(pos[..., None], axis * angle[..., None],
                       torch.zeros_like(axis))


# ---------------------------------------------------------------------------
# 6D spatial vectors
# ---------------------------------------------------------------------------


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    w, l = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, ml) + cross(l, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    w, l = v[..., :3], v[..., 3:]
    fa, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fa) + cross(l, fl), cross(w, fl)], dim=-1)


def inertia_mul_motion(i0, h, m, v):
    """(I0, h, m) applied to motion [w; v]: t = I0 w + h x v,
    f = m v - h x w."""
    w, vl = v[..., :3], v[..., 3:]
    t = matvec(i0, w) + cross(h, vl)
    f = m[..., None] * vl - cross(h, w)
    return torch.cat([t, f], dim=-1)


def spatial_inertia(mass, inert_diag, ipos, imat, origin):
    """(I0, h, m) about ``origin`` (parallel-axis theorem)."""
    c = ipos - origin
    i_c = torch.einsum("...ij,...j,...kj->...ik", imat,
                       inert_diag.expand(imat.shape[:-1]), imat)
    cc = c[..., :, None] * c[..., None, :]
    c2 = (c * c).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    i0 = i_c + mass[..., None, None] * (c2 * eye - cc)
    h = mass[..., None] * c
    return i0, h, mass


# ---------------------------------------------------------------------------
# small dense linear algebra, batched over leading axes
# ---------------------------------------------------------------------------


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``a (..., n, n)`` (NaN where ``a`` is
    not positive definite)."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l,
                       torch.full_like(l, float("nan")))


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with (l l^T) x = b; b is (..., n) or (..., n, k)."""
    vec = b.dim() == l.dim() - 1
    y = torch.linalg.solve_triangular(l, b[..., None] if vec else b,
                                      upper=False)
    x = torch.linalg.solve_triangular(l.mT, y, upper=True)
    return x[..., 0] if vec else x


def solve_pd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = a^-1 b for SPD ``a``."""
    return cho_solve(cholesky(a), b)


def solve_lu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = a^-1 b by LU with partial pivoting; b is (..., n)."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(a)
    return torch.linalg.lu_solve(lu, pivots, b[..., None])[..., 0]
