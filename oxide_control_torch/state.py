"""Simulation state: the port's analog of MuJoCo's ``mjData``.

The port of ``oxide_control_tpu/state.py``.  Arrays are torch tensors; a
batch is the same structure with a leading env axis (``qpos (B, nq)``),
which is what every function of the general path takes.  The rollout
kernel carries only the core fields (qpos, qvel, act, the warmstart, time
and, for a task that observes an accelerometer-family sensor, qacc;
``parallel.rollout.FastRollout.pack``); the general path
(``physics.forward``) fills every derived field below them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import Model


@dataclasses.dataclass
class Contact:
    """Contact lanes, a fixed number per candidate pair; lanes with
    ``dist >= includemargin`` are inactive."""

    dist: torch.Tensor           # (ncon,)
    pos: torch.Tensor            # (ncon, 3)
    frame: torch.Tensor          # (ncon, 3, 3) rows: normal, t1, t2
    includemargin: torch.Tensor  # (ncon,)
    friction: torch.Tensor       # (ncon, 5)
    solref: torch.Tensor         # (ncon, 2)
    solimp: torch.Tensor         # (ncon, 5)
    geom1: torch.Tensor          # (ncon,) int64
    geom2: torch.Tensor          # (ncon,) int64

    def replace(self, **updates) -> "Contact":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class Data:
    """Per-env state and derived quantities (env-major when batched)."""

    # ----- core state -----
    time: torch.Tensor            # ()
    qpos: torch.Tensor            # (nq,)
    qvel: torch.Tensor            # (nv,)
    act: torch.Tensor             # (na,)
    ctrl: torch.Tensor            # (nu,)
    qacc_warmstart: torch.Tensor  # (nv,)
    qacc: torch.Tensor            # (nv,) constrained acceleration
    qfrc_applied: torch.Tensor = None   # (nv,)
    xfrc_applied: torch.Tensor = None   # (nbody, 6) [force; torque] at com
    mocap_pos: torch.Tensor = None      # (nmocap, 3)
    mocap_quat: torch.Tensor = None     # (nmocap, 4)
    eq_active: torch.Tensor = None      # (neq,) bool

    # ----- position stage -----
    xpos: torch.Tensor = None         # (nbody, 3)
    xquat: torch.Tensor = None        # (nbody, 4)
    xmat: torch.Tensor = None         # (nbody, 3, 3)
    xipos: torch.Tensor = None        # (nbody, 3)
    ximat: torch.Tensor = None        # (nbody, 3, 3)
    xanchor: torch.Tensor = None      # (njnt, 3)
    xaxis: torch.Tensor = None        # (njnt, 3)
    geom_xpos: torch.Tensor = None    # (ngeom, 3)
    geom_xmat: torch.Tensor = None    # (ngeom, 3, 3)
    site_xpos: torch.Tensor = None    # (nsite, 3)
    site_xmat: torch.Tensor = None    # (nsite, 3, 3)
    cam_xpos: torch.Tensor = None     # (ncam, 3)
    cam_xmat: torch.Tensor = None     # (ncam, 3, 3)
    subtree_com: torch.Tensor = None  # (nbody, 3)
    cinert_i: torch.Tensor = None     # (nbody, 3, 3)
    cinert_h: torch.Tensor = None     # (nbody, 3)
    cdof: torch.Tensor = None         # (nv, 6)
    qM: torch.Tensor = None           # (nv, nv)

    # ----- velocity stage -----
    cvel: torch.Tensor = None         # (nbody, 6)
    cdof_dot: torch.Tensor = None     # (nv, 6)
    qfrc_bias: torch.Tensor = None    # (nv,)
    qfrc_passive: torch.Tensor = None  # (nv,)

    # ----- actuation -----
    actuator_length: torch.Tensor = None    # (nu,)
    actuator_velocity: torch.Tensor = None  # (nu,)
    actuator_force: torch.Tensor = None     # (nu,)
    act_dot: torch.Tensor = None            # (na,)
    qfrc_actuator: torch.Tensor = None      # (nv,)

    # ----- acceleration -----
    qfrc_smooth: torch.Tensor = None  # (nv,)
    qacc_smooth: torch.Tensor = None  # (nv,)

    # ----- constraints -----
    contact: Contact = None
    nefc_active: torch.Tensor = None      # () int64
    qfrc_constraint: torch.Tensor = None  # (nv,)
    contact_force: torch.Tensor = None    # (ncon, 6) [torque; force]

    # ----- sensors -----
    sensordata: torch.Tensor = None   # (nsensordata,)
    efc_limit: torch.Tensor = None    # (nlimitrow, 3)

    # ----- solver statistics -----
    solver_cost: torch.Tensor = None      # ()
    solver_gradnorm: torch.Tensor = None  # ()
    solver_niter: torch.Tensor = None     # () int64

    def replace(self, **updates) -> "Data":
        return dataclasses.replace(self, **updates)

    @property
    def ncon(self) -> int:
        return self.contact.dist.shape[-1]


def tree_map(fn, *datas):
    """``fn`` applied leaf by leaf over Data (and its Contact)."""
    first = datas[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(d, f.name) for d in datas]
        if vals[0] is None:
            out[f.name] = None
        elif isinstance(vals[0], Contact):
            out[f.name] = Contact(**{
                g.name: fn(*[getattr(v, g.name) for v in vals])
                for g in dataclasses.fields(Contact)})
        else:
            out[f.name] = fn(*vals)
    return type(first)(**out)


def _ncon_slots(model: Model) -> int:
    from .physics.collision import max_contacts_per_pair

    return sum(max_contacts_per_pair(t1, t2) * len(pairs)
               for (t1, t2, pairs) in model.pair_groups)


def _n_limit_rows(model: Model) -> int:
    from .physics.constraint import n_limit_rows

    return n_limit_rows(model)


def mocap_rest_pose(model: Model):
    """(pos (nmocap, 3), quat (nmocap, 4)): the mocap bodies' rest poses,
    their body_pos and body_quat in mocap order."""
    ids = np.argsort(model.body_mocapid)[model.nbody - model.nmocap:]
    return (np.asarray(model.body_pos)[ids].reshape(-1, 3),
            np.asarray(model.body_quat)[ids].reshape(-1, 4))


def make_data(model: Model, device, dtype: torch.dtype | None = None,
              batch: int | None = None) -> Data:
    """mj_makeData + mj_resetData: qpos = qpos0, the mocap bodies at their
    rest pose, eq_active = eq_active0, everything else zero (frames the
    identity).  ``batch`` adds a leading env axis."""
    dtype = dtype or torch.from_numpy(np.asarray(model.qpos0)).dtype
    lead = () if batch is None else (batch,)
    nbody, nv, njnt = model.nbody, model.nv, model.njnt
    ncon = _ncon_slots(model)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    def full(arr, shape):
        t = torch.as_tensor(np.asarray(arr, dtype=np.float64),
                            device=device).to(dtype)
        return t.reshape(shape).expand(lead + shape).clone()

    def eye(n):
        return torch.eye(3, dtype=dtype, device=device).expand(
            lead + (n, 3, 3)).clone()

    ident = z(nbody, 4)
    ident[..., 0] = 1.0
    mpos, mquat = mocap_rest_pose(model)
    contact = Contact(
        dist=torch.full(lead + (ncon,), 1e10, dtype=dtype, device=device),
        pos=z(ncon, 3),
        frame=eye(ncon),
        includemargin=z(ncon),
        friction=torch.ones(lead + (ncon, 5), dtype=dtype, device=device),
        solref=z(ncon, 2),
        solimp=z(ncon, 5),
        geom1=torch.zeros(lead + (ncon,), dtype=torch.int64, device=device),
        geom2=torch.zeros(lead + (ncon,), dtype=torch.int64, device=device),
    )
    return Data(
        time=torch.zeros(lead, dtype=dtype, device=device),
        qpos=full(model.qpos0, (model.nq,)),
        qvel=z(nv),
        act=z(model.na),
        ctrl=z(model.nu),
        qacc_warmstart=z(nv),
        qacc=z(nv),
        qfrc_applied=z(nv),
        xfrc_applied=z(nbody, 6),
        mocap_pos=full(mpos, (model.nmocap, 3)),
        mocap_quat=full(mquat, (model.nmocap, 4)),
        eq_active=torch.as_tensor(
            np.asarray(model.eq_active0, dtype=bool).reshape(model.neq),
            device=device).expand(lead + (model.neq,)).clone(),
        xpos=z(nbody, 3), xquat=ident, xmat=eye(nbody), xipos=z(nbody, 3),
        ximat=eye(nbody), xanchor=z(njnt, 3), xaxis=z(njnt, 3),
        geom_xpos=z(model.ngeom, 3), geom_xmat=eye(model.ngeom),
        site_xpos=z(model.nsite, 3), site_xmat=eye(model.nsite),
        cam_xpos=z(model.ncam, 3), cam_xmat=eye(model.ncam),
        subtree_com=z(nbody, 3), cinert_i=z(nbody, 3, 3),
        cinert_h=z(nbody, 3), cdof=z(nv, 6), qM=z(nv, nv),
        cvel=z(nbody, 6), cdof_dot=z(nv, 6), qfrc_bias=z(nv),
        qfrc_passive=z(nv),
        actuator_length=z(model.nu), actuator_velocity=z(model.nu),
        actuator_force=z(model.nu), act_dot=z(model.na),
        qfrc_actuator=z(nv), qfrc_smooth=z(nv), qacc_smooth=z(nv),
        contact=contact,
        nefc_active=torch.zeros(lead, dtype=torch.int64, device=device),
        qfrc_constraint=z(nv), contact_force=z(ncon, 6),
        sensordata=z(model.nsensordata),
        efc_limit=z(_n_limit_rows(model), 3),
        solver_cost=torch.zeros(lead, dtype=dtype, device=device),
        solver_gradnorm=torch.zeros(lead, dtype=dtype, device=device),
        solver_niter=torch.zeros(lead, dtype=torch.int64, device=device),
    )


def reset_data(model: Model, data: Data) -> Data:
    """mj_resetData on every env of ``data``: the model defaults at
    ``data``'s batch, device and dtype."""
    lead = data.qpos.shape[:-1]
    fresh = make_data(model, data.qpos.device, data.qpos.dtype,
                      batch=lead[0] if lead else None)
    return tree_map(lambda f, d: f.to(d.dtype).expand(d.shape).clone(),
                    fresh, data)


def reset_data_keyframe(model: Model, data: Data, key) -> Data:
    """mj_resetDataKeyframe: reset, then load qpos, qvel, act, ctrl and
    time from keyframe ``key`` (index or name) on every env."""
    from .api.errors import NameNotFoundError

    if isinstance(key, str):
        idx = model.name2id("keyframe", key)
        if idx < 0:
            raise NameNotFoundError("keyframe", key)
        key = idx
    if not 0 <= key < model.nkey:
        raise IndexError(f"keyframe index {key} out of range "
                         f"[0, {model.nkey})")
    d = reset_data(model, data)

    def bc(arr, like):
        t = torch.as_tensor(np.asarray(arr, dtype=np.float64),
                            device=like.device).to(like.dtype)
        return t.expand(like.shape).clone()

    return d.replace(time=bc(model.key_time[key], d.time),
                     qpos=bc(model.key_qpos[key], d.qpos),
                     qvel=bc(model.key_qvel[key], d.qvel),
                     act=bc(model.key_act[key], d.act),
                     ctrl=bc(model.key_ctrl[key], d.ctrl))
