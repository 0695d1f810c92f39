"""Static model description: the port's analog of MuJoCo's ``mjModel``.

The PyTorch port's copy of ``oxide_control_tpu/model.py`` as a plain numpy
dataclass: *structural* fields (tree topology, joint types, addresses, name
tables) are ``static_field()`` tuples read by the build-time Python loops of
``ops.scalar_graph``; *numeric* fields (positions, inertias, gains) are
numpy arrays (the "leaves").  Nothing here touches a device: the rollout
kernel folds the numbers into its emitted step body, and the plain version
reads them as Python floats.

Enum values deliberately match MuJoCo's (mjtJoint / mjtGeom / ...) and the
reference package's, so the two compile to equal fields.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np

_STATIC_MARK = "__oxc_static__"


def static_field(**kwargs: Any) -> dataclasses.Field:
    """A structural (hashable, non-array) model field."""
    metadata = dict(kwargs.pop("metadata", ()) or {})
    metadata[_STATIC_MARK] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def leaf_names(cls) -> tuple[str, ...]:
    """Names of the numeric (array) fields of a model dataclass."""
    return tuple(f.name for f in dataclasses.fields(cls)
                 if not f.metadata.get(_STATIC_MARK, False))


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class Integrator(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class SolverType(enum.IntEnum):
    PGS = 0
    CG = 1
    NEWTON = 2


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class CamMode(enum.IntEnum):
    """Camera motion modes (values match mjtCamLight)."""

    FIXED = 0
    TRACK = 1
    TRACKCOM = 2
    TARGETBODY = 3
    TARGETBODYCOM = 4


class TrnType(enum.IntEnum):
    # values match MuJoCo's mjtTrn
    JOINT = 0
    TENDON = 3
    SITE = 4
    BODY = 5


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3


class SensorType(enum.IntEnum):
    """Sensor kinds (values match MuJoCo mjtSensor for golden parity)."""

    TOUCH = 0
    ACCELEROMETER = 1
    VELOCIMETER = 2
    GYRO = 3
    FORCE = 4
    TORQUE = 5
    MAGNETOMETER = 6
    RANGEFINDER = 7
    JOINTPOS = 9
    JOINTVEL = 10
    CAMPROJECTION = 8
    TENDONPOS = 11
    TENDONVEL = 12
    ACTUATORPOS = 13
    ACTUATORVEL = 14
    ACTUATORFRC = 15
    JOINTACTFRC = 16
    TENDONACTFRC = 17
    BALLQUAT = 18
    BALLANGVEL = 19
    JOINTLIMITPOS = 20
    JOINTLIMITVEL = 21
    JOINTLIMITFRC = 22
    TENDONLIMITPOS = 23
    TENDONLIMITVEL = 24
    TENDONLIMITFRC = 25
    FRAMEPOS = 26
    FRAMEQUAT = 27
    FRAMEXAXIS = 28
    FRAMEYAXIS = 29
    FRAMEZAXIS = 30
    FRAMELINVEL = 31
    FRAMEANGVEL = 32
    FRAMELINACC = 33
    FRAMEANGACC = 34
    SUBTREECOM = 35
    SUBTREELINVEL = 36
    SUBTREEANGMOM = 37
    INSIDESITE = 38
    GEOMDIST = 39
    GEOMNORMAL = 40
    GEOMFROMTO = 41
    E_POTENTIAL = 43
    E_KINETIC = 44
    CLOCK = 45
    USER = 48


class ObjType(enum.IntEnum):
    """Sensor/frame attachment object types (values match mjtObj)."""

    NONE = 0
    BODY = 1
    XBODY = 2
    JOINT = 3
    GEOM = 5
    SITE = 6
    CAMERA = 7
    TENDON = 18
    ACTUATOR = 19


# number of qpos / qvel entries per joint type
QPOS_WIDTH = {JointType.FREE: 7, JointType.BALL: 4, JointType.SLIDE: 1, JointType.HINGE: 1}
DOF_WIDTH = {JointType.FREE: 6, JointType.BALL: 3, JointType.SLIDE: 1, JointType.HINGE: 1}


@dataclasses.dataclass(frozen=True)
class Option:
    """Simulation options (MJCF ``<option>``); hashable, fully static."""

    timestep: float = 0.002
    gravity: tuple[float, float, float] = (0.0, 0.0, -9.81)
    wind: tuple[float, float, float] = (0.0, 0.0, 0.0)
    magnetic: tuple[float, float, float] = (0.0, -0.5, 0.0)
    density: float = 0.0
    viscosity: float = 0.0
    integrator: Integrator = Integrator.EULER
    solver: SolverType = SolverType.NEWTON
    cone: ConeType = ConeType.PYRAMIDAL
    iterations: int = 100
    tolerance: float = 1e-8
    ls_iterations: int = 50
    ls_tolerance: float = 0.01
    impratio: float = 1.0
    # disable flags (subset of mjtDisableBit we honor)
    disable_contact: bool = False
    disable_gravity: bool = False
    disable_limit: bool = False
    disable_eulerdamp: bool = False
    disable_frictionloss: bool = False


@dataclasses.dataclass(frozen=True)
class Model:
    """Compiled model. See module docstring for leaf/static split."""

    # ----- sizes (static) -----
    nq: int = static_field()
    nv: int = static_field()
    nu: int = static_field()
    na: int = static_field()
    nbody: int = static_field()
    njnt: int = static_field()
    ngeom: int = static_field()
    nsite: int = static_field()
    neq: int = static_field()
    nmocap: int = static_field()
    ntendon: int = static_field()

    opt: Option = static_field()

    # ----- structural topology (static tuples of python ints) -----
    body_parentid: tuple = static_field()
    body_rootid: tuple = static_field()
    body_weldid: tuple = static_field()
    body_jntadr: tuple = static_field()   # -1 if no joints
    body_jntnum: tuple = static_field()
    body_dofadr: tuple = static_field()   # -1 if no dofs
    body_dofnum: tuple = static_field()
    body_geomadr: tuple = static_field()
    body_geomnum: tuple = static_field()
    body_mocapid: tuple = static_field()  # -1 if not mocap

    jnt_type: tuple = static_field()
    jnt_qposadr: tuple = static_field()
    jnt_dofadr: tuple = static_field()
    jnt_bodyid: tuple = static_field()
    jnt_limited: tuple = static_field()
    jnt_actfrclimited: tuple = static_field()

    dof_bodyid: tuple = static_field()
    dof_jntid: tuple = static_field()
    dof_parentid: tuple = static_field()  # -1 for tree roots

    geom_type: tuple = static_field()
    geom_bodyid: tuple = static_field()
    geom_contype: tuple = static_field()
    geom_conaffinity: tuple = static_field()
    geom_condim: tuple = static_field()
    geom_priority: tuple = static_field()

    site_bodyid: tuple = static_field()

    actuator_trntype: tuple = static_field()
    actuator_trnid: tuple = static_field()
    actuator_gaintype: tuple = static_field()
    actuator_biastype: tuple = static_field()
    actuator_dyntype: tuple = static_field()
    actuator_ctrllimited: tuple = static_field()
    actuator_forcelimited: tuple = static_field()
    actuator_actadr: tuple = static_field()  # -1 if stateless
    actuator_actnum: tuple = static_field()
    actuator_actlimited: tuple = static_field()

    eq_type: tuple = static_field()
    eq_obj1id: tuple = static_field()
    eq_obj2id: tuple = static_field()
    eq_active0: tuple = static_field()

    # tendons.  Fixed tendons couple scalar joints through the wrap arrays
    # (tendon_adr/num index into tendon_wrap_jnt/coef); spatial tendons
    # route through site paths (tendon_site_* below, with per-segment
    # pulley divisors).  tendon_kind: 0 = fixed, 1 = spatial.
    tendon_adr: tuple = static_field()      # start into wrap arrays
    tendon_num: tuple = static_field()      # joints per tendon (fixed)
    tendon_limited: tuple = static_field()
    tendon_wrap_jnt: tuple = static_field() # (nwrap,) joint ids

    # candidate contact pairs, grouped by (type1, type2) at compile time:
    # dict-like tuple of (type1, type2, ((g1, g2), ...)) entries
    pair_groups: tuple = static_field()
    # condim per candidate pair in flattened group order
    pair_condim: tuple = static_field()

    # True if any dof has positive damping (drives the implicit-damping
    # branch of the Euler integrator; static so the branch is compile-time)
    any_damping: bool = static_field()

    # ----- name tables (static) -----
    names: Any = static_field()  # NameTables

    # ----- numeric parameters (array leaves) -----
    qpos0: np.ndarray
    qpos_spring: np.ndarray

    body_pos: np.ndarray       # (nbody, 3)
    body_quat: np.ndarray      # (nbody, 4)
    body_ipos: np.ndarray      # (nbody, 3)
    body_iquat: np.ndarray     # (nbody, 4)
    body_mass: np.ndarray      # (nbody,)
    body_inertia: np.ndarray   # (nbody, 3)
    body_subtreemass: np.ndarray  # (nbody,)

    jnt_pos: np.ndarray        # (njnt, 3)
    jnt_axis: np.ndarray       # (njnt, 3)
    jnt_range: np.ndarray      # (njnt, 2)
    jnt_stiffness: np.ndarray  # (njnt,)
    jnt_margin: np.ndarray     # (njnt,)
    jnt_solref: np.ndarray     # (njnt, 2) limit solref
    jnt_solimp: np.ndarray     # (njnt, 5) limit solimp

    dof_armature: np.ndarray   # (nv,)
    dof_damping: np.ndarray    # (nv,)
    dof_invweight0: np.ndarray # (nv,) diag(M^-1) at qpos0 (mj_setConst analog)
    body_invweight0: np.ndarray  # (nbody, 2) [trans, rot] inverse weight at qpos0
    dof_frictionloss: np.ndarray  # (nv,)
    dof_solref: np.ndarray     # (nv, 2) friction solref
    dof_solimp: np.ndarray     # (nv, 5)

    geom_pos: np.ndarray       # (ngeom, 3)
    geom_quat: np.ndarray      # (ngeom, 4)
    geom_size: np.ndarray      # (ngeom, 3)
    geom_friction: np.ndarray  # (ngeom, 3)
    geom_margin: np.ndarray    # (ngeom,)
    geom_gap: np.ndarray       # (ngeom,)
    geom_solref: np.ndarray    # (ngeom, 2)
    geom_solimp: np.ndarray    # (ngeom, 5)
    geom_solmix: np.ndarray    # (ngeom,)
    geom_rbound: np.ndarray    # (ngeom,) bounding sphere radius (0 for plane)

    site_pos: np.ndarray       # (nsite, 3)
    site_quat: np.ndarray      # (nsite, 4)

    actuator_gear: np.ndarray       # (nu, 6)
    actuator_ctrlrange: np.ndarray  # (nu, 2)
    actuator_forcerange: np.ndarray # (nu, 2)
    actuator_actrange: np.ndarray   # (nu, 2)
    actuator_gainprm: np.ndarray    # (nu, 10)
    actuator_biasprm: np.ndarray    # (nu, 10)
    actuator_dynprm: np.ndarray     # (nu, 10)

    eq_data: np.ndarray        # (neq, 11)
    eq_solref: np.ndarray      # (neq, 2)
    eq_solimp: np.ndarray      # (neq, 5)

    tendon_range: np.ndarray        # (ntendon, 2)
    tendon_stiffness: np.ndarray    # (ntendon,)
    tendon_damping: np.ndarray      # (ntendon,)
    tendon_frictionloss: np.ndarray # (ntendon,)
    tendon_lengthspring: np.ndarray # (ntendon, 2) [lower, upper] rest band
    tendon_margin: np.ndarray       # (ntendon,)
    tendon_solref_lim: np.ndarray   # (ntendon, 2)
    tendon_solimp_lim: np.ndarray   # (ntendon, 5)
    tendon_solref_fri: np.ndarray   # (ntendon, 2)
    tendon_solimp_fri: np.ndarray   # (ntendon, 5)
    tendon_invweight0: np.ndarray   # (ntendon,) J M^-1 J^T at qpos0
    tendon_wrap_coef: np.ndarray    # (nwrap,)

    # per-candidate-pair precomputed contact params (flattened group order)
    pair_geom1: np.ndarray     # (npair,) int32
    pair_geom2: np.ndarray     # (npair,) int32
    pair_friction: np.ndarray  # (npair, 5)
    pair_solref: np.ndarray    # (npair, 2)
    pair_solimp: np.ndarray    # (npair, 5)
    pair_margin: np.ndarray    # (npair,)
    pair_gap: np.ndarray       # (npair,)

    # ----- sensors (static table + cutoff leaf; defaults = no sensors) ---
    nsensor: int = static_field(default=0)
    nsensordata: int = static_field(default=0)
    sensor_type: tuple = static_field(default=())     # SensorType values
    sensor_objtype: tuple = static_field(default=())  # ObjType values
    sensor_objid: tuple = static_field(default=())
    sensor_reftype: tuple = static_field(default=())  # ObjType; frame ref
    sensor_refid: tuple = static_field(default=())    # -1 = world/global
    sensor_adr: tuple = static_field(default=())      # into sensordata
    sensor_dim: tuple = static_field(default=())
    sensor_cutoff: Any = None  # (nsensor,) leaf; None when nsensor == 0

    # ----- mesh assets (convex hulls in canonical com/principal frame) ---
    nmesh: int = static_field(default=0)
    geom_dataid: tuple = static_field(default=())   # mesh/hfield id, -1
    mesh_vertadr: tuple = static_field(default=())
    mesh_vertnum: tuple = static_field(default=())
    mesh_vert: Any = None  # (sum vertnum, 3) leaf; None when nmesh == 0

    # ----- muscle actuators ----------------------------------------------
    actuator_lengthrange: Any = None  # (nu, 2) muscle length range
    actuator_acc0: Any = None         # (nu,) |M^-1 moment| at qpos0

    # ----- site shapes (for touch-sensor volume clipping; mjtGeom vals) --
    site_type: tuple = static_field(default=())
    site_size: Any = None  # (nsite, 3) leaf; None for older constructors

    # ----- spatial tendons (site-routed paths + pulley divisors) ---------
    tendon_kind: tuple = static_field(default=())     # (ntendon,) 0/1
    tendon_site_adr: tuple = static_field(default=()) # into tendon_sites
    tendon_site_num: tuple = static_field(default=())
    tendon_sites: tuple = static_field(default=())    # flat site ids
    # per-path-point (branch index, pulley divisor): segments connect only
    # consecutive sites of the same branch, contributing length/divisor
    # (MuJoCo <pulley divisor="N"/> semantics)
    tendon_site_div: tuple = static_field(default=())
    # generalized spatial path per tendon: tuple of entries
    # (kind, objid, sideid, branch, div) with kind 0=site (objid=site id)
    # or 1=wrap geom (objid=geom id, sideid=sidesite id or -1).  The
    # site-only arrays above remain for older consumers; the path is the
    # source of truth for length/moment (smooth.tendon_length_moment).
    tendon_path: tuple = static_field(default=())
    tendon_length0: Any = None     # (ntendon,) length at qpos0
    # cameras: fixed / track / trackcom / targetbody / targetbodycom
    # (mjtCamLight modes; camprojection sensors + Data.cam_xpos/cam_xmat)
    ncam: int = static_field(default=0)
    cam_bodyid: tuple = static_field(default=())
    cam_pos: Any = None            # (ncam, 3)
    cam_quat: Any = None           # (ncam, 4)
    cam_fovy: Any = None           # (ncam,)
    cam_resolution: tuple = static_field(default=())  # (ncam, 2) ints
    cam_mode: tuple = static_field(default=())        # (ncam,) CamMode ints
    cam_targetbodyid: tuple = static_field(default=())  # (ncam,) -1 = none
    cam_pos0: Any = None           # (ncam, 3) world offset from body, qpos0
    cam_poscom0: Any = None        # (ncam, 3) offset from subtree com, qpos0
    cam_mat0: Any = None           # (ncam, 3, 3) world orientation at qpos0
    # intrinsics: (fx, fy) focal + sensor size in length units; empty
    # sensorsize (0, 0) selects the fovy projection model
    cam_sensorsize: tuple = static_field(default=())  # (ncam, 2) floats
    cam_intrinsic: tuple = static_field(default=())   # (ncam, 4) floats
    # refsite id per actuator (-1 = none; site transmission only)
    actuator_refid: tuple = static_field(default=())

    # ----- keyframes (<keyframe><key .../>; mj_resetDataKeyframe analog) -
    nkey: int = static_field(default=0)
    key_time: Any = None  # (nkey,) leaf
    key_qpos: Any = None  # (nkey, nq)
    key_qvel: Any = None  # (nkey, nv)
    key_act: Any = None   # (nkey, na)
    key_ctrl: Any = None  # (nkey, nu)

    # ----- height fields (normalized [0,1] elevation grids) --------------
    nhfield: int = static_field(default=0)
    hfield_adr: tuple = static_field(default=())
    hfield_nrow: tuple = static_field(default=())
    hfield_ncol: tuple = static_field(default=())
    hfield_size: Any = None  # (nhfield, 4) [sx, sy, z_top, z_bottom] leaf
    hfield_data: Any = None  # (sum nrow*ncol,) leaf; row-major by y

    # ----- derived helpers -----

    @property
    def npair(self) -> int:
        return len(self.pair_condim)

    def name2id(self, objtype: str, name: str) -> int:
        """Name -> index lookup (reference: Physics::object_id,
        oxide_control src/physics.rs:56-58). Returns -1 if absent."""
        return self.names.name2id(objtype, name)

    def id2name(self, objtype: str, idx: int) -> str:
        """Index -> name (reference: Physics::object_name,
        oxide_control src/physics.rs:60-62)."""
        return self.names.id2name(objtype, idx)

    def replace(self, **updates: Any) -> "Model":
        return dataclasses.replace(self, **updates)

    def astype(self, dtype) -> "Model":
        """Cast the floating array fields to `dtype` (e.g. f32 for the
        kernel); integer arrays and structural fields are kept."""
        def cast(x):
            if isinstance(x, np.ndarray) and np.issubdtype(x.dtype,
                                                            np.floating):
                return np.asarray(x, dtype=dtype)
            return x if x is None else np.asarray(x)

        return self.replace(**{n: cast(getattr(self, n))
                               for n in leaf_names(type(self))})


@dataclasses.dataclass(frozen=True)
class NameTables:
    """Hashable bidirectional name<->index maps per object type."""

    body: tuple = ()
    joint: tuple = ()
    geom: tuple = ()
    site: tuple = ()
    actuator: tuple = ()
    equality: tuple = ()
    tendon: tuple = ()
    sensor: tuple = ()
    keyframe: tuple = ()

    _TYPES = ("body", "joint", "geom", "site", "actuator", "equality",
              "tendon", "sensor", "keyframe")

    def name2id(self, objtype: str, name: str) -> int:
        table = getattr(self, objtype)
        try:
            return table.index(name)
        except ValueError:
            return -1

    def id2name(self, objtype: str, idx: int) -> str:
        table = getattr(self, objtype)
        if 0 <= idx < len(table):
            return table[idx]
        return ""
