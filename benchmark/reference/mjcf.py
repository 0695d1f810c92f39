"""The benchmark's own reading of the two MJCF assets it runs.

A plain reading of the MJCF subset that ``assets/cheetah.xml`` and
``assets/humanoid.xml`` use, after MuJoCo's documented compiler rules:
one unnamed default class, angles in degrees, Euler angles in the ``xyz``
sequence about the moving axes, a capsule's ``fromto``, body inertia
from the geoms' volumes at their density (about the body's centre of
mass, kept as a full 3x3 tensor in the body frame), hinge, slide and
free joints, motors on joints.  Anything else in an asset raises.

Every number is float64 numpy; :mod:`benchmark.reference.physics` turns
them into tensors.
"""

from __future__ import annotations

import dataclasses
import math
import os
import xml.etree.ElementTree as ET

import numpy as np

ASSETS = os.path.join(os.path.dirname(__file__), "assets")

FREE, SLIDE, HINGE = "free", "slide", "hinge"
PLANE, SPHERE, CAPSULE = "plane", "sphere", "capsule"

# MuJoCo's defaults for the attributes these assets leave out
JOINT_DEFAULTS = {"type": HINGE, "axis": "0 0 1", "pos": "0 0 0",
                  "range": "0 0", "limited": "false", "damping": "0",
                  "armature": "0", "stiffness": "0", "springref": "0",
                  "solreflimit": "0.02 1",
                  "solimplimit": "0.9 0.95 0.001 0.5 2"}
GEOM_DEFAULTS = {"type": SPHERE, "pos": "0 0 0", "density": "1000",
                 "friction": "1 0.005 0.0001", "condim": "3",
                 "contype": "1", "conaffinity": "1", "solref": "0.02 1",
                 "solimp": "0.9 0.95 0.001 0.5 2", "margin": "0",
                 "gap": "0"}
MOTOR_DEFAULTS = {"gear": "1", "ctrlrange": "0 0", "ctrllimited": "false"}


def _vec(text: str) -> np.ndarray:
    return np.array([float(x) for x in text.split()], np.float64)


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def axis_angle_quat(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[math.cos(angle / 2)],
                           math.sin(angle / 2) * axis])


def quat_mat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _frame(el, attrs) -> tuple[np.ndarray, np.ndarray]:
    """(pos, quat) of an element: ``pos`` and an Euler ``euler`` in
    degrees about the moving x, y, z axes, or a ``quat``."""
    pos = _vec(attrs.get("pos", "0 0 0"))
    quat = np.array([1.0, 0.0, 0.0, 0.0])
    if "quat" in attrs:
        quat = _vec(attrs["quat"])
        quat = quat / np.linalg.norm(quat)
    if "euler" in attrs:
        for axis, deg in zip(np.eye(3), _vec(attrs["euler"])):
            quat = quat_mul(quat, axis_angle_quat(axis, math.radians(deg)))
    return pos, quat


@dataclasses.dataclass
class Joint:
    name: str
    type: str
    body: int
    qposadr: int
    dofadr: int
    axis: np.ndarray        # unit, body frame
    pos: np.ndarray         # body frame
    limited: bool
    range: np.ndarray       # radians for a hinge
    stiffness: float
    springref: float
    damping: float
    armature: float
    solref: np.ndarray
    solimp: np.ndarray


@dataclasses.dataclass
class Geom:
    name: str
    type: str
    body: int
    pos: np.ndarray
    mat: np.ndarray
    size: np.ndarray        # radius, and a capsule's half-length
    friction: np.ndarray
    condim: int
    contype: int
    conaffinity: int
    solref: np.ndarray
    solimp: np.ndarray
    margin: float


@dataclasses.dataclass
class Body:
    name: str
    parent: int
    pos: np.ndarray
    quat: np.ndarray
    joints: list
    mass: float = 0.0
    ipos: np.ndarray = None     # centre of mass, body frame
    inertia: np.ndarray = None  # 3x3 about the centre of mass, body frame


@dataclasses.dataclass
class Motor:
    name: str
    joint: int
    gear: float
    ctrlrange: np.ndarray
    ctrllimited: bool


@dataclasses.dataclass
class Spec:
    name: str
    timestep: float
    gravity: np.ndarray
    iterations: int
    tolerance: float
    bodies: list
    joints: list
    geoms: list
    motors: list
    nq: int
    nv: int
    qpos0: np.ndarray

    def body_id(self, name: str) -> int:
        return [b.name for b in self.bodies].index(name)


def _geom_inertia(g: Geom, density: float):
    """(mass, 3x3 inertia about the geom's centre in its own frame) of a
    sphere or a capsule of uniform density."""
    r = g.size[0]
    if g.type == SPHERE:
        m = density * 4.0 / 3.0 * math.pi * r ** 3
        return m, np.eye(3) * (0.4 * m * r * r)
    if g.type == CAPSULE:
        h = 2.0 * g.size[1]
        m_cyl = density * math.pi * r * r * h
        m_sph = density * 4.0 / 3.0 * math.pi * r ** 3
        # the cylinder about its centre
        ixx = m_cyl * (3 * r * r + h * h) / 12.0
        izz = m_cyl * r * r / 2.0
        # two hemispheres: a sphere's moment about the axis; across it,
        # each hemisphere's own moment about its centre of mass moved to
        # the capsule's centre (its centre of mass lies 3r/8 beyond the
        # end of the cylinder)
        hemi = m_sph / 2.0
        c = h / 2.0 + 3.0 * r / 8.0
        i_own = hemi * (2.0 * r * r / 5.0 - (3.0 * r / 8.0) ** 2)
        ixx += 2.0 * (i_own + hemi * c * c)
        izz += 0.4 * m_sph * r * r
        return m_cyl + m_sph, np.diag([ixx, ixx, izz])
    raise ValueError(f"no inertia for a {g.type} geom")


def load(name: str) -> Spec:
    """The asset ``assets/<name>.xml`` read into a :class:`Spec`."""
    root = ET.parse(os.path.join(ASSETS, f"{name}.xml")).getroot()
    known = {"option", "default", "worldbody", "actuator"}
    for child in root:
        if child.tag not in known:
            raise ValueError(f"{name}: the reference reads no <{child.tag}>")
    opt = root.find("option")
    opt = {} if opt is None else opt.attrib
    if opt.get("solver", "Newton") != "Newton" or opt.get(
            "integrator", "Euler") != "Euler" or opt.get(
            "cone", "pyramidal") != "pyramidal":
        raise ValueError(f"{name}: the reference solves Newton, Euler, "
                         "pyramidal cones only")
    defaults = {"joint": dict(JOINT_DEFAULTS), "geom": dict(GEOM_DEFAULTS),
                "motor": dict(MOTOR_DEFAULTS)}
    dflt = root.find("default")
    if dflt is not None:
        for el in dflt:
            if el.tag not in defaults:
                raise ValueError(f"{name}: no default for <{el.tag}>")
            defaults[el.tag].update(el.attrib)

    bodies = [Body("world", -1, np.zeros(3), np.array([1.0, 0, 0, 0]), [])]
    joints, geoms, density = [], [], {}
    nq = nv = 0

    def read_geom(el, body: int):
        a = dict(defaults["geom"], **el.attrib)
        if a["type"] not in (PLANE, SPHERE, CAPSULE):
            raise ValueError(f"{name}: no {a['type']} geoms")
        size = _vec(a.get("size", "0"))
        if "fromto" in a:
            ft = _vec(a["fromto"])
            p0, p1 = ft[:3], ft[3:]
            pos = 0.5 * (p0 + p1)
            axis = (p1 - p0) / np.linalg.norm(p1 - p0)
            z = np.array([0.0, 0.0, 1.0])
            c = np.cross(z, axis)
            ang = math.atan2(np.linalg.norm(c), float(z @ axis))
            quat = (axis_angle_quat(c, ang) if np.linalg.norm(c) > 1e-12
                    else np.array([1.0, 0, 0, 0]))
            size = np.array([size[0], 0.5 * np.linalg.norm(p1 - p0)])
        else:
            pos, quat = _frame(el, a)
        g = Geom(a.get("name", ""), a["type"], body, pos, quat_mat(quat),
                 size, _vec(a["friction"]), int(a["condim"]),
                 int(a["contype"]), int(a["conaffinity"]),
                 _vec(a["solref"]), _vec(a["solimp"]), float(a["margin"]))
        if float(a["gap"]) != 0.0:
            raise ValueError(f"{name}: no geom gap")
        density[len(geoms)] = float(a["density"])
        geoms.append(g)

    def read_body(el, parent: int):
        nonlocal nq, nv
        pos, quat = _frame(el, el.attrib)
        b = len(bodies)
        body = Body(el.get("name", ""), parent, pos, quat, [])
        bodies.append(body)
        for child in el:
            if child.tag in ("joint", "freejoint"):
                if child.tag == "freejoint":
                    # a free joint takes no defaults
                    a = dict(JOINT_DEFAULTS, type=FREE, **child.attrib)
                else:
                    a = dict(defaults["joint"], **child.attrib)
                jt = a["type"]
                if jt not in (FREE, SLIDE, HINGE):
                    raise ValueError(f"{name}: no {jt} joints")
                rng = _vec(a["range"])
                if jt == HINGE:
                    rng = np.radians(rng)
                j = Joint(a.get("name", ""), jt, b, nq, nv,
                          _vec(a["axis"]) / np.linalg.norm(_vec(a["axis"])),
                          _vec(a["pos"]), a["limited"] == "true", rng,
                          float(a["stiffness"]), float(a["springref"]),
                          float(a["damping"]), float(a["armature"]),
                          _vec(a["solreflimit"]), _vec(a["solimplimit"]))
                body.joints.append(len(joints))
                joints.append(j)
                nq += 7 if jt == FREE else 1
                nv += 6 if jt == FREE else 1
            elif child.tag == "geom":
                read_geom(child, b)
            elif child.tag == "body":
                read_body(child, b)
            elif child.tag not in ("site", "inertial"):
                raise ValueError(f"{name}: the reference reads no "
                                 f"<{child.tag}> in a body")
            if child.tag == "inertial":
                raise ValueError(f"{name}: no explicit inertials")

    for child in root.find("worldbody"):
        if child.tag == "geom":
            read_geom(child, 0)
        elif child.tag == "body":
            read_body(child, 0)

    # body inertia from the geoms (the world keeps none)
    for gi, g in enumerate(geoms):
        if g.body == 0:
            continue
        m, i_local = _geom_inertia(g, density[gi])
        b = bodies[g.body]
        if b.ipos is None:
            b.mass, b.ipos, b.inertia = 0.0, np.zeros(3), np.zeros((3, 3))
        # combine about the body origin, then move to the centre of mass
        i_origin = b.inertia + b.mass * (b.ipos @ b.ipos * np.eye(3)
                                         - np.outer(b.ipos, b.ipos))
        i_origin = i_origin + g.mat @ i_local @ g.mat.T + m * (
            g.pos @ g.pos * np.eye(3) - np.outer(g.pos, g.pos))
        com = (b.mass * b.ipos + m * g.pos) / (b.mass + m)
        b.mass += m
        b.ipos = com
        b.inertia = i_origin - b.mass * (com @ com * np.eye(3)
                                         - np.outer(com, com))
    for b in bodies[1:]:
        if b.ipos is None:
            raise ValueError(f"{name}: body {b.name!r} has no geom")

    motors = []
    act = root.find("actuator")
    for el in ([] if act is None else act):
        if el.tag != "motor":
            raise ValueError(f"{name}: the reference reads motors only")
        a = dict(defaults["motor"], **el.attrib)
        jid = [j.name for j in joints].index(a["joint"])
        motors.append(Motor(a.get("name", ""), jid, float(a["gear"]),
                            _vec(a["ctrlrange"]),
                            a["ctrllimited"] == "true"))

    qpos0 = np.zeros(nq)
    for j in joints:
        if j.type == FREE:
            b = bodies[j.body]
            qpos0[j.qposadr:j.qposadr + 3] = b.pos
            qpos0[j.qposadr + 3:j.qposadr + 7] = b.quat
    return Spec(root.get("model", name), float(opt.get("timestep", 0.002)),
                _vec(opt.get("gravity", "0 0 -9.81")),
                int(opt.get("iterations", 100)),
                float(opt.get("tolerance", 1e-8)), bodies, joints, geoms,
                motors, nq, nv, qpos0)
