"""MJCF XML -> Model compiler (host-side numpy, runs once).

The PyTorch port's copy of ``oxide_control_tpu/mjcf/compile.py``, kept
line for line so both packages compile the same XML to the same numbers
(tests/test_torch_model.py holds every field equal).  Replaces the MuJoCo
model compiler the reference calls via ``mj_loadXML`` /
``mj_parseXMLString`` + ``mj_compile`` (oxide_control src/physics.rs:12-24).
Parses an MJCF subset sufficient for dm_control-suite-class models
(pendulum, cartpole, cheetah, walker, humanoid) and produces an immutable
:class:`~oxide_control_torch.model.Model`.

Field semantics, defaults and numbering deliberately match MuJoCo so the
compiled model can be validated field-by-field against ``mujoco.MjModel``
(see tests/test_mjcf.py).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Any

import numpy as np

from ..api.errors import ModelError, UnsupportedFeatureError
from ..model import (
    BiasType,
    ConeType,
    DynType,
    EqType,
    GainType,
    GeomType,
    Integrator,
    JointType,
    Model,
    NameTables,
    ObjType,
    Option,
    QPOS_WIDTH,
    DOF_WIDTH,
    SensorType,
    SolverType,
    TrnType,
)

_GEOM_TYPES = {
    "plane": GeomType.PLANE,
    "sphere": GeomType.SPHERE,
    "capsule": GeomType.CAPSULE,
    "ellipsoid": GeomType.ELLIPSOID,
    "cylinder": GeomType.CYLINDER,
    "box": GeomType.BOX,
    "mesh": GeomType.MESH,
    "hfield": GeomType.HFIELD,
}

_JOINT_TYPES = {
    "free": JointType.FREE,
    "ball": JointType.BALL,
    "slide": JointType.SLIDE,
    "hinge": JointType.HINGE,
}

_INTEGRATORS = {
    "Euler": Integrator.EULER,
    "RK4": Integrator.RK4,
    "implicit": Integrator.IMPLICIT,
    "implicitfast": Integrator.IMPLICITFAST,
}

_SOLVERS = {"PGS": SolverType.PGS, "CG": SolverType.CG, "Newton": SolverType.NEWTON}

_DEFAULT_SOLREF = (0.02, 1.0)
_DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)


# ---------------------------------------------------------------------------
# attribute parsing helpers
# ---------------------------------------------------------------------------


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _attr_floats(attrs: dict, key: str, default=None, n: int | None = None):
    if key in attrs:
        v = _floats(attrs[key])
    elif default is None:
        return None
    else:
        v = np.array(default, dtype=np.float64)
    if n is not None:
        if v.size > n:
            raise ModelError(f"attribute '{key}' has {v.size} values, expected <= {n}")
        if v.size < n:
            # MuJoCo pads partially-specified vector attributes with the
            # schema default tail (e.g. solimp "0 0.99 0.01" -> "... 0.5 2")
            if default is not None and np.size(default) == n:
                tail = np.asarray(default, dtype=np.float64)[v.size :]
            else:
                tail = np.zeros(n - v.size)
            v = np.concatenate([v, tail])
    return v


def _attr_float(attrs: dict, key: str, default: float) -> float:
    return float(attrs[key]) if key in attrs else default


def _attr_int(attrs: dict, key: str, default: int) -> int:
    return int(attrs[key]) if key in attrs else default


def _attr_bool(attrs: dict, key: str, default: bool) -> bool:
    if key not in attrs:
        return default
    return attrs[key] in ("true", "1")


# quaternion helpers (numpy, host side)


def _quat_mul(u, v):
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-15:
        return np.array([1.0, 0, 0, 0])
    axis = axis / n
    return np.concatenate([[math.cos(angle / 2)], axis * math.sin(angle / 2)])


def _quat_from_zaxis(zaxis):
    z = np.asarray(zaxis, dtype=np.float64)
    z = z / np.linalg.norm(z)
    z0 = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z0, z))
    if c > 1 - 1e-12:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-12:
        return np.array([0.0, 1.0, 0, 0])  # 180deg about x
    axis = np.cross(z0, z)
    return _axis_angle_quat(axis, math.acos(max(-1.0, min(1.0, c))))


def _quat_from_xyaxes(xy):
    x = np.asarray(xy[:3], dtype=np.float64)
    y = np.asarray(xy[3:6], dtype=np.float64)
    x = x / np.linalg.norm(x)
    y = y - x * np.dot(x, y)
    y = y / np.linalg.norm(y)
    z = np.cross(x, y)
    m = np.stack([x, y, z], axis=1)
    return _mat_to_quat(m)


def _mat_to_quat(m):
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(1e-15, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


# the frame (pos3, quat4) an outer <replicate> copy gives a nested
# meta-element; applied to that element's expansion
_FRAME_ATTR = "_oxc_frame"


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class _Compiler:
    """Single-use MJCF compiler instance."""

    def __init__(self, root: ET.Element, base_dir: str | None = None):
        if root.tag != "mujoco":
            raise ModelError(f"root element must be <mujoco>, got <{root.tag}>")
        self.root = root
        self.base_dir = base_dir

        # <compiler> settings
        comp = root.find("compiler")
        cattrs = dict(comp.attrib) if comp is not None else {}
        self.angle_deg = cattrs.get("angle", "degree") == "degree"
        self.eulerseq = cattrs.get("eulerseq", "xyz")
        self.autolimits = cattrs.get("autolimits", "true") in ("true", "1")
        self.inertiafromgeom = cattrs.get("inertiafromgeom", "auto")
        self.settotalmass = float(cattrs.get("settotalmass", -1))
        self.boundmass = float(cattrs.get("boundmass", 0.0))
        self.boundinertia = float(cattrs.get("boundinertia", 0.0))

        self.defaults = self._build_defaults(root)

        # accumulators
        self.bodies: list[dict] = []
        self.joints: list[dict] = []
        self.geoms: list[dict] = []
        self.sites: list[dict] = []
        self.actuators: list[dict] = []
        self.equalities: list[dict] = []
        self.tendons: list[dict] = []
        self.sensors: list[dict] = []
        self.cameras: list[dict] = []
        self.meshes: list[dict] = []
        self.hfields: list[dict] = []
        self.excludes: list[tuple[str, str]] = []
        self.explicit_pairs: list[dict] = []
        self.keyframes: list[dict] = []

    # -- angle conversion ---------------------------------------------------

    def _ang(self, x):
        return np.deg2rad(x) if self.angle_deg else x

    # -- defaults -----------------------------------------------------------

    def _build_defaults(self, root) -> dict[str, dict[str, dict]]:
        """class name -> {tag -> merged attr dict}."""
        out: dict[str, dict[str, dict]] = {}

        def walk(elem: ET.Element, inherited: dict[str, dict]):
            merged = {tag: dict(attrs) for tag, attrs in inherited.items()}
            for child in elem:
                if child.tag == "default":
                    continue
                merged.setdefault(child.tag, {}).update(child.attrib)
            cls = elem.get("class", "main")
            out[cls] = merged
            for child in elem:
                if child.tag == "default":
                    walk(child, merged)

        top = root.find("default")
        if top is not None:
            walk(top, {})
        out.setdefault("main", {})
        return out

    def _resolved(self, elem: ET.Element, cls: str) -> dict:
        """Element attrs merged over its default class attrs."""
        cls = elem.get("class", cls)
        base = dict(self.defaults.get(cls, {}).get(elem.tag, {}))
        base.update(elem.attrib)
        return base

    # -- orientation --------------------------------------------------------

    def _orientation(self, attrs: dict) -> np.ndarray:
        if "quat" in attrs:
            q = _floats(attrs["quat"])
            return q / np.linalg.norm(q)
        if "euler" in attrs:
            e = self._ang(_floats(attrs["euler"]))
            q = np.array([1.0, 0, 0, 0])
            axes = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1],
                    "X": [1, 0, 0], "Y": [0, 1, 0], "Z": [0, 0, 1]}
            for i, ch in enumerate(self.eulerseq):
                rot = _axis_angle_quat(axes[ch], e[i])
                if ch.islower():
                    q = _quat_mul(q, rot)   # moving (intrinsic) axes
                else:
                    q = _quat_mul(rot, q)   # fixed (extrinsic) axes
            return q
        if "axisangle" in attrs:
            aa = _floats(attrs["axisangle"])
            return _axis_angle_quat(aa[:3], float(self._ang(aa[3])))
        if "xyaxes" in attrs:
            return _quat_from_xyaxes(_floats(attrs["xyaxes"]))
        if "zaxis" in attrs:
            return _quat_from_zaxis(_floats(attrs["zaxis"]))
        return np.array([1.0, 0, 0, 0])

    # -- tree walk ----------------------------------------------------------

    def parse(self):
        self._parse_assets()
        world = self.root.find("worldbody")
        if world is None:
            raise ModelError("missing <worldbody>")
        self._expand_meta(world)
        # world body (id 0)
        self.bodies.append(
            dict(
                name="world", parent=0, pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]),
                mocap=False, explicit_inertial=None, jnt_ids=[], geom_ids=[],
                site_ids=[], childclass="main",
            )
        )
        self._walk_body(world, 0, "main")
        self._parse_tendons()
        self._parse_actuators()
        self._parse_equality()
        self._parse_contact()
        self._parse_sensors()
        self._parse_keyframes()

    # -- meta-element expansion (<replicate> / <composite>) -----------------
    #
    # MuJoCo's parser expands these into plain model elements before
    # compilation (mj_loadXML macro layer; reference hot path
    # physics.rs:12-24 accepts models using them).  We do the same at the
    # XML level so the core compiler stays macro-free.  Conventions
    # (naming, transforms, frames, auto-excludes) verified against
    # MuJoCo 3.10 — see tests/test_mjcf.py replicate/cable cases.

    def _expand_meta(self, elem: ET.Element):
        i = 0
        while i < len(elem):
            child = elem[i]
            if child.tag in ("replicate", "composite"):
                if child.tag == "replicate":
                    new = self._expand_replicate(child)
                else:
                    new = self._expand_composite(child)
                if _FRAME_ATTR in child.attrib:
                    # a meta-element copied by an outer <replicate>: its
                    # expansion lies in that copy's frame (MuJoCo 3.10)
                    f = [float(x) for x in child.attrib[_FRAME_ATTR].split()]
                    for n in new:
                        self._apply_frame(n, np.array(f[:3]),
                                          np.array(f[3:]))
                elem.remove(child)
                for k, n in enumerate(new):
                    elem.insert(i + k, n)
                continue  # re-examine the inserted elements (nesting)
            self._expand_meta(child)
            i += 1

    def _apply_frame(self, c: ET.Element, P, Q):
        """Move element ``c`` into the frame (P, Q): a ``fromto`` or its
        pos/orientation; a nested meta-element keeps the frame in
        ``_FRAME_ATTR`` (composed with one it already has) and applies it
        to its expansion."""
        if c.tag in ("replicate", "composite"):
            if _FRAME_ATTR in c.attrib:
                f = [float(x) for x in c.attrib[_FRAME_ATTR].split()]
                P, Q = (P + _quat_to_mat(Q) @ np.array(f[:3]),
                        _quat_mul(Q, np.array(f[3:])))
            c.attrib[_FRAME_ATTR] = " ".join(
                f"{v:.17g}" for v in np.concatenate([P, Q]))
            return
        cattrs = dict(c.attrib)
        if "fromto" in cattrs:
            ft = _attr_floats(cattrs, "fromto", None, 6)
            R = _quat_to_mat(Q)
            ft = np.concatenate([P + R @ ft[:3], P + R @ ft[3:]])
            c.attrib["fromto"] = " ".join(f"{v:.17g}" for v in ft)
            return
        pos = P + _quat_to_mat(Q) @ _attr_floats(cattrs, "pos", [0, 0, 0], 3)
        quat = _quat_mul(Q, self._orientation(cattrs))
        for k in ("euler", "axisangle", "xyaxes", "zaxis"):
            c.attrib.pop(k, None)
        c.attrib["pos"] = " ".join(f"{v:.17g}" for v in pos)
        c.attrib["quat"] = " ".join(f"{v:.17g}" for v in quat)

    def _expand_replicate(self, el: ET.Element) -> list[ET.Element]:
        """<replicate count offset euler sep>: N copies of the enclosed
        elements, each translated by the ACCUMULATED offset (rotated into
        the accumulated frame) and rotated by the accumulated euler;
        every name gets a zero-padded index suffix (sep-separated).
        Verified vs MuJoCo 3.10: copy i has pos P_i + Q_i p, quat Q_i q
        with P_0 = 0, Q_0 = I, P_{i+1} = P_i + Q_i offset,
        Q_{i+1} = Q_i q_euler.  A nested meta-element is expanded in its
        copy's frame, and ``count`` is required, as in MuJoCo."""
        import copy as _copy

        attrs = dict(el.attrib)
        if "count" not in attrs:
            raise ModelError("XML Error: required attribute missing: 'count' "
                             "(element 'replicate')")
        count = int(attrs["count"].split()[0])
        offset = _attr_floats(attrs, "offset", [0, 0, 0], 3)
        sep = attrs.get("sep", "")
        q_step = self._orientation(attrs) if any(
            k in attrs for k in ("euler", "quat", "axisangle", "xyaxes",
                                 "zaxis")
        ) else np.array([1.0, 0, 0, 0])
        width = len(str(count - 1))

        def suffix_names(e: ET.Element, suf: str):
            if "name" in e.attrib:
                e.attrib["name"] = e.attrib["name"] + suf
            if e.tag == "composite" and "prefix" in e.attrib:
                e.attrib["prefix"] = e.attrib["prefix"] + suf
            for sub in e:
                suffix_names(sub, suf)

        out = []
        P = np.zeros(3)
        Q = np.array([1.0, 0, 0, 0])
        for i in range(count):
            suf = f"{sep}{i:0{width}d}"
            for child in el:
                c = _copy.deepcopy(child)
                suffix_names(c, suf)
                self._apply_frame(c, P, Q)
                out.append(c)
            P = P + _quat_to_mat(Q) @ offset
            Q = _quat_mul(Q, q_step)
        return out

    def _expand_composite(self, el: ET.Element) -> list[ET.Element]:
        """<composite type="cable">: a chain of ball-jointed capsule
        bodies along a polyline (MuJoCo 3.x reduces composite to cable;
        particle/grid/rope/cloth are deprecated upstream in favor of
        replicate/flexcomp).  Supported here: curve="s"-family straight
        cables and explicit ``vertex`` polylines, ``initial`` first-joint
        free/ball/none, per-geom and kind="main" joint attribute
        templates, and the auto-generated consecutive-body contact
        excludes.  Body frames follow MuJoCo's rule (verified vs 3.10):
        x = segment tangent; z_0 = normalized cross(t_0, t_1) (fallback:
        world z projected off the tangent, then world x); z parallel-
        transported along the chain; y = z cross x."""
        attrs = dict(el.attrib)
        ctype = attrs.get("type", "")
        if ctype != "cable":
            raise UnsupportedFeatureError(
                f"composite type={ctype!r} not supported: MuJoCo 3.x keeps "
                "only 'cable' (particle -> <replicate>, grid/cloth/rope -> "
                "flex/flexcomp, which are out of scope)"
            )
        prefix = attrs.get("prefix", "")
        initial = attrs.get("initial", "none")
        offset = _attr_floats(attrs, "offset", [0, 0, 0], 3)

        # templates from child elements
        geom_tpl = None
        joint_tpl: dict[str, str] = {}
        for sub in el:
            if sub.tag == "geom":
                geom_tpl = dict(sub.attrib)
            elif sub.tag == "joint":
                kind = sub.attrib.get("kind", "main")
                if kind != "main":
                    raise UnsupportedFeatureError(
                        f"cable joint kind={kind!r} not supported"
                    )
                joint_tpl = {k: v for k, v in sub.attrib.items()
                             if k != "kind"}
            elif sub.tag == "plugin":
                raise UnsupportedFeatureError(
                    "cable elasticity plugins are not supported (engine "
                    "plugin machinery is out of scope; passive cable "
                    "chains compile without one)"
                )
            else:
                raise UnsupportedFeatureError(
                    f"unsupported <{sub.tag}> inside <composite>"
                )
        if geom_tpl is None or geom_tpl.get("type") != "capsule":
            raise UnsupportedFeatureError(
                "cable composite needs a <geom type='capsule'> template "
                "(sphere/box cable geoms not supported)"
            )

        # vertex polyline (offset is added in f64 to the first body's
        # position only; segment geometry uses the f32-rounded raw
        # vertices — matches MuJoCo's composite arithmetic)
        if "vertex" in attrs:
            verts = _floats(attrs["vertex"]).reshape(-1, 3)
        else:
            count = int(attrs.get("count", "0").split()[0])
            if count < 2:
                raise ModelError("cable needs count >= 2 or a vertex list")
            curve = attrs.get("curve", "s").split()
            curve += ["0"] * (3 - len(curve))
            size = _attr_floats(attrs, "size", [1, 0, 0], 3)
            verts = np.zeros((count, 3))
            for ax, fn in enumerate(curve[:3]):
                if fn == "s":
                    verts[:, ax] = np.linspace(0, size[0], count)
                elif fn == "-s":
                    verts[:, ax] = -np.linspace(0, size[0], count)
                elif fn in ("0", ""):
                    pass
                else:
                    raise UnsupportedFeatureError(
                        f"cable curve function {fn!r} not supported (use "
                        "an explicit vertex list for curved cables)"
                    )
        # MuJoCo's composite machinery stores cable vertices in float32;
        # round so compiled fields match the oracle bit-for-bit-ish
        verts = verts.astype(np.float32).astype(np.float64)
        nseg = len(verts) - 1
        if nseg < 1:
            raise ModelError("cable needs at least 2 vertices")

        # frames (verified vs MuJoCo 3.10): x = tangent; the FIRST frame's
        # z = normalized cross(t_0, t_1) (fallback: world z projected off
        # the tangent, then world x); subsequent frames PARALLEL-TRANSPORT
        # the whole frame — local rotation between body i-1 and i is the
        # minimal rotation taking t_{i-1} to t_i (zero twist about the
        # tangent: the local quat's x component is exactly 0)
        d = np.diff(verts, axis=0)
        lens = np.linalg.norm(d, axis=1)
        if np.any(lens < 1e-12):
            raise ModelError("cable has coincident vertices")
        t = d / lens[:, None]
        c0 = np.cross(t[0], t[1]) if nseg > 1 else np.zeros(3)
        if np.linalg.norm(c0) > 1e-10:
            z0 = c0 / np.linalg.norm(c0)
        else:
            z0 = np.array([0.0, 0, 1]) - t[0][2] * t[0]
            if np.linalg.norm(z0) < 1e-10:
                z0 = np.array([1.0, 0, 0]) - t[0][0] * t[0]
            z0 = z0 / np.linalg.norm(z0)
        mats = [np.stack([t[0], np.cross(z0, t[0]), z0], axis=1)]
        loc_quats = [None]  # local quat per body (body 0 uses mats[0])
        for i in range(1, nseg):
            b = mats[i - 1].T @ t[i]  # new tangent in the previous frame
            # minimal rotation (1,0,0) -> b: q = (1 + b_x, 0, -b_z, b_y)
            q = np.array([1.0 + b[0], 0.0, -b[2], b[1]])
            n = np.linalg.norm(q)
            if n < 1e-10:  # 180-degree reversal: rotate about local z
                q = np.array([0.0, 0.0, 0.0, 1.0])
            else:
                q = q / n
            loc_quats.append(q)
            mats.append(mats[i - 1] @ _quat_to_mat(q))

        def bname(i):
            return prefix + ("B_first" if i == 0
                             else "B_last" if i == nseg - 1 else f"B_{i}")

        def jname(i):
            return prefix + ("J_first" if i == 0
                             else "J_last" if i == nseg - 1 else f"J_{i}")

        def fmt(v):
            return " ".join(f"{x:.17g}" for x in np.asarray(v))

        bodies = []
        for i in range(nseg):
            b = ET.Element("body")
            b.attrib["name"] = bname(i)
            if i == 0:
                pos = verts[0] + offset
                quat = _mat_to_quat(mats[0])
            else:
                pos = np.array([lens[i - 1], 0.0, 0.0])
                quat = loc_quats[i]
            b.attrib["pos"] = fmt(pos)
            b.attrib["quat"] = fmt(quat)
            if i == 0 and initial != "none":
                if initial not in ("free", "ball"):
                    raise ModelError(f"cable initial={initial!r}")
                j = ET.SubElement(b, "joint")
                if initial == "ball":
                    # the ball first joint takes the full main-joint
                    # template; the free one only its stiffness
                    # (verified vs MuJoCo 3.10)
                    j.attrib.update(joint_tpl)
                elif "stiffness" in joint_tpl:
                    j.attrib["stiffness"] = joint_tpl["stiffness"]
                j.attrib.update(name=jname(0), type=initial)
            elif i > 0:
                j = ET.SubElement(b, "joint")
                j.attrib.update(joint_tpl)
                j.attrib.update(name=jname(i), type="ball")
            g = ET.SubElement(b, "geom")
            g.attrib.update({k: v for k, v in geom_tpl.items()
                             if k not in ("type", "size", "pos", "quat",
                                          "fromto", "euler", "axisangle",
                                          "zaxis", "xyaxes")})
            r = float(_floats(geom_tpl.get("size", "0.005"))[0])
            g.attrib.update(
                name=prefix + f"G{i}", type="capsule",
                size=f"{r:.17g} {lens[i] / 2:.17g}",
                pos=f"{lens[i] / 2:.17g} 0 0",
                # z-axis -> -x (the MuJoCo cable convention; capsule is
                # symmetric so only the stored quat differs from +x)
                quat="0.70710678118654757 0 -0.70710678118654746 0",
            )
            if i == 0:
                s = ET.SubElement(b, "site")
                s.attrib.update(name=prefix + "S_first", pos="0 0 0")
            if i == nseg - 1:
                s = ET.SubElement(b, "site")
                s.attrib.update(name=prefix + "S_last",
                                pos=f"{lens[i]:.17g} 0 0")
            bodies.append(b)

        # nest the chain and register the consecutive-body excludes
        for i in range(nseg - 1):
            bodies[i].append(bodies[i + 1])
            self.excludes.append((bname(i), bname(i + 1)))
        return [bodies[0]]

    def _parse_keyframes(self):
        """<keyframe><key .../> (mjModel.key_* analog).  Attributes omitted
        on a key default at model-build time: qpos -> qpos0, the rest -> 0."""
        root = self.root.find("keyframe")
        if root is None:
            return
        for elem in root:
            if elem.tag != "key":
                raise ModelError(f"unexpected <{elem.tag}> inside <keyframe>")
            attrs = dict(elem.attrib)
            self.keyframes.append(
                dict(
                    name=attrs.get("name", f"key{len(self.keyframes)}"),
                    time=float(attrs.get("time", 0.0)),
                    qpos=(_floats(attrs["qpos"]) if "qpos" in attrs else None),
                    qvel=(_floats(attrs["qvel"]) if "qvel" in attrs else None),
                    act=(_floats(attrs["act"]) if "act" in attrs else None),
                    ctrl=(_floats(attrs["ctrl"]) if "ctrl" in attrs else None),
                )
            )

    # -- assets -------------------------------------------------------------

    def _parse_assets(self):
        a_root = self.root.find("asset")
        if a_root is None:
            return
        for elem in a_root:
            if elem.tag in ("texture", "material", "skin"):
                continue  # rendering-only assets: no physics, ignored
            if elem.tag == "hfield":
                attrs = dict(elem.attrib)
                if "elevation" in attrs:
                    nrow = int(attrs["nrow"])
                    ncol = int(attrs["ncol"])
                    # MuJoCo stores inline elevation with the FIRST line at
                    # MAXIMUM local y (verified vs mjModel.hfield_data +
                    # surface probes): reverse rows so storage row 0 is
                    # y = -sy, matching the PNG path below
                    data = _floats(attrs["elevation"]).reshape(
                        nrow, ncol)[::-1, :]
                elif "file" in attrs:
                    # file-based hfields (VERDICT r3 missing #6): PNG
                    # (grayscale, top row = max Y like MuJoCo) or MuJoCo's
                    # custom binary format (int32 nrow, ncol; float32 data)
                    path = attrs["file"]
                    if self.base_dir is not None:
                        path = os.path.join(self.base_dir, path)
                    if path.lower().endswith(".png"):
                        from PIL import Image

                        img = np.asarray(
                            Image.open(path).convert("L"), dtype=np.float64
                        )
                        # PNG row 0 is the TOP of the image; MuJoCo maps it
                        # to the LAST hfield row (max local y) — flip
                        data = img[::-1, :]
                        nrow, ncol = data.shape
                    else:
                        raw = open(path, "rb").read()
                        hdr = np.frombuffer(raw[:8], dtype=np.int32)
                        nrow, ncol = int(hdr[0]), int(hdr[1])
                        data = np.frombuffer(
                            raw[8 : 8 + 4 * nrow * ncol], dtype=np.float32
                        ).astype(np.float64).reshape(nrow, ncol)
                else:
                    raise ModelError(
                        "hfield asset requires elevation or file data"
                    )
                # MuJoCo normalizes elevation into [0, 1]; z scaling lives
                # in size[2]
                dmin, dmax = float(data.min()), float(data.max())
                if dmax > dmin:
                    data = (data - dmin) / (dmax - dmin)
                else:
                    data = np.zeros_like(data)
                self.hfields.append(
                    dict(
                        name=attrs.get("name", f"hfield{len(self.hfields)}"),
                        nrow=nrow, ncol=ncol, data=data,
                        size=_attr_floats(attrs, "size", None, 4),
                    )
                )
                continue
            if elem.tag != "mesh":
                raise UnsupportedFeatureError(f"unsupported asset <{elem.tag}>")
            attrs = dict(elem.attrib)
            scale = _attr_floats(attrs, "scale", [1, 1, 1], 3)
            if "vertex" in attrs:
                verts = _floats(attrs["vertex"]).reshape(-1, 3)
                default_name = None
            elif "file" in attrs:
                path = attrs["file"]
                if self.base_dir is not None:
                    path = os.path.join(self.base_dir, path)
                ext = os.path.splitext(path)[1].lower()
                if ext == ".obj":
                    verts = _load_obj_vertices(path)
                elif ext == ".msh":
                    verts = _load_msh_vertices(path)
                else:
                    verts = _load_stl_vertices(path)
                default_name = os.path.splitext(
                    os.path.basename(attrs["file"]))[0]
            else:
                raise ModelError("<mesh> requires vertex or file data")
            if verts.shape[0] < 4:
                raise ModelError("<mesh> needs at least 4 vertices")
            name = attrs.get("name", default_name)
            if name is None:
                raise ModelError("<mesh> requires a name")
            self.meshes.append(dict(name=name, verts=verts * scale))

    # -- tendons ------------------------------------------------------------

    def _parse_tendons(self):
        t_root = self.root.find("tendon")
        if t_root is None:
            return
        for elem in t_root:
            if elem.tag not in ("fixed", "spatial"):
                raise UnsupportedFeatureError(
                    f"unsupported tendon kind <{elem.tag}>"
                )
            # MJCF defaults store tendon attributes under <tendon>, while
            # the element tag here is <fixed>/<spatial>
            cls = elem.get("class", "main")
            attrs = dict(self.defaults.get(cls, {}).get("tendon", {}))
            attrs.update(elem.attrib)
            joints, coefs = [], []
            sites, divisors = [], []
            path = []
            if elem.tag == "fixed":
                for sub in elem:
                    if sub.tag != "joint":
                        raise UnsupportedFeatureError(
                            f"unsupported fixed-tendon wrap <{sub.tag}>"
                        )
                    joints.append(sub.attrib["joint"])
                    coefs.append(float(sub.attrib.get("coef", 0.0)))
            else:  # spatial: sites, wrap geoms (sphere/cylinder, optional
                # sidesite), pulley branch divisors
                div = 1.0
                branch = 0
                prev_kind = None
                for sub in elem:
                    if sub.tag == "site":
                        sites.append(sub.attrib["site"])
                        divisors.append((branch, div))
                        path.append(("site", sub.attrib["site"], None,
                                     branch, div))
                        prev_kind = "site"
                    elif sub.tag == "geom":
                        if prev_kind != "site":
                            raise ModelError(
                                "spatial tendon wrap geom must be "
                                "bracketed by sites"
                            )
                        path.append(("geom", sub.attrib["geom"],
                                     sub.attrib.get("sidesite"), branch,
                                     div))
                        prev_kind = "geom"
                    elif sub.tag == "pulley":
                        # a pulley starts a new branch whose segment lengths
                        # are divided by `divisor` (MuJoCo semantics)
                        div = float(sub.attrib.get("divisor", 1.0))
                        branch += 1
                        prev_kind = "pulley"
                    else:
                        raise UnsupportedFeatureError(
                            "spatial tendons support site/geom/pulley "
                            f"path elements only, got <{sub.tag}>"
                        )
                if path and path[-1][0] == "geom":
                    raise ModelError(
                        "spatial tendon wrap geom must be bracketed by "
                        "sites"
                    )
                if len(sites) < 2:
                    raise ModelError(
                        "spatial tendon needs at least two sites"
                    )
            rng = _attr_floats(attrs, "range", [0, 0], 2)
            has_rng = "range" in attrs and (rng[0] != 0 or rng[1] != 0)
            if "limited" in attrs:
                limited = attrs["limited"] in ("true", "1")
            else:
                limited = bool(has_rng) if self.autolimits else False
            # springlength: one value = exact rest length; two = dead band;
            # -1 means "use the qpos0 length" (resolved in _set_const)
            sl = _floats(attrs["springlength"]) if "springlength" in attrs \
                else np.array([-1.0])
            if sl.size == 1:
                sl = np.array([sl[0], sl[0]])
            self.tendons.append(
                dict(
                    name=attrs.get("name", f"tendon{len(self.tendons)}"),
                    kind=(0 if elem.tag == "fixed" else 1),
                    sites=sites, divisors=divisors, path=path,
                    joints=joints, coefs=coefs, limited=limited, range=rng,
                    stiffness=_attr_float(attrs, "stiffness", 0.0),
                    damping=_attr_float(attrs, "damping", 0.0),
                    frictionloss=_attr_float(attrs, "frictionloss", 0.0),
                    springlength=sl,
                    margin=_attr_float(attrs, "margin", 0.0),
                    solref_lim=_attr_floats(attrs, "solreflimit",
                                            _DEFAULT_SOLREF, 2),
                    solimp_lim=_attr_floats(attrs, "solimplimit",
                                            _DEFAULT_SOLIMP, 5),
                    solref_fri=_attr_floats(attrs, "solreffriction",
                                            _DEFAULT_SOLREF, 2),
                    solimp_fri=_attr_floats(attrs, "solimpfriction",
                                            _DEFAULT_SOLIMP, 5),
                )
            )

    def _walk_body(self, elem: ET.Element, body_id: int, cls: str):
        for child in elem:
            if child.tag == "joint":
                self._add_joint(child, body_id, cls)
            elif child.tag == "freejoint":
                attrs = {"type": "free"}
                if "name" in child.attrib:
                    attrs["name"] = child.attrib["name"]
                self._add_joint_attrs(attrs, body_id)
            elif child.tag == "geom":
                self._add_geom(child, body_id, cls)
            elif child.tag == "site":
                self._add_site(child, body_id, cls)
            elif child.tag == "inertial":
                self._set_inertial(child, body_id)
            elif child.tag == "body":
                self._add_body(child, body_id, cls)
            elif child.tag == "camera":
                self._add_camera(child, body_id, cls)
            elif child.tag == "light":
                pass
            else:
                raise UnsupportedFeatureError(
                    f"unsupported element <{child.tag}> inside <body>"
                )

    def _add_body(self, elem: ET.Element, parent: int, cls: str):
        attrs = dict(elem.attrib)
        cls = attrs.get("childclass", cls)
        body_id = len(self.bodies)
        self.bodies.append(
            dict(
                name=attrs.get("name", f"body{body_id}"),
                parent=parent,
                pos=_attr_floats(attrs, "pos", [0, 0, 0], 3),
                quat=self._orientation(attrs),
                mocap=_attr_bool(attrs, "mocap", False),
                explicit_inertial=None,
                jnt_ids=[], geom_ids=[], site_ids=[],
                childclass=cls,
            )
        )
        self._walk_body(elem, body_id, cls)

    def _add_joint(self, elem: ET.Element, body_id: int, cls: str):
        self._add_joint_attrs(self._resolved(elem, cls), body_id)

    def _add_joint_attrs(self, attrs: dict, body_id: int):
        jtype = _JOINT_TYPES.get(attrs.get("type", "hinge"))
        if jtype is None:
            raise ModelError(f"unknown joint type {attrs.get('type')!r}")
        if jtype == JointType.FREE and self.bodies[body_id]["parent"] != 0:
            # MuJoCo requires free joints on children of world
            raise ModelError("free joint allowed only on direct children of world")
        rng = _attr_floats(attrs, "range", [0, 0], 2)
        if jtype in (JointType.HINGE, JointType.BALL):
            rng = self._ang(rng)
        has_range = "range" in attrs and (rng[0] != 0 or rng[1] != 0)
        if "limited" in attrs:
            limited = attrs["limited"] in ("true", "1")
        elif self.autolimits:
            limited = bool(has_range)
        else:
            limited = False
        if jtype == JointType.FREE:
            # MuJoCo silently clears `limited` on free joints (verified
            # against 3.10: limited="true" compiles to jnt_limited=False)
            limited = False
        ref = _attr_float(attrs, "ref", 0.0)
        springref = _attr_float(attrs, "springref", 0.0)
        if jtype == JointType.HINGE:
            ref, springref = float(self._ang(ref)), float(self._ang(springref))
        jid = len(self.joints)
        self.joints.append(
            dict(
                name=attrs.get("name", f"joint{jid}"),
                type=jtype,
                body=body_id,
                pos=_attr_floats(attrs, "pos", [0, 0, 0], 3),
                axis=_attr_floats(attrs, "axis", [0, 0, 1], 3),
                range=rng,
                limited=limited,
                stiffness=_attr_float(attrs, "stiffness", 0.0),
                damping=_attr_float(attrs, "damping", 0.0),
                armature=_attr_float(attrs, "armature", 0.0),
                frictionloss=_attr_float(attrs, "frictionloss", 0.0),
                ref=ref,
                springref=springref,
                margin=_attr_float(attrs, "margin", 0.0),
                solref=_attr_floats(attrs, "solreflimit", _DEFAULT_SOLREF, 2),
                solimp=_attr_floats(attrs, "solimplimit", _DEFAULT_SOLIMP, 5),
                solref_friction=_attr_floats(attrs, "solreffriction", _DEFAULT_SOLREF, 2),
                solimp_friction=_attr_floats(attrs, "solimpfriction", _DEFAULT_SOLIMP, 5),
            )
        )
        self.bodies[body_id]["jnt_ids"].append(jid)

    def _add_geom(self, elem: ET.Element, body_id: int, cls: str):
        attrs = self._resolved(elem, cls)
        gtype = _GEOM_TYPES.get(attrs.get("type", "sphere"))
        if gtype is None:
            raise UnsupportedFeatureError(f"unsupported geom type {attrs.get('type')!r}")
        size = _attr_floats(attrs, "size", [0, 0, 0], 3)
        pos = _attr_floats(attrs, "pos", [0, 0, 0], 3)
        quat = self._orientation(attrs)
        if "fromto" in attrs:
            ft = _floats(attrs["fromto"])
            a, b = ft[:3], ft[3:6]
            pos = 0.5 * (a + b)
            # MuJoCo convention: geom z-axis points along (from - to)
            quat = _quat_from_zaxis(a - b)
            size = size.copy()
            size[1] = 0.5 * np.linalg.norm(b - a)  # half-length
        if gtype == GeomType.MESH and "mesh" not in attrs:
            raise ModelError("mesh geom requires a mesh attribute")
        if gtype == GeomType.HFIELD and "hfield" not in attrs:
            raise ModelError("hfield geom requires an hfield attribute")
        gid = len(self.geoms)
        self.geoms.append(
            dict(
                name=attrs.get("name", f"geom{gid}"),
                mesh=attrs.get("mesh"),
                hfield=attrs.get("hfield"),
                type=gtype,
                body=body_id,
                pos=pos,
                quat=quat,
                size=size,
                mass=(_attr_float(attrs, "mass", -1.0) if "mass" in attrs else None),
                density=_attr_float(attrs, "density", 1000.0),
                friction=_attr_floats(attrs, "friction", [1.0, 0.005, 0.0001], 3),
                contype=_attr_int(attrs, "contype", 1),
                conaffinity=_attr_int(attrs, "conaffinity", 1),
                condim=_attr_int(attrs, "condim", 3),
                priority=_attr_int(attrs, "priority", 0),
                margin=_attr_float(attrs, "margin", 0.0),
                gap=_attr_float(attrs, "gap", 0.0),
                solref=_attr_floats(attrs, "solref", _DEFAULT_SOLREF, 2),
                solimp=_attr_floats(attrs, "solimp", _DEFAULT_SOLIMP, 5),
                solmix=_attr_float(attrs, "solmix", 1.0),
                group=_attr_int(attrs, "group", 0),
            )
        )
        self.bodies[body_id]["geom_ids"].append(gid)

    def _add_site(self, elem: ET.Element, body_id: int, cls: str):
        attrs = self._resolved(elem, cls)
        sid = len(self.sites)
        stype = _GEOM_TYPES.get(attrs.get("type", "sphere"))
        if stype is None:
            raise UnsupportedFeatureError(
                f"unsupported site type {attrs.get('type')!r}"
            )
        # MuJoCo default site size is 0.005 in every slot
        size = _attr_floats(attrs, "size", [0.005, 0.005, 0.005], 3)
        pos = _attr_floats(attrs, "pos", [0, 0, 0], 3)
        quat = self._orientation(attrs)
        if "fromto" in attrs:
            ft = _floats(attrs["fromto"])
            a, b = ft[:3], ft[3:6]
            pos = 0.5 * (a + b)
            quat = _quat_from_zaxis(a - b)
            size = size.copy()
            size[1] = 0.5 * np.linalg.norm(b - a)
        self.sites.append(
            dict(
                name=attrs.get("name", f"site{sid}"),
                body=body_id,
                type=stype,
                pos=pos,
                quat=quat,
                size=size,
            )
        )
        self.bodies[body_id]["site_ids"].append(sid)

    def _add_camera(self, elem: ET.Element, body_id: int, cls: str):
        attrs = dict(elem.attrib)
        mode = attrs.get("mode", "fixed")
        modes = {"fixed": 0, "track": 1, "trackcom": 2, "targetbody": 3,
                 "targetbodycom": 4}
        if mode not in modes:
            raise UnsupportedFeatureError(
                f"camera mode {mode!r} not supported"
            )
        if mode in ("targetbody", "targetbodycom") and "target" not in attrs:
            raise ModelError(f"camera mode {mode!r} needs a target body")
        resolution = tuple(int(x) for x in
                           _attr_floats(attrs, "resolution", [1, 1], 2))
        # intrinsics (mjModel.cam_intrinsic semantics): focal (fx, fy) in
        # length units + sensorsize; focalpixel converts via
        # sensorsize / resolution.  Empty sensorsize -> fovy projection.
        sensorsize = tuple(_attr_floats(attrs, "sensorsize", [0, 0], 2))
        intrinsic = [0.0, 0.0, 0.0, 0.0]
        if sensorsize != (0.0, 0.0):
            if "focalpixel" in attrs:
                fp = _attr_floats(attrs, "focalpixel", [0, 0], 2)
                intrinsic[0] = fp[0] * sensorsize[0] / resolution[0]
                intrinsic[1] = fp[1] * sensorsize[1] / resolution[1]
            else:
                intrinsic[:2] = _attr_floats(attrs, "focal", [0, 0], 2)
            if "principalpixel" in attrs:
                pp = _attr_floats(attrs, "principalpixel", [0, 0], 2)
                intrinsic[2] = pp[0] * sensorsize[0] / resolution[0]
                intrinsic[3] = pp[1] * sensorsize[1] / resolution[1]
            else:
                intrinsic[2:] = _attr_floats(attrs, "principal", [0, 0], 2)
        elif "focal" in attrs or "focalpixel" in attrs:
            raise ModelError(
                "camera focal/focalpixel needs an explicit sensorsize"
            )
        self.cameras.append(dict(
            name=attrs.get("name", f"camera{len(self.cameras)}"),
            body=body_id,
            mode=modes[mode],
            target=attrs.get("target"),
            pos=_attr_floats(attrs, "pos", [0, 0, 0], 3),
            quat=self._orientation(attrs),
            fovy=_attr_float(attrs, "fovy", 45.0),
            resolution=resolution,
            sensorsize=sensorsize,
            intrinsic=tuple(intrinsic),
        ))

    def _set_inertial(self, elem: ET.Element, body_id: int):
        attrs = dict(elem.attrib)
        mass = float(attrs["mass"])
        pos = _attr_floats(attrs, "pos", [0, 0, 0], 3)
        quat = self._orientation(attrs)
        if "diaginertia" in attrs:
            diag = _floats(attrs["diaginertia"])
            full = None
        elif "fullinertia" in attrs:
            fi = _floats(attrs["fullinertia"])  # ixx iyy izz ixy ixz iyz
            full = np.array(
                [
                    [fi[0], fi[3], fi[4]],
                    [fi[3], fi[1], fi[5]],
                    [fi[4], fi[5], fi[2]],
                ]
            )
            diag = None
        else:
            raise ModelError("<inertial> needs diaginertia or fullinertia")
        self.bodies[body_id]["explicit_inertial"] = dict(
            mass=mass, pos=pos, quat=quat, diag=diag, full=full
        )

    # -- actuators ----------------------------------------------------------

    def _parse_actuators(self):
        act_root = self.root.find("actuator")
        if act_root is None:
            return
        for elem in act_root:
            attrs = self._resolved(elem, "main")
            kind = elem.tag
            if kind not in ("motor", "position", "velocity", "general",
                            "intvelocity", "damper", "muscle", "cylinder",
                            "adhesion"):
                raise UnsupportedFeatureError(f"unsupported actuator <{kind}>")
            if kind == "adhesion":
                trntype, target = TrnType.BODY, attrs["body"]
            elif "joint" in attrs:
                trntype, target = TrnType.JOINT, attrs["joint"]
            elif "tendon" in attrs:
                trntype, target = TrnType.TENDON, attrs["tendon"]
            elif "site" in attrs:
                trntype, target = TrnType.SITE, attrs["site"]
            else:
                raise ModelError(f"actuator <{kind}> missing transmission target")

            gainprm = np.zeros(10)
            biasprm = np.zeros(10)
            dynprm = np.zeros(10)
            dynprm[0] = 1.0
            gaintype, biastype, dyntype = GainType.FIXED, BiasType.NONE, DynType.NONE
            if kind == "motor":
                gainprm[0] = 1.0
            elif kind == "position":
                kp = _attr_float(attrs, "kp", 1.0)
                kv = _attr_float(attrs, "kv", 0.0)
                gainprm[0] = kp
                biastype = BiasType.AFFINE
                biasprm[1] = -kp
                biasprm[2] = -kv
            elif kind == "velocity":
                kv = _attr_float(attrs, "kv", 1.0)
                gainprm[0] = kv
                biastype = BiasType.AFFINE
                biasprm[2] = -kv
            elif kind == "intvelocity":
                # velocity servo through an integrator on the setpoint
                # (mjcf shortcut: dyntype=integrator, position-servo on act)
                kp = _attr_float(attrs, "kp", 1.0)
                kv = _attr_float(attrs, "kv", 0.0)
                gainprm[0] = kp
                biastype = BiasType.AFFINE
                biasprm[1] = -kp
                biasprm[2] = -kv
                dyntype = DynType.INTEGRATOR
                # MuJoCo requires actrange for intvelocity (the integrated
                # setpoint must be bounded) and act-limits it by default
                if "actrange" not in attrs:
                    raise ModelError(
                        "intvelocity actuator requires actrange"
                    )
            elif kind == "adhesion":
                # adhesion: fixed gain, force along averaged contact
                # normals (mjs_setToAdhesion); MuJoCo requires a
                # non-negative ctrlrange
                gainprm[0] = _attr_float(attrs, "gain", 1.0)
                _acr = _attr_floats(attrs, "ctrlrange", [0, 0], 2)
                if "ctrlrange" not in attrs or _acr[0] < 0:
                    raise ModelError(
                        "adhesion actuator requires ctrlrange with "
                        "ctrlrange[0] >= 0"
                    )
            elif kind == "cylinder":
                # pneumatic/hydraulic cylinder shortcut (mjs_setToCylinder):
                # first-order pressure filter + piston area gain + affine
                # bias.  Field mapping verified against MuJoCo 3.10:
                # dyntype=filter dynprm[0]=timeconst, gainprm[0]=area
                # (pi d^2/4 when diameter given), biastype=affine
                # biasprm[0]=bias[0] (only the constant term survives the
                # MuJoCo compiler — replicated exactly).
                dyntype = DynType.FILTER
                dynprm[0] = _attr_float(attrs, "timeconst", 1.0)
                if "diameter" in attrs:
                    dia = _attr_float(attrs, "diameter", 1.0)
                    gainprm[0] = np.pi * 0.25 * dia * dia
                else:
                    gainprm[0] = _attr_float(attrs, "area", 1.0)
                biastype = BiasType.AFFINE
                bias3 = _attr_floats(attrs, "bias", [0, 0, 0], 3)
                biasprm[0] = bias3[0]
            elif kind == "damper":
                # active damper: force = -kv * ctrl * velocity.  MuJoCo
                # requires ctrlrange with a non-negative lower bound (a
                # negative ctrl would flip the sign and inject energy).
                kv = _attr_float(attrs, "kv", 1.0)
                gaintype = GainType.AFFINE
                gainprm[0] = 0.0
                gainprm[2] = -kv
                _dcr = _attr_floats(attrs, "ctrlrange", [0, 0], 2)
                if "ctrlrange" not in attrs or _dcr[0] < 0:
                    raise ModelError(
                        "damper actuator requires ctrlrange with "
                        "ctrlrange[0] >= 0"
                    )
            elif kind == "muscle":
                # mjs_defaultActuator muscle defaults, validated vs the
                # mujoco wheel's compiled gainprm/biasprm/dynprm
                dyntype = DynType.MUSCLE
                gaintype = GainType.MUSCLE
                biastype = BiasType.MUSCLE
                tc = _attr_floats(attrs, "timeconst", [0.01, 0.04], 2)
                dynprm[0], dynprm[1] = tc[0], tc[1]
                dynprm[2] = _attr_float(attrs, "tausmooth", 0.0)
                rng_m = _attr_floats(attrs, "range", [0.75, 1.05], 2)
                prm9 = [
                    rng_m[0], rng_m[1],
                    _attr_float(attrs, "force", -1.0),
                    _attr_float(attrs, "scale", 200.0),
                    _attr_float(attrs, "lmin", 0.5),
                    _attr_float(attrs, "lmax", 1.6),
                    _attr_float(attrs, "vmax", 1.5),
                    _attr_float(attrs, "fpmax", 1.3),
                    _attr_float(attrs, "fvmax", 1.2),
                ]
                gainprm[:9] = prm9
                biasprm[:9] = prm9
            else:  # general
                gp = _attr_floats(attrs, "gainprm", [1, 0, 0], 3)
                gainprm[: gp.size] = gp
                bp = _attr_floats(attrs, "biasprm", [0, 0, 0], 3)
                biasprm[: bp.size] = bp
                gaintype = GainType[attrs.get("gaintype", "fixed").upper()]
                biastype = BiasType[attrs.get("biastype", "none").upper()]
                dt_name = attrs.get("dyntype", "none").upper()
                if dt_name not in DynType.__members__:
                    raise UnsupportedFeatureError(
                        f"unsupported actuator dyntype {dt_name.lower()!r}"
                    )
                dyntype = DynType[dt_name]
                dp = _attr_floats(attrs, "dynprm", [1, 0, 0], 3)
                dynprm[: dp.size] = dp

            ctrlrange = _attr_floats(attrs, "ctrlrange", [0, 0], 2)
            has_cr = "ctrlrange" in attrs and (ctrlrange[0] != 0 or ctrlrange[1] != 0)
            if "ctrllimited" in attrs:
                ctrllimited = attrs["ctrllimited"] in ("true", "1")
            elif kind in ("damper", "adhesion"):
                ctrllimited = True  # MuJoCo forces ctrl limits on these
            else:
                ctrllimited = bool(has_cr) if self.autolimits else False
            forcerange = _attr_floats(attrs, "forcerange", [0, 0], 2)
            has_fr = "forcerange" in attrs and (forcerange[0] != 0 or forcerange[1] != 0)
            if "forcelimited" in attrs:
                forcelimited = attrs["forcelimited"] in ("true", "1")
            else:
                forcelimited = bool(has_fr) if self.autolimits else False
            actrange = _attr_floats(attrs, "actrange", [0, 0], 2)
            has_ar = "actrange" in attrs and (actrange[0] != 0 or actrange[1] != 0)
            if "actlimited" in attrs:
                actlimited = attrs["actlimited"] in ("true", "1")
            elif kind == "intvelocity":
                actlimited = True  # MuJoCo act-limits the integrated setpoint
            else:
                actlimited = bool(has_ar) if self.autolimits else False

            aid = len(self.actuators)
            self.actuators.append(
                dict(
                    name=attrs.get("name", f"actuator{aid}"),
                    trntype=trntype,
                    target=target,
                    gear=_attr_floats(attrs, "gear", [1, 0, 0, 0, 0, 0], 6),
                    ctrlrange=ctrlrange,
                    ctrllimited=ctrllimited,
                    forcerange=forcerange,
                    forcelimited=forcelimited,
                    actrange=actrange,
                    actlimited=actlimited,
                    gaintype=gaintype,
                    biastype=biastype,
                    dyntype=dyntype,
                    gainprm=gainprm,
                    biasprm=biasprm,
                    dynprm=dynprm,
                    lengthrange=(_attr_floats(attrs, "lengthrange", None, 2)
                                 if "lengthrange" in attrs else None),
                    refsite=attrs.get("refsite"),
                )
            )

    # -- equality -----------------------------------------------------------

    def _parse_equality(self):
        eq_root = self.root.find("equality")
        if eq_root is None:
            return
        for elem in eq_root:
            attrs = self._resolved(elem, "main")
            active = _attr_bool(attrs, "active", True)
            solref = _attr_floats(attrs, "solref", _DEFAULT_SOLREF, 2)
            solimp = _attr_floats(attrs, "solimp", _DEFAULT_SOLIMP, 5)
            data = np.zeros(11)
            if elem.tag == "connect":
                etype = EqType.CONNECT
                anchor = _attr_floats(attrs, "anchor", [0, 0, 0], 3)
                data[:3] = anchor
                obj1, obj2 = attrs["body1"], attrs.get("body2", "world")
            elif elem.tag == "weld":
                etype = EqType.WELD
                # MuJoCo default relpose is all-zero; a zero quat part means
                # "use the relative pose at qpos0" (resolved in _set_const)
                relpose = _attr_floats(attrs, "relpose", [0, 0, 0, 0, 0, 0, 0], 7)
                data[3:10] = relpose
                data[10] = _attr_float(attrs, "torquescale", 1.0)
                if "anchor" in attrs:
                    data[:3] = _attr_floats(attrs, "anchor", [0, 0, 0], 3)
                obj1, obj2 = attrs["body1"], attrs.get("body2", "world")
            elif elem.tag == "joint":
                etype = EqType.JOINT
                poly = _attr_floats(attrs, "polycoef", [0, 1, 0, 0, 0], 5)
                data[:5] = poly
                obj1, obj2 = attrs["joint1"], attrs.get("joint2", "")
            elif elem.tag == "tendon":
                etype = EqType.TENDON
                poly = _attr_floats(attrs, "polycoef", [0, 1, 0, 0, 0], 5)
                data[:5] = poly
                obj1, obj2 = attrs["tendon1"], attrs.get("tendon2", "")
            else:
                raise UnsupportedFeatureError(f"unsupported equality <{elem.tag}>")
            self.equalities.append(
                dict(
                    name=attrs.get("name", f"eq{len(self.equalities)}"),
                    type=etype, obj1=obj1, obj2=obj2, active=active,
                    solref=solref, solimp=solimp, data=data,
                )
            )

    # -- contact overrides --------------------------------------------------

    def _parse_contact(self):
        c_root = self.root.find("contact")
        if c_root is None:
            return
        for elem in c_root:
            attrs = self._resolved(elem, "main")
            if elem.tag == "exclude":
                self.excludes.append((attrs["body1"], attrs["body2"]))
            elif elem.tag == "pair":
                self.explicit_pairs.append(attrs)
            else:
                raise UnsupportedFeatureError(f"unsupported contact <{elem.tag}>")

    # -- sensors ------------------------------------------------------------

    # tag -> (SensorType, dim, attachment kind)
    _SENSOR_TAGS = {
        "touch": (SensorType.TOUCH, 1, "site"),
        "accelerometer": (SensorType.ACCELEROMETER, 3, "site"),
        "velocimeter": (SensorType.VELOCIMETER, 3, "site"),
        "gyro": (SensorType.GYRO, 3, "site"),
        "force": (SensorType.FORCE, 3, "site"),
        "torque": (SensorType.TORQUE, 3, "site"),
        "magnetometer": (SensorType.MAGNETOMETER, 3, "site"),
        "rangefinder": (SensorType.RANGEFINDER, 1, "site"),
        "jointpos": (SensorType.JOINTPOS, 1, "joint"),
        "jointvel": (SensorType.JOINTVEL, 1, "joint"),
        "jointactuatorfrc": (SensorType.JOINTACTFRC, 1, "joint"),
        "jointlimitpos": (SensorType.JOINTLIMITPOS, 1, "joint"),
        "jointlimitvel": (SensorType.JOINTLIMITVEL, 1, "joint"),
        "jointlimitfrc": (SensorType.JOINTLIMITFRC, 1, "joint"),
        "tendonlimitpos": (SensorType.TENDONLIMITPOS, 1, "tendon"),
        "tendonlimitvel": (SensorType.TENDONLIMITVEL, 1, "tendon"),
        "tendonlimitfrc": (SensorType.TENDONLIMITFRC, 1, "tendon"),
        "ballquat": (SensorType.BALLQUAT, 4, "joint"),
        "ballangvel": (SensorType.BALLANGVEL, 3, "joint"),
        "tendonpos": (SensorType.TENDONPOS, 1, "tendon"),
        "tendonvel": (SensorType.TENDONVEL, 1, "tendon"),
        "actuatorpos": (SensorType.ACTUATORPOS, 1, "actuator"),
        "actuatorvel": (SensorType.ACTUATORVEL, 1, "actuator"),
        "actuatorfrc": (SensorType.ACTUATORFRC, 1, "actuator"),
        "framepos": (SensorType.FRAMEPOS, 3, "frame"),
        "framequat": (SensorType.FRAMEQUAT, 4, "frame"),
        "framexaxis": (SensorType.FRAMEXAXIS, 3, "frame"),
        "frameyaxis": (SensorType.FRAMEYAXIS, 3, "frame"),
        "framezaxis": (SensorType.FRAMEZAXIS, 3, "frame"),
        "framelinvel": (SensorType.FRAMELINVEL, 3, "frame"),
        "frameangvel": (SensorType.FRAMEANGVEL, 3, "frame"),
        "framelinacc": (SensorType.FRAMELINACC, 3, "frame"),
        "frameangacc": (SensorType.FRAMEANGACC, 3, "frame"),
        "subtreecom": (SensorType.SUBTREECOM, 3, "body"),
        "subtreelinvel": (SensorType.SUBTREELINVEL, 3, "body"),
        "subtreeangmom": (SensorType.SUBTREEANGMOM, 3, "body"),
        "e_potential": (SensorType.E_POTENTIAL, 1, "none"),
        "e_kinetic": (SensorType.E_KINETIC, 1, "none"),
        "clock": (SensorType.CLOCK, 1, "none"),
        # two-object collision-distance family (mj_geomDistance semantics)
        "distance": (SensorType.GEOMDIST, 1, "geompair"),
        "normal": (SensorType.GEOMNORMAL, 3, "geompair"),
        "fromto": (SensorType.GEOMFROMTO, 6, "geompair"),
        "insidesite": (SensorType.INSIDESITE, 1, "insidesite"),
        "tendonactuatorfrc": (SensorType.TENDONACTFRC, 1, "tendon"),
        "user": (SensorType.USER, 0, "user"),
        "camprojection": (SensorType.CAMPROJECTION, 2, "camproj"),
    }

    _FRAME_OBJTYPES = {
        "body": ObjType.BODY,
        "xbody": ObjType.XBODY,
        "geom": ObjType.GEOM,
        "site": ObjType.SITE,
    }

    def _parse_sensors(self):
        s_root = self.root.find("sensor")
        if s_root is None:
            return
        for elem in s_root:
            if elem.tag not in self._SENSOR_TAGS:
                raise UnsupportedFeatureError(
                    f"unsupported sensor <{elem.tag}>"
                )
            stype, dim, kind = self._SENSOR_TAGS[elem.tag]
            attrs = dict(elem.attrib)
            reftype, refname = ObjType.NONE, ""
            if kind == "frame":
                otname = attrs.get("objtype", "")
                if otname not in self._FRAME_OBJTYPES:
                    raise ModelError(
                        f"<{elem.tag}> objtype must be one of "
                        f"{sorted(self._FRAME_OBJTYPES)}, got {otname!r}"
                    )
                objtype = self._FRAME_OBJTYPES[otname]
                objname = attrs.get("objname", "")
                if "reftype" in attrs or "refname" in attrs:
                    rtname = attrs.get("reftype", "")
                    if rtname not in self._FRAME_OBJTYPES:
                        raise ModelError(
                            f"<{elem.tag}> reftype {rtname!r} not supported"
                        )
                    if stype in (SensorType.FRAMELINACC,
                                 SensorType.FRAMEANGACC):
                        raise UnsupportedFeatureError(
                            "reference frames on acceleration sensors are "
                            "not supported (matches MuJoCo)"
                        )
                    reftype = self._FRAME_OBJTYPES[rtname]
                    refname = attrs.get("refname", "")
            elif kind == "geompair":
                # <distance|normal|fromto geom1=/geom2= or body1=/body2=>
                if "geom1" in attrs or "geom2" in attrs:
                    objtype = reftype = ObjType.GEOM
                    objname = attrs.get("geom1", "")
                    refname = attrs.get("geom2", "")
                else:
                    objtype = reftype = ObjType.BODY
                    objname = attrs.get("body1", "")
                    refname = attrs.get("body2", "")
                if not objname or not refname:
                    raise ModelError(
                        f"<{elem.tag}> needs geom1+geom2 or body1+body2"
                    )
            elif kind == "insidesite":
                # objtype/objname point at the object whose position is
                # tested; the site is carried in reftype/refname
                otname = attrs.get("objtype", "")
                if otname not in self._FRAME_OBJTYPES:
                    raise ModelError(
                        f"<insidesite> objtype must be one of "
                        f"{sorted(self._FRAME_OBJTYPES)}, got {otname!r}"
                    )
                objtype = self._FRAME_OBJTYPES[otname]
                objname = attrs.get("objname", "")
                reftype = ObjType.SITE
                refname = attrs.get("site", "")
                if not refname:
                    raise ModelError("<insidesite> requires a site attribute")
            elif kind == "camproj":
                objtype = ObjType.SITE
                objname = attrs.get("site", "")
                reftype = ObjType.CAMERA
                refname = attrs.get("camera", "")
                if not objname or not refname:
                    raise ModelError(
                        "<camprojection> requires site and camera attributes"
                    )
            elif kind == "user":
                # user sensors carry caller-defined values; without the
                # mjcb_sensor callback MuJoCo leaves them zero — replicated
                objtype, objname = ObjType.NONE, ""
                dim = int(attrs.get("dim", "1"))
            elif kind == "none":
                objtype, objname = ObjType.NONE, ""
            else:
                objtype = {
                    "site": ObjType.SITE, "joint": ObjType.JOINT,
                    "tendon": ObjType.TENDON, "actuator": ObjType.ACTUATOR,
                    "body": ObjType.BODY,
                }[kind]
                objname = attrs.get(kind, "")
                if not objname:
                    raise ModelError(
                        f"<{elem.tag}> requires a {kind!r} attribute"
                    )
            self.sensors.append(
                dict(
                    name=attrs.get("name", f"sensor{len(self.sensors)}"),
                    type=stype, dim=dim,
                    objtype=objtype, objname=objname,
                    reftype=reftype, refname=refname,
                    cutoff=_attr_float(attrs, "cutoff", 0.0),
                )
            )

    # -- option -------------------------------------------------------------

    def parse_option(self) -> Option:
        opt_elem = self.root.find("option")
        attrs = dict(opt_elem.attrib) if opt_elem is not None else {}
        flags = opt_elem.find("flag") if opt_elem is not None else None
        fattrs = dict(flags.attrib) if flags is not None else {}
        integ = attrs.get("integrator", "Euler")
        if integ not in _INTEGRATORS:
            raise UnsupportedFeatureError(f"integrator {integ!r} not supported")
        solver = attrs.get("solver", "Newton")
        cone = attrs.get("cone", "pyramidal")
        return Option(
            timestep=_attr_float(attrs, "timestep", 0.002),
            gravity=tuple(_attr_floats(attrs, "gravity", [0, 0, -9.81], 3)),
            wind=tuple(_attr_floats(attrs, "wind", [0, 0, 0], 3)),
            magnetic=tuple(_attr_floats(attrs, "magnetic", [0, -0.5, 0], 3)),
            density=_attr_float(attrs, "density", 0.0),
            viscosity=_attr_float(attrs, "viscosity", 0.0),
            integrator=_INTEGRATORS[integ],
            solver=_SOLVERS[solver],
            cone=ConeType.PYRAMIDAL if cone == "pyramidal" else ConeType.ELLIPTIC,
            iterations=_attr_int(attrs, "iterations", 100),
            tolerance=_attr_float(attrs, "tolerance", 1e-8),
            ls_iterations=_attr_int(attrs, "ls_iterations", 50),
            ls_tolerance=_attr_float(attrs, "ls_tolerance", 0.01),
            impratio=_attr_float(attrs, "impratio", 1.0),
            disable_contact=fattrs.get("contact", "enable") == "disable",
            disable_gravity=fattrs.get("gravity", "enable") == "disable",
            disable_limit=fattrs.get("limit", "enable") == "disable",
            disable_eulerdamp=fattrs.get("eulerdamp", "enable") == "disable",
            disable_frictionloss=(
                fattrs.get("frictionloss", "enable") == "disable"
            ),
        )


# ---------------------------------------------------------------------------
# mesh assets
# ---------------------------------------------------------------------------


def _load_stl_vertices(path: str) -> np.ndarray:
    """Unique vertices of a binary STL file (the only physics-relevant
    payload: collision and inertia use the convex hull)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 84:
        raise ModelError(f"not a binary STL: {path!r}")
    ntri = int(np.frombuffer(data[80:84], dtype="<u4")[0])
    rec = np.frombuffer(data[84 : 84 + 50 * ntri], dtype=np.uint8)
    rec = rec.reshape(ntri, 50)
    tris = rec[:, 12:48].copy().view("<f4").reshape(ntri, 3, 3)
    verts = np.unique(tris.reshape(-1, 3), axis=0).astype(np.float64)
    return verts


def _load_obj_vertices(path: str) -> np.ndarray:
    """Vertex positions of a Wavefront OBJ file ('v' records; faces,
    normals and texcoords are irrelevant to the convex-hull physics)."""
    verts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
    if not verts:
        raise ModelError(f"no vertices in OBJ file {path!r}")
    return np.unique(np.asarray(verts, dtype=np.float64), axis=0)


def _load_msh_vertices(path: str) -> np.ndarray:
    """Vertex positions of MuJoCo's legacy binary .msh mesh format:
    int32 header (nvertex, nnormal, ntexcoord, nface) followed by
    float32 vertex data."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 16:
        raise ModelError(f"not a MuJoCo .msh file: {path!r}")
    nvert = int(np.frombuffer(data[:4], dtype="<i4")[0])
    if nvert <= 0 or 16 + 12 * nvert > len(data):
        raise ModelError(f"corrupt .msh header in {path!r}")
    verts = np.frombuffer(
        data[16 : 16 + 12 * nvert], dtype="<f4"
    ).astype(np.float64).reshape(nvert, 3)
    return np.unique(verts, axis=0)


def _process_mesh(verts: np.ndarray):
    """Convex-hull mass properties + canonical (com-centered, principal-
    axis-aligned) vertex frame — the mjCMesh::Process analog.  Returns
    (canonical hull verts, volume, com (in the input frame), principal
    quat, unit-mass inertia diag)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    # signed tetrahedra (origin, triangle) over outward-oriented hull faces
    tris = verts[hull.simplices]  # (nf, 3, 3)
    # orient each face outward (qhull simplices are not ordered): flip a
    # face if its normal points toward the hull interior
    centroid = np.mean(verts[hull.vertices], axis=0)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flip = np.einsum("fi,fi->f", n, tris[:, 0] - centroid) < 0
    tris[flip] = tris[flip][:, ::-1]

    vols = np.einsum(
        "fi,fi->f", tris[:, 0], np.cross(tris[:, 1], tris[:, 2])
    ) / 6.0
    volume = float(np.sum(vols))
    if volume <= 0:
        raise ModelError("mesh has non-positive hull volume")
    # centroid of tetra (origin, a, b, c) = (a + b + c)/4
    com = 0.75 * np.einsum("f,fi->i", vols, np.mean(tris, axis=1)) / volume

    # inertia (unit density) about com: exact tetrahedron covariance sums
    t = tris - com
    cov = np.zeros((3, 3))
    for f in range(t.shape[0]):
        a, b, cc = t[f]
        det = np.dot(a, np.cross(b, cc))
        pts = np.stack([a, b, cc])
        s = pts.sum(axis=0)
        c_f = (np.einsum("ki,kj->ij", pts, pts) + np.outer(s, s)) * (
            det / 120.0
        )
        cov += c_f
    inertia_full = np.trace(cov) * np.eye(3) - cov
    diag, iquat = _principal_decomposition(inertia_full)
    r = _quat_to_mat(iquat)
    canonical = (verts[hull.vertices] - com) @ r
    return canonical, volume, com, iquat, diag / volume


# ---------------------------------------------------------------------------
# geom mass properties
# ---------------------------------------------------------------------------


def _geom_mass_inertia(g: dict) -> tuple[float, np.ndarray]:
    """(mass, principal inertia diag about geom com, in geom frame)."""
    t, size = g["type"], g["size"]
    r = float(size[0])
    if t == GeomType.MESH:
        # geom pos/quat were re-anchored to the mesh's canonical frame at
        # asset-processing time, so the diag is already principal
        vol = g["mesh_volume"]
        mass = g["mass"] if g["mass"] is not None else g["density"] * vol
        return mass, mass * np.asarray(g["mesh_unit_inertia"])
    if t in (GeomType.PLANE, GeomType.HFIELD):
        return 0.0, np.zeros(3)
    if t == GeomType.SPHERE:
        vol = 4.0 / 3.0 * math.pi * r**3
        mass = g["mass"] if g["mass"] is not None else g["density"] * vol
        i = 0.4 * mass * r * r
        return mass, np.array([i, i, i])
    if t == GeomType.CAPSULE:
        h = float(size[1])
        vol_c = math.pi * r * r * 2 * h
        vol_s = 4.0 / 3.0 * math.pi * r**3
        vol = vol_c + vol_s
        mass = g["mass"] if g["mass"] is not None else g["density"] * vol
        mc = mass * vol_c / vol
        ms = mass * vol_s / vol
        iz = mc * r * r / 2 + 0.4 * ms * r * r
        ix = (
            mc * (3 * r * r + 4 * h * h) / 12.0
            + ms * (0.4 * r * r + h * h + 0.75 * h * r)
        )
        return mass, np.array([ix, ix, iz])
    if t == GeomType.CYLINDER:
        h = float(size[1])
        vol = math.pi * r * r * 2 * h
        mass = g["mass"] if g["mass"] is not None else g["density"] * vol
        iz = mass * r * r / 2
        ix = mass * (3 * r * r + 4 * h * h) / 12.0
        return mass, np.array([ix, ix, iz])
    if t == GeomType.BOX:
        a, b, c = [float(x) for x in size]
        vol = 8 * a * b * c
        mass = g["mass"] if g["mass"] is not None else g["density"] * vol
        return mass, mass / 3.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    if t == GeomType.ELLIPSOID:
        a, b, c = [float(x) for x in size]
        vol = 4.0 / 3.0 * math.pi * a * b * c
        mass = g["mass"] if g["mass"] is not None else g["density"] * vol
        return mass, mass / 5.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    raise UnsupportedFeatureError(f"mass properties for geom type {t}")


def _principal_decomposition(full: np.ndarray):
    """Full 3x3 inertia -> (diag(3) descending? MuJoCo order, quat)."""
    w, v = np.linalg.eigh(full)  # ascending
    # MuJoCo stores eigenvalues in the order produced by its own eigen
    # decomposition (descending). Match: reverse.
    w = w[::-1]
    v = v[:, ::-1]
    if np.linalg.det(v) < 0:
        v[:, 2] = -v[:, 2]
    return w, _mat_to_quat(v)


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def load_model_from_xml(xml: str, dtype=np.float64) -> Model:
    """Compile an MJCF string (analog of Physics::from_xml_string,
    oxide_control src/physics.rs:18-24)."""
    try:
        root = ET.fromstring(xml)
    except ET.ParseError as e:
        raise ModelError(f"XML parse error: {e}") from e
    return _compile(root, dtype=dtype)


def load_model(path: str | os.PathLike, dtype=np.float64) -> Model:
    """Compile an MJCF file (analog of Physics::from_xml,
    oxide_control src/physics.rs:12-16)."""
    try:
        tree = ET.parse(path)
    except (ET.ParseError, OSError) as e:
        raise ModelError(f"cannot load {path}: {e}") from e
    return _compile(tree.getroot(), base_dir=os.path.dirname(os.fspath(path)),
                    dtype=dtype)


def _compile(root: ET.Element, base_dir: str | None = None, dtype=np.float64) -> Model:
    c = _Compiler(root, base_dir)
    c.parse()
    opt = c.parse_option()

    nbody = len(c.bodies)
    njnt = len(c.joints)
    ngeom = len(c.geoms)
    nsite = len(c.sites)
    nu = len(c.actuators)
    neq = len(c.equalities)

    # ----- addresses -------------------------------------------------------
    jnt_qposadr, jnt_dofadr = [], []
    nq = nv = 0
    for j in c.joints:
        jnt_qposadr.append(nq)
        jnt_dofadr.append(nv)
        nq += QPOS_WIDTH[j["type"]]
        nv += DOF_WIDTH[j["type"]]

    body_parentid = [b["parent"] for b in c.bodies]
    # rootid: highest ancestor below world
    body_rootid = [0] * nbody
    for i in range(1, nbody):
        b = i
        while body_parentid[b] != 0:
            b = body_parentid[b]
        body_rootid[i] = b
    # weldid: nearest ancestor (or self) with a joint; world otherwise
    body_weldid = [0] * nbody
    for i in range(1, nbody):
        if c.bodies[i]["jnt_ids"]:
            body_weldid[i] = i
        else:
            body_weldid[i] = body_weldid[body_parentid[i]]

    body_jntadr = [c.bodies[i]["jnt_ids"][0] if c.bodies[i]["jnt_ids"] else -1 for i in range(nbody)]
    body_jntnum = [len(c.bodies[i]["jnt_ids"]) for i in range(nbody)]
    body_dofadr = [
        jnt_dofadr[c.bodies[i]["jnt_ids"][0]] if c.bodies[i]["jnt_ids"] else -1
        for i in range(nbody)
    ]
    body_dofnum = [
        sum(DOF_WIDTH[c.joints[j]["type"]] for j in c.bodies[i]["jnt_ids"])
        for i in range(nbody)
    ]
    body_geomadr = [c.bodies[i]["geom_ids"][0] if c.bodies[i]["geom_ids"] else -1 for i in range(nbody)]
    body_geomnum = [len(c.bodies[i]["geom_ids"]) for i in range(nbody)]

    nmocap = 0
    body_mocapid = []
    for b in c.bodies:
        if b["mocap"]:
            if b["jnt_ids"]:
                raise ModelError("mocap body cannot have joints")
            body_mocapid.append(nmocap)
            nmocap += 1
        else:
            body_mocapid.append(-1)

    # dof tables
    dof_bodyid, dof_jntid = [], []
    for jid, j in enumerate(c.joints):
        for _ in range(DOF_WIDTH[j["type"]]):
            dof_bodyid.append(j["body"])
            dof_jntid.append(jid)
    # dof_parentid: previous dof within the same body chain
    # last dof of the nearest ancestor body with dofs; within a body/joint the
    # dofs chain sequentially.
    last_dof_of_body = {}  # body -> last dof index so far
    dof_parentid = []
    d = 0
    for jid, j in enumerate(c.joints):
        b = j["body"]
        # find parent dof: last dof of this body if already has dofs, else
        # climb ancestors
        pb = b
        parent = last_dof_of_body.get(pb, None)
        while parent is None and body_parentid[pb] != 0:
            pb = body_parentid[pb]
            parent = last_dof_of_body.get(pb, None)
        if parent is None and body_parentid[pb] == 0:
            parent = last_dof_of_body.get(0, None) if pb == 0 else None
        prev = parent if parent is not None else -1
        for _ in range(DOF_WIDTH[j["type"]]):
            dof_parentid.append(prev)
            prev = d
            last_dof_of_body[b] = d
            d += 1

    # ----- per-joint arrays -----
    jnt_type = [int(j["type"]) for j in c.joints]
    jnt_bodyid = [j["body"] for j in c.joints]
    jnt_pos = np.array([j["pos"] for j in c.joints]).reshape(njnt, 3)
    jnt_axis = np.array(
        [j["axis"] / np.linalg.norm(j["axis"]) for j in c.joints]
    ).reshape(njnt, 3)
    jnt_range = np.array([j["range"] for j in c.joints]).reshape(njnt, 2)
    jnt_limited = [bool(j["limited"]) for j in c.joints]
    jnt_stiffness = np.array([j["stiffness"] for j in c.joints])
    jnt_margin = np.array([j["margin"] for j in c.joints])
    jnt_solref = np.array([j["solref"] for j in c.joints]).reshape(njnt, 2)
    jnt_solimp = np.array([j["solimp"] for j in c.joints]).reshape(njnt, 5)

    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    dof_solref = np.zeros((nv, 2))
    dof_solimp = np.zeros((nv, 5))
    for jid, j in enumerate(c.joints):
        sl = slice(jnt_dofadr[jid], jnt_dofadr[jid] + DOF_WIDTH[j["type"]])
        dof_armature[sl] = j["armature"]
        dof_damping[sl] = j["damping"]
        dof_frictionloss[sl] = j["frictionloss"]
        dof_solref[sl] = j["solref_friction"]
        dof_solimp[sl] = j["solimp_friction"]

    # ----- qpos0 / qpos_spring -----
    qpos0 = np.zeros(nq)
    qpos_spring = np.zeros(nq)
    for jid, j in enumerate(c.joints):
        adr = jnt_qposadr[jid]
        t = j["type"]
        if t == JointType.FREE:
            qpos0[adr : adr + 3] = c.bodies[j["body"]]["pos"]
            qpos0[adr + 3 : adr + 7] = c.bodies[j["body"]]["quat"]
            qpos_spring[adr : adr + 7] = qpos0[adr : adr + 7]
        elif t == JointType.BALL:
            qpos0[adr : adr + 4] = [1, 0, 0, 0]
            qpos_spring[adr : adr + 4] = [1, 0, 0, 0]
        else:
            qpos0[adr] = j["ref"]
            qpos_spring[adr] = j["springref"]

    # ----- mesh assets: process hulls, re-anchor mesh geoms -----
    mesh_names = [m["name"] for m in c.meshes]
    hfield_names = [h["name"] for h in c.hfields]
    mesh_canonical: dict[int, np.ndarray] = {}
    geom_dataid = []
    for g in c.geoms:
        if g["type"] == GeomType.HFIELD:
            try:
                geom_dataid.append(hfield_names.index(g["hfield"]))
            except ValueError:
                raise ModelError(
                    f"geom references unknown hfield {g['hfield']!r}"
                )
            continue
        if g["type"] != GeomType.MESH:
            geom_dataid.append(-1)
            continue
        try:
            mid = mesh_names.index(g["mesh"])
        except ValueError:
            raise ModelError(f"geom references unknown mesh {g['mesh']!r}")
        if mid not in mesh_canonical:
            canonical, vol, com, iq, unit_diag = _process_mesh(
                c.meshes[mid]["verts"]
            )
            mesh_canonical[mid] = canonical
            c.meshes[mid].update(volume=vol, com=com, iquat=iq,
                                 unit_inertia=unit_diag)
        mm = c.meshes[mid]
        # shift the geom frame to the canonical mesh frame (MuJoCo
        # compiler semantics: stored vertices are com-centered and
        # principal-axis aligned; the geom pose absorbs the transform)
        r_g = _quat_to_mat(g["quat"])
        g["pos"] = np.asarray(g["pos"]) + r_g @ mm["com"]
        g["quat"] = _quat_mul(g["quat"], mm["iquat"])
        g["mesh_volume"] = mm["volume"]
        g["mesh_unit_inertia"] = mm["unit_inertia"]
        geom_dataid.append(mid)
    nhfield = len(c.hfields)
    hfield_adr, hfield_data_rows = [], []
    adr_h = 0
    for h in c.hfields:
        hfield_adr.append(adr_h)
        hfield_data_rows.append(h["data"].reshape(-1))
        adr_h += h["nrow"] * h["ncol"]
    hfield_data = (
        np.concatenate(hfield_data_rows) if hfield_data_rows else None
    )

    nmesh = len(c.meshes)
    if mesh_canonical:
        mesh_vertadr, mesh_vertnum = [], []
        stacked = []
        adr = 0
        for mid in range(nmesh):
            v = mesh_canonical.get(mid, np.zeros((0, 3)))
            mesh_vertadr.append(adr)
            mesh_vertnum.append(v.shape[0])
            stacked.append(v)
            adr += v.shape[0]
        mesh_vert = np.concatenate(stacked, axis=0)
    else:
        mesh_vertadr = [0] * nmesh
        mesh_vertnum = [0] * nmesh
        mesh_vert = None

    # ----- geoms -----
    geom_type = [int(g["type"]) for g in c.geoms]
    geom_bodyid = [g["body"] for g in c.geoms]
    geom_pos = np.array([g["pos"] for g in c.geoms]).reshape(ngeom, 3)
    geom_quat = np.array([g["quat"] for g in c.geoms]).reshape(ngeom, 4)
    geom_size = np.array([g["size"] for g in c.geoms]).reshape(ngeom, 3)
    geom_friction = np.array([g["friction"] for g in c.geoms]).reshape(ngeom, 3)
    geom_margin = np.array([g["margin"] for g in c.geoms])
    geom_gap = np.array([g["gap"] for g in c.geoms])
    geom_solref = np.array([g["solref"] for g in c.geoms]).reshape(ngeom, 2)
    geom_solimp = np.array([g["solimp"] for g in c.geoms]).reshape(ngeom, 5)
    geom_solmix = np.array([g["solmix"] for g in c.geoms])
    geom_contype = [g["contype"] for g in c.geoms]
    geom_conaffinity = [g["conaffinity"] for g in c.geoms]
    geom_condim = [g["condim"] for g in c.geoms]
    geom_priority = [g["priority"] for g in c.geoms]

    rbound = np.zeros(ngeom)
    for i, g in enumerate(c.geoms):
        t, s = g["type"], g["size"]
        if t == GeomType.PLANE:
            rbound[i] = 0.0
        elif t == GeomType.HFIELD:
            hs = c.hfields[geom_dataid[i]]["size"]
            rbound[i] = float(np.linalg.norm(hs[:3]))
        elif t == GeomType.SPHERE:
            rbound[i] = s[0]
        elif t in (GeomType.CAPSULE, GeomType.CYLINDER):
            rbound[i] = s[0] + s[1] if t == GeomType.CAPSULE else math.hypot(s[0], s[1])
        elif t == GeomType.MESH:
            rbound[i] = float(
                np.max(np.linalg.norm(mesh_canonical[geom_dataid[i]], axis=1))
            )
        else:
            rbound[i] = float(np.linalg.norm(s))

    # ----- body inertial properties -----
    body_pos = np.array([b["pos"] for b in c.bodies]).reshape(nbody, 3)
    body_quat = np.array([b["quat"] for b in c.bodies]).reshape(nbody, 4)
    body_mass = np.zeros(nbody)
    body_inertia = np.zeros((nbody, 3))
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))

    for i in range(1, nbody):
        b = c.bodies[i]
        expl = b["explicit_inertial"]
        use_geom = (
            c.inertiafromgeom == "true"
            or (c.inertiafromgeom == "auto" and expl is None)
        )
        if use_geom and b["geom_ids"]:
            # combine geom inertias
            masses, coms, fulls = [], [], []
            for gid in b["geom_ids"]:
                g = c.geoms[gid]
                m, diag = _geom_mass_inertia(g)
                r = _quat_to_mat(g["quat"])
                full = r @ np.diag(diag) @ r.T
                masses.append(m)
                coms.append(g["pos"])
                fulls.append(full)
            mtot = float(np.sum(masses))
            if mtot > 0:
                com = np.sum([m * p for m, p in zip(masses, coms)], axis=0) / mtot
            else:
                com = np.zeros(3)
            itot = np.zeros((3, 3))
            for m, p, full in zip(masses, coms, fulls):
                d = p - com
                itot += full + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            if len(b["geom_ids"]) == 1:
                # single-geom body: MuJoCo's compiler takes the geom frame
                # as the inertial frame directly (geom-axis order, no eig),
                # which pins the gauge for axisymmetric geoms — matched so
                # ximat-based frame sensors agree with the oracle
                g = c.geoms[b["geom_ids"][0]]
                _, diag = _geom_mass_inertia(g)
                iquat = np.asarray(g["quat"], dtype=float)
            else:
                diag, iquat = _principal_decomposition(itot)
            body_mass[i] = max(mtot, c.boundmass)
            body_inertia[i] = np.maximum(diag, c.boundinertia)
            body_ipos[i] = com
            body_iquat[i] = iquat
        elif expl is not None:
            body_mass[i] = max(expl["mass"], c.boundmass)
            body_ipos[i] = expl["pos"]
            if expl["diag"] is not None:
                body_inertia[i] = np.maximum(expl["diag"], c.boundinertia)
                body_iquat[i] = expl["quat"]
            else:
                r = _quat_to_mat(expl["quat"])
                full_world = r @ expl["full"] @ r.T
                diag, iquat = _principal_decomposition(full_world)
                body_inertia[i] = np.maximum(diag, c.boundinertia)
                body_iquat[i] = iquat
        else:
            # massless body (allowed if it has dofs only in chains; MuJoCo
            # errors for moving massless bodies — keep permissive, zero mass)
            pass

    body_subtreemass = body_mass.copy()
    for i in range(nbody - 1, 0, -1):
        body_subtreemass[body_parentid[i]] += body_subtreemass[i]

    # ----- names -----
    names = NameTables(
        body=tuple(b["name"] for b in c.bodies),
        joint=tuple(j["name"] for j in c.joints),
        geom=tuple(g["name"] for g in c.geoms),
        site=tuple(s["name"] for s in c.sites),
        actuator=tuple(a["name"] for a in c.actuators),
        equality=tuple(e["name"] for e in c.equalities),
        tendon=tuple(t["name"] for t in c.tendons),
        sensor=tuple(s["name"] for s in c.sensors),
        keyframe=tuple(k["name"] for k in c.keyframes),
    )

    # ----- tendons (fixed joint couplings + spatial site paths) -----
    ntendon = len(c.tendons)
    tendon_adr, tendon_num, wrap_jnt, wrap_coef = [], [], [], []
    ten_site_adr, ten_site_num, ten_sites, ten_site_div = [], [], [], []
    ten_path = []
    for t in c.tendons:
        tendon_adr.append(len(wrap_jnt))
        tendon_num.append(len(t["joints"]))
        for jname, coef in zip(t["joints"], t["coefs"]):
            try:
                jid = names.joint.index(jname)
            except ValueError:
                raise ModelError(f"tendon references unknown joint {jname!r}")
            if c.joints[jid]["type"] not in (JointType.HINGE, JointType.SLIDE):
                raise ModelError("fixed tendons couple scalar joints only")
            wrap_jnt.append(jid)
            wrap_coef.append(coef)
        ten_site_adr.append(len(ten_sites))
        ten_site_num.append(len(t["sites"]))
        for sname, (branch, div) in zip(t["sites"], t["divisors"]):
            try:
                ten_sites.append(names.site.index(sname))
            except ValueError:
                raise ModelError(
                    f"spatial tendon references unknown site {sname!r}"
                )
            ten_site_div.append((int(branch), float(div)))
        entries = []
        for (kind, objname, sidename, branch, div) in t.get("path", ()):
            if kind == "site":
                try:
                    oid = names.site.index(objname)
                except ValueError:
                    raise ModelError(
                        f"spatial tendon references unknown site {objname!r}"
                    )
                entries.append((0, oid, -1, int(branch), float(div)))
            else:  # wrap geom
                try:
                    gid = names.geom.index(objname)
                except ValueError:
                    raise ModelError(
                        f"spatial tendon references unknown geom {objname!r}"
                    )
                if geom_type[gid] not in (GeomType.SPHERE, GeomType.CYLINDER):
                    raise UnsupportedFeatureError(
                        "tendon wrap geoms must be spheres or cylinders, "
                        f"got {GeomType(geom_type[gid]).name}"
                    )
                if sidename is None:
                    sid = -1
                else:
                    try:
                        sid = names.site.index(sidename)
                    except ValueError:
                        raise ModelError(
                            "tendon sidesite references unknown site "
                            f"{sidename!r}"
                        )
                entries.append((1, gid, sid, int(branch), float(div)))
        ten_path.append(tuple(entries))

    # ----- actuators -----
    def _joint_id(name):
        try:
            return names.joint.index(name)
        except ValueError:
            raise ModelError(f"actuator references unknown joint {name!r}")

    def _site_id(name):
        try:
            return names.site.index(name)
        except ValueError:
            raise ModelError(f"actuator references unknown site {name!r}")

    def _tendon_id(name):
        try:
            return names.tendon.index(name)
        except ValueError:
            raise ModelError(f"actuator references unknown tendon {name!r}")

    def _trnid(a):
        if a["trntype"] == TrnType.JOINT:
            return _joint_id(a["target"])
        if a["trntype"] == TrnType.TENDON:
            return _tendon_id(a["target"])
        if a["trntype"] == TrnType.BODY:
            try:
                return names.body.index(a["target"])
            except ValueError:
                raise ModelError(
                    f"actuator references unknown body {a['target']!r}"
                )
        return _site_id(a["target"])

    actuator_trnid = [_trnid(a) for a in c.actuators]
    actuator_refid = []
    for a in c.actuators:
        rs = a.get("refsite")
        if rs is None:
            actuator_refid.append(-1)
        else:
            if a["trntype"] != TrnType.SITE:
                raise ModelError("refsite requires site transmission")
            try:
                actuator_refid.append(names.site.index(rs))
            except ValueError:
                raise ModelError(
                    f"actuator references unknown refsite {rs!r}"
                )

    # ----- muscle length ranges -----
    # explicit lengthrange wins; otherwise derive from the transmission's
    # limited range (JOINT: sorted gear0 * jnt_range — exact for the linear
    # joint transmission; TENDON: the tendon's limit range).  MuJoCo's
    # compiler instead runs a simulation-based estimation whose result
    # lands within ~1e-3 of these bounds; models needing oracle-exact
    # muscle normalization should state lengthrange explicitly.
    act_lengthrange = np.zeros((nu, 2))
    for u, a in enumerate(c.actuators):
        if a.get("lengthrange") is not None:
            act_lengthrange[u] = a["lengthrange"]
            continue
        if (a["gaintype"] != GainType.MUSCLE
                and a["biastype"] != BiasType.MUSCLE):
            continue
        gear0 = float(np.asarray(a["gear"]).reshape(-1)[0])
        if a["trntype"] == TrnType.JOINT:
            jid = actuator_trnid[u]
            if not c.joints[jid]["limited"]:
                raise ModelError(
                    f"muscle actuator {a['name']!r} needs an explicit "
                    "lengthrange or a limited joint"
                )
            vals = sorted([gear0 * jnt_range[jid][0], gear0 * jnt_range[jid][1]])
            act_lengthrange[u] = vals
        elif a["trntype"] == TrnType.TENDON:
            tid = actuator_trnid[u]
            if not c.tendons[tid]["limited"]:
                raise ModelError(
                    f"muscle actuator {a['name']!r} needs an explicit "
                    "lengthrange or a limited tendon"
                )
            vals = sorted([gear0 * c.tendons[tid]["range"][0],
                           gear0 * c.tendons[tid]["range"][1]])
            act_lengthrange[u] = vals
        else:
            raise ModelError(
                f"muscle actuator {a['name']!r}: lengthrange estimation "
                "supports joint/tendon transmission only"
            )

    # ----- equality id resolution -----
    eq_obj1id, eq_obj2id = [], []
    for e in c.equalities:
        if e["type"] in (EqType.CONNECT, EqType.WELD):
            tbl = names.body
        elif e["type"] == EqType.TENDON:
            tbl = [t["name"] for t in c.tendons]
        else:
            tbl = names.joint
        try:
            eq_obj1id.append(tbl.index(e["obj1"]))
        except ValueError:
            raise ModelError(f"equality references unknown object {e['obj1']!r}")
        if e["obj2"]:
            try:
                eq_obj2id.append(tbl.index(e["obj2"]))
            except ValueError:
                raise ModelError(f"equality references unknown object {e['obj2']!r}")
        else:
            eq_obj2id.append(-1)

    # ----- sensor id resolution + data layout -----
    _SENSOR_TABLES = {
        ObjType.BODY: names.body, ObjType.XBODY: names.body,
        ObjType.JOINT: names.joint, ObjType.GEOM: names.geom,
        ObjType.SITE: names.site, ObjType.ACTUATOR: names.actuator,
        ObjType.TENDON: names.tendon,
        ObjType.CAMERA: [cam["name"] for cam in c.cameras],
    }

    def _sensor_obj(stype, objtype, objname, what):
        if objtype == ObjType.NONE:
            return -1
        try:
            oid = _SENSOR_TABLES[objtype].index(objname)
        except ValueError:
            raise ModelError(
                f"sensor references unknown {what} {objname!r}"
            )
        if objtype == ObjType.JOINT:
            jt = c.joints[oid]["type"]
            if stype in (SensorType.BALLQUAT, SensorType.BALLANGVEL):
                if jt != JointType.BALL:
                    raise ModelError(
                        f"ball sensor on non-ball joint {objname!r}")
            elif jt not in (JointType.HINGE, JointType.SLIDE):
                raise ModelError(
                    f"scalar joint sensor on joint {objname!r} of type {jt}"
                )
        return oid

    sensor_adr, nsensordata = [], 0
    for s in c.sensors:
        s["objid"] = _sensor_obj(s["type"], s["objtype"], s["objname"],
                                 "object")
        s["refid"] = _sensor_obj(s["type"], s["reftype"], s["refname"],
                                 "reference object")
        sensor_adr.append(nsensordata)
        nsensordata += s["dim"]

    # ----- contact pair table -----
    pair_entries = _build_pairs(c, names, geom_type, geom_bodyid, body_weldid,
                                body_parentid, geom_contype, geom_conaffinity,
                                geom_condim, geom_priority, geom_solmix,
                                geom_friction, geom_solref, geom_solimp,
                                geom_margin, geom_gap)

    # every convex-convex pair runs either a bespoke narrowphase or the
    # generic MPR support-function routine; the remaining compile-time
    # rejections are hfield-vs-exotic pairings only
    for p in pair_entries:
        ts = (geom_type[p["g1"]], geom_type[p["g2"]])
        if GeomType.HFIELD in ts and ts not in (
            (GeomType.HFIELD, GeomType.SPHERE),
            (GeomType.HFIELD, GeomType.CAPSULE),
            (GeomType.HFIELD, GeomType.BOX),
            (GeomType.HFIELD, GeomType.ELLIPSOID),
            (GeomType.HFIELD, GeomType.CYLINDER),
        ):
            raise UnsupportedFeatureError(
                "hfield collision supported against sphere/capsule/box/"
                "ellipsoid/cylinder geoms, got pair "
                f"{GeomType(ts[0]).name}-{GeomType(ts[1]).name}"
            )

    # group by (type1, type2)
    groups: dict[tuple[int, int], list[int]] = {}
    for idx, p in enumerate(pair_entries):
        key = (geom_type[p["g1"]], geom_type[p["g2"]])
        groups.setdefault(key, []).append(idx)
    order = [i for key in sorted(groups) for i in groups[key]]
    pair_entries = [pair_entries[i] for i in order]
    pair_groups = tuple(
        (int(t1), int(t2), tuple((pair_entries[i]["g1"], pair_entries[i]["g2"])
                                 for i in range(len(pair_entries))
                                 if (geom_type[pair_entries[i]["g1"]],
                                     geom_type[pair_entries[i]["g2"]]) == (t1, t2)))
        for (t1, t2) in sorted(groups)
    )

    npair = len(pair_entries)
    pair_geom1 = np.array([p["g1"] for p in pair_entries], dtype=np.int32)
    pair_geom2 = np.array([p["g2"] for p in pair_entries], dtype=np.int32)
    pair_friction = np.array([p["friction"] for p in pair_entries]).reshape(npair, 5)
    pair_solref = np.array([p["solref"] for p in pair_entries]).reshape(npair, 2)
    pair_solimp = np.array([p["solimp"] for p in pair_entries]).reshape(npair, 5)
    pair_margin = np.array([p["margin"] for p in pair_entries]).reshape(npair)
    pair_gap = np.array([p["gap"] for p in pair_entries]).reshape(npair)
    pair_condim = tuple(int(p["condim"]) for p in pair_entries)

    # activation-state layout: one act dim per stateful actuator, in actuator
    # order (MuJoCo mjModel.actuator_actadr semantics)
    actadr, actnum = [], []
    na = 0
    for a in c.actuators:
        if a["dyntype"] == DynType.NONE:
            actadr.append(-1)
            actnum.append(0)
        else:
            actadr.append(na)
            actnum.append(1)
            na += 1

    f = lambda x: np.asarray(x, dtype=np.float64)

    # ----- keyframes: fill omitted fields (qpos -> qpos0, rest -> 0) -----
    nkey = len(c.keyframes)
    key_qpos = np.tile(qpos0, (nkey, 1)) if nkey else None
    key_qvel = np.zeros((nkey, nv)) if nkey else None
    key_act = np.zeros((nkey, na)) if nkey else None
    key_ctrl = np.zeros((nkey, nu)) if nkey else None
    key_time = np.zeros(nkey) if nkey else None
    for ki, kf in enumerate(c.keyframes):
        key_time[ki] = kf["time"]
        for field, dst, width in (
            ("qpos", key_qpos, nq), ("qvel", key_qvel, nv),
            ("act", key_act, na), ("ctrl", key_ctrl, nu),
        ):
            if kf[field] is not None:
                if len(kf[field]) != width:
                    raise ModelError(
                        f"keyframe {kf['name']!r} {field} has "
                        f"{len(kf[field])} values, expected {width}"
                    )
                dst[ki] = kf[field]

    model = Model(
        nq=nq, nv=nv, nu=nu, na=na, nbody=nbody, njnt=njnt, ngeom=ngeom,
        nsite=nsite, neq=neq, nmocap=nmocap, ntendon=ntendon,
        opt=opt,
        tendon_adr=tuple(tendon_adr),
        tendon_num=tuple(tendon_num),
        tendon_limited=tuple(bool(t["limited"]) for t in c.tendons),
        tendon_wrap_jnt=tuple(wrap_jnt),
        tendon_kind=tuple(int(t["kind"]) for t in c.tendons),
        tendon_site_adr=tuple(ten_site_adr),
        tendon_site_num=tuple(ten_site_num),
        tendon_sites=tuple(ten_sites),
        tendon_site_div=tuple(ten_site_div),
        tendon_path=tuple(ten_path),
        tendon_range=f(np.array([t["range"] for t in c.tendons]).reshape(ntendon, 2)),
        tendon_stiffness=f([t["stiffness"] for t in c.tendons]),
        tendon_damping=f([t["damping"] for t in c.tendons]),
        tendon_frictionloss=f([t["frictionloss"] for t in c.tendons]),
        tendon_lengthspring=f(np.array([t["springlength"] for t in c.tendons]).reshape(ntendon, 2)),
        tendon_margin=f([t["margin"] for t in c.tendons]),
        tendon_solref_lim=f(np.array([t["solref_lim"] for t in c.tendons]).reshape(ntendon, 2)),
        tendon_solimp_lim=f(np.array([t["solimp_lim"] for t in c.tendons]).reshape(ntendon, 5)),
        tendon_solref_fri=f(np.array([t["solref_fri"] for t in c.tendons]).reshape(ntendon, 2)),
        tendon_solimp_fri=f(np.array([t["solimp_fri"] for t in c.tendons]).reshape(ntendon, 5)),
        tendon_invweight0=f(np.zeros(ntendon)),
        tendon_wrap_coef=f(wrap_coef),
        body_parentid=tuple(body_parentid),
        body_rootid=tuple(body_rootid),
        body_weldid=tuple(body_weldid),
        body_jntadr=tuple(body_jntadr),
        body_jntnum=tuple(body_jntnum),
        body_dofadr=tuple(body_dofadr),
        body_dofnum=tuple(body_dofnum),
        body_geomadr=tuple(body_geomadr),
        body_geomnum=tuple(body_geomnum),
        body_mocapid=tuple(body_mocapid),
        jnt_type=tuple(jnt_type),
        jnt_qposadr=tuple(jnt_qposadr),
        jnt_dofadr=tuple(jnt_dofadr),
        jnt_bodyid=tuple(jnt_bodyid),
        jnt_limited=tuple(jnt_limited),
        jnt_actfrclimited=tuple(False for _ in range(njnt)),
        dof_bodyid=tuple(dof_bodyid),
        dof_jntid=tuple(dof_jntid),
        dof_parentid=tuple(dof_parentid),
        geom_type=tuple(geom_type),
        geom_bodyid=tuple(geom_bodyid),
        geom_contype=tuple(geom_contype),
        geom_conaffinity=tuple(geom_conaffinity),
        geom_condim=tuple(geom_condim),
        geom_priority=tuple(geom_priority),
        site_bodyid=tuple(s["body"] for s in c.sites),
        site_type=tuple(int(s["type"]) for s in c.sites),
        actuator_trntype=tuple(int(a["trntype"]) for a in c.actuators),
        actuator_trnid=tuple(actuator_trnid),
        actuator_refid=tuple(actuator_refid),
        actuator_gaintype=tuple(int(a["gaintype"]) for a in c.actuators),
        actuator_biastype=tuple(int(a["biastype"]) for a in c.actuators),
        actuator_dyntype=tuple(int(a["dyntype"]) for a in c.actuators),
        actuator_ctrllimited=tuple(bool(a["ctrllimited"]) for a in c.actuators),
        actuator_forcelimited=tuple(bool(a["forcelimited"]) for a in c.actuators),
        actuator_actadr=tuple(actadr),
        actuator_actnum=tuple(actnum),
        actuator_actlimited=tuple(bool(a["actlimited"]) for a in c.actuators),
        eq_type=tuple(int(e["type"]) for e in c.equalities),
        eq_obj1id=tuple(eq_obj1id),
        eq_obj2id=tuple(eq_obj2id),
        eq_active0=tuple(bool(e["active"]) for e in c.equalities),
        pair_groups=pair_groups,
        pair_condim=pair_condim,
        names=names,
        qpos0=f(qpos0),
        qpos_spring=f(qpos_spring),
        body_pos=f(body_pos),
        body_quat=f(body_quat),
        body_ipos=f(body_ipos),
        body_iquat=f(body_iquat),
        body_mass=f(body_mass),
        body_inertia=f(body_inertia),
        body_subtreemass=f(body_subtreemass),
        jnt_pos=f(jnt_pos),
        jnt_axis=f(jnt_axis),
        jnt_range=f(jnt_range),
        jnt_stiffness=f(jnt_stiffness),
        jnt_margin=f(jnt_margin),
        jnt_solref=f(jnt_solref),
        jnt_solimp=f(jnt_solimp),
        any_damping=bool(np.any(dof_damping > 0)),
        dof_armature=f(dof_armature),
        dof_damping=f(dof_damping),
        dof_invweight0=f(np.zeros(nv)),
        body_invweight0=f(np.zeros((nbody, 2))),
        dof_frictionloss=f(dof_frictionloss),
        dof_solref=f(dof_solref),
        dof_solimp=f(dof_solimp),
        geom_pos=f(geom_pos),
        geom_quat=f(geom_quat),
        geom_size=f(geom_size),
        geom_friction=f(geom_friction),
        geom_margin=f(geom_margin),
        geom_gap=f(geom_gap),
        geom_solref=f(geom_solref),
        geom_solimp=f(geom_solimp),
        geom_solmix=f(geom_solmix),
        geom_rbound=f(rbound),
        ncam=len(c.cameras),
        cam_bodyid=tuple(cam["body"] for cam in c.cameras),
        cam_pos=f(np.array([cam["pos"] for cam in c.cameras]).reshape(
            len(c.cameras), 3)),
        cam_quat=f(np.array([cam["quat"] for cam in c.cameras]).reshape(
            len(c.cameras), 4)),
        cam_fovy=f(np.array([cam["fovy"] for cam in c.cameras])),
        cam_resolution=tuple(cam["resolution"] for cam in c.cameras),
        cam_mode=tuple(cam["mode"] for cam in c.cameras),
        cam_targetbodyid=tuple(
            -1 if cam["target"] is None else _cam_target_id(names, cam)
            for cam in c.cameras
        ),
        cam_sensorsize=tuple(cam["sensorsize"] for cam in c.cameras),
        cam_intrinsic=tuple(cam["intrinsic"] for cam in c.cameras),
        site_pos=f(np.array([s["pos"] for s in c.sites]).reshape(nsite, 3)),
        site_quat=f(np.array([s["quat"] for s in c.sites]).reshape(nsite, 4)),
        site_size=f(np.array([s["size"] for s in c.sites]).reshape(nsite, 3)),
        actuator_gear=f(np.array([a["gear"] for a in c.actuators]).reshape(nu, 6)),
        actuator_ctrlrange=f(np.array([a["ctrlrange"] for a in c.actuators]).reshape(nu, 2)),
        actuator_forcerange=f(np.array([a["forcerange"] for a in c.actuators]).reshape(nu, 2)),
        actuator_actrange=f(np.array([a["actrange"] for a in c.actuators]).reshape(nu, 2)),
        actuator_gainprm=f(np.array([a["gainprm"] for a in c.actuators]).reshape(nu, 10)),
        actuator_biasprm=f(np.array([a["biasprm"] for a in c.actuators]).reshape(nu, 10)),
        actuator_dynprm=f(np.array([a["dynprm"] for a in c.actuators]).reshape(nu, 10)),
        actuator_lengthrange=f(act_lengthrange),
        actuator_acc0=f(np.zeros(nu)),
        eq_data=f(np.array([e["data"] for e in c.equalities]).reshape(neq, 11)),
        eq_solref=f(np.array([e["solref"] for e in c.equalities]).reshape(neq, 2)),
        eq_solimp=f(np.array([e["solimp"] for e in c.equalities]).reshape(neq, 5)),
        pair_geom1=pair_geom1,
        pair_geom2=pair_geom2,
        pair_friction=f(pair_friction),
        pair_solref=f(pair_solref),
        pair_solimp=f(pair_solimp),
        pair_margin=f(pair_margin),
        pair_gap=f(pair_gap),
        nsensor=len(c.sensors),
        nsensordata=nsensordata,
        sensor_type=tuple(int(s["type"]) for s in c.sensors),
        sensor_objtype=tuple(int(s["objtype"]) for s in c.sensors),
        sensor_objid=tuple(s["objid"] for s in c.sensors),
        sensor_reftype=tuple(int(s["reftype"]) for s in c.sensors),
        sensor_refid=tuple(s["refid"] for s in c.sensors),
        sensor_adr=tuple(sensor_adr),
        sensor_dim=tuple(s["dim"] for s in c.sensors),
        sensor_cutoff=(f([s["cutoff"] for s in c.sensors])
                       if c.sensors else None),
        nmesh=nmesh,
        geom_dataid=tuple(geom_dataid),
        mesh_vertadr=tuple(mesh_vertadr),
        mesh_vertnum=tuple(mesh_vertnum),
        mesh_vert=None if mesh_vert is None else f(mesh_vert),
        nhfield=nhfield,
        hfield_adr=tuple(hfield_adr),
        hfield_nrow=tuple(h["nrow"] for h in c.hfields),
        hfield_ncol=tuple(h["ncol"] for h in c.hfields),
        hfield_size=(f(np.array([h["size"] for h in c.hfields])
                       .reshape(nhfield, 4)) if nhfield else None),
        hfield_data=None if hfield_data is None else f(hfield_data),
        nkey=nkey,
        key_time=None if key_time is None else f(key_time),
        key_qpos=None if key_qpos is None else f(key_qpos),
        key_qvel=None if key_qvel is None else f(key_qvel),
        key_act=None if key_act is None else f(key_act),
        key_ctrl=None if key_ctrl is None else f(key_ctrl),
    )
    model = _set_const(model)
    model = _set_cam_const(model)
    if dtype != np.float64:
        model = model.astype(dtype)
    return model


def _cam_target_id(names, cam):
    try:
        return names.body.index(cam["target"])
    except ValueError:
        raise ModelError(
            f"camera {cam['name']!r} targets unknown body "
            f"{cam['target']!r}"
        )


def _set_cam_const(model: Model) -> Model:
    """Camera qpos0 constants (mjModel cam_pos0 / cam_poscom0 / cam_mat0
    semantics, verified empirically vs MuJoCo 3.10):

    * cam_pos0    = camera world position - body world position at qpos0
    * cam_poscom0 = camera world position - subtree com at qpos0 of the
      camera's OWN body for fixed/track modes, of the TARGET body for
      targetbody/targetbodycom (the observed MuJoCo convention)
    * cam_mat0    = camera world orientation at qpos0, with the look-at
      construction already applied for target modes
    """
    from ..model import CamMode
    from ..physics import smooth as _smooth

    if not model.ncam:
        return model
    nbody = model.nbody
    body_pos = np.asarray(model.body_pos, dtype=np.float64)
    body_quat = np.asarray(model.body_quat, dtype=np.float64)
    body_ipos = np.asarray(model.body_ipos, dtype=np.float64)
    body_mass = np.asarray(model.body_mass, dtype=np.float64)
    xpos = np.zeros((nbody, 3))
    xmat = np.tile(np.eye(3), (nbody, 1, 1))
    for b in range(1, nbody):
        p = model.body_parentid[b]
        xpos[b] = xpos[p] + xmat[p] @ body_pos[b]
        xmat[b] = xmat[p] @ _quat_to_mat(body_quat[b])
    xipos = xpos + np.einsum("bij,bj->bi", xmat, body_ipos)
    sub = (body_mass[:, None] * xipos).copy()
    subm = body_mass.copy()
    for b in range(nbody - 1, 0, -1):
        p = model.body_parentid[b]
        subm[p] += subm[b]
        sub[p] += sub[b]
    sub_com = np.where(
        (subm > 0)[:, None], sub / np.maximum(subm, 1e-12)[:, None], xpos
    )

    cam_pos = np.asarray(model.cam_pos, dtype=np.float64)
    cam_quat = np.asarray(model.cam_quat, dtype=np.float64)
    pos0 = np.zeros((model.ncam, 3))
    poscom0 = np.zeros((model.ncam, 3))
    mat0 = np.zeros((model.ncam, 3, 3))
    for i in range(model.ncam):
        b = model.cam_bodyid[i]
        mode = CamMode(model.cam_mode[i])
        cw = xpos[b] + xmat[b] @ cam_pos[i]
        # mat0 is the RIGID orientation even for target modes (verified:
        # MuJoCo applies the look-at only at runtime; mat0 is unused then)
        cm = xmat[b] @ _quat_to_mat(cam_quat[i])
        if mode in (CamMode.TARGETBODY, CamMode.TARGETBODYCOM):
            com_ref = sub_com[model.cam_targetbodyid[i]]
        else:
            com_ref = sub_com[b]
        pos0[i] = cw - xpos[b]
        poscom0[i] = cw - com_ref
        mat0[i] = cm
    dtype = np.asarray(model.cam_pos).dtype
    return model.replace(
        cam_pos0=np.asarray(pos0, dtype=dtype),
        cam_poscom0=np.asarray(poscom0, dtype=dtype),
        cam_mat0=np.asarray(mat0, dtype=dtype),
    )


def _set_const(model: Model) -> Model:
    """Compute qpos0-dependent constants (mj_setConst analog):
    dof_invweight0 = diag(M^-1) and body_invweight0 = mean diagonal of the
    body-com end-effector inverse inertia, both at the default pose.

    Pure numpy: model compilation is host-side and must never touch a
    device.  FK at qpos0 is trivial (every joint is at its reference), so
    only parent-frame accumulation is needed.
    """
    from ..physics import smooth as _smooth  # static mask helpers only

    nv, nbody = model.nv, model.nbody
    if nv == 0:
        return model

    body_pos = np.asarray(model.body_pos, dtype=np.float64)
    body_quat = np.asarray(model.body_quat, dtype=np.float64)
    body_ipos = np.asarray(model.body_ipos, dtype=np.float64)
    body_iquat = np.asarray(model.body_iquat, dtype=np.float64)
    body_mass = np.asarray(model.body_mass, dtype=np.float64)
    body_inertia = np.asarray(model.body_inertia, dtype=np.float64)
    jnt_pos = np.asarray(model.jnt_pos, dtype=np.float64)
    jnt_axis = np.asarray(model.jnt_axis, dtype=np.float64)

    # FK at qpos0: all joint transforms are identity
    xpos = np.zeros((nbody, 3))
    xmat = np.tile(np.eye(3), (nbody, 1, 1))
    xquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    for b in range(1, nbody):
        p = model.body_parentid[b]
        xpos[b] = xpos[p] + xmat[p] @ body_pos[b]
        xmat[b] = xmat[p] @ _quat_to_mat(body_quat[b])
        xquat[b] = _quat_mul(xquat[p], body_quat[b])

    # resolve weld relpose defaults: a zero quat part means "relative pose
    # of body2 in body1's frame at qpos0" (MuJoCo compiler semantics)
    eq_data = np.asarray(model.eq_data, dtype=np.float64).copy()
    eq_fixed = False
    from ..model import EqType as _ET

    for e in range(model.neq):
        if _ET(model.eq_type[e]) != _ET.WELD:
            continue
        if np.linalg.norm(eq_data[e][6:10]) > 0:
            continue
        b1 = model.eq_obj1id[e]
        b2 = max(model.eq_obj2id[e], 0)
        eq_data[e][3:6] = xmat[b1].T @ (xpos[b2] - xpos[b1])
        q1c = xquat[b1] * np.array([1.0, -1, -1, -1])
        eq_data[e][6:10] = _quat_mul(q1c, xquat[b2])
        eq_fixed = True
    if eq_fixed:
        model = model.replace(eq_data=eq_data)
    xipos = xpos + np.einsum("bij,bj->bi", xmat, body_ipos)
    ximat = np.einsum(
        "bij,bjk->bik", xmat, np.stack([_quat_to_mat(q) for q in body_iquat])
    )

    # subtree com
    sub = np.zeros((nbody, 3))
    subm = np.zeros(nbody)
    for b in range(nbody - 1, -1, -1):
        subm[b] += body_mass[b]
        sub[b] += body_mass[b] * xipos[b]
        if b > 0:
            p = model.body_parentid[b]
            subm[p] += subm[b]
            sub[p] += sub[b]
    sub_com = np.where(
        (subm > 0)[:, None], sub / np.maximum(subm, 1e-12)[:, None], xpos
    )

    # spatial inertias about subtree_com[rootid]
    cin_i = np.zeros((nbody, 3, 3))
    cin_h = np.zeros((nbody, 3))
    for b in range(nbody):
        origin = sub_com[model.body_rootid[b]]
        c = xipos[b] - origin
        i_c = ximat[b] @ np.diag(body_inertia[b]) @ ximat[b].T
        cin_i[b] = i_c + body_mass[b] * (np.dot(c, c) * np.eye(3) - np.outer(c, c))
        cin_h[b] = body_mass[b] * c

    # cdof
    cdof = np.zeros((nv, 6))
    from ..model import JointType as _JT

    for j in range(model.njnt):
        jt = model.jnt_type[j]
        vadr = model.jnt_dofadr[j]
        b = model.jnt_bodyid[j]
        com = sub_com[model.body_rootid[b]]
        anchor = xpos[b] + xmat[b] @ jnt_pos[j]
        axis_w = xmat[b] @ jnt_axis[j]
        if jt == _JT.FREE:
            for i in range(3):
                cdof[vadr + i, 3 + i] = 1.0
            off = com - xpos[b]
            for i in range(3):
                ax = xmat[b][:, i]
                cdof[vadr + 3 + i] = np.concatenate([ax, np.cross(ax, off)])
        elif jt == _JT.BALL:
            off = com - anchor
            for i in range(3):
                ax = xmat[b][:, i]
                cdof[vadr + i] = np.concatenate([ax, np.cross(ax, off)])
        elif jt == _JT.SLIDE:
            cdof[vadr] = np.concatenate([np.zeros(3), axis_w])
        else:
            off = com - anchor
            cdof[vadr] = np.concatenate([axis_w, np.cross(axis_w, off)])

    # CRB -> dense M
    crb_i = cin_i.copy()
    crb_h = cin_h.copy()
    crb_m = body_mass.copy()
    for b in range(nbody - 1, 0, -1):
        p = model.body_parentid[b]
        crb_i[p] += crb_i[b]
        crb_h[p] += crb_h[b]
        crb_m[p] += crb_m[b]

    anc = _smooth.dof_ancestor_mask(model)
    m_mat = np.zeros((nv, nv))
    for i in range(nv):
        bi = model.dof_bodyid[i]
        w, v = cdof[i, :3], cdof[i, 3:]
        f = np.concatenate(
            [crb_i[bi] @ w + np.cross(crb_h[bi], v), crb_m[bi] * v - np.cross(crb_h[bi], w)]
        )
        for j in range(nv):
            if anc[i, j]:
                m_mat[i, j] = np.dot(cdof[j], f)
                m_mat[j, i] = m_mat[i, j]
    m_mat += np.diag(np.asarray(model.dof_armature, dtype=np.float64))

    m_inv = np.linalg.inv(m_mat)
    dof_invweight0 = np.diag(m_inv).copy()
    # MuJoCo averages the inverse-inertia diagonal over multi-dof joint
    # blocks (ball: 3 dofs; free: translation and rotation blocks separately)
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        vadr = model.jnt_dofadr[j]
        if jt == _JT.BALL:
            dof_invweight0[vadr : vadr + 3] = dof_invweight0[vadr : vadr + 3].mean()
        elif jt == _JT.FREE:
            dof_invweight0[vadr : vadr + 3] = dof_invweight0[vadr : vadr + 3].mean()
            dof_invweight0[vadr + 3 : vadr + 6] = dof_invweight0[
                vadr + 3 : vadr + 6
            ].mean()

    mask = _smooth.body_dof_mask(model)
    sub_mask_bi = _smooth.subtree_mask(model)
    body_invweight0 = np.zeros((nbody, 2))
    for b in range(1, nbody):
        origin = sub_com[model.body_rootid[b]]
        jacp = np.zeros((3, nv))
        jacr = np.zeros((3, nv))
        for i in range(nv):
            if mask[b, i]:
                ang, lin = cdof[i, :3], cdof[i, 3:]
                jacp[:, i] = lin + np.cross(ang, xipos[b] - origin)
                jacr[:, i] = ang
        a_t = jacp @ m_inv @ jacp.T
        a_r = jacr @ m_inv @ jacr.T
        # MuJoCo divisor quirk (verified against 3.10 body_invweight0 over
        # slide/hinge/ball/free/mixed/coupled-tree probes): trace/3
        # everywhere, EXCEPT bodies whose dofs are ALL exactly
        # coordinate-axis-aligned slide joints AND whose subtree adds no
        # further dofs — those divide by the number of distinct axes
        # (a leaf z-slide body gets 1/m, not 1/(3m); an x+z pair gets /2;
        # a cartpole cart with a pole below stays at /3)
        div_t = 3.0
        dofs = [i for i in range(nv) if mask[b, i]]
        sub_bodies = [c for c in range(nbody) if sub_mask_bi[b, c]]
        extra_dofs = any(
            model.dof_bodyid[i] in sub_bodies and not mask[b, i]
            for i in range(nv)
        )
        if dofs and not extra_dofs:
            axes = set()
            all_aligned = True
            for i in dofs:
                j = model.dof_jntid[i]
                if model.jnt_type[j] != _JT.SLIDE:
                    all_aligned = False
                    break
                ax = cdof[i, 3:]
                k = int(np.argmax(np.abs(ax)))
                if abs(abs(ax[k]) - 1.0) > 1e-12 or \
                        np.abs(ax).sum() - abs(ax[k]) > 1e-12:
                    all_aligned = False
                    break
                axes.add(k)
            if all_aligned and axes:
                div_t = float(len(axes))
        body_invweight0[b, 0] = np.trace(a_t) / div_t
        body_invweight0[b, 1] = np.trace(a_r) / 3.0

    # tendons: invweight0 = J M^-1 J^T at qpos0; springlength < 0
    # resolves to the qpos0 tendon length (MuJoCo compiler semantics).
    # Spatial tendons evaluate their site-path length/moment at the
    # qpos0 pose (joint transforms identity in the FK above).
    extra = {}
    if model.ntendon:
        qpos0 = np.asarray(model.qpos0, dtype=np.float64)
        coefs = np.asarray(model.tendon_wrap_coef, dtype=np.float64)
        tj = np.zeros((model.ntendon, nv))
        len0 = np.zeros(model.ntendon)
        for t in range(model.ntendon):
            adr, num = model.tendon_adr[t], model.tendon_num[t]
            for w in range(adr, adr + num):
                j = model.tendon_wrap_jnt[w]
                tj[t, model.jnt_dofadr[j]] += coefs[w]
                len0[t] += coefs[w] * qpos0[model.jnt_qposadr[j]]
        kinds = getattr(model, "tendon_kind", ()) or (0,) * model.ntendon
        if any(k == 1 for k in kinds):
            site_pos = np.asarray(model.site_pos, dtype=np.float64)
            site_x0 = np.stack([
                xpos[model.site_bodyid[s]]
                + xmat[model.site_bodyid[s]] @ site_pos[s]
                for s in range(model.nsite)
            ]) if model.nsite else np.zeros((0, 3))
            def _pjac(point, b):
                origin = sub_com[model.body_rootid[b]]
                out = np.zeros((nv, 3))
                for i in range(nv):
                    if mask[b, i]:
                        ang, lin = cdof[i, :3], cdof[i, 3:]
                        out[i] = lin + np.cross(ang, point - origin)
                return out

            def _seg(t, p1, j1, p2, j2, div):
                dvec = p2 - p1
                n = np.linalg.norm(dvec)
                u = dvec / max(n, 1e-12)
                len0[t] += n / div
                tj[t] += ((j2 - j1) @ u) / div

            from ..physics import smooth as _smooth

            for t in range(model.ntendon):
                if kinds[t] != 1:
                    continue
                path = model.tendon_path[t]
                k = 0
                while k < len(path) - 1:
                    _, s1, _, br1, div = path[k]
                    nxt = path[k + 1]
                    if nxt[3] != br1:
                        k += 1
                        continue
                    p1 = site_x0[s1]
                    j1 = _pjac(p1, model.site_bodyid[s1])
                    if nxt[0] == 0:
                        s2 = nxt[1]
                        p2 = site_x0[s2]
                        _seg(t, p1, j1, p2,
                             _pjac(p2, model.site_bodyid[s2]), div)
                        k += 1
                        continue
                    g, side = nxt[1], nxt[2]
                    s2 = path[k + 2][1]
                    p2 = site_x0[s2]
                    j2 = _pjac(p2, model.site_bodyid[s2])
                    gb = model.geom_bodyid[g]
                    gq = np.asarray(model.geom_quat, dtype=np.float64)[g]
                    gpos = xpos[gb] + xmat[gb] @ np.asarray(
                        model.geom_pos, dtype=np.float64)[g]
                    gmat = xmat[gb] @ _quat_to_mat(gq)
                    radius = float(np.asarray(model.geom_size)[g][0])
                    is_cyl = model.geom_type[g] == GeomType.CYLINDER
                    side_w = site_x0[side] if side >= 0 else None
                    active, t0w, t1w, wlen = _smooth.wrap_segment(
                        p1, p2, gpos, gmat, radius, is_cyl, side_w, xp=np
                    )
                    if bool(active):
                        jt0 = _pjac(t0w, gb)
                        jt1 = _pjac(t1w, gb)
                        _seg(t, p1, j1, t0w, jt0, div)
                        # arc: length from the surface path, moment from
                        # the chord (mj_tendon's wpnt-chain convention)
                        dvec = t1w - t0w
                        n = np.linalg.norm(dvec)
                        u = dvec / max(n, 1e-12)
                        len0[t] += float(wlen) / div
                        tj[t] += ((jt1 - jt0) @ u) / div
                        _seg(t, t1w, jt1, p2, j2, div)
                    else:
                        _seg(t, p1, j1, p2, j2, div)
                    k += 2
        extra["tendon_invweight0"] = np.einsum(
            "ti,ij,tj->t", tj, m_inv, tj
        )
        extra["tendon_length0"] = len0.copy()
        spring = np.asarray(model.tendon_lengthspring, dtype=np.float64).copy()
        spring[spring[:, 0] < 0, 0] = len0[spring[:, 0] < 0]
        spring[spring[:, 1] < 0, 1] = len0[spring[:, 1] < 0]
        extra["tendon_lengthspring"] = spring

    # actuator_acc0: |M(qpos0)^-1 moment| for the unit actuator force
    # (muscle force auto-scaling; mjModel.actuator_acc0 semantics).  The
    # qpos0 moment is exact for joint and fixed/spatial-tendon
    # transmissions (tj rows above); site transmissions report 0.
    if model.nu:
        from ..model import TrnType as _TRN

        acc0 = np.zeros(model.nu)
        gear = np.asarray(model.actuator_gear, dtype=np.float64)
        for u in range(model.nu):
            mom = np.zeros(nv)
            tt = _TRN(model.actuator_trntype[u])
            if tt == _TRN.JOINT:
                j = model.actuator_trnid[u]
                vadr = model.jnt_dofadr[j]
                num = {0: 6, 1: 3, 2: 1, 3: 1}[int(model.jnt_type[j])]
                mom[vadr : vadr + num] = gear[u][: num] if num > 1 else gear[u][0]
            elif tt == _TRN.TENDON and model.ntendon:
                mom = gear[u][0] * tj[model.actuator_trnid[u]]
            acc0[u] = np.linalg.norm(np.linalg.solve(m_mat, mom))
        extra["actuator_acc0"] = acc0

    return model.replace(
        dof_invweight0=np.asarray(dof_invweight0),
        body_invweight0=np.asarray(body_invweight0),
        **extra,
    )


def _build_pairs(c, names, geom_type, geom_bodyid, body_weldid, body_parentid,
                 geom_contype, geom_conaffinity, geom_condim, geom_priority,
                 geom_solmix, geom_friction, geom_solref, geom_solimp,
                 geom_margin, geom_gap) -> list[dict]:
    """Candidate contact pair enumeration with MuJoCo's dynamic filtering and
    parameter mixing (static per pair — contact params don't depend on
    state, so mixing is precomputed at compile time)."""
    ngeom = len(geom_type)
    exclude_bodies = set()
    for b1name, b2name in c.excludes:
        try:
            b1 = names.body.index(b1name)
            b2 = names.body.index(b2name)
        except ValueError as e:
            raise ModelError(f"contact exclude references unknown body: {e}")
        exclude_bodies.add((min(b1, b2), max(b1, b2)))

    def mix_params(g1, g2):
        p1, p2 = geom_priority[g1], geom_priority[g2]
        if p1 != p2:
            hi = g1 if p1 > p2 else g2
            fr = geom_friction[hi]
            solref = geom_solref[hi]
            solimp = geom_solimp[hi]
            condim = geom_condim[hi]
        else:
            s1 = geom_solmix[g1]
            s2 = geom_solmix[g2]
            if s1 >= 0.001 or s2 >= 0.001:
                mix = s1 / (s1 + s2) if (s1 + s2) > 0 else 0.5
            else:
                mix = 0.5
            if geom_solref[g1][0] > 0 and geom_solref[g2][0] > 0:
                solref = mix * geom_solref[g1] + (1 - mix) * geom_solref[g2]
            else:
                solref = np.minimum(geom_solref[g1], geom_solref[g2])
            solimp = mix * geom_solimp[g1] + (1 - mix) * geom_solimp[g2]
            fr = np.maximum(geom_friction[g1], geom_friction[g2])
            condim = max(geom_condim[g1], geom_condim[g2])
        friction5 = np.array([fr[0], fr[0], fr[1], fr[2], fr[2]])
        # MuJoCo 3.10 combination for auto-generated pairs (verified
        # against mjData.contact.includemargin / nefc): margins ADD, and
        # the geom `gap` attribute has NO effect (no solver exclusion even
        # when gap >= margin) — explicit <pair> margins/gaps still override
        margin = geom_margin[g1] + geom_margin[g2]
        gap = 0.0
        return dict(friction=friction5, solref=np.asarray(solref),
                    solimp=np.asarray(solimp), condim=condim, margin=margin,
                    gap=gap)

    pairs = []
    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
            w1, w2 = body_weldid[b1], body_weldid[b2]
            if w1 == w2:
                continue
            pw1 = body_weldid[body_parentid[w1]]
            pw2 = body_weldid[body_parentid[w2]]
            # parent-child exclusion, except contacts with the world
            if (pw1 == w2 or pw2 == w1) and w1 != 0 and w2 != 0:
                continue
            if (min(b1, b2), max(b1, b2)) in exclude_bodies:
                continue
            if not (
                (geom_contype[g1] & geom_conaffinity[g2])
                or (geom_contype[g2] & geom_conaffinity[g1])
            ):
                continue
            # canonical order: lower geom type first (plane first etc.)
            a, b = (g1, g2) if geom_type[g1] <= geom_type[g2] else (g2, g1)
            entry = dict(g1=a, g2=b)
            entry.update(mix_params(a, b))
            pairs.append(entry)

    # explicit <contact><pair> entries (override / addition)
    for attrs in c.explicit_pairs:
        try:
            a = names.geom.index(attrs["geom1"])
            b = names.geom.index(attrs["geom2"])
        except ValueError as e:
            raise ModelError(f"contact pair references unknown geom: {e}")
        if geom_type[a] > geom_type[b]:
            a, b = b, a
        base = mix_params(a, b)
        fr3 = _attr_floats(attrs, "friction", None)
        if fr3 is not None:
            base["friction"] = np.array([fr3[0], fr3[1] if fr3.size > 1 else fr3[0],
                                         fr3[2] if fr3.size > 2 else 0.005,
                                         fr3[3] if fr3.size > 3 else 0.0001,
                                         fr3[4] if fr3.size > 4 else 0.0001])
        if "solref" in attrs:
            base["solref"] = _floats(attrs["solref"])
        if "solimp" in attrs:
            base["solimp"] = _attr_floats(attrs, "solimp", None, 5)
        if "condim" in attrs:
            base["condim"] = int(attrs["condim"])
        if "margin" in attrs:
            base["margin"] = float(attrs["margin"])
        if "gap" in attrs:
            base["gap"] = float(attrs["gap"])
        entry = dict(g1=a, g2=b)
        entry.update(base)
        # replace dynamic pair if it exists
        pairs = [p for p in pairs if not (p["g1"] == a and p["g2"] == b)]
        pairs.append(entry)

    return pairs
