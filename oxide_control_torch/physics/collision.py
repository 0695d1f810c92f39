"""Contact-lane counts of the collision stage.

The port's copy of ``max_contacts_per_pair`` from
``oxide_control_tpu/physics/collision.py``: the fixed number of contact
lanes each candidate geom pair owns.  The batched narrowphase is ROADMAP
Queue A item 11; the kernel's scalar narrowphase lives in
``ops/scalar_graph.py``.
"""

from __future__ import annotations

from ..model import GeomType

# pairs with a closed-form primitive in the reference narrowphase
_PRIMS = frozenset({
    (GeomType.PLANE, GeomType.SPHERE),
    (GeomType.PLANE, GeomType.CAPSULE),
    (GeomType.PLANE, GeomType.BOX),
    (GeomType.PLANE, GeomType.CYLINDER),
    (GeomType.PLANE, GeomType.ELLIPSOID),
    (GeomType.SPHERE, GeomType.SPHERE),
    (GeomType.SPHERE, GeomType.CAPSULE),
    (GeomType.SPHERE, GeomType.BOX),
    (GeomType.SPHERE, GeomType.CYLINDER),
    (GeomType.CAPSULE, GeomType.CAPSULE),
    (GeomType.CAPSULE, GeomType.BOX),
    (GeomType.BOX, GeomType.BOX),
})

_CONVEX_TYPES = (
    GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
    GeomType.CYLINDER, GeomType.BOX, GeomType.MESH,
)


def max_contacts_per_pair(t1: int, t2: int) -> int:
    """Fixed contact-lane count per candidate pair of geom types."""
    pair = (GeomType(t1), GeomType(t2))
    if pair == (GeomType.PLANE, GeomType.CAPSULE):
        return 2
    if pair == (GeomType.PLANE, GeomType.BOX):
        return 8
    if pair == (GeomType.PLANE, GeomType.CYLINDER):
        return 4
    if pair == (GeomType.CAPSULE, GeomType.CAPSULE):
        return 1
    if pair == (GeomType.CAPSULE, GeomType.BOX):
        return 3
    if pair == (GeomType.BOX, GeomType.BOX):
        return 8
    if pair == (GeomType.PLANE, GeomType.MESH):
        return 4
    if pair == (GeomType.HFIELD, GeomType.CAPSULE):
        return 3
    if pair in ((GeomType.HFIELD, GeomType.BOX),
                (GeomType.HFIELD, GeomType.ELLIPSOID),
                (GeomType.HFIELD, GeomType.CYLINDER)):
        # 3x3 cell window x 2 triangle prisms, each with an MPR witness +
        # 4 perturbed-support manifold lanes (flat-face/ridge restings)
        return 90
    if (pair[0] in _CONVEX_TYPES and pair[1] in _CONVEX_TYPES
            and pair not in _PRIMS):
        return 5  # MPR + 4 perturbed-support manifold lanes
    return 1
