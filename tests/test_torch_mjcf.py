"""PyTorch port: ``<replicate>`` in the port's MJCF compiler against MuJoCo.

MuJoCo 3.10.0 is the oracle here, not the reference package: the
reference's compiler has two known faults with ``<replicate>`` that the
port does not copy (ROADMAP Queue C):

* a meta-element (``<replicate>`` or ``<composite>``) nested under a
  ``<replicate>`` loses the outer copy's frame there, so the copies
  overlap; the port expands it in that frame, as MuJoCo does;
* a ``<replicate>`` without ``count`` compiles two copies there; the port
  raises ``ModelError``, as MuJoCo rejects it.

Every other XML of the port's tests keeps its field-by-field equality
with the reference (tests/test_torch_model.py).
"""

import mujoco
import numpy as np
import pytest

from oxide_control_torch.api.errors import ModelError
from oxide_control_torch.mjcf.compile import load_model_from_xml

NESTED = {
    # ROADMAP Queue C's two-level example
    "two-level": """
<mujoco><worldbody>
  <replicate count="2" offset="1 0 0">
    <replicate count="2" offset="0 0.5 0">
      <body pos="0 0 1"><geom size="0.1"/></body>
    </replicate>
  </replicate>
</worldbody></mujoco>""",
    # both levels turn their copies, the body has its own orientation
    "rotated": """
<mujoco><worldbody>
  <replicate count="2" offset="1 0 0" euler="0 0 90">
    <replicate count="3" offset="0 0.5 0" euler="0 0 30">
      <body pos="0.1 0 1" euler="10 0 0"><geom size="0.1"/></body>
    </replicate>
  </replicate>
</worldbody></mujoco>""",
    # a cable composite under a turning replicate
    "composite": """
<mujoco><worldbody>
  <replicate count="2" offset="1 0 0" euler="0 0 90">
    <composite type="cable" count="4" curve="s" size="0.3" offset="0 0 1"
               initial="ball">
      <geom type="capsule" size="0.01"/>
    </composite>
  </replicate>
</worldbody></mujoco>""",
}


@pytest.mark.parametrize("name", list(NESTED))
def test_nested_meta_element_takes_the_outer_frame(name):
    """The port's body frames equal MuJoCo's (the reference's compiler
    differs here: it drops the outer copy's frame, its known fault)."""
    xml = NESTED[name]
    want = mujoco.MjModel.from_xml_string(xml)
    got = load_model_from_xml(xml)
    assert got.nbody == want.nbody
    np.testing.assert_allclose(np.asarray(got.body_pos), want.body_pos,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.body_quat), want.body_quat,
                               rtol=0, atol=1e-12)
    if name == "two-level":
        np.testing.assert_allclose(
            np.asarray(got.body_pos)[1:],
            [[0, 0, 1], [0, 0.5, 1], [1, 0, 1], [1, 0.5, 1]], atol=1e-15)


def test_replicate_without_count_is_rejected():
    """MuJoCo rejects a ``<replicate>`` without ``count``, and so does the
    port (the reference's compiler makes two copies: its known fault)."""
    xml = """
<mujoco><worldbody>
  <replicate offset="1 0 0"><body pos="0 0 1"><geom size="0.1"/></body>
  </replicate>
</worldbody></mujoco>"""
    with pytest.raises(ValueError, match="required attribute missing: "
                       "'count'"):
        mujoco.MjModel.from_xml_string(xml)
    with pytest.raises(ModelError, match="required attribute missing: "
                       "'count'"):
        load_model_from_xml(xml)
