"""Measure the reference's refsite fault: its kernel-class step against
its own general path on a site transmission with a refsite.

The reference's ``supports()`` (oxide_control_tpu/ops/scalar_graph.py)
admits an actuator on a site transmission with a refsite, but its kernel
step computes that transmission as if there were no refsite; its general
path (physics/smooth.py) handles the refsite.  The PyTorch port refuses
such a model (``oxide_control_torch.ops.scalar_graph.unsupported_reason``).
This script steps the model of ``tests/test_torch_model.py``'s ``refsite``
case once, in f64 on the CPU, through both of the reference's paths, and
prints the largest differences; then the same model without the refsite,
where the two paths agree.

Run from the repository root: ``JAX_PLATFORMS=cpu PYTHONPATH=.
python3 tools/reference_refsite_fault.py`` (about 30 s).
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from oxide_control_tpu.mjcf.compile import load_model_from_xml  # noqa: E402
from oxide_control_tpu.ops import scalar_graph as sg  # noqa: E402
from oxide_control_tpu.physics import forward  # noqa: E402
from oxide_control_tpu.state import make_data  # noqa: E402

XML = """
<mujoco>
  <option/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="a" pos="0 0 1" >
      <joint name="h1" type="hinge" axis="0 1 0"/>
      <geom type="sphere" size="0.1 0.1 0.1"/>
      <site name="s1" pos="0.1 0 0"/>
      <body name="b" pos="0.3 0 0">
        <joint name="h2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.05" fromto="0 0 0 0.2 0 0"/>
        <site name="s2" pos="0.2 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator><general site="s2" refsite="s1" gear="1 0 0 0 0 0"/></actuator>
</mujoco>
"""
B = 4


def one_step(xml, qpos, qvel, ctrl):
    """(kernel-class step, general path step) of one step from a state:
    each a (qpos, qvel) pair of (B, n) arrays."""
    m = load_model_from_xml(xml)
    assert sg.supports(m)
    cols = lambda a: [jnp.asarray(a[:, i]) for i in range(a.shape[1])]
    q, v = sg.build_step(m)(cols(qpos), cols(qvel), [],
                            cols(np.zeros_like(qvel)), cols(ctrl))[:2]
    stack = lambda xs: np.stack([np.asarray(x) for x in xs], 1)
    d = jax.vmap(lambda q_, v_, c_: make_data(m).replace(
        qpos=q_, qvel=v_, ctrl=c_))(qpos, qvel, ctrl)
    d = jax.jit(jax.vmap(lambda x: forward.step(m, x)))(d)
    return (stack(q), stack(v)), (np.asarray(d.qpos), np.asarray(d.qvel))


def main():
    rng = np.random.default_rng(0)
    qpos = rng.uniform(-0.5, 0.5, (B, 2))
    qvel = rng.uniform(-1.0, 1.0, (B, 2))
    ctrl = rng.uniform(-1.0, 1.0, (B, 1))
    for label, xml in (("with the refsite", XML),
                       ("without it", XML.replace(' refsite="s1"', ""))):
        (kq, kv), (gq, gv) = one_step(xml, qpos, qvel, ctrl)
        print(f"{label}: kernel step - general path after one step: "
              f"qpos {np.abs(kq - gq).max():.6e}, "
              f"qvel {np.abs(kv - gv).max():.6e}")


if __name__ == "__main__":
    main()
