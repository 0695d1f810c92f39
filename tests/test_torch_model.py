"""PyTorch port: model compilation, package isolation, device policy.

The port compiles its own Model from XML with its own copy of the MJCF
compiler; every field must equal the reference's ``load_model``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import load_model as ref_load_model
from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.suite.common import asset_path as ref_asset_path
from test_megakernel import _XML as HOPPER_XML

import oxide_control_torch
from oxide_control_torch import suite
from oxide_control_torch.api.environment import BatchedEnvironment
from oxide_control_torch.mjcf.compile import load_model, load_model_from_xml
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.policy import MLPPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_models_equal(port, ref):
    for f in dataclasses.fields(ref):
        x, y = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray), f.name
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif dataclasses.is_dataclass(y):
            assert dataclasses.asdict(x) == dataclasses.asdict(y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name,dtype", [
    ("cheetah", np.float64), ("walker", np.float64), ("humanoid", np.float64),
    ("cartpole", np.float64), ("pendulum", np.float64),
    ("cheetah", np.float32),
])
def test_load_model_matches_reference(name, dtype):
    path = ref_asset_path(name)
    _assert_models_equal(load_model(path, dtype=dtype),
                         ref_load_model(path, dtype=dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hopper_model_matches_reference(dtype):
    _assert_models_equal(load_model_from_xml(HOPPER_XML, dtype=dtype),
                         ref_load_model_from_xml(HOPPER_XML, dtype=dtype))


def test_port_asset_is_the_reference_asset():
    for name in ("cheetah", "walker", "humanoid", "cartpole", "pendulum"):
        with open(suite.asset_path(name)) as a, \
                open(ref_asset_path(name)) as b:
            assert a.read() == b.read(), name


def test_import_leaves_jax_out():
    code = (
        "import sys, oxide_control_torch, oxide_control_torch.suite, "
        "oxide_control_torch.suite.rewards, "
        "oxide_control_torch.parallel.rollout, oxide_control_torch.convert, "
        "oxide_control_torch.ops.emit, oxide_control_torch.ops.build, "
        "oxide_control_torch.bench_configs, "
        "oxide_control_torch.physics.muscle, "
        "oxide_control_torch.physics.forward, "
        "oxide_control_torch.physics.constraint, "
        "oxide_control_torch.physics.sensor, "
        "oxide_control_torch.physics.integrate, "
        "oxide_control_torch.utils.divergence, "
        "oxide_control_torch.utils.checkpoint, "
        "oxide_control_torch.utils.debug, "
        "oxide_control_torch.utils.profiling, "
        "oxide_control_torch.api.environment, "
        "oxide_control_torch.api.physics, "
        "oxide_control_torch.parallel.mesh, "
        "oxide_control_torch.parallel.multitask, "
        "oxide_control_torch.parallel.dryrun, "
        "oxide_control_torch.train.ppo, oxide_control_torch.train.es\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('oxide_control_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oxide_control_torch.default_device()
    with pytest.raises(RuntimeError):
        suite.load_batched("cheetah", "run", 8)
    model, task = suite.cheetah.run()
    with pytest.raises(RuntimeError):
        BatchedEnvironment(model, task, 8)
    with pytest.raises(RuntimeError):
        MLPPolicy(17, 6)
    assert oxide_control_torch.default_device("cpu") == torch.device("cpu")


_TWO_LINKS = """
<mujoco>
  <option {opt}/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="a" pos="0 0 1" {mocap}>
      <joint name="h1" type="hinge" axis="0 1 0"/>
      <geom type="{geom}" size="0.1 0.1 0.1"/>
      <site name="s1" pos="0.1 0 0"/>
      <body name="b" pos="0.3 0 0">
        <joint name="h2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.05" fromto="0 0 0 0.2 0 0"/>
        <site name="s2" pos="0.2 0 0"/>
      </body>
    </body>
  </worldbody>
  {extra}
</mujoco>
"""


def _two_links(opt="", mocap="", geom="sphere", extra=""):
    return _TWO_LINKS.format(opt=opt, mocap=mocap, geom=geom, extra=extra)


_REFUSED = dict(
    # ball joints, elliptic cones and condim 4/6 are admitted since they
    # were ported, and fluid forces and mocap bodies since slice 7
    # (test_slice7_models_are_supported); the others are still refused
    wind=_two_links(opt='wind="0.5 0 0"'),
    mocap_ball=_two_links().replace(
        '<joint name="h2" type="hinge" axis="0 1 0"/>',
        '<joint name="h2" type="ball"/>').replace(
        "</worldbody>", '<body name="m" mocap="true"><geom type="sphere" '
        'size="0.05" contype="0" conaffinity="0"/></body></worldbody>'),
    implicitfast=_two_links(opt='integrator="implicitfast"'),
    cylinder_pair=_two_links().replace(
        "</worldbody>", '<body pos="1 0 1"><joint type="hinge"/><geom '
        'type="cylinder" size="0.1 0.1"/></body></worldbody>'),
    fluid=_two_links(opt='density="1.2"'),
    refsite=_two_links(extra='<actuator><general site="s2" refsite="s1" '
                       'gear="1 0 0 0 0 0"/></actuator>'),
    mocap=_two_links().replace(
        "</worldbody>", '<body name="m" mocap="true"><geom type="sphere" '
        'size="0.05" contype="0" conaffinity="0"/></body></worldbody>'),
)
_IMPLICIT = HOPPER_XML.replace('<option timestep="0.01"',
                               '<option integrator="implicit" '
                               'timestep="0.01"')


@pytest.mark.parametrize("name,row", [
    ("implicit", "Queue A item 11"), ("implicitfast", "Queue A item 11"),
    ("cylinder_pair", "Queue A item 11"), ("refsite", "Queue A item 11"),
])
def test_unsupported_models_name_their_roadmap_row(name, row):
    xml = dict(_REFUSED, implicit=_IMPLICIT)[name]
    reason = sg.unsupported_reason(load_model_from_xml(xml))
    assert reason is not None and row in reason


@pytest.mark.parametrize("name", ["wind", "mocap_ball", "fluid", "mocap"])
def test_slice7_models_are_supported(name):
    """Fluid forces (wind, density) and mocap bodies (beside a ball
    joint, too) are in the port's class, as in the reference's."""
    from oxide_control_tpu.ops import scalar_graph as rsg

    assert sg.supports(load_model_from_xml(_REFUSED[name]))
    assert rsg.supports(ref_load_model_from_xml(_REFUSED[name]))


def test_supported_models():
    for name in ("cheetah", "walker", "humanoid", "cartpole", "pendulum"):
        assert sg.supports(load_model(ref_asset_path(name))), name
    assert sg.supports(load_model_from_xml(HOPPER_XML))


def test_ball_and_cone_models_are_supported():
    """The models this class admits for ball joints, condim 4/6 and
    elliptic cones: the two bench rows, the smoke's six parity models and
    the wrist under RK4."""
    import chip_smoke
    from oxide_control_torch import bench_configs

    xmls = [bench_configs.CABLE_XML, chip_smoke.BALL_LIMIT_XML,
            chip_smoke.BALL_LIMIT_XML.replace(
                '<option solver="Newton"',
                '<option integrator="RK4" solver="Newton"'),
            chip_smoke.BALL_FREE_XML, chip_smoke.WELD_BALL_XML,
            chip_smoke.CONDIM46_XML, chip_smoke.ELLIPTIC4_XML,
            chip_smoke.ELLIPTIC6_XML]
    for xml in xmls:
        assert sg.unsupported_reason(load_model_from_xml(xml)) is None
    assert sg.supports(bench_configs.cheetah_run_elliptic()[0])


def test_unported_tasks_raise():
    """Every task of the reference's suite is ported; a name outside it
    is refused with the list of tasks."""
    with pytest.raises(ValueError, match="available"):
        suite.load_batched("acrobot", "swingup", 8, device="cpu")
