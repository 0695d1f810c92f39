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
    port = suite.asset_path("cheetah")
    with open(port) as a, open(ref_asset_path("cheetah")) as b:
        assert a.read() == b.read()


def test_import_leaves_jax_out():
    code = (
        "import sys, oxide_control_torch, oxide_control_torch.suite, "
        "oxide_control_torch.parallel.rollout, oxide_control_torch.convert, "
        "oxide_control_torch.ops.emit, oxide_control_torch.ops.build\n"
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


@pytest.mark.parametrize("name,row", [
    ("humanoid", "Queue A item 9"), ("cartpole", "Queue A item 9"),
])
def test_unsupported_models_name_their_roadmap_row(name, row):
    reason = sg.unsupported_reason(load_model(ref_asset_path(name)))
    assert reason is not None and row in reason


def test_supported_models():
    assert sg.supports(load_model(ref_asset_path("cheetah")))
    assert sg.supports(load_model_from_xml(HOPPER_XML))


def test_unported_tasks_raise():
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        suite.load_batched("walker", "walk", 8, device="cpu")
