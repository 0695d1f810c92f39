"""oxide_control_torch: the PyTorch/CUDA port of ``oxide_control_tpu``.

The JAX package beside it is the reference; this package imports neither
JAX nor anything of it.  The main path is the rollout engine on one GPU::

    from oxide_control_torch import suite
    from oxide_control_torch.parallel.rollout import FastRollout

    benv = suite.load_batched("cheetah", "run", 4096)    # on cuda
    roll = FastRollout(benv, steps_per_call=200)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = roll.init(gen)
    state, traj = roll.run(state, gen)

and one environment behind typed accessors, on the general path::

    from oxide_control_torch.api import Physics

    physics = Physics.from_xml_string(xml)                # on cuda
    physics.set_qpos("hinge", 0.3)
    physics.step()
    z = physics.body_xpos("torso")[2]

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor the rollout runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written kernel
(``ops/csrc/rollout.cu``).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device.  Raises ``RuntimeError`` when ``None`` is given and no CUDA
    device is present: the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: oxide_control_torch runs on the GPU unless "
            "the caller passes device='cpu'"
        )
    return torch.device("cuda", torch.cuda.current_device())


# the reference's top-level exports (after default_device, which the API
# modules they import read)
from .mjcf.compile import load_model, load_model_from_xml  # noqa: E402
from .model import (  # noqa: E402
    GeomType,
    Integrator,
    JointType,
    Model,
    Option,
    SolverType,
)

__all__ = [
    "GeomType",
    "Integrator",
    "JointType",
    "Model",
    "Option",
    "SolverType",
    "default_device",
    "load_model",
    "load_model_from_xml",
]
