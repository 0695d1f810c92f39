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
