"""Checkpoint and resume: the port of
``oxide_control_tpu/utils/checkpoint.py``.

The env ``Data``'s core fields are the checkpoint (the reference crate's
resume surface: time, qpos, qvel, act, ctrl, warmstart, applied forces,
mocap poses, eq_active); derived fields are recomputed by ``forward`` or
the next step.  ``save`` writes them to a ``.npz`` with the state of a
``torch.Generator`` in place of the reference's JAX key, so that a
resumed run draws the same numbers and continues bit for bit.  ``load``
also reads a file the reference saved: its core state carries across the
packages (as ``convert.py`` carries weights); a JAX key has no torch
counterpart, so such a file gives no generator.  The reference's orbax
pair (``save_orbax``/``load_orbax``) is not ported: orbax is installed on
neither the machine that runs the tests nor the one with the card.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .. import default_device
from ..model import Model
from ..state import Data, make_data

# the exact-resume state surface (the reference crate's accessor list)
CORE_FIELDS = (
    "time",
    "qpos",
    "qvel",
    "act",
    "ctrl",
    "qacc_warmstart",
    "qfrc_applied",
    "xfrc_applied",
    "mocap_pos",
    "mocap_quat",
    "eq_active",
)
_GENERATOR = "__generator__"


def core_state(data: Data) -> dict[str, torch.Tensor]:
    return {f: getattr(data, f) for f in CORE_FIELDS}


def restore_core(model: Model, core: dict[str, Any], device=None) -> Data:
    """A full batched Data on ``device`` (None: the current CUDA device)
    from a core dict of arrays, in qpos's dtype (derived fields zeroed;
    run forward() to refresh them).  An unbatched core (the reference's
    single env) becomes a batch of one, as the port's Environment holds
    it."""
    device = default_device(device)
    core = {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in core.items()}
    if core["qpos"].dim() == 1:
        core = {k: v[None] for k, v in core.items()}
    data = make_data(model, device, core["qpos"].dtype,
                     batch=core["qpos"].shape[0])
    return data.replace(**core)


def save(path: str, data: Data,
         generator: torch.Generator | None = None) -> None:
    """Save the core state (and the generator's state) to an .npz file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in core_state(data).items()}
    if generator is not None:
        arrays[_GENERATOR] = generator.get_state().numpy()
    np.savez(path, **arrays)


def load(path: str, model: Model, device=None):
    """Load an .npz checkpoint -> ``(Data, generator or None)``, both on
    ``device`` (None: the current CUDA device).  The generator carries the
    saved state; a file without one, or one the reference saved (a JAX
    key), gives None."""
    device = default_device(device)
    with np.load(path) as z:
        core = {k: z[k] for k in CORE_FIELDS if k in z.files}
        state = z[_GENERATOR] if _GENERATOR in z.files else None
    generator = None
    if state is not None:
        generator = torch.Generator(device=device)
        generator.set_state(torch.from_numpy(state))
    return restore_core(model, core, device), generator
