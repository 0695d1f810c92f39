"""Shared helpers for the control suite tasks."""

from __future__ import annotations

import functools
import os

import numpy as np

from ..api.errors import UnsupportedFeatureError
from ..mjcf.compile import load_model
from ..model import Model

ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


@functools.lru_cache(maxsize=None)
def _load_cached(name: str, dtype_str: str) -> Model:
    return load_model(asset_path(name), dtype=np.dtype(dtype_str))


def load_asset(name: str, dtype=np.float64) -> Model:
    """Load and compile a suite asset model, cached per (name, dtype)."""
    return _load_cached(name, np.dtype(dtype).name)


def asset_path(name: str) -> str:
    path = os.path.join(ASSET_DIR, f"{name}.xml")
    if not os.path.exists(path):
        raise UnsupportedFeatureError(
            f"suite asset {name!r} is not ported yet (ROADMAP Queue A item "
            f"9: the rest of the suite); available: cheetah"
        )
    return path
