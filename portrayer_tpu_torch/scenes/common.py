"""Shared helpers of the port's scene programs (counterpart of
``scenes/common.py``): where the asset files are, the sky and white
backgrounds and ``deg``."""

from __future__ import annotations

import os

import torch

from ..math3d import radians
from ..ops.intersect import _vec

# The asset folder when PORTRAYER_ASSETS is not set: ``assets/`` at the
# repository's root, beside this package.
DEFAULT_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


def asset(name: str) -> str:
    """`name` in the asset folder: PORTRAYER_ASSETS, read at each call,
    else DEFAULT_ASSETS."""
    return os.path.join(os.environ.get("PORTRAYER_ASSETS", DEFAULT_ASSETS), name)


def sky_background(uv):
    """The gradient used by most examples: (0.2,0.4,0.6)*(1-v) + blue*v."""
    v = uv[..., 1:2]
    # Constants filled on the device: a render captures this in a CUDA
    # graph, which cannot hold a copy from the host.
    top, blue = _vec((0.2, 0.4, 0.6), uv), _vec((0.0, 0.0, 1.0), uv)
    return top * (1.0 - v) + blue * v


def white_background(uv):
    return torch.ones(uv.shape[:-1] + (3,), dtype=uv.dtype, device=uv.device)


deg = radians
