"""Numerical checks (counterpart of ``portrayer_tpu/debug.py``).

The reference leans on Rust ownership and rayon's panic_fuse
(src/render.rs:36,130); what is left to go wrong in a wavefront pipeline
is numerical.  `checked_trace` runs the bounce loop under a
``TorchDispatchMode`` that looks at the floating outputs of every op for a
NaN, the counterpart of checkify's float checks, and names the op and the
line of the port it came from; `queue_overflow_fraction` measures the
throughput lost to bounce-queue overflow on a full-frame subsample;
`assert_image_finite` is a cheap guard for finished images.
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import rng
from .config import RenderConfig
from .ops.trace import trace

_PACKAGE = os.path.dirname(os.path.abspath(__file__))


def _has_nan(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel() > 0
            and bool(torch.isnan(x).any()))


def _port_frame() -> str:
    """The innermost frame of the port outside this module: "path:line
    (function)", the path relative to the package's parent."""
    here = os.path.abspath(__file__)
    for fr in reversed(traceback.extract_stack()):
        path = os.path.abspath(fr.filename)
        if path.startswith(_PACKAGE + os.sep) and path != here:
            return f"{os.path.relpath(path, os.path.dirname(_PACKAGE))}:{fr.lineno} ({fr.name})"
    return "outside the port"


class FloatCheck:
    """The result of a checked run: the first op that made a NaN from
    inputs without one (``made_here``), or, where none did, the first op
    that met a NaN in its inputs (one that came into the run from outside,
    as from a table).  Inf is allowed: the sweeps use it as a sentinel."""

    def __init__(self):
        self.op: Optional[str] = None
        self.frame: Optional[str] = None
        self.made_here = False

    def get(self) -> Optional[str]:
        """The error message, None when the run was clean."""
        if self.op is None:
            return None
        how = "made a NaN" if self.made_here else "met a NaN in its inputs"
        return f"nan: {self.op} {how}, at {self.frame}"

    def throw(self):
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


class _NanMode(TorchDispatchMode):
    """Checks every op's floating outputs for a NaN (one host sync per op
    on the card: a debug mode) and records the first op per FloatCheck."""

    def __init__(self, check: FloatCheck):
        super().__init__()
        self.check = check
        self.met = None  # (op, frame) of the first op that met a NaN

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.check.made_here or not any(_has_nan(x) for x in tree_leaves(out)):
            return out
        if not any(_has_nan(x) for x in tree_leaves((args, kwargs))):
            self.check.op, self.check.frame, self.check.made_here = (
                str(func), _port_frame(), True)
        elif self.met is None:
            self.met = (str(func), _port_frame())
        return out


def checked_trace(key, o, d, pix, bg, n_pixels, st, cfg: RenderConfig):
    """Run trace() with every op's floating outputs checked for NaN.
    Returns (err, acc); err.throw() raises FloatingPointError naming the
    op and the line of the port.  Uses the flat sweep, as the JAX package
    does: its checkify cannot look inside the sweep kernel."""
    if cfg.accel != "flat":
        cfg = dataclasses.replace(cfg, accel="flat")
    check = FloatCheck()
    mode = _NanMode(check)
    with mode:
        acc = trace(key, o, d, pix, bg, n_pixels, st, cfg)
    if check.op is None and mode.met is not None:
        check.op, check.frame = mode.met
    return check, acc


def queue_overflow_fraction(scene_or_tables, camera, size, background, cfg: RenderConfig,
                            max_rays: int = 65536) -> float:
    """Fraction of the primary throughput ended by bounce-queue overflow
    (TraceStats.dropped_w) on a full-frame strided subsample of the view,
    one ray at each pixel centre.  The loud-failure gate for stale
    per-scene queue_caps: a crop can miss exactly the geometry that keeps
    rays alive."""
    from .camera import Camera
    from .scene.flatten import SceneTables, flatten_scene

    if isinstance(scene_or_tables, SceneTables):
        st = scene_or_tables
    else:
        st = flatten_scene(scene_or_tables, cfg.device, dtype=cfg.dtype)
    w, h = size
    dev, dt = cfg.device, cfg.dtype
    cam = Camera(camera, (w, h), dev, dt)
    stride = max(1, (w * h) // max_rays)
    flat = torch.arange(0, w * h, stride, device=dev)
    P_ = flat.shape[0]
    px = (flat % w).to(dt) + 0.5
    py = (flat // w).to(dt) + 0.5
    o, d = cam.rays_at(px, py)
    pix = torch.arange(P_, dtype=torch.int32, device=dev)
    bg = background(torch.stack([px / w, py / h], dim=-1)).to(dt)
    _, stats = trace(rng.PRNGKey(cfg.seed), o, d, pix, bg, P_, st, cfg, with_stats=True)
    return float(stats.dropped_w)


def assert_image_finite(img, context: str = "render"):
    """Raise FloatingPointError naming the first non-finite texel."""
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    bad = ~np.isfinite(arr)
    if bad.any():
        first = np.unravel_index(int(np.argmax(bad)), arr.shape)
        raise FloatingPointError(
            f"{context}: {int(bad.sum())} non-finite values; first at "
            f"index {tuple(int(i) for i in first)}")
    return img
