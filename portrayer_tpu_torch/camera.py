"""Camera (counterpart of ``portrayer_tpu/camera.py``, src/camera.rs).

Screen -> NDC -> view (image plane at z=-1, fov_factor = tan(fovy/2), x
scaled by aspect) -> world through the inverted look_at_rh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math3d as m3


@dataclasses.dataclass
class CameraSettings:
    eye: tuple
    center: tuple
    up: tuple = (0.0, 1.0, 0.0)
    fovy: float = m3.radians(90.0)  # radians


class Camera:
    def __init__(self, settings: CameraSettings, size, device):
        width, height = size
        self.width = float(width)
        self.height = float(height)
        self.aspect = self.width / self.height
        self.fov_factor = float(np.tan(settings.fovy / 2.0))
        v2w = m3.invert(m3.look_at_rh(settings.eye, settings.center, settings.up))
        self.eye = torch.as_tensor(np.asarray(settings.eye), dtype=torch.float32,
                                   device=device)
        self.view_to_world = torch.as_tensor(m3.to_affine34(v2w), dtype=torch.float32,
                                             device=device)

    def rays_at(self, x, y):
        """Primary rays through sample positions x, y [R] (pixels).

        Returns (origins [R,3], unit directions [R,3])."""
        full = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)
        ndc_x = x / full(self.width)
        ndc_y = y / full(self.height)
        view_x = (2.0 * ndc_x - 1.0) * self.aspect * self.fov_factor
        view_y = (1.0 - 2.0 * ndc_y) * self.fov_factor
        pixel_view = torch.stack([view_x, view_y, -torch.ones_like(view_x)], dim=-1)
        pixel_world = m3.transform_point(self.view_to_world, pixel_view)
        delta = pixel_world - self.eye
        d = delta / torch.sqrt(m3.dot(delta, delta))[:, None]
        o = self.eye.expand_as(d)
        return o, d
