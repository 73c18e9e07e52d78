"""Materials (counterpart of ``portrayer_tpu/scene/material.py``).

Diffuse, specular, shininess (Blinn-Phong with 4x compensation),
reflectivity, glossy side length, refraction index, a uv transform, and
an optional texture and normal map (src/material.rs:51-86).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


def _rgb(v) -> np.ndarray:
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full(3, float(arr))
    return arr


@dataclasses.dataclass
class Material:
    diffuse: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    reflectivity: float = 0.0
    glossy_side_length: float = 0.0
    refraction_index: float = 0.0
    texture: Optional[Any] = None
    # 3x3 transform applied to (u, v, 1) before sampling (src/material.rs:113-117)
    uv_trans: Optional[np.ndarray] = None
    normals: Optional[Any] = None

    def __post_init__(self):
        self.diffuse = _rgb(self.diffuse)
        self.specular = _rgb(self.specular)
        if self.uv_trans is not None:
            self.uv_trans = np.asarray(self.uv_trans, dtype=np.float64).reshape(3, 3)

    def __hash__(self):  # identity hash: materials are shared via references
        return id(self)

    def __eq__(self, other):
        return self is other
