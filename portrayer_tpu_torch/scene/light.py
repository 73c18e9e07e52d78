"""Lights (counterpart of ``portrayer_tpu/scene/light.py``).

Point lights with quadratic falloff, attenuation = c0 + c1*r + c2*r^2
(src/light.rs:31-33), and the parallelogram area description
(src/light.rs:62-70): the shading samples one point of it per lane.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _vec3(v) -> np.ndarray:
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full(3, float(arr))
    return arr


@dataclasses.dataclass
class Falloff:
    c0: float = 1.0
    c1: float = 0.0
    c2: float = 0.0


@dataclasses.dataclass
class Parallelogram:
    a: tuple = (0.0, 0.0, 0.0)
    b: tuple = (0.0, 0.0, 0.0)

    def __post_init__(self):
        self.a = _vec3(self.a)
        self.b = _vec3(self.b)

    def is_empty(self) -> bool:
        return bool(np.all(self.a == 0.0) or np.all(self.b == 0.0))


@dataclasses.dataclass
class Light:
    position: tuple = (0.0, 0.0, 0.0)
    color: tuple = (0.0, 0.0, 0.0)
    falloff: Falloff = dataclasses.field(default_factory=Falloff)
    area: Parallelogram = dataclasses.field(default_factory=Parallelogram)

    def __post_init__(self):
        self.position = _vec3(self.position)
        self.color = _vec3(self.color)
        if not isinstance(self.falloff, Falloff):
            self.falloff = Falloff(*tuple(self.falloff))
