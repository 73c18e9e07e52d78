"""Textures and normal maps (counterpart of
``portrayer_tpu/scene/texture.py``, src/texture.rs).

* ``Texture`` is either a procedural function or an image.  A procedural
  one is a callable on torch tensors, ``fn(uv[..., 2]) -> rgb[..., 3]``,
  evaluated where a hit's material names it.
* Image texels stay sRGB-encoded uint8 on the device; sampling is nearest
  neighbour with euclidean-remainder wraparound and decodes c^2.2
  (src/texture.rs:104-168, ``ops/shade.sample_atlas``).
* ``NormalMap`` texels decode to a tangent-space vector at shade time
  (src/texture.rs:192-221).

Images come from a ``data=`` array ([H, W, 3] uint8, or floats in [0, 1])
or from a PNG or baseline JPEG file, read by ``image_io.read_image``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..image_io import read_image


def _as_u8(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data)
    if data.dtype == np.uint8:
        return data
    return np.clip(np.round(data * 255.0), 0, 255).astype(np.uint8)


class ImageTexture:
    """A texture sampled from an image; texels stored as sRGB uint8."""

    def __init__(self, path=None, *, data: Optional[np.ndarray] = None):
        if data is None:
            data = read_image(path)
        self.raw = _as_u8(data)  # [H, W, 3] sRGB-encoded uint8
        self.path = path

    @property
    def shape(self):
        return self.raw.shape

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class NormalMap:
    """Normal map: uint8 texel values, decoded to vectors at shade time."""

    def __init__(self, path=None, *, data: Optional[np.ndarray] = None):
        if data is None:
            data = read_image(path)
        self.raw = _as_u8(data)
        self.path = path

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class Texture:
    """FnTex | Image sum type (src/texture.rs:22-27)."""

    def __init__(self, source):
        if isinstance(source, Texture):
            source = source.source
        self.source = source

    @property
    def is_image(self) -> bool:
        return isinstance(self.source, ImageTexture)

    @property
    def fn(self) -> Callable:
        if self.is_image:
            raise TypeError("an image texture has no procedural function")
        return self.source

    @property
    def image(self) -> ImageTexture:
        if not self.is_image:
            raise TypeError("a procedural texture has no image")
        return self.source

    @classmethod
    def open(cls, path) -> "Texture":
        return cls(ImageTexture(path))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
