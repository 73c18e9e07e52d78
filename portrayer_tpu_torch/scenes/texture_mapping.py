"""examples/texture-mapping.rs (``scenes/texture_mapping.py``).

Where assets/earth_cube.png is absent, as the JAX package does, a 4x3
cube map tiled from earth.jpg stands in (the make-cube-map.sh recipe)."""

import os

import numpy as np

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Material, Light,
    CameraSettings, Texture, ImageTexture,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def _earth_cubemap() -> ImageTexture:
    path = asset("earth_cube.png")
    if os.path.exists(path):
        return ImageTexture(path)
    # make-cube-map.sh: tile the texture into a 4x3 grid
    earth = ImageTexture(asset("earth.jpg"))
    h, w, _ = earth.raw.shape
    tile = earth.raw[:: max(1, h // 170), :: max(1, w // 170)][:170, :170]
    grid = np.tile(tile, (3, 4, 1))
    return ImageTexture(data=grid)


def build() -> SceneSpec:
    mat_mirror = Material(
        diffuse=(0, 0, 0), specular=(0.6, 0.6, 0.6),
        shininess=1000.0, reflectivity=1.0,
    )
    mat_wood = Material(diffuse=(0.545, 0.353, 0.169), specular=(0.5, 0.7, 0.5), shininess=25.0)
    earth = Texture(ImageTexture(asset("earth.jpg")))
    mat_tex = Material(
        diffuse=(0.506, 0.78, 0.518), specular=(0.5, 0.5, 0.5), shininess=25.0,
        texture=earth,
    )
    mat_tex_cube = Material(
        diffuse=(0.506, 0.78, 0.518), specular=(0.5, 0.5, 0.5), shininess=25.0,
        texture=Texture(_earth_cubemap()),
    )

    mirror = (
        SceneNode(Geometry(Cube(), mat_wood))
        .scaled((9.0, 0.5, 6.0)).rotated_x(deg(10.0))
        .with_child(
            SceneNode(Geometry(Cube(), mat_mirror))
            .scaled((8.1 / 9.0, 0.05 / 0.5, 5.4 / 6.0))
            .translated((0.0, 0.27 / 0.5, 0.0))
        )
    )

    scene = Scene(
        root=SceneNode([
            mirror,
            SceneNode(Geometry(Plane(), mat_tex)).scaled((8.0, 1.0, 2.0))
                .rotated_x(deg(90.0)).translated((0.0, 2.0, -2.0)),
            SceneNode(Geometry(Cube(), mat_tex_cube)).scaled(1.4)
                .translated((-2.0, 2.0, 0.0)),
            SceneNode(Geometry(Sphere(), mat_tex)).translated((2.0, 2.0, 0.0)),
        ]),
        lights=[
            Light(position=(-6.0, 5.0, 4.0), color=(0.5, 0.5, 0.5)),
            Light(position=(6.0, 5.0, 4.0), color=(0.5, 0.5, 0.5)),
            Light(position=(0.0, 1.0, -4.0), color=(0.5, 0.5, 0.5)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 10.15667, 11.579666), center=(0.0, -5.913023, -7.571445),
        up=(0.0, 1.0, 0.0), fovy=deg(25.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="texture-mapping")
