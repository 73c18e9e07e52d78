"""examples/antialiasing.rs (``scenes/antialiasing.py``) — flat-shaded monkey."""

from .. import (
    Scene, SceneNode, Geometry, Mesh, MeshData, Shading, Material, Light,
    CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build() -> SceneSpec:
    mat_monkey = Material(diffuse=(0.961, 0.573, 0.259), specular=(0.3, 0.3, 0.3), shininess=25.0)
    monkey = MeshData.load_obj(asset("monkey.obj"))
    scene = Scene(
        root=SceneNode([SceneNode(Geometry(Mesh(monkey, Shading.Flat), mat_monkey))]),
        lights=[Light(position=(0.0, 0.0, 10.0), color=(0.5, 0.5, 0.5))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 0.0, 6.5), center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0), fovy=deg(20.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(300, 250),
                     background=sky_background, name="antialiasing")
