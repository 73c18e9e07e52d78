"""examples/fish.rs (``scenes/fish.py``) — mesh texture mapping."""

from .. import (
    Scene, SceneNode, Geometry, Mesh, MeshData, Shading, Material, Light,
    CameraSettings, Texture, ImageTexture,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build() -> SceneSpec:
    fish_skin = Texture(ImageTexture(asset("fish.png")))
    mat_fish = Material(
        diffuse=(0.8, 0.8, 0.8), specular=(0.3, 0.3, 0.3), shininess=25.0,
        texture=fish_skin,
    )
    fish_model = MeshData.load_obj(asset("fish.obj"))

    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Mesh(fish_model, Shading.Smooth), mat_fish))
                .rotated_y(deg(30.0)),
            SceneNode(Geometry(Mesh(fish_model, Shading.Smooth), mat_fish))
                .rotated_y(deg(210.0)),
        ]),
        lights=[Light(position=(0.0, 0.0, 10.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 0.0, 11.0), center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0), fovy=deg(25.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="fish")
