"""examples/graphics-poster.rs (``scenes/graphics_poster.py``) — glass dodecahedron + cow."""

from .. import (
    Scene, SceneNode, Geometry, Mesh, MeshData, Shading, Material, Light,
    CameraSettings, OPTICAL_GLASS_REFRACTION_INDEX,
)
from . import SceneSpec
from .common import deg, asset, white_background


def build() -> SceneSpec:
    mat_glass = Material(
        diffuse=(0.003638, 0.017153, 0.048247), specular=(0.5, 0.5, 0.5),
        shininess=100.0, reflectivity=0.8, glossy_side_length=0.5,
        refraction_index=OPTICAL_GLASS_REFRACTION_INDEX,
    )
    mat_cow = Material(
        diffuse=(0.725682, 0.501253, 0.8), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    dodeca = MeshData.load_obj(asset("dodeca.obj"))
    cow = MeshData.load_obj(asset("cow.obj"))

    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Mesh(dodeca, Shading.Flat), mat_glass)).rotated_y(deg(90.0)),
            SceneNode(Geometry(Mesh(cow, Shading.Smooth), mat_cow))
                .scaled(0.24).rotated_y(deg(-60.0)),
        ]),
        lights=[
            Light(position=(1.33223, 4.297232, 3.473453), color=(0.9, 0.9, 0.9)),
            Light(position=(0.8, 0.806596, 0.9), color=(0.3, 0.3, 0.3)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(4.482203, 3.038775, 4.350142),
        center=(-7.387217, -4.572944, -6.838186),
        up=(0.0, 1.0, 0.0), fovy=deg(35.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=white_background, name="graphics-poster")
