"""examples/macho-cows.rs (``scenes/macho_cows.py``) — real cow meshes around Stonehenge."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Mesh, MeshData, Shading,
    Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset
from .simple_cows import _stone_grass_hide, COW_SPOTS


def build() -> SceneSpec:
    stone, grass, cow_hide = _stone_grass_hide()
    cow_model = MeshData.load_obj(asset("cow.obj"))
    plane = MeshData.load_obj(asset("plane.obj"))
    buckyball = MeshData.load_obj(asset("buckyball.obj"))

    arc = SceneNode([
        SceneNode(Geometry(Cube(), stone)).scaled((0.8, 4.0, 0.8)).translated((-2.0, 2.0, 0.0)),
        SceneNode(Geometry(Cube(), stone)).scaled((0.8, 4.0, 0.8)).translated((2.0, 2.0, 0.0)),
        SceneNode(Geometry(Sphere(), stone)).scaled((4.0, 0.6, 0.6)).translated((0.0, 4.0, 0.0)),
    ]).translated((0.0, 0.0, -10.0))

    nodes = [SceneNode(arc).rotated_y(deg(60.0 * (i - 1))) for i in range(1, 7)]

    cow = (
        SceneNode(Geometry(Mesh(cow_model, Shading.Flat), cow_hide))
        .translated((0.0, 3.637, 0.0))
        .scaled(2.0 / (2.76 + 3.637))
        .translated((0.0, -1.0, 0.0))
    )
    for pos, rot in COW_SPOTS:
        nodes.append(SceneNode(cow).scaled(1.4).rotated_y(deg(rot)).translated(pos))

    nodes.append(SceneNode(Geometry(Mesh(plane, Shading.Flat), grass)).scaled(30.0))
    nodes.append(SceneNode(Geometry(Mesh(buckyball, Shading.Flat), stone)).scaled(1.5))

    scene = Scene(
        root=SceneNode(nodes).rotated_x(deg(23.0)),
        lights=[Light(position=(200.0, 202.0, 430.0), color=(0.8, 0.8, 0.8))],
        ambient=(0.4, 0.4, 0.4),
    )
    cam = CameraSettings(
        eye=(0.0, 2.0, 30.0), center=(0.0, 2.0, 29.0),
        up=(0.0, 1.0, 0.0), fovy=deg(50.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=sky_background, name="macho-cows")
