"""examples/smooth-shading.rs (``scenes/smooth_shading.py``) — flat vs smooth shaded meshes."""

from .. import (
    Scene, SceneNode, Geometry, Mesh, MeshData, Shading, Material, Light,
    CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset

_cache = {}


def build() -> SceneSpec:
    mat_rock = Material(diffuse=(0.256361,) * 3, specular=(0.6, 0.6, 0.6), shininess=50.0)
    mat_cow = Material(diffuse=(0.692066, 0.477245, 0.293336), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_monkey = Material(diffuse=(0.261829, 0.8, 0.310477), specular=(0.3, 0.3, 0.3), shininess=25.0)

    paths = (asset("monkey.obj"), asset("cow.obj"), asset("flat_rock.obj"),
             asset("smooth_rock.obj"))
    if paths not in _cache:
        _cache[paths] = tuple(MeshData.load_obj(p) for p in paths)
    monkey, cow, flat_rock, smooth_rock = _cache[paths]

    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Mesh(monkey, Shading.Flat), mat_monkey))
                .rotated_y(deg(45.0)).translated((-1.904434, 1.4, 0.0)),
            SceneNode(Geometry(Mesh(cow, Shading.Flat), mat_cow))
                .scaled(0.5).rotated_y(deg(-15.0)).translated((-4.2, 1.8, 4.0)),
            SceneNode(Geometry(Mesh(flat_rock, Shading.Flat), mat_rock))
                .translated((-3.396987, -1.4, 2.286671)),
            SceneNode(Geometry(Mesh(monkey, Shading.Smooth), mat_monkey))
                .rotated_y(deg(-45.0)).translated((1.242585, 1.4, 0.0)),
            SceneNode(Geometry(Mesh(cow, Shading.Smooth), mat_cow))
                .scaled(0.5).rotated_y(deg(205.0)).translated((3.8, 1.8, 4.0)),
            SceneNode(Geometry(Mesh(smooth_rock, Shading.Smooth), mat_rock))
                .translated((3.271008, -1.406423, 2.372513)),
        ]),
        lights=[Light(position=(0.0, 5.0, 10.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(1.062382, 0.54746, 22.827951),
        center=(-0.813817, 0.424462, -8.112782),
        up=(0.0, 1.0, 0.0), fovy=deg(24.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="smooth-shading")
