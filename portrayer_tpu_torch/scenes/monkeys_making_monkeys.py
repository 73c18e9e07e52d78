"""examples/monkeys-making-monkeys.rs (``scenes/monkeys_making_monkeys.py``).

Where assets/cpu_cubemap.png is absent, as the JAX package does, a
procedural dark "computer case" 4x3 cube map stands in.
"""

import os

import numpy as np

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Cone, Mesh, MeshData,
    Shading, Material, Light, Parallelogram, CameraSettings,
    Texture, ImageTexture, NormalMap,
    OPTICAL_GLASS_REFRACTION_INDEX, WATER_REFRACTION_INDEX,
)
from . import SceneSpec
from .common import sky_background, deg, asset

_mesh_cache = {}


def _load(name):
    path = asset(name)
    if path not in _mesh_cache:
        _mesh_cache[path] = MeshData.load_obj(path)
    return _mesh_cache[path]


def _cpu_cubemap() -> ImageTexture:
    path = asset("cpu_cubemap.png")
    if os.path.exists(path):
        return ImageTexture(path)
    # dark case with lighter vents: procedural 4x3 atlas
    h, w = 192, 256
    img = np.full((h, w, 3), 0.05)
    yy, xx = np.mgrid[0:h, 0:w]
    vents = ((yy % 8) < 2) & ((xx % 64) > 8) & ((xx % 64) < 56)
    img[vents] = 0.18
    return ImageTexture(data=img)


def room():
    mat_floor = Material(diffuse=(0.655758, 0.8, 0.753899), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_walls = Material(diffuse=(0.8, 0.680366, 0.555109), specular=(0.8, 0.8, 0.8), shininess=25.0)
    return SceneNode([
        SceneNode(Geometry(Plane(), mat_floor)).scaled(16.0).translated((0.0, 0.0, 3.708507)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled(16.0)
            .rotated_z(deg(-90.0)).translated((-6.340487, 5.0, 4.199467)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled(16.0)
            .rotated_x(deg(90.0)).translated((0.0, 5.0, -3.2)),
    ])


def wall_decor():
    mat_poster = Material(diffuse=(0.8, 0.329194, 0.120657), specular=(0.8, 0.8, 0.8), shininess=25.0)
    painting = Texture(ImageTexture(asset("four-shapes.png")))
    mat_painting = Material(specular=(0.2, 0.2, 0.2), shininess=25.0, texture=painting)
    mat_canvas = Material(diffuse=(0.8, 0.8, 0.8), specular=(0.2, 0.2, 0.2), shininess=25.0)
    return SceneNode([
        SceneNode(Geometry(Plane(), mat_poster)).scaled(4.74905)
            .rotated_z(deg(-90.0)).translated((-6.330487, 8.043096, 3.401992)),
        SceneNode(Geometry(Plane(), mat_painting)).scaled((6.0, 1.0, 1.6))
            .rotated_x(deg(90.0)).translated((-1.0, 10.2, -3.095)),
        SceneNode(Geometry(Cube(), mat_canvas)).scaled((6.0, 1.6, 0.2))
            .translated((-1.0, 10.2, -3.2)),
    ])


def desk():
    wood = Texture(ImageTexture(asset("Wood_018_basecolor_cubemap.jpg")))
    wood_normals = NormalMap(asset("Wood_018_normal_cubemap.jpg"))
    mat_desk = Material(
        specular=(0.5, 0.5, 0.5), shininess=100.0, reflectivity=0.2,
        glossy_side_length=2.0, texture=wood, normals=wood_normals,
    )
    nodes = [
        SceneNode(Geometry(Cube(), mat_desk)).scaled((8.0, 0.5, 6.0)).translated((0.0, 5.0, 0.0))
    ]
    for x in (-3.5, 3.5):
        for z in (-2.517656, 2.517656):
            nodes.append(
                SceneNode(Geometry(Cube(), mat_desk))
                .scaled((0.470548, 4.8, 0.470548)).translated((x, 2.54158, z))
            )
    return SceneNode(nodes)


def computer(monkey):
    mat_cpu = Material(texture=Texture(_cpu_cubemap()))
    mat_computer = Material(diffuse=(0.043232,) * 3, specular=(0.3, 0.3, 0.3), shininess=10.0)
    mat_screen = Material(diffuse=(0.655925,) * 3, specular=(0.3, 0.3, 0.3), shininess=10.0)
    mat_screen_text = Material(diffuse=(0.8, 0.8, 0.8), specular=(0.3, 0.3, 0.3), shininess=10.0)
    mat_hologram = Material(
        diffuse=(0.479036, 0.8, 0.518124), reflectivity=0.6,
        refraction_index=WATER_REFRACTION_INDEX,
    )
    return SceneNode([
        SceneNode(Geometry(Cube(), mat_cpu)).scaled((1.6, 3.0, 2.0))
            .translated((-3.0, 6.74, 0.0)),
        SceneNode(Geometry(Sphere(), mat_computer)).scaled((0.28, 0.12, 0.4))
            .translated((1.411292, 5.327119, 1.857835)),
        SceneNode(Geometry(Mesh(_load("computer_screen_base.obj"), Shading.Smooth), mat_computer))
            .translated((0.0, 5.25, 0.0)),
        SceneNode(Geometry(Mesh(_load("computer_edge_display.obj"), Shading.Flat), mat_screen))
            .translated((0.0, 7.256888, 0.0)),
        SceneNode(Geometry(Mesh(_load("text_monkey.3d.obj"), Shading.Flat), mat_screen_text))
            .translated((0.0, 9.081371, 0.01)),
        SceneNode(Geometry(Mesh(monkey, Shading.Flat), mat_hologram)).scaled(1.5)
            .rotated_xzy((deg(-33.2668), deg(8.17821), deg(-8.17821)))
            .translated((0.0, 7.0, 0.0)),
    ])


def chair():
    mat_chair = Material(diffuse=(0.032075,) * 3, specular=(0.3, 0.3, 0.3), shininess=25.0)
    return SceneNode([
        SceneNode(Geometry(Sphere(), mat_chair)).scaled((1.283107, 1.537732, 0.425492))
            .translated((0.0, 5.334378, 5.404959)),
    ])


def character(monkey):
    mat_torso = Material(diffuse=(0.077701, 0.075793, 0.125964), specular=(0.8, 0.8, 0.8), shininess=25.0)
    mat_head = Material(diffuse=(0.064598, 0.270305, 0.716789), specular=(0.8, 0.8, 0.8), shininess=25.0)
    return SceneNode([
        SceneNode(Geometry(Mesh(monkey, Shading.Smooth), mat_head))
            .rotated_y(deg(180.0)).translated((0.0, 7.0, 4.0)),
        SceneNode(Geometry(Mesh(_load("monkey_torso.obj"), Shading.Smooth), mat_torso))
            .translated((0.0, 5.148612, 4.23546)),
        SceneNode(Geometry(Sphere(), mat_torso)).scaled((0.282782, 1.299079, 0.282782))
            .rotated_z(deg(19.0)).translated((0.984683, 5.126376, 4.344858)),
    ])


def desk_objects():
    mat_teapot = Material(
        diffuse=(0.314666,) * 3, specular=(0.8, 0.8, 0.8), shininess=25.0,
        reflectivity=0.3, glossy_side_length=1.0,
    )
    mat_glass = Material(
        diffuse=(0, 0, 0), specular=(0.3, 0.3, 0.3), shininess=25.0,
        reflectivity=1.0, refraction_index=OPTICAL_GLASS_REFRACTION_INDEX,
    )
    mat_apple = Material(diffuse=(0.8, 0.0, 0.0))
    mat_golf = Material(
        diffuse=(0.8, 0.8, 0.8), specular=(0.8, 0.8, 0.8), shininess=25.0,
        reflectivity=0.3, glossy_side_length=1.0,
    )
    mat_cone = Material(diffuse=(0.368949, 0.335492, 0.8))
    return SceneNode([
        SceneNode(Geometry(Mesh(_load("teapot.obj"), Shading.Smooth), mat_teapot))
            .scaled(0.030).translated((2.43888, 5.241134, -0.617814)),
        SceneNode(Geometry(Sphere(), mat_glass)).scaled(0.5)
            .translated((2.768083, 5.751237, -1.475317)),
        SceneNode(Geometry(Sphere(), mat_apple)).scaled(0.28)
            .translated((3.369787, 5.538453, -0.782367)),
        SceneNode(Geometry(Sphere(), mat_golf)).scaled(0.14)
            .translated((3.03616, 5.384166, -0.381234)),
        SceneNode(Geometry(Cone(), mat_cone)).scaled((0.64963, 1.106842, 0.64963))
            .translated((3.182365, 5.777666, -2.332999)),
    ])


def build() -> SceneSpec:
    monkey = _load("monkey.obj")
    scene = Scene(
        root=SceneNode([
            room(), wall_decor(), desk(), desk_objects(),
            computer(monkey), chair(), character(monkey),
        ]),
        lights=[
            Light(position=(0.0, 13.0, 1.0), color=(0.9, 0.9, 0.9),
                  area=Parallelogram(a=(4.0, 0.0, 0.0), b=(0.0, 0.0, 4.0))),
            Light(position=(8.0, 8.0, 8.0), color=(0.4, 0.4, 0.4),
                  area=Parallelogram(a=(0.0, 0.0, 2.5), b=(0.0, 2.5, 0.0))),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(10.626843, 11.525522, 15.875655),
        center=(-11.287256, 4.506533, -10.496798),
        up=(0.0, 1.0, 0.0), fovy=deg(23.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(1920, 1080),
                     background=sky_background, name="monkeys-making-monkeys")
