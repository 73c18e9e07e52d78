"""examples/robot-alarm-clock.rs (``scenes/robot_alarm_clock.py``) — "Andy the Alarm Clock"."""

import numpy as np

from .. import (
    Scene, SceneNode, Geometry, Cube, Plane, Mesh, KDMesh, MeshData,
    Shading, Material, Light, Parallelogram, CameraSettings,
    Texture, ImageTexture, NormalMap, OPTICAL_GLASS_REFRACTION_INDEX,
)
from . import SceneSpec
from ..ops.intersect import _vec
from .common import deg, asset

_cache = {}


def _load(name):
    path = asset("robot-alarm-clock/" + name)
    if path not in _cache:
        _cache[path] = MeshData.load_obj(path)
    return _cache[path]


def robot_background(uv):
    v = uv[..., 1:2]
    top, bot = _vec((0.529, 0.808, 0.922), uv), _vec((0.086, 0.38, 0.745), uv)
    return top * (1.0 - v) + bot * v


def room():
    wallpaper = Texture(ImageTexture(asset("robot-alarm-clock/wallpaper.jpg")))
    mat_wall = Material(
        specular=(0.3, 0.3, 0.3), shininess=25.0, texture=wallpaper,
        uv_trans=np.diag([3.0, 3.0, 1.0]),  # Mat3::scaling_3d(3.0)
    )
    wood = Texture(ImageTexture(asset("Wood_018_basecolor_cubemap.jpg")))
    wood_normals = NormalMap(asset("Wood_018_normal_cubemap.jpg"))
    mat_table = Material(
        specular=(0.5, 0.5, 0.5), shininess=100.0, reflectivity=0.2,
        glossy_side_length=2.0, texture=wood, normals=wood_normals,
    )
    return SceneNode([
        SceneNode(Geometry(Plane(), mat_wall)).scaled(20.0)
            .rotated_x(deg(90.0)).translated((-2.0, 8.0, -5.0)),
        SceneNode(Geometry(Cube(), mat_table)).scaled((20.0, 1.0, 10.0))
            .translated((-2.0, 0.0, 0.0)),
    ])


def robot():
    mat_metal = Material(
        diffuse=(0.006449, 0.417885, 0.025384), specular=(0.8, 0.8, 0.8),
        shininess=100.0, reflectivity=0.3, glossy_side_length=2.0,
    )
    mat_connector = Material(
        diffuse=(0.048247,) * 3, specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    return SceneNode([
        robot_base(mat_metal, mat_connector),
        robot_torso(mat_metal, mat_connector),
        robot_head(mat_metal, mat_connector),
    ])


def clock():
    mat_case = Material(diffuse=(1, 1, 1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_time_bg = Material(diffuse=(0.059252,) * 3)
    mat_time = Material(diffuse=(1.0, 0.0, 0.0))
    angle = -6.62911
    return SceneNode([
        SceneNode(Geometry(Mesh(_load("robot_base_clock_case.obj"), Shading.Smooth), mat_case))
            .rotated_x(deg(angle)).translated((0.0, 1.228179, 0.350087)),
        SceneNode(Geometry(Plane(), mat_time_bg)).scaled((2.966855, 1.0, 0.684205))
            .rotated_x(deg(90.0 + angle)).translated((0.0, 1.294323, 0.919223)),
        SceneNode(Geometry(Mesh(_load("robot_base_clock_time.obj"), Shading.Flat), mat_time))
            .rotated_x(deg(83.2518 - 90.0)).translated((0.0, 1.535768, 0.921095)),
    ])


def clock_buttons():
    mat_button = Material(
        diffuse=(0.8, 0.103095, 0.086502), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    button = SceneNode(
        Geometry(Mesh(_load("robot_base_clock_button.obj"), Shading.Smooth), mat_button)
    )
    return SceneNode([
        SceneNode(button).rotated_x(deg(15.0)).translated((x, 1.7, -0.2))
        for x in (-1.2, -0.4, 0.4, 1.2)
    ])


def base_connectors(mat_connector):
    connector = SceneNode(
        Geometry(KDMesh(_load("robot_base_connector.obj"), Shading.Flat), mat_connector)
    )
    return SceneNode([
        SceneNode(connector).translated((0.0, 1.960454 + i * 0.2, -0.712655))
        for i in range(5)
    ])


def robot_base(mat_metal, mat_connector):
    return SceneNode([
        SceneNode(Geometry(KDMesh(_load("robot_base.obj"), Shading.Smooth), mat_metal))
            .translated((0.0, 1.002795, -0.209603)),
        SceneNode(Geometry(KDMesh(_load("robot_base_sides.obj"), Shading.Flat), mat_metal))
            .translated((0.0, 1.002795, -0.209603)),
        clock(),
        clock_buttons(),
        base_connectors(mat_connector),
    ])


def arm_sockets():
    mat_socket = Material(diffuse=(1, 1, 1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    model = _load("robot_arm_socket.obj")
    return SceneNode([
        SceneNode(Geometry(Mesh(model, Shading.Smooth), mat_socket))
            .translated((2.1, 3.8, -0.7)),
        SceneNode(Geometry(Mesh(model, Shading.Smooth), mat_socket))
            .rotated_y(deg(180.0)).translated((-2.1, 3.8, -0.7)),
    ])


def arms(mat_metal):
    mat_hand = Material(diffuse=(1, 1, 1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    return SceneNode([
        SceneNode(Geometry(Mesh(_load("robot_arm_left.obj"), Shading.Smooth), mat_metal))
            .translated((2.1, 3.8, -0.7)),
        SceneNode(Geometry(Mesh(_load("robot_arm_right.obj"), Shading.Smooth), mat_metal))
            .translated((-2.1, 3.8, -0.7)),
        SceneNode(Geometry(Mesh(_load("robot_hand_left.obj"), Shading.Smooth), mat_hand))
            .translated((2.95, 5.45, -0.7)),
        SceneNode(Geometry(Mesh(_load("robot_hand_right.obj"), Shading.Smooth), mat_hand))
            .translated((-2.95, 5.45, -0.7)),
    ])


def torso_connectors(mat_connector):
    connector = SceneNode(
        Geometry(KDMesh(_load("robot_torso_connector.obj"), Shading.Flat), mat_connector)
    )
    return SceneNode([
        SceneNode(connector).translated((0.0, 4.783508 + i * 0.2, -0.712655))
        for i in range(4)
    ])


def robot_torso(mat_metal, mat_connector):
    mat_display = Material(
        diffuse=(0.204899, 0.066919, 0.086002), reflectivity=0.1,
        refraction_index=OPTICAL_GLASS_REFRACTION_INDEX,
    )
    mat_text = Material(diffuse=(1.0, 0.0, 0.0))
    return SceneNode([
        SceneNode(Geometry(KDMesh(_load("robot_torso.obj"), Shading.Smooth), mat_metal))
            .translated((0.0, 3.781665, -0.7)),
        SceneNode(Geometry(KDMesh(_load("robot_torso_sides.obj"), Shading.Flat), mat_metal))
            .translated((0.0, 3.781665, -0.7)),
        SceneNode(Geometry(Mesh(_load("robot_torso_display.obj"), Shading.Smooth), mat_display))
            .translated((0.0, 3.828179, -0.255186)),
        SceneNode(Geometry(Mesh(_load("robot_torso_text.obj"), Shading.Flat), mat_text))
            .translated((-0.016937, 3.806762, 0.040324)),
        arm_sockets(),
        arms(mat_metal),
        torso_connectors(mat_connector),
    ])


def head_connectors(mat_connector):
    connector = SceneNode(
        Geometry(KDMesh(_load("robot_head_connector.obj"), Shading.Flat), mat_connector)
    )
    nodes = []
    for x in (-0.6, 0.6):
        for i in range(3):
            nodes.append(
                SceneNode(connector).translated((x, 6.583508 + i * 0.2, -0.712655))
            )
    return SceneNode(nodes)


def robot_head(mat_metal, mat_connector):
    mat_smile = Material(diffuse=(0, 0, 0), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_eyeball = Material(diffuse=(1, 1, 1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_pupil = Material(diffuse=(0, 0, 0), specular=(0.3, 0.3, 0.3), shininess=25.0)

    eyeball = SceneNode([
        SceneNode(Geometry(Mesh(_load("robot_eyeball.obj"), Shading.Smooth), mat_eyeball)),
        SceneNode(Geometry(Mesh(_load("robot_pupil.obj"), Shading.Smooth), mat_pupil)),
    ])
    return SceneNode([
        SceneNode(Geometry(KDMesh(_load("robot_head.obj"), Shading.Smooth), mat_metal))
            .translated((0.0, 5.95, -0.7)),
        SceneNode(Geometry(KDMesh(_load("robot_head_sides.obj"), Shading.Flat), mat_metal))
            .translated((0.0, 5.95, -0.7)),
        SceneNode(Geometry(Mesh(_load("robot_smile.obj"), Shading.Smooth), mat_smile))
            .translated((0.0, 6.137964, -0.117689)),
        head_connectors(mat_connector),
        SceneNode(eyeball).translated((-0.6, 7.53, -0.7)),
        SceneNode(eyeball).translated((0.6, 7.53, -0.7)),
    ])


def build() -> SceneSpec:
    scene = Scene(
        root=SceneNode([room(), robot()]),
        lights=[
            Light(position=(-2.0, 15.0, 5.0), color=(0.9, 0.9, 0.9),
                  area=Parallelogram(a=(5.0, 0.0, 0.0), b=(0.0, 0.0, 5.0))),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(1.914036, 3.826548, 20.213762),
        center=(-3.201259, 4.146196, -14.407373),
        up=(0.0, 1.0, 0.0), fovy=deg(23.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(1920, 1080),
                     background=robot_background, name="robot-alarm-clock")
