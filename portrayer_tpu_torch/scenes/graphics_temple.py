"""examples/graphics-temple.rs (``scenes/graphics_temple.py``):
"The Temple of Computer Graphics".

The reference scene is an unfinished WIP (placeholder red materials,
floor-1 maze generator stubbed out); this port reproduces it as-is.
"""

from .. import (
    Scene, SceneNode, Geometry, Cube, Sphere, Cylinder, Mesh, KDMesh,
    MeshData, Shading, Material, Light, CameraSettings,
    WATER_REFRACTION_INDEX,
)
from . import SceneSpec
from .common import deg, asset
from .robot_alarm_clock import robot_background

_cache = {}


def _load(name):
    path = asset(name)
    if path not in _cache:
        _cache[path] = MeshData.load_obj(path)
    return _cache[path]


_PLACEHOLDER = dict(diffuse=(1.0, 0.0, 0.0), specular=(0.3, 0.3, 0.3), shininess=25.0)


def hills():
    mat_grass = Material(diffuse=(0.376, 0.502, 0.22))
    return SceneNode(
        Geometry(KDMesh(_load("tog_grass.obj"), Shading.Smooth), mat_grass)
    ).translated((1.958125, 16.093138, -86.113747))


def lake():
    mat_water = Material(
        diffuse=(0.0, 0.0, 0.1), specular=(0.5, 0.5, 0.5), shininess=100.0,
        reflectivity=0.9, glossy_side_length=1.0,
        refraction_index=WATER_REFRACTION_INDEX,
    )
    mat_dirt = Material(diffuse=(0.592, 0.671, 0.055))
    return SceneNode([
        SceneNode(Geometry(Cube(), mat_water)).scaled((600.0, 200.0, 600.0))
            .translated((0.0, -107.0, 300.0)),
        SceneNode(Geometry(KDMesh(_load("tog_underwater_land.obj"), Shading.Flat), mat_dirt))
            .translated((0.0, -107.0, 300.0)),
    ])


def cylinder_column(mat):
    return SceneNode([
        SceneNode(Geometry(Cube(), mat)).scaled((3.2, 1.0, 3.2)).translated((0.0, 3.8, 0.0)),
        SceneNode(Geometry(Cube(), mat)).scaled((3.2, 1.0, 3.2)).translated((0.0, -3.8, 0.0)),
        SceneNode(Geometry(Sphere(), mat)).scaled((1.5, 0.5, 1.5)).translated((0.0, 3.0, 0.0)),
        SceneNode(Geometry(Sphere(), mat)).scaled((1.5, 0.5, 1.5)).translated((0.0, -3.0, 0.0)),
        SceneNode(Geometry(Cylinder(), mat)).scaled((2.0, 6.0, 2.0)),
    ]).translated((0.0, 4.3, 0.0))


def temple_floor_1():
    # floor-1 maze generation is a stub in the reference — contributes no nodes
    return SceneNode([])


def temple_floor_2():
    floor_width, floor_height, floor_length = 168.0, 20.0, 32.0
    floor_y_offset = 20.0
    floor_front_z = floor_length / 2.0
    sections, section_width = 4, 30.0
    column_scale = 2.0
    column_diameter = 3.2 * column_scale
    column_height = 8.6 * column_scale
    section_spacing = (
        floor_width - column_diameter - sections * section_width
    ) / (sections - 1)

    mat_column = Material(**_PLACEHOLDER)
    nodes = []
    column = cylinder_column(mat_column)
    for i in range(sections * 2):
        x = (
            section_width * ((i + 1) // 2)
            + section_spacing * (i // 2)
            - floor_width / 2.0 + column_diameter / 2.0
        )
        for z in (floor_front_z - column_diameter / 2.0, -(floor_front_z - column_diameter / 2.0)):
            nodes.append(
                SceneNode(column).scaled(column_scale).translated((x, floor_y_offset, z))
            )

    ceiling_height = floor_height - column_height
    nodes.append(
        SceneNode(Geometry(Cube(), mat_column))
        .scaled((floor_width, ceiling_height, floor_length))
        .translated((0.0, floor_y_offset + column_height + ceiling_height / 2.0, 0.0))
    )

    mat_idol = Material(**_PLACEHOLDER)
    extent = min(section_width, column_height)
    base_idol = SceneNode(Geometry(Cube(), mat_idol)).scaled(extent * 0.5).rotated_y(deg(30.0))
    idols = [
        SceneNode(base_idol),
        SceneNode(base_idol).scaled((1.0, 0.4, 1.0)),
        SceneNode(base_idol).rotated_z(deg(80.0)),
        SceneNode([
            SceneNode(base_idol).scaled(0.5)
                .translated((-extent / 4.0, extent / 8.0, -floor_length / 8.0)),
            SceneNode(base_idol).scaled(0.5)
                .translated((extent / 4.0, -extent / 8.0, floor_length / 8.0)),
        ]),
    ]
    for i, idol in enumerate(idols):
        x = (
            section_width * (i + 1) + section_spacing * i
            - floor_width / 2.0 - section_width / 2.0 + column_diameter / 2.0
        )
        nodes.append(idol.translated((x, floor_y_offset + column_height / 2.0, 0.0)))
    return SceneNode(nodes)


def temple_floor_3():
    floor_width, floor_length, floor_height = 117.6, 25.6, 20.0
    floor_y_offset = 40.0
    puppet_height = 17.2
    puppet_y_offset = 44.083061
    ceiling_height = floor_height - puppet_height
    ceiling_y_offset = floor_y_offset + puppet_height + ceiling_height / 2.0

    mat_puppet = Material(**_PLACEHOLDER)
    mat_ceiling = Material(**_PLACEHOLDER)
    puppet = SceneNode(
        Geometry(KDMesh(_load("tog_puppet.obj"), Shading.Smooth), mat_puppet)
    ).translated((0.0, puppet_y_offset, 0.0))

    return SceneNode([
        SceneNode(Geometry(Cube(), mat_ceiling))
            .scaled((floor_width, ceiling_height, floor_length))
            .translated((0.0, ceiling_y_offset, 0.0)),
        SceneNode(puppet).rotated_y(deg(90.0)).translated((-55.1, 0.0, 0.0)),
        SceneNode(puppet).translated((0.0, 0.0, -5.0)),
        SceneNode(puppet).rotated_y(deg(-90.0)).translated((55.1, 0.0, 0.0)),
    ])


def temple_floor_4():
    mat_crystal = Material(**_PLACEHOLDER)
    return SceneNode([
        SceneNode(Geometry(Mesh(_load("monkey.obj"), Shading.Smooth), mat_crystal))
            .scaled(8.0).rotated_xzy((deg(-34.9072), deg(25.0), deg(0.0)))
            .translated((-30.0, 64.214905, 1.0)),
        SceneNode(Geometry(KDMesh(_load("teapot.obj"), Shading.Smooth), mat_crystal))
            .scaled(0.6).rotated_y(deg(-55.0)).translated((0.0, 59.857296, 0.0)),
        SceneNode(Geometry(KDMesh(_load("cow.obj"), Shading.Smooth), mat_crystal))
            .scaled(1.5).rotated_y(deg(-125.0)).translated((30.0, 65.31517, 0.0)),
    ])


def build() -> SceneSpec:
    mat_temple_block = Material(diffuse=(0.913099, 0.913099, 0.715694),
                                specular=(0.3, 0.3, 0.3), shininess=25.0)
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Cube(), mat_temple_block))
                .scaled((240.0, 20.0, 40.0)).translated((0.0, 10.0, 0.0)),
            hills(), lake(),
            temple_floor_1(), temple_floor_2(), temple_floor_3(), temple_floor_4(),
        ]),
        lights=[Light(position=(190.0, 98.0, 151.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 61.971188, 546.971191), center=(0.0, -13.390381, -585.524353),
        up=(0.0, 1.0, 0.0), fovy=deg(25.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(533, 300),
                     background=robot_background, name="graphics-temple",
                     # The JAX package's hint, from the full frame's live
                     # fractions on the real assets (96x54, uncapped: 0.67,
                     # 0.35, 0.11, 0.10, 0.066, 0.056, 0.051, 0.030, 0.016,
                     # 0.015), ~2x headroom.
                     queue_caps=(1.0, 0.75, 0.25))
