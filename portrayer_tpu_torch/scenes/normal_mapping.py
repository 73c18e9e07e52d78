"""examples/normal-mapping.rs (``scenes/normal_mapping.py``) (main light config:
normal-mapping.png; the -left/-right variants differ only in light pos)."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Material, Light,
    CameraSettings, Texture, ImageTexture, NormalMap,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build(light_pos=(0.0, 8.0, 10.0)) -> SceneSpec:
    tex_plane = Texture(ImageTexture(asset("Terracotta_Tiles_002_Base_Color.jpg")))
    norm_plane = NormalMap(asset("Terracotta_Tiles_002_Normal.jpg"))
    mat_tex_plane = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.4, 0.4, 0.4),
        shininess=25.0, texture=tex_plane,
    )
    mat_tex_plane_norm = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.4, 0.4, 0.4),
        shininess=25.0, texture=tex_plane, normals=norm_plane,
    )

    tex_sphere = Texture(ImageTexture(asset("Rock_033_baseColor_2.jpg")))
    norm_sphere = NormalMap(asset("Rock_033_normal_2.jpg"))
    mat_tex_sphere = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.6, 0.6, 0.6),
        shininess=25.0, texture=tex_sphere,
    )
    mat_tex_sphere_norm = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.6, 0.6, 0.6),
        shininess=25.0, texture=tex_sphere, normals=norm_sphere,
    )

    tex_cube = Texture(ImageTexture(asset("Stone_Wall_007_COLOR_cubemap.jpg")))
    norm_cube = NormalMap(asset("Stone_Wall_007_NORM_cubemap.jpg"))
    mat_tex_cube = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.3, 0.3, 0.3),
        shininess=25.0, texture=tex_cube,
    )
    mat_tex_cube_norm = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.3, 0.3, 0.3),
        shininess=25.0, texture=tex_cube, normals=norm_cube,
    )

    mat_wall_floor = Material(
        diffuse=(0.424858, 0.531206, 0.8), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )

    root = SceneNode([
        SceneNode(Geometry(Plane(), mat_wall_floor)).scaled(40.0).translated((0.0, -1.0, 0.0)),
        # Left — texture only
        SceneNode(Geometry(Plane(), mat_tex_plane)).scaled(6.0)
            .rotated_x(deg(90.0)).translated((-4.0, 2.0, -6.0)),
        SceneNode(Geometry(Cube(), mat_tex_cube)).scaled(2.0).translated((-7.0, 0.0, -1.0)),
        SceneNode(Geometry(Sphere(), mat_tex_sphere)).translated((-7.0, 2.0, -1.0)),
        SceneNode(Geometry(Cube(), mat_tex_cube)).scaled(2.0).translated((-2.0, 0.0, 3.0)),
        SceneNode(Geometry(Sphere(), mat_tex_sphere)).translated((-2.0, 2.0, 3.0)),
        # Right — texture + normal map
        SceneNode(Geometry(Plane(), mat_tex_plane_norm)).scaled(6.0)
            .rotated_x(deg(90.0)).translated((4.0, 2.0, -6.0)),
        SceneNode(Geometry(Cube(), mat_tex_cube_norm)).scaled(2.0).translated((7.0, 0.0, -1.0)),
        SceneNode(Geometry(Sphere(), mat_tex_sphere_norm)).translated((7.0, 2.0, -1.0)),
        SceneNode(Geometry(Cube(), mat_tex_cube_norm)).scaled(2.0).translated((2.0, 0.0, 3.0)),
        SceneNode(Geometry(Sphere(), mat_tex_sphere_norm)).translated((2.0, 2.0, 3.0)),
    ])

    scene = Scene(
        root=root,
        lights=[Light(position=light_pos, color=(0.9, 0.9, 0.9))],
        ambient=(0.2, 0.2, 0.2),
    )
    cam = CameraSettings(
        eye=(0.0, 8.07551, 23.078941), center=(0.0, -2.854475, -16.437334),
        up=(0.0, 1.0, 0.0), fovy=deg(22.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="normal-mapping")
