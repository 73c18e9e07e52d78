"""examples/soft-shadows.rs (``scenes/soft_shadows.py``) — point vs area light."""

from .. import (
    Scene, SceneNode, Geometry, Cube, Plane, Mesh, MeshData, Shading,
    Material, Light, Parallelogram, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build() -> SceneSpec:
    mat_cow = Material(
        diffuse=(0.37168, 0.236767, 0.692066), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    mat_wall_floor = Material(
        diffuse=(0.627459, 0.8, 0.589836), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    cow = MeshData.load_obj(asset("cow.obj"))

    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Plane(), mat_wall_floor)).scaled(30.0),
            SceneNode(Geometry(Cube(), mat_wall_floor)).scaled((0.2, 20.0, 20.0))
                .translated((0.0, 8.0, 8.0)),
            SceneNode(Geometry(Cube(), mat_wall_floor)).scaled((30.0, 30.0, 0.4))
                .translated((0.0, 8.0, -2.0)),
            SceneNode(Geometry(Mesh(cow, Shading.Smooth), mat_cow))
                .scaled(0.5).rotated_y(deg(-15.0)).translated((-4.2, 1.8, 4.0)),
            SceneNode(Geometry(Mesh(cow, Shading.Smooth), mat_cow))
                .scaled(0.5).rotated_y(deg(195.0)).translated((4.2, 1.8, 4.0)),
        ]),
        lights=[
            Light(position=(-2.0, 2.0, 16.0), color=(0.5, 0.5, 0.5)),
            Light(position=(2.0, 2.0, 16.0), color=(0.5, 0.5, 0.5),
                  area=Parallelogram(a=(0.0, 0.5, 0.0), b=(0.5, 0.0, 0.0))),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 5.04746, 24.827951), center=(0.012231, -0.459716, -15.800501),
        up=(0.0, 1.0, 0.0), fovy=deg(25.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="soft-shadows")
