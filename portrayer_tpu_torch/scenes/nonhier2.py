"""examples/nonhier2.rs (``scenes/nonhier2.py``) — nonhier with a root translation."""

from .. import Scene, SceneNode, Light, CameraSettings
from . import SceneSpec
from .common import sky_background, deg
from .nonhier import _nodes


def build() -> SceneSpec:
    scene = Scene(
        root=SceneNode(_nodes()).translated((0.0, 0.0, -800.0)),
        lights=[
            Light(position=(-100.0, 150.0, -400.0), color=(0.9, 0.9, 0.9)),
            Light(position=(400.0, 100.0, -650.0), color=(0.7, 0.0, 0.7)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 0.0, 0.0), center=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0), fovy=deg(50.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=sky_background, name="nonhier2")
