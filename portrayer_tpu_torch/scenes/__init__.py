"""The port's scene programs (counterpart of ``scenes/``): one module per
example of the reference, each with ``build() -> SceneSpec``, built from
the port's own description classes, so that nothing here needs JAX.

Programs that load meshes or images read them from the asset folder
(``common.asset``: ``PORTRAYER_ASSETS``, read at each call); a missing
file raises ``FileNotFoundError`` naming it.  ``names()`` lists the
programs in the JAX package's registry order.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Tuple

from ..camera import CameraSettings
from ..scene import Scene


@dataclasses.dataclass
class SceneSpec:
    scene: Scene
    camera: CameraSettings
    size: Tuple[int, int]          # (width, height)
    background: Callable
    name: str
    golden: Optional[str] = None   # the reference's render of this example, by file name
    # Per-round bounce-queue capacity hint (RenderConfig.queue_caps); None
    # = auto.
    queue_caps: Optional[Tuple[float, ...]] = None


from .common import sky_background, white_background, deg  # noqa: E402

_REGISTRY = {
    "simple": ("simple", None),
    "primitives-simple": ("primitives_simple", "01a_primitives-simple.png"),
    "primitives": ("primitives", "01b_primitives.png"),
    "smooth-shading": ("smooth_shading", "02_smooth-shading.png"),
    "antialiasing": ("antialiasing", "03_antialiasing.png"),
    "normal-mapping": ("normal_mapping", "04a_normal-mapping.png"),
    "texture-mapping": ("texture_mapping", "05a_texture-mapping.png"),
    "cube-mapping": ("cube_mapping", "05b_cube-mapping.png"),
    "water-glass": ("water_glass", "06a_water-glass.png"),
    "transmission-refraction": ("transmission_refraction", "06b_transmission-refraction.png"),
    "glossy-reflection": ("glossy_reflection", "07_glossy-reflection.png"),
    "soft-shadows": ("soft_shadows", "08_soft-shadows.png"),
    "entering-the-mirror-dimension": ("mirror_dimension", "entering-the-mirror-dimension.png"),
    "big-scene": ("big_scene", None),
    "instance": ("instance", None),
    "hier": ("hier", None),
    "nonhier": ("nonhier", None),
    "nonhier2": ("nonhier2", None),
    "single-triangle": ("single_triangle", None),
    "four-shapes": ("four_shapes", None),
    "simple-cows": ("simple_cows", None),
    "macho-cows": ("macho_cows", None),
    "monkeys-making-monkeys": ("monkeys_making_monkeys", None),
    "fish": ("fish", None),
    "graphics-poster": ("graphics_poster", None),
    "graphics-temple": ("graphics_temple", None),
    "graphics-castle": ("graphics_castle", None),
    "robot-alarm-clock": ("robot_alarm_clock", "10_robot-alarm-clock_green.png"),
    "torus-showcase": ("torus_showcase", None),
}

# The programs that read no asset file.
ASSET_FREE = ("simple", "primitives-simple", "glossy-reflection", "big-scene",
              "single-triangle", "four-shapes", "torus-showcase")


def names():
    return list(_REGISTRY)


def load(name: str) -> SceneSpec:
    mod_name, golden = _REGISTRY[name]
    spec = importlib.import_module(f"{__name__}.{mod_name}").build()
    spec.golden = golden
    return spec
