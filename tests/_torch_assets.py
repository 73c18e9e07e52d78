"""Stand-in asset files for the scene programs that load meshes and images.

``write_standins(directory, seed)`` writes, under the exact names that the
programs load (``robot-alarm-clock/`` included), a seeded file for each:

- ``.obj``: a jittered icosphere (320 triangles) with ``v``, ``vt`` and
  ``vn`` lines and ``f v/vt/vn`` faces, so that smooth shading and texture
  coordinates are exercised;
- ``.png``: a seeded RGB image of 16 to 64 pixels a side, written by the
  port's PNG encoder;
- ``.jpg``: a copy of one of the JPEG fixtures of ``tests/data/jpeg/``
  (``normal_444.jpg`` for normal maps, else ``colour_420.jpg`` or
  ``grey.jpg`` in turn).

The names come from reading the programs' sources (``asset("...")`` and
their ``_load("...")`` mesh loaders), not from a list kept here.  This
module imports neither JAX nor the JAX package: ``chip_smoke.py`` imports
it on the card.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import zlib

import numpy as np

from _torch_jax import _icosphere

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT_SCENES = os.path.join(ROOT, "portrayer_tpu_torch", "scenes")
JPEG_FIXTURES = os.path.join(HERE, "data", "jpeg")

_ASSET = re.compile(r'asset\("([^"]+)"\)')
_LOAD = re.compile(r'_load\("([^"]+)"\)')
_LOAD_PREFIX = re.compile(r'def _load\(name\):.*?asset\((?:"([^"]*)" \+ )?name\)', re.S)


def asset_names(scene_dir: str = PORT_SCENES) -> dict:
    """{program module: sorted asset names it loads} over the scene
    programs in `scene_dir` (the port's, or the JAX package's ``scenes/``)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(scene_dir, "*.py"))):
        src = open(path).read()
        names = set(_ASSET.findall(src))
        loader = _LOAD_PREFIX.search(src)
        if loader:
            names.update((loader.group(1) or "") + n for n in _LOAD.findall(src))
        if names:
            out[os.path.splitext(os.path.basename(path))[0]] = sorted(names)
    return out


def all_asset_names(scene_dir: str = PORT_SCENES) -> list:
    return sorted({n for names in asset_names(scene_dir).values() for n in names})


def obj_text(rng) -> str:
    """A jittered icosphere as OBJ text, one v/vt/vn triple per vertex."""
    unit, faces = _icosphere(2)
    pos = unit * rng.uniform(0.85, 1.15, (len(unit), 1))
    u = 0.5 + np.arctan2(unit[:, 2], unit[:, 0]) / (2.0 * np.pi)
    v = np.arccos(np.clip(unit[:, 1], -1.0, 1.0)) / np.pi
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vt {a:.6f} {b:.6f}" for a, b in zip(u, v)]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in unit]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in f) for f in faces]
    return "\n".join(lines) + "\n"


def _is_normal_map(name: str) -> bool:
    return "nor" in os.path.basename(name).lower()


def write_standins(directory, seed: int = 0, scene_dir: str = PORT_SCENES) -> list:
    """Write a stand-in for every asset the programs in `scene_dir` load
    into `directory`; returns the names written."""
    import sys

    sys.path.insert(0, ROOT)
    from portrayer_tpu_torch.image_io import encode_png

    names = all_asset_names(scene_dir)
    colour_or_grey = ("colour_420.jpg", "grey.jpg")
    plain_jpgs = [n for n in names if n.endswith(".jpg") and not _is_normal_map(n)]
    for name in names:
        path = os.path.join(directory, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
        if name.endswith(".obj"):
            with open(path, "w") as f:
                f.write(obj_text(rng))
        elif name.endswith(".png"):
            h, w = rng.integers(16, 65, 2)
            with open(path, "wb") as f:
                f.write(encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        elif name.endswith(".jpg"):
            fixture = ("normal_444.jpg" if _is_normal_map(name)
                       else colour_or_grey[plain_jpgs.index(name) % 2])
            shutil.copyfile(os.path.join(JPEG_FIXTURES, fixture), path)
        else:
            raise ValueError(f"no stand-in for {name}")
    return names
