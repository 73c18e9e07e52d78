"""A configuration's scene family: the builder that hands its scene to the
program and the plain reference that renders it, two files found by the
family's name, as traffic mixes, limits and metric readers are found by
theirs.  A configuration names its family with ``"scene": "<family>"``:

- ``portbench/harness/scene_<family>.py``: ``build(T, data) -> (scene,
  camera settings, background, overrides)``, where `overrides` holds the
  ``RenderConfig`` fields the configuration fixes (``queue_caps``, ...);
- ``portbench/reference/render_<family>.py``: ``reference_frame(data,
  traffic, seed, device, dtype) -> u8 [H, W, 3]`` in plain PyTorch,
  importing nothing of the program; and, where the family compares more
  than the frame, ``numbers(record) -> {name: number}``, each number with
  a limit in the cell's limits file.  `record` is the run's record (see
  ``mode_render.run``), with ``"stats"``: the ``TraceStats`` of each chunk
  of one frame rendered after the window.

A configuration without ``"scene"`` is of the first family: the builder
``harness/scene.py`` (whose three-tuple ``build`` ``harness/fit.py``
shares) and the reference ``reference/render.py``."""

from __future__ import annotations

import importlib.util
import os

from . import bench
from . import scene as first_builder


def _load(bench_dir: str, package: str, stem: str):
    """<bench_dir>/<package>/<stem>.py as the module <package>.<stem>, so
    that its relative imports reach the package's other modules."""
    path = os.path.join(bench_dir, package, f"{stem}.py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: the scene family needs {path}")
    spec = importlib.util.spec_from_file_location(f"{package}.{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Family:
    """The builder and reference modules of one family."""

    def __init__(self, name: str | None, builder, reference):
        self.name, self.builder, self.reference = name, builder, reference

    def build(self, T, data: dict):
        """(scene, camera settings, background, RenderConfig overrides)."""
        if self.name is None:
            caps = data.get("queue_caps")
            return (*self.builder.build(T, data),
                    {"queue_caps": None if caps is None else tuple(caps)})
        return self.builder.build(T, data)

    @property
    def numbers(self):
        """The reference's ``numbers``, or None where it compares only the
        frame."""
        return getattr(self.reference, "numbers", None)


def lookup(data: dict) -> Family:
    """The family of the configuration `data`, its files under the
    benchmark's folder (``bench.BENCH_DIR``)."""
    name = data.get("scene")
    if name is None:
        from reference import render

        return Family(None, first_builder, render)
    return Family(name, _load(bench.BENCH_DIR, "harness", f"scene_{name}"),
                  _load(bench.BENCH_DIR, "reference", f"render_{name}"))
