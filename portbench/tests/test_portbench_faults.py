"""`correct` comes out false for the control and for each fault a render
cell can have, planted in the timed path underneath a run that skips the
look for a card and runs at a size the CPU holds; a sound run comes out
true.  (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import render as program_render
from harness import bench
from control import control_readings

from _small import small_cell

CELLS = ["glossy-reflection.spp100", "big-scene.spp1"]
SEED = 2**31 + 99


def run(workload, size=(48, 27)):
    spec, data, traffic, limits = small_cell(workload, size)
    return bench.run_cell(T, data, traffic, limits, SEED, 0.0, False, "cpu", 0.0)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    rec = run(workload)
    assert rec["correct"], rec["checks"]


def _state_unchanged(monkeypatch):
    """A render that leaves the image as it was."""
    monkeypatch.setattr(T.Image, "render", lambda self, *a, **k: self)


def _half_the_batch(monkeypatch):
    """Each chunk traces the first half of its lanes, at twice the weight:
    the mean over the rest."""
    orig = program_render._tile_rays

    def tile_rays(*a, **k):
        o, d, pix, bg, w = orig(*a, **k)
        keep = torch.arange(w.shape[0], device=w.device) < w.shape[0] // 2
        return o, d, pix, bg, torch.where(keep, 2.0 * w, 0.0)

    monkeypatch.setattr(program_render, "_tile_rays", tile_rays)


def _answer_altered(monkeypatch):
    """One tile's pixels inverted where the frame is assembled."""
    orig = program_render._render_tiles

    def render_tiles(*a, **k):
        out = orig(*a, **k)
        out[len(out) // 2] = 255 - out[len(out) // 2]
        return out

    monkeypatch.setattr(program_render, "_render_tiles", render_tiles)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    rec = run(workload)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    spec, data, traffic, limits = small_cell(workload)
    for reading in control_readings(data, traffic, [SEED, 3], "cpu"):
        ok, checks = bench.judge(reading, limits)
        assert not ok, checks


@pytest.mark.cuda
def test_the_cell_runs_on_the_card(card):
    """A short run of each cell at its own size on the card, correct."""
    spec = bench.Spec()
    for workload in CELLS:
        cell = spec.cell(workload)
        rec = bench.run_cell(T, spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                             spec.limits(workload), SEED, 0.0, False, card, 0.0)
        assert rec["correct"], rec["checks"]
