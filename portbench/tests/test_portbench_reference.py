"""The plain reference against the program at frames the CPU can hold:
both configurations' renders and the fit, and the frozen threefry against
the program's draws."""

import pytest
import torch

import portrayer_tpu_torch as T
from harness import check, mode_render
from harness import fit as HF
from reference import fit as RF
from reference import threefry as tf

from _small import small_cell


@pytest.mark.parametrize("workload,size", [
    ("glossy-reflection.spp100", (48, 27)),
    ("glossy-reflection.spp100", (70, 33)),
    ("big-scene.spp1", (66, 34)),
])
def test_reference_frame_matches_the_program(workload, size):
    spec, data, traffic, limits = small_cell(workload, size)
    cell = mode_render.RenderCell(T, data, traffic, 2**31 + 77, "cpu")
    cell.render()
    numbers = check.compare_frames(cell.image.buffer,
                                   check.reference_frame(data, traffic, 2**31 + 77, "cpu"))
    # At most one pixel apart: a sample at a silhouette that the two sides'
    # roundings put on either side of it.
    assert numbers["off_share"] * size[0] * size[1] <= 1.0
    assert numbers["mean_abs"] < 0.05


def test_threefry_matches_the_program_draws():
    from portrayer_tpu_torch import rng

    for seed in (0, 7, 2**31 + 5):
        k = tf.fold(tf.fold(tf.key(seed, "cpu"), 3), 1)
        pk = rng.fold_in(rng.fold_in(rng.PRNGKey(seed), 3), 1)
        assert torch.equal(k, pk)
        assert torch.equal(tf.uniform_at(k, torch.arange(64)), rng.uniform(pk, (64,), "cpu"))
        sid = torch.arange(0, 5000, 7)
        lanes = tf.fold(k, sid)
        assert torch.equal(lanes, rng.fold_in(pk, sid))
        assert torch.equal(tf.uniform_at(lanes[:, None, :], torch.arange(2)[None, :]),
                           rng.uniform_lanes(rng.fold_in(pk, sid), 2))


@pytest.fixture(scope="module")
def fit_runs():
    """Three steps of the program's fit through each sweep, and the
    reference's, at 48x27 from seed 5's start."""
    _, data, _, _ = small_cell("glossy-reflection.spp100", (48, 27))
    start = HF.perturb(data, 5)
    out = {"reference": RF.follow(data, start, "cpu", 5, 1, 3)}
    for accel in ("cuda", "flat"):
        f = HF.Fit(T, data, start, 5, 1, "cpu", accel=accel)
        p0, losses, first = f.params(), [], None
        for _ in range(3):
            losses.append(float(f.step()))
            first = f.first_gradient() if first is None else first
        out[accel] = (losses, first, p0, f.params())
        f.close()
    return out


@pytest.mark.parametrize("accel", ["cuda", "flat"])
def test_first_fit_step_matches_the_reference(fit_runs, accel):
    losses, first, _, _ = fit_runs[accel]
    r_losses, r_first, _, _ = fit_runs["reference"]
    assert losses[0] == pytest.approx(r_losses[0], rel=1e-6)
    for k, g in r_first.items():
        assert float(first[k].norm()) == pytest.approx(float(g.norm()), rel=1e-5, abs=1e-12)


def test_three_fit_steps_through_the_flat_sweep_match_the_reference(fit_runs):
    """The flat sweep reads the tables the fit updates; the reference
    follows it over three steps (the kernel's sweep reads the packed
    tables of the start: PERF.md, Open questions)."""
    losses, _, p0, p3 = fit_runs["flat"]
    r_losses, _, r0, r3 = fit_runs["reference"]
    assert losses == pytest.approx(r_losses, rel=1e-5)
    for k in r3:
        assert float((p3[k] - p0[k]).norm()) == pytest.approx(float((r3[k] - r0[k]).norm()),
                                                               rel=1e-4, abs=1e-9)
