"""The port's multi-device path (portrayer_tpu_torch.parallel) against the
JAX package's, mirroring tests/test_multichip.py.

The port's ranks are gloo processes on the CPU (tests/_torch_parallel_worker.py,
one world size after another, PYTHONPATH the repo root only); the JAX
side runs here on its 8 virtual devices.  Both take the same numpy rays and
keys.

Tolerances, with their reasons:
- trace_sharded against JAX's at the same shard count: the image gate of
  tests/test_torch_render.py on acc / spp (at most 1% of pixels off by
  more than 1e-4, none by 2e-2): JAX's shard_map is jitted, and XLA
  contracts mul+add into FMA.
- trace_sharded against the port's own single-process shard sum (the
  shards traced one after the other with keys fold_in(key, r)): the
  rtol 1e-5 / atol 1e-5 of tests/test_multichip.py (the same ops; only
  the order of the all-reduce's sum differs).
- train_step against JAX's: loss within rtol 1e-4 and gradients within
  rtol 1e-3 / atol 1e-4 of their largest entry, the tolerance of
  tests/test_torch_grad.py (FMA contraction under jit moves hit points
  and x^(4 shininess) highlights).  The port's world sizes 1, 2 and 4
  against each other: 1e-5 of the largest entry (the order of the sums).
- render_tiles_sharded and render_frame_distributed against JAX's, also
  with a padded grid: the image gate above.  Every rank returns the same
  image, exactly.
- four-shapes sharded through the kernel's plain version against the flat
  sweep: the rtol 2e-4 / atol 2e-4 of tests/test_multichip.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.parallel import (
    make_mesh, trace_sharded, train_step, render_tiles_sharded, DIFF_FIELDS,
)
from portrayer_tpu.parallel.distributed import render_frame_distributed
from portrayer_tpu_torch import parallel as tpar, rng
from portrayer_tpu_torch.parallel.distributed import initialize
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops.trace import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
JCFG = P.RenderConfig(samples=2, tile=(16, 16), node_chunk=64, accel="flat")
# Tasks per world size of the port's runs.
RUNS = {1: "train", 2: "trace,train,tiles,frame,four", 4: "trace,train,pad"}
WORKER_TIMEOUT = 300
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _rays(tile, spp=2):
    """tests/test_multichip.py's rays: simple, pixel centres, spp each."""
    spec = scenes.load("simple")
    st = P.flatten_scene(spec.scene, dtype=jnp.float32)
    cam = JaxCamera(spec.camera, (tile, tile), dtype=jnp.float32)
    ys, xs = np.mgrid[0:tile, 0:tile]
    px = jnp.asarray(np.repeat(xs.reshape(-1), spp), jnp.float32) + 0.5
    py = jnp.asarray(np.repeat(ys.reshape(-1), spp), jnp.float32) + 0.5
    o, d = cam.rays_at(px, py)
    n = tile * tile
    pix = jnp.asarray(np.repeat(np.arange(n), spp), jnp.int32)
    return st, np.array(o), np.array(d), np.array(pix), n


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every world size of RUNS in turn, its ranks started together: {world:
    {task: [npz of each rank]}}."""
    _, o, d, pix, n = _rays(16)
    _, to, td, tpix, tn = _rays(8)
    tmp = str(tmp_path_factory.mktemp("parallel"))
    inp = os.path.join(tmp, "in.npz")
    np.savez(inp, o=o, d=d, pix=pix, bg=np.zeros((n, 3), np.float32), n_pixels=n,
             train_o=to, train_d=td, train_pix=tpix, train_n_pixels=tn)
    env = {k: v for k, v in os.environ.items() if k not in _TORCHRUN_ENV}
    env["PYTHONPATH"] = ROOT  # keeps the container's sitecustomize out
    for world, tasks in RUNS.items():
        out = os.path.join(tmp, f"w{world}")
        os.makedirs(out)
        store = os.path.join(tmp, f"store{world}")
        procs = [subprocess.Popen(
            [sys.executable, WORKER, store, str(world), str(rank), inp, out, tasks],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
        try:
            logs = [(p.communicate(timeout=WORKER_TIMEOUT)[0], p.returncode) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for log, rc in logs:
            assert rc == 0, f"world {world}: a rank failed:\n{log[-3000:]}"
    return {world: {task: [np.load(os.path.join(tmp, f"w{world}", f"{task}_r{r}.npz"))
                           for r in range(world)]
                    for task in tasks.split(",")}
            for world, tasks in RUNS.items()}


def assert_images_close(ours, ref):
    """tests/test_torch_render.py's image gate."""
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert (diff > 1e-4).mean() < 0.01, f"{(diff > 1e-4).mean():.3%} pixels off"
    assert diff.max() < 2e-2, diff.max()


def _same_on_every_rank(results, name):
    for r in results[1:]:
        np.testing.assert_array_equal(r[name], results[0][name])
    return results[0][name]


@pytest.mark.parametrize("world", [2, 4])
def test_trace_sharded_matches_jax_and_shard_sum(port_runs, world):
    st, o, d, pix, n = _rays(16)
    runs = port_runs[world]["trace"]
    acc = _same_on_every_rank(runs, "acc")
    parts = _same_on_every_rank(runs, "parts")
    ref = trace_sharded(make_mesh(world), jax.random.PRNGKey(7), jnp.asarray(o),
                        jnp.asarray(d), jnp.asarray(pix), jnp.zeros((n, 3), jnp.float32), n,
                        st, JCFG)
    assert_images_close(acc.reshape(16, 16, 3) / 2, np.asarray(ref).reshape(16, 16, 3) / 2)
    # The single-process oracle: the shards one after the other.
    tst = T.flatten_scene(tscenes.load("simple").scene, "cpu")
    cfg = T.RenderConfig(device="cpu", samples=2, accel="flat")
    per = o.shape[0] // world
    shards = [trace(rng.fold_in(rng.PRNGKey(7), r), *(torch.from_numpy(x[r * per:(r + 1) * per])
                                                     for x in (o, d, pix)),
                    torch.zeros((n, 3)), n, tst, cfg).numpy() for r in range(world)]
    assert parts.shape == (world, n, 3)
    for r in range(world):
        np.testing.assert_allclose(parts[r], shards[r], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc, sum(shards), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_train():
    """JAX's train_step at make_mesh(1), (2) and (4): (loss, grads)."""
    st, o, d, pix, n = _rays(8)
    out = {}
    for world in (1, 2, 4):
        loss, grads = train_step(make_mesh(world), jax.random.PRNGKey(3), jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(pix), jnp.zeros((n, 3)), n, 2,
                                 jnp.zeros((n, 3), jnp.float32), st, JCFG)
        out[world] = (float(loss), {f: np.asarray(g) for f, g in grads.items()})
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_train_step_matches_jax_at_every_world_size(port_runs, jax_train, world):
    """No world-size factor: the port's loss and every DIFF_FIELDS gradient
    equal JAX's at the same mesh size, and the port's world size 1."""
    runs = port_runs[world]["train"]
    one = port_runs[1]["train"][0]
    jloss, jgrads = jax_train[world]
    loss = float(_same_on_every_rank(runs, "loss"))
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert loss == pytest.approx(float(one["loss"]), rel=1e-5)
    assert set(DIFF_FIELDS) == set(tpar.DIFF_FIELDS)
    for f in DIFF_FIELDS:
        got, ref = _same_on_every_rank(runs, f), jgrads[f]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale, err_msg=f)
        np.testing.assert_allclose(got, one[f], rtol=0, atol=1e-5 * scale, err_msg=f)
    g = runs[0]["mat_diffuse"]
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_render_tiles_sharded_matches_jax(port_runs):
    spec = scenes.load("simple")
    cfg = P.RenderConfig(samples=2, accel="flat", node_chunk=16)
    st = P.flatten_scene(spec.scene, dtype=cfg.dtype)
    ref = render_tiles_sharded(make_mesh(2), st, spec.camera, (24, 20), spec.background, cfg)
    runs = port_runs[2]["tiles"]
    img = _same_on_every_rank(runs, "img")
    assert img.shape == (20, 24, 3) and img.max() > 0
    assert_images_close(img, ref)
    R = 24 * 20 * 2
    for rank, run in enumerate(runs):
        # One make_shard call per rank, for its own block only.
        np.testing.assert_array_equal(run["rows"], [[rank * R // 2, (rank + 1) * R // 2, R,
                                                     R // 2]])


def test_render_frame_distributed_matches_jax(port_runs):
    """Two ranks, each building only its own rows, against JAX's renderer
    over a mesh of 2 devices (the same jitter keys)."""
    spec = scenes.load("simple")
    cfg = P.RenderConfig(samples=2, accel="flat", node_chunk=16)
    st = P.flatten_scene(spec.scene, dtype=cfg.dtype)
    ref = render_frame_distributed(make_mesh(2), st, spec.camera, (32, 32), spec.background,
                                   cfg)
    runs = port_runs[2]["frame"]
    img = _same_on_every_rank(runs, "img")
    assert_images_close(img, ref)
    R = 32 * 32 * 2
    for rank, run in enumerate(runs):
        # One make_shard call per rank, for its own block only.
        np.testing.assert_array_equal(run["rows"], [[rank * R // 2, (rank + 1) * R // 2, R,
                                                     R // 2]])


def test_sharded_renders_pad_the_grid_as_jax(port_runs):
    """15 rays over 4 ranks: the padding row carries zero throughput (and,
    in render_frame_distributed, a pixel id past the frame, which the
    port clamps where JAX's scatter drops it)."""
    spec = scenes.load("simple")
    cfg = P.RenderConfig(samples=1, accel="flat", node_chunk=16)
    st = P.flatten_scene(spec.scene, dtype=cfg.dtype)
    args = (make_mesh(4), st, spec.camera, (5, 3), spec.background, cfg)
    runs = port_runs[4]["pad"]
    assert_images_close(_same_on_every_rank(runs, "tiles"), render_tiles_sharded(*args))
    assert_images_close(_same_on_every_rank(runs, "frame"), render_frame_distributed(*args))


def test_four_shapes_sharded_plain_sweep_matches_flat(port_runs):
    """tests/test_multichip.py:129-155: the production sweep (here its plain
    version, on CPU tensors) split over the ranks agrees with the flat
    sweep."""
    run = port_runs[2]["four"]
    cuda = _same_on_every_rank(run, "cuda")
    flat = _same_on_every_rank(run, "flat")
    assert cuda.max() > 0
    np.testing.assert_allclose(cuda, flat, rtol=2e-4, atol=2e-4)


def test_initialize_without_configuration_is_a_noop(monkeypatch):
    import torch.distributed as dist

    for k in _TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        initialize(num_processes=2)
    with pytest.raises(RuntimeError, match="initialize"):
        tpar.make_mesh(2, device="cpu")


def test_initialize_forms_a_one_rank_group(monkeypatch):
    """initialize(num_processes=1) forms the group of a single process;
    make_mesh takes it and refuses another size."""
    import torch.distributed as dist

    for k in _TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize(num_processes=1, device="cpu") is False
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = tpar.make_mesh(1, device="cpu")
        assert mesh.size() == 1 and mesh.get_local_rank() == 0
        with pytest.raises(ValueError, match="ranks"):
            tpar.make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
