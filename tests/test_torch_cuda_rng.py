"""The port's threefry kernel (csrc/threefry.cu, through rng.fold_in,
rng.uniform and rng.draw_lanes on CUDA tensors) against rng's plain
versions (fold_in_plain, uniform_plain, draw_lanes_plain: the PyTorch
int64 ops that tests/test_torch_rng.py holds to jax.random), on the card,
bit for bit.  These tests need an NVIDIA GPU with nvcc; elsewhere they
skip.

    python -m pytest tests/test_torch_cuda_rng.py -m cuda

Keys with words 0 and 2^32 - 1 and drawn ones, on the card and on the host
(passed by value); the shading sites 1000-2003; sample ids up to 2^27;
the render's key folds at its three broadcast shapes; a replayed CUDA
graph reads the key its buffer holds at each replay; captured renders of a
glossy-reflection tile and a big-scene tile equal, bit for bit (under
deterministic algorithms, so that index_add sums in one order), the same
renders with the plain versions patched into rng, and draw through the
kernel alone.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import RenderConfig, flatten_scene, rng, scenes

pytestmark = pytest.mark.cuda

KEYS = ((0, 0), (2**32 - 1, 2**32 - 1), (0, 2**32 - 1), (0x9E3779B9, 0x7F4A7C15))
SITES = (1000, 1001, 1002, 1003, 2000, 2003)
LANES = (1, 33, 8192, 131072)
# (x0, y0), (x1, y1) inclusive: one 128x128 tile of each frame.
GLOSSY_TILE = ((384, 128), (511, 255))
BIG_TILE = ((896, 384), (1023, 511))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


def _sid(dev, lanes, seed, dtype=torch.int32):
    """Sample ids up to 2^27 (children's ids double each round), the ends
    among them."""
    g = np.random.default_rng(seed)
    sid = g.integers(0, 2**27 + 1, lanes)
    sid[:3] = (0, 2**27, 2**27 - 1)[:lanes]
    return torch.tensor(sid, dtype=dtype, device=dev)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_draw_lanes_kernel_bit_equal_to_plain(dev, lanes, n):
    """One launch of draw_lanes against uniform_lanes(fold_in(fold_in(key,
    site), sid), n), for every key and site, int32 and int64 ids, and a
    key on the host."""
    rng.reset_counts()
    for words in KEYS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        for site in SITES:
            for dtype in (torch.int32, torch.int64):
                sid = _sid(dev, lanes, site, dtype)
                got = rng.draw_lanes(key, site, sid, n)
                assert got.shape == (lanes, n) and got.dtype == torch.float32
                _bits_equal(got, rng.draw_lanes_plain(key, site, sid, n))
        _bits_equal(rng.draw_lanes(key.cpu(), 2000, sid, n),
                    rng.draw_lanes_plain(key, 2000, sid, n))
    counts = rng.counts()
    assert counts["draw_lanes"] == len(KEYS) * (2 * len(SITES) + 1)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("start", [0, 2 * 65536, 2**32 - 7])
def test_uniform_kernel_bit_equal_to_plain(dev, lanes, start):
    """uniform(key, (R, 2), start=...) in one launch against its plain
    version (start 2^32 - 7 wraps the counter word), keys on the card and
    on the host."""
    for words in KEYS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        ref = rng.uniform_plain(key, (lanes, 2), dev, start=start)
        _bits_equal(rng.uniform(key, (lanes, 2), dev, start=start), ref)
        _bits_equal(rng.uniform(key.cpu(), (lanes, 2), dev, start=start), ref)


def test_fold_in_kernel_at_the_render_shapes_bit_equal_to_plain(dev):
    """The render's _fold_keys folds (a key [2] with a strided int64
    column of the row table, keys [n, 2] with a column or an int, keys
    [n, 1, 2] with rounds [1, D]), a 0-d index on the card and on the host,
    and per-lane ids: each one launch, bit-equal to the plain version."""
    g = torch.Generator().manual_seed(18)
    rows = torch.randint(0, 2**32, (416, 4), dtype=torch.int64, generator=g).to(dev)
    rows[0] = torch.tensor([0, 0, 0, 2**32 - 1])
    rounds = torch.arange(11, device=dev)
    rng.reset_counts()
    for words in KEYS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        ck = rng.fold_in(rng.fold_in(rng.fold_in(key, rows[:, 0]), rows[:, 1]), rows[:, 3])
        ref = rng.fold_in_plain(rng.fold_in_plain(rng.fold_in_plain(key, rows[:, 0]),
                                                  rows[:, 1]), rows[:, 3])
        _bits_equal(ck, ref)
        _bits_equal(rng.fold_in(ck, 0), rng.fold_in_plain(ck, 0))
        got = rng.fold_in(rng.fold_in(ck, 1)[:, None, :], rounds[None, :])
        _bits_equal(got, rng.fold_in_plain(rng.fold_in_plain(ck, 1)[:, None, :],
                                           rounds[None, :]))
        for ix in (rounds[7], torch.tensor(7), 7):
            _bits_equal(rng.fold_in(key, ix), rng.fold_in_plain(key, 7))
        sid = _sid(dev, 8192, 3)
        _bits_equal(rng.fold_in(key, sid), rng.fold_in_plain(key, sid))
        _bits_equal(rng.fold_in(key.cpu(), sid), rng.fold_in_plain(key, sid))
    counts = rng.counts()
    assert counts["fold_in"] == len(KEYS) * 11 and counts["uniform"] == 0


def test_kernel_wrappers_reject_what_the_kernel_does_not_take(dev):
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    sid = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        rng.draw_lanes(key.to(torch.int32), 2000, sid, 2)
    with pytest.raises(ValueError):
        rng.draw_lanes(torch.zeros((8, 2), dtype=torch.int64, device=dev), 2000, sid, 2)
    with pytest.raises(ValueError):
        rng.draw_lanes(key, 2000, sid.float(), 2)
    with pytest.raises(ValueError):
        rng.fold_in(torch.zeros((1, 1, 1, 1, 1, 2), dtype=torch.int64, device=dev), 3)


def test_replayed_graph_draws_from_the_key_its_buffer_holds(dev):
    """The three draws captured in one CUDA graph from a key buffer on the
    card: each replay after the buffer is rewritten draws from the new
    key, as the plain versions do, and counts its launches on the
    device."""
    key = torch.zeros(2, dtype=torch.int64, device=dev)
    sid = _sid(dev, 8192, 5)
    data = torch.arange(7, device=dev)
    rng.device_counts(dev)

    def draws():
        return (rng.draw_lanes(key, 2000, sid, 2), rng.uniform(key, (8192, 2), dev, start=66),
                rng.fold_in(key, data))

    draws()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = draws()
    rng.reset_counts()
    for words in KEYS:
        key.copy_(torch.tensor(words, dtype=torch.int64))
        g.replay()
        ref = (rng.draw_lanes_plain(key, 2000, sid, 2),
               rng.uniform_plain(key, (8192, 2), dev, start=66), rng.fold_in_plain(key, data))
        for a, b in zip(out, ref):
            _bits_equal(a, b)
    counts = rng.counts()
    assert counts["draw_lanes"] == counts["uniform"] == counts["fold_in"] == len(KEYS)


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms (warn_only: index_copy_ has none on the
    card), uninitialised memory left unfilled: index_add_ sums in one
    order, so two programs that run the same ops agree bit for bit."""
    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


@pytest.mark.parametrize("name, size, region, spp", [
    ("glossy-reflection", (910, 512), GLOSSY_TILE, 4), ("big-scene", (1980, 1020), BIG_TILE, 1)])
def test_captured_render_through_the_kernel_equals_the_plain_draws(dev, monkeypatch, name, size,
                                                                   region, spp):
    """A captured render of one tile through the kernel against the same
    render with rng's plain versions patched in, on fresh tables each:
    bit-equal linear images and live counts; the kernel's render makes
    no plain call on CUDA tensors, and draws per lane inside the round
    kernel (shade_round, csrc/threefry.cuh's hash), with no draw_lanes
    launch."""
    from portrayer_tpu_torch.ops import cuda_round

    spec = scenes.load(name)
    cfg = RenderConfig(device=dev, samples=spp, max_rays_per_launch=131072,
                       queue_caps=spec.queue_caps)

    def render():
        st = flatten_scene(spec.scene, dev)
        stats = []
        rng.reset_counts()
        cuda_round.reset_counts()
        with _deterministic():
            img = T.render_linear(st, spec.camera, size, spec.background, cfg, region=region,
                                  stats=stats)
        (prog,) = st.chunk_programs.values()
        assert prog.graphs["chunk"].replays == len(stats)
        return img, [s.live.tolist() for s in stats], {**rng.counts(), **cuda_round.counts()}

    img, live, counts = render()
    with monkeypatch.context() as m:
        m.setattr(rng, "fold_in", rng.fold_in_plain)
        m.setattr(rng, "uniform", rng.uniform_plain)
        m.setattr(rng, "draw_lanes", rng.draw_lanes_plain)
        ref, ref_live, plain = render()
    np.testing.assert_array_equal(img, ref)
    assert live == ref_live
    assert counts["plain_on_cuda"] == 0 and plain["plain_on_cuda"] > 0
    assert counts["fold_in"] > 0 and counts["uniform"] > 0
    assert counts["draw_lanes"] == 0 and counts["shade_round"] > 0
    assert counts["plain_rounds_cuda"] == 0
    assert all(plain[k] == 0 for k in rng.KERNELS)
