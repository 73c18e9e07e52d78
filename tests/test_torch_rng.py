"""The port's threefry draws are bit-equal to jax.random (partitionable
threefry) for the renderer's call shapes: PRNGKey(seed), the tile/chunk
key chain fold_in(fold_in(fold_in(key, x0), y0), ci), and the jitter
uniform(fold_in(ckey, 0), (R, 2)); the chain also from int tensors (the
render's row table), for all rows at once, without a host read."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from portrayer_tpu_torch import rng


def _bits(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**31 - 1])
def test_prng_key_and_fold_in_bit_equal(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_bits(kj), kt.numpy())
    for x0, y0, ci in ((0, 0, 0), (128, 896, 1), (1920, 64, 7), (2**31 + 5, 3, 2**32 - 1)):
        kj2 = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(kj, x0), y0), ci)
        kt2 = rng.fold_in(rng.fold_in(rng.fold_in(kt, x0), y0), ci)
        np.testing.assert_array_equal(_bits(kj2), kt2.numpy())


@pytest.mark.parametrize("R", [1, 33, 4225, 65536])
def test_uniform_bit_equal(R):
    kj = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 64), 0)
    kt = rng.fold_in(rng.fold_in(rng.PRNGKey(0), 64), 0)
    uj = np.asarray(jax.random.uniform(kj, (R, 2), jnp.float32))
    ut = rng.uniform(kt, (R, 2), "cpu")
    assert ut.dtype == torch.float32 and tuple(ut.shape) == (R, 2)
    np.testing.assert_array_equal(uj.view(np.uint32), ut.numpy().view(np.uint32))
    assert (ut >= 0).all() and (ut < 1).all()


@pytest.mark.parametrize("site, n", [(2000, 2), (1002, 3), (1000, 1), (2003, 2), (1001, 3)])
def test_per_lane_draws_bit_equal_to_shade_uniform(site, n):
    """fold_in over a tensor of sample ids, then per-lane uniforms: bit-equal
    to the JAX package's shade._uniform (vmap(fold_in), vmap(uniform)) and
    to that composition written out in jax.random; rng.draw_lanes, which
    shade._uniform calls, is uniform_lanes(fold_in(fold_in(key, site), sid),
    n) on the CPU, with int32 or int64 sample ids."""
    from portrayer_tpu.ops.shade import _uniform as jax_uniform
    from portrayer_tpu_torch.ops.shade import _uniform

    sid = np.random.default_rng(site).integers(0, 2**27, 777).astype(np.int32)
    sid[:3] = (0, 1, 2**31 - 1)
    kj = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    kt = rng.fold_in(rng.PRNGKey(5), 3)
    uj = np.asarray(jax_uniform(kj, site, jnp.asarray(sid), n, jnp.float32))
    ut = _uniform(kt, site, torch.from_numpy(sid), n)
    assert ut.dtype == torch.float32 and tuple(ut.shape) == (777, n)
    np.testing.assert_array_equal(uj.view(np.uint32), ut.numpy().view(np.uint32))
    lanes = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.fold_in(kj, site),
                                                             jnp.asarray(sid))
    composed = jax.vmap(lambda k: jax.random.uniform(k, (n,), jnp.float32))(lanes)
    np.testing.assert_array_equal(np.asarray(composed).view(np.uint32), uj.view(np.uint32))
    plain = rng.uniform_lanes(rng.fold_in(rng.fold_in(kt, site), torch.from_numpy(sid)), n)
    for ids in (torch.from_numpy(sid), torch.from_numpy(sid).to(torch.int64)):
        got = rng.draw_lanes(kt, site, ids, n)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), plain.numpy().view(np.uint32))
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), uj.view(np.uint32))


def test_cpu_draws_take_the_plain_versions():
    """On CPU tensors the draws run their plain versions: no kernel launch
    and no plain call counted on the card."""
    rng.reset_counts()
    key = rng.fold_in(rng.PRNGKey(7), torch.arange(4))[2]
    np.testing.assert_array_equal(rng.uniform(key, (9, 2), "cpu", start=6).numpy(),
                                  rng.uniform_plain(key, (9, 2), "cpu", start=6).numpy())
    sid = torch.arange(5, dtype=torch.int32)
    np.testing.assert_array_equal(rng.draw_lanes(key, 2000, sid, 2).numpy(),
                                  rng.draw_lanes_plain(key, 2000, sid, 2).numpy())
    np.testing.assert_array_equal(rng.fold_in(key, sid).numpy(),
                                  rng.fold_in_plain(key, sid).numpy())
    assert rng.counts() == dict.fromkeys(rng.KERNELS + ("plain_on_cuda",), 0)


@pytest.mark.parametrize("seed", [0, 1234])
def test_device_key_chain_from_tensor_inputs_bit_equal(seed):
    """The render's key chain from its row table (x0, y0, sample offset,
    chunk index) as int tensors, folded for all rows at once and for one
    row from 0-d tensors: chunk keys, jitter draws, round keys and the
    per-lane keys of shading, bit-equal to jax.random, and no op reads a
    key on the host (tests/_torch_jax.py's HostReads)."""
    from _torch_jax import HostReads

    rows = torch.tensor([(0, 0, 0, 0), (128, 896, 8, 1), (1920, 64, 56, 7),
                         (2**31 + 5, 3, 0, 2**32 - 1)], dtype=torch.int64)
    sid = torch.from_numpy(np.random.default_rng(seed).integers(0, 2**27, 64).astype(np.int32))
    key = rng.PRNGKey(seed)
    rounds = torch.arange(11)
    with HostReads() as reads:
        ck = rng.fold_in(rng.fold_in(rng.fold_in(key, rows[:, 0]), rows[:, 1]), rows[:, 3])
        jk = rng.fold_in(ck, 0)
        rk = rng.fold_in(rng.fold_in(ck, 1)[:, None, :], rounds[None, :])
        one = rng.fold_in(rng.fold_in(rng.fold_in(key, rows[2, 0]), rows[2, 1]), rows[2, 3])
        draws = [rng.uniform(jk[i], (33, 2), "cpu") for i in range(len(rows))]
        lanes = rng.fold_in(rk[1, 3], sid)
    assert reads.seen == []
    np.testing.assert_array_equal(one.numpy(), ck[2].numpy())
    kj = jax.random.PRNGKey(seed)
    for i, (x0, y0, _, ci) in enumerate(rows.tolist()):
        cj = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(kj, x0), y0), ci)
        np.testing.assert_array_equal(_bits(cj), ck[i].numpy())
        uj = np.asarray(jax.random.uniform(jax.random.fold_in(cj, 0), (33, 2), jnp.float32))
        np.testing.assert_array_equal(uj.view(np.uint32), draws[i].numpy().view(np.uint32))
        tj = jax.random.fold_in(cj, 1)
        for r in rounds.tolist():
            np.testing.assert_array_equal(_bits(jax.random.fold_in(tj, r)), rk[i, r].numpy())
    rj = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(kj, 128), 896), 1), 1), 3)
    lj = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(rj, jnp.asarray(sid.numpy()))
    np.testing.assert_array_equal(_bits(lj), lanes.numpy())


@pytest.mark.parametrize("a, b", [((), ()), ((4,), ()), ((), (7,)), ((416,), (416,)),
                                  ((416, 1), (1, 11)), ((3, 1, 5), (4, 1)), ((0,), (1,))])
def test_fold_in_kernel_broadcasts_as_torch(a, b):
    """The kernel's fold_in broadcasts key and data as torch does, without
    torch.broadcast_shapes (whose first call imports sympy)."""
    assert rng._broadcast_shape(a, b) == tuple(torch.broadcast_shapes(a, b))
