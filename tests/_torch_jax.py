"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: carrying JAX tables across, and the JAX package's kernel gates."""

import numpy as np

from portrayer_tpu_torch.scene.flatten import TABLE_FIELDS, PACKED_FIELDS, META_FIELDS


def jax_arrays(st):
    """({field: numpy array}, meta) of a JAX SceneTables, the input of
    portrayer_tpu_torch.tables_from_numpy."""
    arrays = {f: np.asarray(getattr(st, f)) for f in TABLE_FIELDS}
    arrays.update({f"packed.{f}": np.asarray(getattr(st.packed, f)) for f in PACKED_FIELDS})
    meta = {f: getattr(st, f) for f in META_FIELDS if hasattr(st, f)}
    meta.update(kind_ranges=st.packed.kind_ranges, n_chunks=st.packed.n_chunks)
    return arrays, meta


# A ray that re-hits the node it left does so near-tangentially, just past
# the self-eps raise: the root is ill-conditioned there, and the JAX
# package's own flat sweep and Pallas kernel differ by up to 2e-3 relative
# t on such rays (big-scene shadow rays).  Everywhere else the kernel
# gate's rtol 1e-4 holds.
SELF_HIT_RTOL = 5e-3


def assert_gates(ref, got, src_node=None):
    """The kernel gates of tests/test_pallas.py: .hit equal; node
    mismatches on at most 0.2% of hits and only within 2*2^-16 relative t;
    elsewhere tri equal and t within rtol 1e-4 / atol 1e-5 (SELF_HIT_RTOL
    on re-hits of the ray's own src_node)."""
    rh, gh = np.asarray(ref.hit), np.asarray(got.hit)
    np.testing.assert_array_equal(rh, gh)
    rn, gn = np.asarray(ref.node)[rh], np.asarray(got.node)[rh]
    rt, gt = np.asarray(ref.t)[rh], np.asarray(got.t)[rh]
    mism = rn != gn
    assert mism.sum() <= 0.002 * max(mism.size, 1), f"{mism.sum()} node mismatches"
    np.testing.assert_array_equal(np.asarray(ref.tri)[rh][~mism],
                                  np.asarray(got.tri)[rh][~mism])
    self_hit = np.zeros_like(mism)
    if src_node is not None:
        self_hit = rn == np.asarray(src_node)[rh]
    plain = ~mism & ~self_hit
    np.testing.assert_allclose(gt[plain], rt[plain], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gt[self_hit], rt[self_hit], rtol=SELF_HIT_RTOL, atol=1e-5)
    if mism.any():
        quantum = 2.0 ** -16 * np.maximum(np.abs(rt[mism]), np.abs(gt[mism]))
        assert (np.abs(gt[mism] - rt[mism]) <= 2.0 * quantum + 1e-5).all(), (
            "node-mismatched rays outside the tie quantum")
