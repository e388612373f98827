"""The port's neighbour queries and KPConv aggregation at the 15,000-point
configs' sizes, against the JAX package on the same numpy inputs.

* Ball query and 1-NN: indices and masks bitwise equal to JAX's
  ``masked_ordered_ball_query`` / ``masked_nearest_query`` at N = 60,
  2100, 4096, 4608 and 15000 (JAX sorts rows of at most 4096 columns and
  takes ``lax.top_k`` above), on patches whose padding copies real points,
  on lattices whose distances tie exactly (coordinates in eighths, so
  every difference and square is exact), with capacities above the real
  count and with empty balls; JAX chunked by a forced ``chunk_size``, the
  port at several chunks and with and without dropping the invalid
  supports first, all equal.
* The aggregation at N = 2304 > 2048, where JAX's forward takes the
  Pallas ``_fwd_kernel`` (interpret mode) and its VJP the jnp closed form:
  forward rtol 2e-4 / atol 2e-5, gradients at
  ``test_torch_kpconv_grad.py``'s rtol 3e-4 / atol 3e-5.
"""
import zlib
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.ops import neighbors as jnb
from deep3dpointclouddenoising_tpu.ops.pallas_kpconv import \
    kpconv_aggregate as jax_kpconv
from deep3dpointclouddenoising_torch.ops import kpconv as tkp
from deep3dpointclouddenoising_torch.ops import neighbors as tnb
from test_torch_ops import float64_distances


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _patch(rng, B, N, real, radius):
    """Dataset-like patches: ``real`` points in a ball, the other slots
    padding that copies real points (mask 0)."""
    xyz = rng.normal(size=(B, N, 3))
    xyz *= (radius * rng.random((B, N, 1)) ** (1 / 3)
            / np.linalg.norm(xyz, axis=-1, keepdims=True))
    pick = rng.integers(0, real, size=(B, N - real))
    xyz[:, real:] = np.take_along_axis(xyz[:, :real], pick[..., None], 1)
    mask = np.zeros((B, N), np.float32)
    mask[:, :real] = 1.0
    return xyz.astype(np.float32), mask


def _lattice(n):
    """The first ``n`` points of a 25 x 25 x 25 lattice of step 1/8."""
    g = np.stack(np.meshgrid(*[np.arange(25.0)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3)[:n] / 8.0).astype(np.float32)[None]


def _case(name):
    """(query, support, query mask, support mask, radius, nsample)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "patch_60":
        s, sm = _patch(rng, 2, 60, 25, 0.05)
        return s, s, sm, sm, 0.025, 26
    if name == "patch_2100":
        s, sm = _patch(rng, 2, 2100, 300, 0.05)
        return s, s, sm, sm, 0.025, 31
    if name == "empty_balls_4608":
        s, sm = _patch(rng, 1, 4608, 4300, 0.05)
        q = s[:, :600] + 0.2  # most queries far from every support
        q[:, :100] = s[:, :100]
        return q, s, np.ones((1, 600), np.float32), sm, 0.01, 26
    if name == "nsample_gt_real_4608":
        s, sm = _patch(rng, 1, 4608, 20, 0.05)
        return s[:, :700], s, sm[:, :700], sm, 0.2, 41
    if name in ("lattice_4096", "lattice_4608"):  # each side of 4096
        g = _lattice(int(name[-4:]))
        m = np.ones(g.shape[:2], np.float32)
        return g[:, ::7], g, m[:, ::7], m, 0.3, 41
    if name == "lattice_15000_masked":  # 4,000 of 15,000 supports valid
        g = _lattice(15000)
        sm = np.zeros((1, 15000), np.float32)
        sm[:, 5000:9000] = 1.0
        q = g[:, 4000:10000:3]
        return q, g, np.ones(q.shape[:2], np.float32), sm, 0.3, 41
    if name == "lattice_15000":
        g = _lattice(15000)
        m = np.ones((1, 15000), np.float32)
        q = g[:, ::11]
        return q, g, m[:, ::11], m, 0.3, 26
    if name == "patch_15000":  # the stem query of a 15k patch
        s, sm = _patch(rng, 1, 15000, 900, 0.05)
        return s, s, sm, sm, 0.025, 26
    raise KeyError(name)


BALL_CASES = ["patch_60", "patch_2100", "empty_balls_4608",
              "nsample_gt_real_4608", "lattice_4096", "lattice_4608",
              "lattice_15000_masked", "lattice_15000", "patch_15000"]


def _compacting(compact: bool):
    """Forces the queries' choice whether to drop the invalid supports."""
    return mock.patch.object(tnb, "auto_compact", lambda b, m, n: compact)


def _port_ball_queries(q, s, qm, sm, radius, nsample):
    """The port's query at several chunks, with and without compaction;
    all equal, the first returned."""
    M, N = q.shape[1], s.shape[1]
    chunks = (None, 997) if M * N > 2**25 else (None, 997, M)
    runs = []
    for chunk in chunks:
        for compact in (False, True):
            with _compacting(compact):
                runs.append(tnb.masked_ordered_ball_query(
                    *_t(q, s, qm, sm), radius=radius, nsample=nsample,
                    chunk_size=chunk))
    for idx, msk in runs[1:]:
        assert torch.equal(idx, runs[0][0])
        assert torch.equal(msk, runs[0][1])
    return runs[0]


@pytest.mark.parametrize("case", BALL_CASES)
def test_ball_query_matches_jax_at_15k_sizes(case):
    q, s, qm, sm, radius, nsample = _case(case)
    M = q.shape[1]
    want_idx, want_mask = jnb.masked_ordered_ball_query(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
        radius=radius, nsample=nsample, chunk_size=min(M, 512))
    got_idx, got_mask = _port_ball_queries(q, s, qm, sm, radius, nsample)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    counts = np.asarray(want_mask).sum(-1)
    if case == "empty_balls_4608":
        assert (counts == 0).any() and (counts > 0).any()
    if case == "nsample_gt_real_4608":  # slots cycle the 20 real points
        assert counts.max() == 20
    if case.startswith("lattice"):  # tied neighbours fill the capacity
        assert (counts == nsample).any()


@pytest.mark.parametrize("case", ["patch_60", "lattice_4608",
                                  "lattice_15000_masked", "patch_15000"])
def test_nearest_query_matches_jax_at_15k_sizes(case):
    q, s, qm, sm, _, _ = _case(case)
    if case.startswith("lattice"):  # queries between lattice points tie
        q = q + np.float32(1 / 16)
    M = q.shape[1]
    want_idx, want_mask = jnb.masked_nearest_query(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
        chunk_size=min(M, 512))
    runs = []
    for chunk in (None, 997):
        for compact in (False, True):
            with _compacting(compact):
                runs.append(tnb.masked_nearest_query(*_t(q, s, qm, sm),
                                                     chunk_size=chunk))
    for idx, msk in runs:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(msk.numpy(), np.asarray(want_mask))


def test_auto_chunk_and_compaction_at_the_two_patch_sizes():
    """One tile and no compaction (no wait for the device) at the 500-point
    configs; 186-query chunks over the compacted supports at 15,000."""
    assert tnb.auto_chunk(16, 500, 500) == 500
    assert not tnb.auto_compact(16, 500, 500)
    assert tnb.auto_chunk(8, 15000, 15000) == 186
    assert tnb.auto_compact(8, 15000, 15000)
    xyz, mask = _t(*_patch(np.random.default_rng(0), 2, 50, 10, 1.0))
    mask[1] = 0.0
    mask[1, [5, 7, 20]] = 1.0
    sub, sub_mask, cols = tnb.compact_supports(xyz, mask)
    # valid supports first in index order, then the invalid ones, cut to
    # the batch's largest valid count
    assert cols.tolist() == [list(range(10)), [5, 7, 20, 0, 1, 2, 3, 4, 6, 8]]
    assert sub_mask.tolist() == [[1.0] * 10, [1.0] * 3 + [0.0] * 7]
    assert torch.equal(sub, tnb.gather_rows(xyz, cols))


def _kpconv_inputs(rng, B=2, M=131, K=26, C=16, P=15, N=2304):
    """Patch-like aggregation inputs at N > 2048: neighbours inside the
    ball, about 30% masked slots and a padded last query row."""
    features = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, M, K)).astype(np.int32)
    rel = ((rng.random((B, M, K, 3), dtype=np.float32) * 2 - 1) * 0.1)
    mask = (rng.random((B, M, K)) > 0.3).astype(np.float32)
    idx[:, -1], mask[:, -1] = 0, 1.0
    kpoints = (rng.random((P, 3), dtype=np.float32) * 2 - 1) * 0.08
    kw = rng.normal(size=(P, C)).astype(np.float32) * 0.1
    return features, idx, rel, mask, kpoints, kw


@pytest.mark.parametrize("influence", ["linear", "gaussian"])
def test_kpconv_above_2048_supports_matches_jax(influence):
    """JAX's ``_fwd_kernel`` (interpret mode) forward and its N > 2048
    closed-form VJP against the port's plain forward and backward."""
    arrays = _kpconv_inputs(np.random.default_rng(4))
    g = np.random.default_rng(5).normal(size=(2, 131, 16)).astype(
        np.float32)
    extent = 0.12
    feat, idx, rel, mask, kp, kw = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda f, w: jax_kpconv(f, idx, rel, mask, kp, w,
                                               extent, influence, True),
                       feat, kw)
    d_feat, d_kw = vjp(jnp.asarray(g))
    tf, ti, tr, tm, tk, tw = _t(*arrays)
    tf.requires_grad_()
    tw.requires_grad_()
    got = tkp.kpconv_aggregate(tf, ti, tr, tm, tk, tw, extent, influence)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(out), rtol=2e-4, atol=2e-5,
        err_msg=float64_distances(got.detach().numpy(), out, arrays, extent,
                                  influence))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(d_feat),
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(d_kw),
                               rtol=3e-4, atol=3e-5)
    # the backward kernel's per-support form gives the same gradients
    inv_feat, inv_kw = tkp.kpconv_aggregate_backward_inverted_plain(
        *_t(*arrays), torch.from_numpy(g), extent, influence)
    np.testing.assert_allclose(inv_feat.numpy(), np.asarray(d_feat),
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(inv_kw.numpy(), np.asarray(d_kw),
                               rtol=3e-4, atol=3e-5)
