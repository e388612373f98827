"""The port's point ops and KPConv aggregation against the JAX package on
the same numpy inputs.  Neighbour indices and masks must be equal exactly;
subsampled positions to rtol 1e-6 (barycentre sums in another order);
the KPConv aggregation to the Pallas tests' rtol 2e-4 / atol 2e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.ops import neighbors as jnb
from deep3dpointclouddenoising_tpu.ops import subsample as jsub
from deep3dpointclouddenoising_tpu.ops.pallas_kpconv import \
    kpconv_aggregate as jax_kpconv
from deep3dpointclouddenoising_torch.ops import kpconv as tkp
from deep3dpointclouddenoising_torch.ops import neighbors as tnb
from deep3dpointclouddenoising_torch.ops import subsample as tsub


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _patch(rng, B, N, radius, pad=0):
    """Patch-like clouds: points in a ball, the last ``pad`` slots of each
    cloud padding that replicates real points."""
    xyz = rng.normal(size=(B, N, 3))
    xyz *= (radius * rng.random((B, N, 1)) ** (1 / 3)
            / np.linalg.norm(xyz, axis=-1, keepdims=True))
    mask = np.ones((B, N), np.float32)
    if pad:
        mask[:, N - pad:] = 0.0
        xyz[:, N - pad:] = xyz[:, :pad]
    return xyz.astype(np.float32), mask


def _ball_query_case(name, rng):
    if name == "random_masked":
        q, qm = _patch(rng, 2, 40, 1.0)
        s, sm = _patch(rng, 2, 60, 1.0)
        qm[:, ::7] = 0.0
        sm[:, ::5] = 0.0
        return q, s, qm, sm, 0.5, 8
    if name == "empty_balls":
        q, qm = _patch(rng, 2, 30, 1.0)
        s, sm = _patch(rng, 2, 40, 1.0)
        return q, s, qm, sm, 0.08, 6
    if name == "nsample_gt_n":
        q, qm = _patch(rng, 2, 12, 0.3)
        s, sm = _patch(rng, 2, 10, 0.3)
        sm[1, :4] = 0.0
        return q, s, qm, sm, 1.0, 16
    if name == "exact_ties":
        g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                     -1).reshape(1, 64, 3).astype(np.float32) * 0.1
        g = np.repeat(g, 2, axis=0)
        m = np.ones((2, 64), np.float32)
        return g, g, m, m, 0.25, 20
    if name == "near_ties":
        g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                     -1).reshape(1, 64, 3) * 0.1
        g = np.repeat(g, 2, axis=0) + rng.normal(size=(2, 64, 3)) * 1e-7
        g = g.astype(np.float32)
        m = np.ones((2, 64), np.float32)
        return g, g, m, m, 0.25, 20
    if name == "l1_geometry":
        s, sm = _patch(rng, 2, 500, 0.05, pad=60)
        return s, s, sm, sm, 0.025, 52
    raise KeyError(name)


BALL_CASES = ["random_masked", "empty_balls", "nsample_gt_n", "exact_ties",
              "near_ties", "l1_geometry"]


@pytest.mark.parametrize("case", BALL_CASES)
def test_ball_query_matches_jax(case):
    rng = np.random.default_rng(3)
    q, s, qm, sm, radius, nsample = _ball_query_case(case, rng)
    want_idx, want_mask = jnb.masked_ordered_ball_query(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
        radius=radius, nsample=nsample)
    got_idx, got_mask = tnb.masked_ordered_ball_query(
        *_t(q, s, qm, sm), radius=radius, nsample=nsample)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if case == "empty_balls":
        assert (np.asarray(want_mask).sum(-1) == 0).any()


@pytest.mark.parametrize("case", ["random_masked", "exact_ties",
                                  "l1_geometry"])
def test_nearest_query_matches_jax(case):
    rng = np.random.default_rng(5)
    q, s, qm, sm, _, _ = _ball_query_case(case, rng)
    sm = sm.copy()
    sm[:, 1::3] = 0.0
    want_idx, want_mask = jnb.masked_nearest_query(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm))
    got_idx, got_mask = tnb.masked_nearest_query(*_t(q, s, qm, sm))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_grouping_matches_jax():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 30, 5)).astype(np.float32)
    xyz = rng.normal(size=(2, 30, 3)).astype(np.float32)
    qxyz = rng.normal(size=(2, 7, 3)).astype(np.float32)
    idx = rng.integers(0, 30, size=(2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tnb.group_features(*_t(feats, idx)).numpy(),
        np.asarray(jnb.group_features(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tnb.gather_rows(*_t(feats, idx[:, :, 0])).numpy(),
        np.asarray(jnb.gather_rows(jnp.asarray(feats),
                                   jnp.asarray(idx[:, :, 0]))))
    np.testing.assert_array_equal(
        tnb.group_xyz(*_t(xyz, qxyz, idx)).numpy(),
        np.asarray(jnb.group_xyz(jnp.asarray(xyz), jnp.asarray(qxyz),
                                 jnp.asarray(idx))))


def _subsample_case(name, rng):
    if name == "random_masked":
        xyz, mask = _patch(rng, 3, 200, 1.0, pad=30)
        return xyz, mask, 40, 0.2
    if name == "all_masked_cloud":
        xyz, mask = _patch(rng, 2, 50, 1.0)
        mask[1] = 0.0
        return xyz, mask, 12, 0.3
    if name == "npoint_gt_voxels":
        xyz, mask = _patch(rng, 2, 60, 0.2)
        return xyz, mask, 64, 0.15
    if name == "l1_geometry":
        xyz, mask = _patch(rng, 2, 500, 0.05, pad=80)
        return xyz, mask, 125, 2 * 0.0015625
    raise KeyError(name)


@pytest.mark.parametrize("case", ["random_masked", "all_masked_cloud",
                                  "npoint_gt_voxels", "l1_geometry"])
def test_grid_subsampling_matches_jax(case):
    rng = np.random.default_rng(7)
    xyz, mask, npoint, dl = _subsample_case(case, rng)
    want_xyz, want_mask = jsub.masked_grid_subsampling(
        jnp.asarray(xyz), jnp.asarray(mask), npoint=npoint, sample_dl=dl)
    got_xyz, got_mask = tsub.masked_grid_subsampling(
        *_t(xyz, mask), npoint=npoint, sample_dl=dl)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(want_xyz),
                               rtol=1e-6, atol=1e-7)


def test_lcg_tables_and_numpy_subsampling_match_jax():
    a, g = tsub._lcg_tables(300)
    ja, jg = jsub._lcg_tables(300)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(g, jg)
    rng = np.random.default_rng(8)
    pts = rng.random((500, 3)).astype(np.float32)
    feats = rng.normal(size=(500, 4)).astype(np.float32)
    labels = rng.integers(0, 3, size=500)
    for got, want in zip(
            tsub.grid_subsample_numpy(pts, 0.1, feats, labels),
            jsub.grid_subsample_numpy(pts, 0.1, feats, labels)):
        np.testing.assert_array_equal(got, want)


def _kpconv_inputs(rng, B=2, M=50, K=7, C=12, P=15, N=60):
    """The inputs of tests/test_pallas_kpconv.py, plus a padded query row
    (indices 0, mask all ones) as the model makes them."""
    features = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, M, K)).astype(np.int32)
    rel = ((rng.random((B, M, K, 3), dtype=np.float32) * 2 - 1) * 0.1)
    mask = (rng.random((B, M, K)) > 0.3).astype(np.float32)
    idx[:, -1], mask[:, -1] = 0, 1.0
    kpoints = (rng.random((P, 3), dtype=np.float32) * 2 - 1) * 0.08
    kw = rng.normal(size=(P, C)).astype(np.float32) * 0.1
    return features, idx, rel, mask, kpoints, kw


@pytest.mark.parametrize("influence,M", [("linear", 50), ("gaussian", 50),
                                         ("constant", 50), ("linear", 131)])
def test_kpconv_matches_jax_pallas_interpret(influence, M):
    rng = np.random.default_rng(0)
    arrays = _kpconv_inputs(rng, M=M)
    extent = 0.12
    want = jax_kpconv(*[jnp.asarray(a) for a in arrays], extent, influence,
                      True)
    got = tkp.kpconv_aggregate(*_t(*arrays), extent, influence)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    ref = tkp.kpconv_aggregate_reference(
        tnb.group_features(*_t(arrays[0], arrays[1])), *_t(*arrays[2:]),
        extent=extent, influence=influence)
    assert torch.equal(got, ref)


def test_kpconv_influence_zero_distance_gradient_finite():
    rel = torch.zeros(4, 3, requires_grad=True)
    w = tkp.influence_weights((rel * rel).sum(-1), 1.0, "linear")
    assert w.tolist() == [1.0] * 4
    w.sum().backward()
    assert torch.isfinite(rel.grad).all()


def test_kpconv_wrapper_checks():
    rng = np.random.default_rng(1)
    arrays = _t(*_kpconv_inputs(rng))
    with pytest.raises(ValueError, match="Unknown KP_influence"):
        tkp.kpconv_aggregate(*arrays, 0.1, "cubic")
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tkp.kpconv_aggregate(*meta, 0.1, "linear")
