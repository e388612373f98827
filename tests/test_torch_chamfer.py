"""The port's Chamfer distance and Chamfer training losses against the JAX
package's, on the CPU.

Tolerances: values and gradients rtol 1e-5 (atol 1e-7 for gradients,
many of which are exactly 0); the nearest-neighbour search exact; three
``chamfer_L1`` train steps from one converted init, losses rtol 1e-5 at
the first step and 1e-3 after it (test_torch_train.py says why).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.losses import build as jax_build
from deep3dpointclouddenoising_tpu.losses import chamfer as jax_chamfer
from deep3dpointclouddenoising_torch.losses import chamfer
from deep3dpointclouddenoising_torch.losses.build import \
    get_offset_regression_loss
from test_torch_cleaning import three_steps, train_batches

TOL = dict(rtol=1e-5, atol=1e-7)
OFFSET_LOSSES = ["L1", "chamfer_L1", "chamfer", "chamfer_sparse",
                 "l1_chamfer_sparse", "l1_chamfer_adaptive_to_chamfer",
                 "l1_chamfer_adaptive_to_l1"]


def _clouds(rng, B=3, P1=48, P2=40):
    """Two padded batches of clouds: item 1's y is all padding (its x
    costs the 1e10 sentinel), item 2 has padding in both."""
    x = rng.normal(size=(B, P1, 3)).astype(np.float32) * 0.2
    y = (x[:, :P2] + rng.normal(size=(B, P2, 3)) * 0.02).astype(np.float32)
    xm = np.ones((B, P1), np.float32)
    ym = np.ones((B, P2), np.float32)
    ym[1] = 0.0
    xm[2, 30:] = 0.0
    ym[2, 25:] = 0.0
    return x, y, xm, ym


def _grads(fn, *arrays):
    """Value and gradients in the first two arrays, in torch."""
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    for t in ts[:2]:
        t.requires_grad_(True)
    out = fn(*ts)
    out.sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts[:2]]


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
@pytest.mark.parametrize("norm", ["L2", "L1"])
def test_chamfer_distance_matches_jax(norm, reduction):
    x, y, xm, ym = _clouds(np.random.default_rng(0))

    def jfn(a, b):
        return jax_chamfer.chamfer_distance(a, b, xm, ym, norm_type=norm,
                                            batch_reduction=reduction)

    want = np.asarray(jfn(x, y))
    want_g = jax.grad(lambda a, b: jnp.sum(jfn(a, b)), argnums=(0, 1))(x, y)
    got, got_g = _grads(lambda a, b, am, bm: chamfer.chamfer_distance(
        a, b, am, bm, norm_type=norm, batch_reduction=reduction),
        x, y, xm, ym)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(got_g, want_g):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    if reduction is None:
        assert got.shape == (3,) and got[1] >= 1e10   # the sentinel
    # a chunked search gives the same numbers
    chunked, _ = _grads(lambda a, b, am, bm: chamfer.chamfer_distance(
        a, b, am, bm, norm_type=norm, batch_reduction=reduction, chunk=7),
        x, y, xm, ym)
    np.testing.assert_array_equal(chunked, got)


def test_chamfer_distance_default_masks_and_bad_norm():
    x, y, _, _ = _clouds(np.random.default_rng(1))
    want = np.asarray(jax_chamfer.chamfer_distance(x, y))
    got = chamfer.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    with pytest.raises(ValueError):
        chamfer.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y),
                                 norm_type="L3")


@pytest.mark.parametrize("near_duplicates", [False, True])
def test_nearest_distances_match_jax(near_duplicates):
    """On near-duplicate points far from the origin the difference form
    keeps the distances that ``|x|^2 - 2 x.y + |y|^2`` would cancel."""
    rng = np.random.default_rng(2)
    x, y, _, ym = _clouds(rng)
    if near_duplicates:
        x = (x * 1e-3 + 10.0).astype(np.float32)
        y = (x[:, :40] + rng.normal(size=y.shape) * 1e-5).astype(np.float32)
    want = np.asarray(jax_chamfer.nearest_distances(x, y, ym))
    got = chamfer.nearest_distances(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(ym)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    idx = chamfer.nearest_indices(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(ym)).numpy()
    d64 = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    d64 = np.where(ym[:, None] > 0, d64, np.inf)
    valid = ym.any(-1)
    np.testing.assert_array_equal(idx[valid], d64.argmin(-1)[valid])
    assert (got[1] >= 1e10).all()


def _loss_inputs(rng, B=3, N=48):
    points = (rng.normal(size=(B, N, 3)) * 0.1).astype(np.float32)
    target = (rng.normal(size=(B, N, 3)) * 0.01).astype(np.float32)
    pred = (target + rng.normal(size=(B, N, 3)) * 0.005).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[-1, 36:] = 0.0
    points[-1, 36:] = points[-1, :12]
    return pred, target, mask, points


@pytest.mark.parametrize("name", OFFSET_LOSSES)
def test_offset_losses_and_gradients_match_jax(name):
    pred, target, mask, points = _loss_inputs(np.random.default_rng(3))
    jloss = jax_build.get_offset_regression_loss(name)
    want, want_g = jax.value_and_grad(
        lambda p: jloss(p, target, mask, points))(jnp.asarray(pred))
    tpred = torch.from_numpy(pred.copy()).requires_grad_(True)
    got = get_offset_regression_loss(name)(
        tpred, *(torch.from_numpy(a) for a in (target, mask, points)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tpred.grad.numpy(), np.asarray(want_g), **TOL)
    assert np.abs(tpred.grad.numpy()).max() > 0


def test_unknown_losses_raise():
    with pytest.raises(ValueError):
        get_offset_regression_loss("chamfer_L3")
    with pytest.raises(ValueError):
        chamfer.masked_adaptive_l1_chamfer_loss(
            *(torch.zeros(1, 4, 3) for _ in range(2)), torch.ones(1, 4),
            torch.zeros(1, 4, 3), converging_to="L2")


def test_three_chamfer_l1_steps_losses_match_jax(tmp_path):
    batches = train_batches(tmp_path, 0.0)
    got, want = three_steps(batches, "offset", loss="chamfer_L1", depth=1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
