"""The port's KPConv gradients against the JAX package's custom VJP.

The same numpy inputs go through ``jax.vjp`` of the JAX
``kpconv_aggregate`` in interpret mode, which reaches the Pallas backward
``_bwd_pallas_onehot`` for linear and gaussian influence with N <= 2048 and
the jnp fallback of ``_vjp_bwd`` for constant influence and N > 2048, and
through the port's autograd function on the CPU (its plain backward).
Tolerances are those of tests/test_pallas_kpconv.py: rtol 3e-4 / atol 3e-5,
and rtol 1e-3 / atol 1e-4 where M is not a multiple of the query tile.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.ops.pallas_kpconv import \
    kpconv_aggregate as jax_kpconv
from deep3dpointclouddenoising_tpu.ops.pallas_kpconv import \
    kpconv_aggregate_reference as jax_reference
from deep3dpointclouddenoising_torch.ops import kpconv as tkp


def _inputs(rng, B=2, M=50, K=7, C=12, P=15, N=60):
    return (rng.normal(size=(B, N, C)).astype(np.float32),
            rng.integers(0, N, size=(B, M, K)).astype(np.int32),
            ((rng.random((B, M, K, 3), dtype=np.float32) * 2 - 1) * 0.1),
            (rng.random((B, M, K)) > 0.3).astype(np.float32),
            ((rng.random((P, 3), dtype=np.float32) * 2 - 1) * 0.08),
            rng.normal(size=(P, C)).astype(np.float32) * 0.1)


def _jax_vjp(arrays, g, extent, influence):
    feat, idx, rel, mask, kp, kw = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(lambda f, w: jax_kpconv(f, idx, rel, mask, kp, w,
                                               extent, influence, True),
                       feat, kw)
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(g)))]


def _torch_vjp(arrays, g, extent, influence):
    feat, idx, rel, mask, kp, kw = (torch.from_numpy(a) for a in arrays)
    feat.requires_grad_()
    kw.requires_grad_()
    out = tkp.kpconv_aggregate(feat, idx, rel, mask, kp, kw, extent,
                               influence)
    out.backward(torch.from_numpy(g))
    return [t.detach().numpy() for t in (out, feat.grad, kw.grad)]


CASES = {
    # name: (input sizes, influence, rtol, atol); the JAX path it reaches
    "onehot_linear": (dict(), "linear", 3e-4, 3e-5),        # Pallas bwd
    "onehot_gaussian": (dict(), "gaussian", 3e-4, 3e-5),    # Pallas bwd
    "constant": (dict(), "constant", 3e-4, 3e-5),           # jnp fallback
    "large_support": (dict(N=2100, C=4, M=20, K=5), "linear", 3e-4,
                      3e-5),                                 # jnp fallback
    "ragged_tile": (dict(M=131, K=5, C=8, N=40), "linear", 1e-3, 1e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_vjp(case):
    sizes, influence, rtol, atol = CASES[case]
    rng = np.random.default_rng(11)
    arrays = _inputs(rng, **sizes)
    B, M = arrays[1].shape[:2]
    g = rng.normal(size=(B, M, arrays[0].shape[-1])).astype(np.float32)
    want = _jax_vjp(arrays, g, 0.12, influence)
    got = _torch_vjp(arrays, g, 0.12, influence)
    for name, a, b in zip(("out", "d_features", "d_kernel_weights"), got,
                          want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_padded_query_rows_pass_gradient_as_in_jax():
    """A padded query row (indices 0, mask all ones, as the model makes
    them) sends its gradient to support row 0, in both packages."""
    rng = np.random.default_rng(12)
    arrays = list(_inputs(rng, M=20, K=5, C=8, N=30))
    arrays[1][:, -3:] = 0
    arrays[3][:, -3:] = 1.0
    g = np.zeros((2, 20, 8), np.float32)
    g[:, -3:] = rng.normal(size=(2, 3, 8))
    want = _jax_vjp(arrays, g, 0.12, "linear")
    got = _torch_vjp(arrays, g, 0.12, "linear")
    assert np.abs(got[1][:, 0]).max() > 0
    assert np.abs(got[1][:, 1:]).max() == 0
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
def test_autograd_function_gradcheck_float64(influence):
    rng = np.random.default_rng(13)
    feat, idx, rel, mask, kp, kw = (torch.from_numpy(a.astype(
        np.int32 if a.dtype == np.int32 else np.float64))
        for a in _inputs(rng, B=2, M=9, K=5, C=4, N=11))
    feat.requires_grad_()
    kw.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f, w: tkp.kpconv_aggregate(f, idx, rel, mask, kp, w, 0.12,
                                          influence), (feat, kw))


def test_backward_computes_only_what_is_needed():
    rng = np.random.default_rng(14)
    arrays = [torch.from_numpy(a) for a in _inputs(rng, M=12, K=4, C=6,
                                                     N=20)]
    g = torch.randn(2, 12, 6, generator=torch.Generator().manual_seed(0))
    full = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, need_rel=True)
    d_feat, d_kw, d_rel = tkp.kpconv_aggregate_backward(
        *arrays, g, 0.12, need_kernel_weights=False)
    assert d_kw is None and d_rel is None and torch.equal(d_feat, full[0])
    d_feat, d_kw, d_rel = tkp.kpconv_aggregate_backward(
        *arrays, g, 0.12, need_features=False)
    assert d_feat is None and torch.equal(d_kw, full[1])
    d_feat, d_kw, d_rel = tkp.kpconv_aggregate_backward(
        *arrays, g, 0.12, need_features=False, need_kernel_weights=False,
        need_rel=True)
    assert d_feat is None and d_kw is None and torch.equal(d_rel, full[2])
    # autograd asks only for the kernel weights' gradient here
    kw = arrays[5].clone().requires_grad_()
    tkp.kpconv_aggregate(*arrays[:5], kw, 0.12).backward(g)
    torch.testing.assert_close(kw.grad, full[1], rtol=0, atol=0)
    assert tkp.kpconv_aggregate_backward.launches == 0  # no kernel on CPU


def _coincident_inputs(rng):
    """Inputs where neighbour (b, m, k) = (0, 0, 0) sits exactly on kernel
    point 0 (sq == 0, the safe sqrt's case) and (0, 1, 0) on kernel point
    3."""
    arrays = list(_inputs(rng, M=12, K=6, C=5, N=20))
    arrays[2][0, 0, 0] = arrays[4][0]
    arrays[2][0, 1, 0] = arrays[4][3]
    arrays[3][0, :2, 0] = 1.0
    return arrays


# corners of kpconv_bwd_drel's tiling, where its chunks of 8 edges and
# groups of 8 channels are cut ragged: name -> (K, C, P, layout) on B=2,
# M=6, N=11; "clamp" puts every other neighbour far out (the linear
# influence clamped), "coincide" puts two neighbours exactly on kernel
# points (d = 0), "masked" masks every edge of one query
REL_CORNERS = {
    "K1": (1, 8, 15, "random"),
    "K8": (8, 8, 15, "random"),
    "K9": (9, 13, 15, "random"),
    "C13": (7, 13, 15, "random"),
    "P1": (9, 8, 1, "random"),
    "clamp": (9, 13, 15, "clamp"),
    "coincide": (8, 8, 15, "coincide"),
    "masked_query": (9, 8, 15, "masked"),
}
INFLUENCES = ("linear", "gaussian", "constant")
REL_CASES = ([pytest.param(None, i, id=i) for i in INFLUENCES]
             + [pytest.param(c, i, id=f"{c}-{i}")
                for c in sorted(REL_CORNERS) for i in INFLUENCES])


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corner_inputs(rng, K, C, P, layout):
    arrays = list(_inputs(rng, B=2, M=6, K=K, C=C, P=P, N=11))
    rel, mask, kp = arrays[2], arrays[3], arrays[4]
    if layout == "clamp":
        rel[:, :, ::2] *= 4.0
        assert (np.linalg.norm(rel[..., None, :] - kp, axis=-1)
                >= 0.12).mean() > 0.3
    elif layout == "coincide":  # on the first and the last kernel point
        rel[:, 1, 0] = kp[0]
        rel[:, 1, -1] = kp[-1]
        mask[:, 1] = 1.0
    elif layout == "masked":
        mask[:, 2] = 0.0
    return arrays


def _rel_grads(arrays, g, influence):
    """d_rel of jax.grad of kpconv_aggregate_reference and of the port's
    autograd (its plain backward on the CPU)."""
    feat, idx, rel, mask, kp, kw = arrays

    def ref(r):
        grouped = jnp.take_along_axis(
            jnp.asarray(feat)[:, None], jnp.asarray(idx)[..., None], axis=2)
        return jnp.sum(jax_reference(grouped, r, jnp.asarray(mask),
                                     jnp.asarray(kp), jnp.asarray(kw),
                                     extent=0.12, influence=influence)
                       * jnp.asarray(g))

    want = np.asarray(jax.grad(ref)(jnp.asarray(rel)))
    t_rel = torch.from_numpy(rel).requires_grad_()
    out = tkp.kpconv_aggregate(torch.from_numpy(feat), torch.from_numpy(idx),
                               t_rel, *(torch.from_numpy(a)
                                        for a in (mask, kp, kw)),
                               0.12, influence)
    out.backward(torch.from_numpy(g))
    return t_rel.grad.numpy(), want


@pytest.mark.parametrize("corner,influence", REL_CASES)
def test_rel_gradient_matches_jax_grad_of_reference(corner, influence,
                                                    one_thread):
    """d_rel against jax.grad of kpconv_aggregate_reference (the oracle
    path, which the JAX model takes with use_pallas off), rtol 3e-4 and an
    atol of 3e-5 of the largest entry: d_rel scales with 1 / extent.  On
    inputs with two coincident neighbours, and at REL_CORNERS, the shapes
    and layouts that cut kpconv_bwd_drel's tiling ragged (the plain d_rel
    here is what the card holds the kernel to)."""
    if corner is None:
        rng = np.random.default_rng(15)
        arrays = _coincident_inputs(rng)
        g = rng.normal(size=(2, 12, 5)).astype(np.float32)
    else:
        rng = np.random.default_rng(31)
        K, C, P, layout = REL_CORNERS[corner]
        arrays = _corner_inputs(rng, K, C, P, layout)
        g = rng.normal(size=(2, 6, C)).astype(np.float32)
    got, want = _rel_grads(arrays, g, influence)
    assert np.isfinite(want).all()
    if influence == "constant":
        assert np.abs(want).max() == 0 and np.abs(got).max() == 0
        return
    assert np.abs(want).max() > (1.0 if corner is None else 0.0)
    np.testing.assert_allclose(got, want, rtol=3e-4,
                               atol=3e-5 * np.abs(want).max())
    if corner is None:
        np.testing.assert_array_equal(got[0, 0, 0] == 0, want[0, 0, 0] == 0)
    elif corner == "masked_query":
        assert np.abs(got[:, 2]).max() == 0 and np.abs(want[:, 2]).max() == 0
    elif corner == "coincide" and influence == "linear":
        # kernel point 0's term vanishes (zero subgradient at d = 0) in both
        feat, idx, rel, mask, kp, kw = arrays
        others, _ = _rel_grads([feat, idx, rel, mask, kp[1:], kw[1:]], g,
                               influence)
        np.testing.assert_allclose(got[:, 1, 0], others[:, 1, 0], rtol=1e-6,
                                   atol=1e-6 * np.abs(got).max())


def test_rel_gradient_float64_gradcheck():
    """The closed form of d_rel against finite differences, in float64,
    away from the clamp and the coincidence."""
    rng = np.random.default_rng(16)
    feat, idx, rel, mask, kp, kw = (torch.from_numpy(a.astype(
        np.int32 if a.dtype == np.int32 else np.float64))
        for a in _inputs(rng, B=2, M=5, K=4, C=3, N=7))
    for influence in ("linear", "gaussian"):
        r = rel.clone().requires_grad_()
        assert torch.autograd.gradcheck(
            lambda x: tkp.kpconv_aggregate(feat, idx, x, mask, kp, kw, 0.12,
                                           influence), (r,))


def test_two_level_model_input_gradient_matches_jax():
    """The model at tests/test_torch_model.py's small config with input
    points that carry the gradient: the port's xyz gradient against
    jax.grad of the JAX model on the CPU with use_pallas off.  It reaches
    the points through the relative positions of the pyramid's first two
    levels only (level 0's self neighbourhoods and the first pool; the
    subsampled positions stop the gradient in both packages); the features
    are a separate constant.  Weights come from the converter
    with O(1) running stats and final Dense (tests/test_torch_model.py's
    perturbation).  rtol 1e-3 and an atol of 1e-4 of the largest entry:
    the gradient passes a train-free BatchNorm chain and sums over every
    aggregation."""
    from deep3dpointclouddenoising_tpu.config import default_config as jcfg
    from deep3dpointclouddenoising_tpu.models.build import \
        OffsetRegressionModel as JaxModel
    from deep3dpointclouddenoising_torch.config import default_config
    from deep3dpointclouddenoising_torch.convert import (flax_from_params,
                                                         params_from_flax)
    from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
    from test_torch_model import perturb, small_config, small_inputs

    rng = np.random.default_rng(17)
    xyz, mask = small_inputs(rng)
    feats = rng.normal(size=xyz.shape).astype(np.float32)
    jc = small_config(jcfg())
    jc.use_pallas = 0
    jmodel = JaxModel(cfg=jc)
    torch.manual_seed(1)
    tmodel = OffsetRegressionModel(small_config(default_config())).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    g = rng.normal(size=xyz.shape).astype(np.float32)

    def loss(x):
        out = jmodel.apply(variables, x, jnp.asarray(mask),
                           jnp.asarray(feats), train=False)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(xyz)))
    t_xyz = torch.from_numpy(xyz).requires_grad_()
    out = tmodel(t_xyz, torch.from_numpy(mask), torch.from_numpy(feats))
    out.backward(torch.from_numpy(g))
    got = t_xyz.grad.numpy()
    assert np.abs(want).max() > 1.0  # a gradient the check can see
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


def test_check_forward_takes_the_larger_limit():
    """grad_check.check_forward: an element passes within its float32
    noise (three times plain vs float64) even above rtol / atol, and fails
    above both; it reports the element nearest its limit."""
    from deep3dpointclouddenoising_torch.utils import grad_check
    plain = torch.tensor([1000.0, 1.0, -2.0])
    f64 = plain.double() + torch.tensor([0.5, 0.0, 0.0], dtype=torch.float64)
    got = plain + torch.tensor([1.2, 0.0, 1e-4])
    worst = grad_check.check_forward(got, plain, f64, rtol=5e-4, atol=5e-5)
    assert worst["index"] == (0,)
    assert worst["limit"] == pytest.approx(1.5)  # 3 x 0.5 > 5e-5 + 0.5
    with pytest.raises(AssertionError, match=r"output \(0,\)"):
        grad_check.check_forward(plain + torch.tensor([1.6, 0.0, 0.0]),
                                 plain, f64, rtol=5e-4, atol=5e-5)
