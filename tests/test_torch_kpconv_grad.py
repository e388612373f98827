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
    full = tkp.kpconv_aggregate_backward(*arrays, g, 0.12)
    d_feat, d_kw = tkp.kpconv_aggregate_backward(
        *arrays, g, 0.12, need_kernel_weights=False)
    assert d_kw is None and torch.equal(d_feat, full[0])
    d_feat, d_kw = tkp.kpconv_aggregate_backward(*arrays, g, 0.12,
                                                 need_features=False)
    assert d_feat is None and torch.equal(d_kw, full[1])
    # autograd asks only for the kernel weights' gradient here
    kw = arrays[5].clone().requires_grad_()
    tkp.kpconv_aggregate(*arrays[:5], kw, 0.12).backward(g)
    torch.testing.assert_close(kw.grad, full[1], rtol=0, atol=0)
    assert tkp.kpconv_aggregate_backward.launches == 0  # no kernel on CPU
