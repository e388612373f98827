"""The backward kernel's form on the CPU: the gradients grouped by support
over inverted neighbourhoods, and the inversion itself.

The card's kernel (``csrc/kpconv_bwd.cu``) computes, per support n,
H[n,p,c] = sum over the live edges (m,k) that name n of w[m,k,p] g[m,c],
then d_features = sum_p kw H and d_kernel_weights = sum_n feat H.  Its plain
form, ``kpconv_aggregate_backward_inverted_plain``, is held here to the JAX
package's custom VJP (``jax.vjp`` of the JAX ``kpconv_aggregate`` in
interpret mode: the Pallas backward for linear and gaussian influence with
N <= 2048, the jnp segment-sum path for constant influence and N > 2048) at
tests/test_pallas_kpconv.py's tolerances (rtol 3e-4 / atol 3e-5, rtol 1e-3
/ atol 1e-4 where M is not a multiple of the query tile), and to the port's
plain backward in float64 to 1e-12 (the same sums in another order).
``invert_neighbors_plain`` is held to the structure the kernel writes.
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
    return [rng.normal(size=(B, N, C)).astype(np.float32),
            rng.integers(0, N, size=(B, M, K)).astype(np.int32),
            ((rng.random((B, M, K, 3), dtype=np.float32) * 2 - 1) * 0.1),
            (rng.random((B, M, K)) > 0.3).astype(np.float32),
            ((rng.random((P, 3), dtype=np.float32) * 2 - 1) * 0.08),
            rng.normal(size=(P, C)).astype(np.float32) * 0.1]


def _pad_to_zero(arrays, rows: int):
    """The last ``rows`` query rows padded as the model pads them: every
    index 0 and the mask all ones, so every such edge names support 0."""
    arrays[1][:, -rows:] = 0
    arrays[3][:, -rows:] = 1.0
    return arrays


def _jax_vjp(arrays, g, extent, influence):
    feat, idx, rel, mask, kp, kw = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda f, w: jax_kpconv(f, idx, rel, mask, kp, w,
                                             extent, influence, True),
                     feat, kw)
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


JAX_CASES = {
    # name: (input sizes, influence, rows padded to support 0, rtol, atol);
    # the JAX path it reaches
    "linear": (dict(), "linear", 0, 3e-4, 3e-5),                # Pallas bwd
    "gaussian": (dict(), "gaussian", 0, 3e-4, 3e-5),            # Pallas bwd
    "constant": (dict(), "constant", 0, 3e-4, 3e-5),            # jnp path
    "large_support": (dict(N=2100, C=4, M=20, K=5), "linear", 0, 3e-4,
                      3e-5),                                     # jnp path
    "ragged_tile": (dict(M=131, K=5, C=8, N=40), "linear", 0, 1e-3, 1e-4),
    "padded_rows": (dict(M=20, K=5, C=8, N=30), "linear", 6, 3e-4, 3e-5),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_inverted_form_matches_jax_vjp(case):
    sizes, influence, padded, rtol, atol = JAX_CASES[case]
    rng = np.random.default_rng(21)
    arrays = _pad_to_zero(_inputs(rng, **sizes), padded) if padded \
        else _inputs(rng, **sizes)
    B, M = arrays[1].shape[:2]
    g = rng.normal(size=(B, M, arrays[0].shape[-1])).astype(np.float32)
    want = _jax_vjp(arrays, g, 0.12, influence)
    got = tkp.kpconv_aggregate_backward_inverted_plain(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(g), 0.12,
        influence)
    for name, a, b in zip(("d_features", "d_kernel_weights"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol,
                                   err_msg=name)


FLOAT64_SHAPES = {
    # name: input sizes and a layout: "padded" sends the last 4 query rows'
    # edges to support 0; "holes" keeps every index in the lower half of
    # the supports, so the upper half has in-degree 0; N = 1 puts every edge
    # on one row
    "random": (dict(M=23, K=6, C=5, N=17), None),
    "padded": (dict(M=23, K=6, C=5, N=17), "padded"),
    "holes": (dict(M=9, K=3, C=4, N=40), "holes"),
    "one_support": (dict(M=11, K=4, C=3, N=1), None),
}


@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("shape", sorted(FLOAT64_SHAPES))
def test_inverted_form_matches_plain_float64(influence, shape):
    sizes, layout = FLOAT64_SHAPES[shape]
    rng = np.random.default_rng(22)
    arrays = _inputs(rng, **sizes)
    if layout == "padded":
        arrays = _pad_to_zero(arrays, 4)
    elif layout == "holes":
        arrays[1] = arrays[1] % (sizes["N"] // 2)
    tensors = [torch.from_numpy(a.astype(np.int32 if a.dtype == np.int32
                                         else np.float64)) for a in arrays]
    g = torch.from_numpy(rng.normal(size=(2, sizes["M"], sizes["C"])))
    want = tkp.kpconv_aggregate_backward_plain(*tensors, g, 0.12, influence)
    got = tkp.kpconv_aggregate_backward_inverted_plain(*tensors, g, 0.12,
                                                       influence)
    for a, b in zip(got, want[:2]):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    d_feat, d_kw = tkp.kpconv_aggregate_backward_inverted_plain(
        *tensors, g, 0.12, influence, need_features=False)
    assert d_feat is None and torch.equal(d_kw, got[1])


def _invert_case(name, rng):
    """(idx, mask, N) for one structure case."""
    if name == "random":
        arrays = _inputs(rng, M=30, K=5, N=25)
        return arrays[1], arrays[3], 25
    if name == "one_support":
        return (np.zeros((2, 7, 3), np.int32),
                (rng.random((2, 7, 3)) > 0.5).astype(np.float32), 1)
    if name == "holes":
        arrays = _inputs(rng, M=6, K=4, N=50)
        return arrays[1] % 10, arrays[3], 50
    if name == "sink":
        arrays = _pad_to_zero(_inputs(rng, M=40, K=6, N=20), 25)
        return arrays[1], arrays[3], 20
    if name == "masked_cloud":
        arrays = _inputs(rng, M=12, K=4, N=9)
        arrays[3][1] = 0.0
        return arrays[1], arrays[3], 9
    if name == "out_of_range":
        arrays = _inputs(rng, M=12, K=4, N=9)
        arrays[1][0, 0, :2] = (-1, 9)
        arrays[3][0, 0, :2] = 1.0
        return arrays[1], arrays[3], 9
    raise ValueError(name)


@pytest.mark.parametrize("case", ["random", "one_support", "holes", "sink",
                                  "masked_cloud", "out_of_range"])
def test_invert_neighbors_plain_structure(case):
    """Offsets start at 0 and end at the live-edge count; each support's
    segment lists exactly its live edges, ascending by edge id; masked
    edges and indices outside [0, N) are absent; the tail holds -1."""
    idx, mask, N = _invert_case(case, np.random.default_rng(23))
    offsets, edges = tkp.invert_neighbors_plain(torch.from_numpy(idx),
                                                torch.from_numpy(mask), N)
    B, M, K = idx.shape
    assert offsets.shape == (B, N + 1) and edges.shape == (B, M * K)
    assert offsets.dtype == torch.int32 and edges.dtype == torch.int32
    flat_idx, flat_mask = idx.reshape(B, -1), mask.reshape(B, -1)
    for b in range(B):
        live = (flat_mask[b] != 0) & (flat_idx[b] >= 0) & (flat_idx[b] < N)
        off = offsets[b].numpy()
        assert off[0] == 0 and off[N] == live.sum()
        assert (np.diff(off) >= 0).all()
        for n in range(N):
            seg = edges[b, off[n]:off[n + 1]].numpy()
            want = np.flatnonzero(live & (flat_idx[b] == n))
            np.testing.assert_array_equal(seg, want)  # ascending edge ids
        assert (edges[b, off[N]:].numpy() == -1).all()
    if case == "one_support":
        assert offsets[:, 1].tolist() == (mask != 0).reshape(B, -1).sum(
            1).tolist()
    if case == "holes":
        assert (offsets[:, 11:] == offsets[:, 10:11]).all()  # degree 0
    if case == "masked_cloud":
        assert offsets[1].abs().max() == 0
