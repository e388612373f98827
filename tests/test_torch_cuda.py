"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests import no JAX, so they run on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up).  Without a
card they skip.  Tolerances: the aggregation rtol 2e-4 / atol 2e-5 (its
d_rel as the other gradients below); the whole model, element by element,
the larger of rtol 5e-4 / atol 5e-5 (as in the CPU tests against JAX) and
three times the element's own float32 noise, the plain float32 path
against the plain float64 path (grad_check.check_forward); the
backward rtol 3e-4 (the JAX package's gradient tolerance) with an atol of
1e-5 of the largest gradient, since d_kernel_weights sums up to
B*M*K = 416,000 terms and d_features up to thousands (a sink support), in
another order than the plain einsum and index_add_;
whole-model gradients per tensor within three times their own float32
noise, with a floor (utils/grad_check.py says why).
"""
import copy
import os

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.models import local_aggregation
from deep3dpointclouddenoising_torch.ops import kpconv as tkp
from deep3dpointclouddenoising_torch.utils import grad_check

L1_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs", "l1.yaml")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(rng, B, M, N, K, C, P=15):
    """Random inputs with about 30% masked slots and a padded last query row
    (indices 0, mask all ones) as the model makes them."""
    idx = rng.integers(0, N, size=(B, M, K)).astype(np.int32)
    mask = (rng.random((B, M, K)) > 0.3).astype(np.float32)
    idx[:, -1], mask[:, -1] = 0, 1.0
    arrays = (rng.normal(size=(B, N, C)).astype(np.float32), idx,
              ((rng.random((B, M, K, 3)) * 2 - 1) * 0.1).astype(np.float32),
              mask,
              ((rng.random((P, 3)) * 2 - 1) * 0.08).astype(np.float32),
              (rng.normal(size=(P, C)) * 0.1).astype(np.float32))
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("M,N,K,C", [(131, 60, 7, 12), (500, 500, 52, 72),
                                     (3, 15, 26, 1152)])
def test_kpconv_kernel_matches_plain(card, influence, M, N, K, C):
    arrays = [a.to(card) for a in _inputs(np.random.default_rng(2), 16, M,
                                          N, K, C)]
    before = tkp.kpconv_aggregate.launches
    with torch.no_grad():
        got = tkp.kpconv_aggregate(*arrays, 0.12, influence)
        want = tkp.kpconv_aggregate_plain(*arrays, 0.12, influence)
    torch.cuda.synchronize()
    assert tkp.kpconv_aggregate.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_kpconv_kernel_refuses_what_it_does_not_take(card):
    arrays = [a.to(card) for a in _inputs(np.random.default_rng(3), 2, 9, 20,
                                          5, 8)]
    with pytest.raises(TypeError):
        tkp.kpconv_aggregate(arrays[0].double(), *arrays[1:], 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tkp.kpconv_aggregate(arrays[0].transpose(1, 2).contiguous()
                             .transpose(1, 2), *arrays[1:], 0.1)
    g = torch.ones(2, 9, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        tkp.kpconv_aggregate_backward(*arrays, g, 0.1)


def _assert_grad_close(got, want, rtol, atol_frac):
    torch.testing.assert_close(
        got, want, rtol=rtol, atol=atol_frac * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("M,N,K,C", [(131, 60, 7, 12), (500, 500, 52, 72),
                                     (3, 15, 26, 1152)])
def test_kpconv_backward_kernel_matches_plain(card, influence, M, N, K, C):
    rng = np.random.default_rng(5)
    arrays = [a.to(card) for a in _inputs(rng, 16, M, N, K, C)]
    g = torch.from_numpy(rng.normal(size=(16, M, C)).astype(
        np.float32)).to(card)
    before = tkp.kpconv_aggregate_backward.launches
    got = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, influence)
    want = tkp.kpconv_aggregate_backward_plain(*arrays, g, 0.12, influence,
                                               need_rel=True)
    torch.cuda.synchronize()
    assert tkp.kpconv_aggregate_backward.launches == before + 1
    assert got[2] is None
    for a, b in zip(got[:2], want):
        _assert_grad_close(a, b, 3e-4, 1e-5)
    # with d_rel (the kernel's DREL variant)
    got = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, influence,
                                        need_rel=True)
    for a, b in zip(got, want):
        _assert_grad_close(a, b, 3e-4, 1e-5)
    # only what is asked for, and the autograd function routes to it
    d_feat, d_kw, d_rel = tkp.kpconv_aggregate_backward(
        *arrays, g, 0.12, influence, need_features=False)
    assert d_feat is None and d_rel is None
    _assert_grad_close(d_kw, want[1], 3e-4, 1e-5)
    feat = arrays[0].clone().requires_grad_()
    rel = arrays[2].clone().requires_grad_()
    out = tkp.kpconv_aggregate(feat, arrays[1], rel, *arrays[3:], 0.12,
                               influence)
    out.backward(g)
    assert tkp.kpconv_aggregate_backward.launches == before + 4
    _assert_grad_close(feat.grad, want[0], 3e-4, 1e-5)
    _assert_grad_close(rel.grad, want[2], 3e-4, 1e-5)


def _l1_model_outputs(card, monkeypatch, aggregate=None):
    """The l1.yaml model's eval output on one B=4 pyramid through the
    kernel (or ``aggregate`` in its place), the plain path's and the plain
    path's in float64, and the kernel's launches.  BatchNorm running stats
    and the final Dense get O(1) values, as chip_smoke.py's seeded model
    does: the head's 1e-4 init would leave outputs that atol 5e-5 hides."""
    cfg = load_config(L1_YAML)
    torch.manual_seed(0)
    model = OffsetRegressionModel(cfg).eval()
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(size=buf.shape).astype(np.float32) * 0.5))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 2.0, size=buf.shape).astype(np.float32)))
        dense = model.MultiDimHead_0.Dense_0
        for param in (dense.weight, dense.bias):
            param.copy_(torch.from_numpy(
                rng.normal(size=tuple(param.shape)).astype(np.float32)))
    model = model.to(card)
    xyz = rng.normal(size=(4, 500, 3))
    xyz = 0.05 * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True) \
        * rng.random((4, 500, 1))
    xyz = torch.from_numpy(xyz.astype(np.float32)).to(card)
    mask = torch.ones(4, 500, device=card)
    with torch.no_grad():
        pyr = model.make_pyramid(xyz, mask)
        before = tkp.kpconv_aggregate.launches
        if aggregate is not None:
            monkeypatch.setattr(local_aggregation, "kpconv_aggregate",
                                aggregate)
        got = model.MultiDimHead_0(pyr, model.ResNetEncoder_0(pyr, xyz))
        launches = tkp.kpconv_aggregate.launches - before
        monkeypatch.setattr(local_aggregation, "kpconv_aggregate",
                            tkp.kpconv_aggregate_plain)
        want = model.MultiDimHead_0(pyr, model.ResNetEncoder_0(pyr, xyz))
        model64 = copy.deepcopy(model).double()
        want64 = model64.MultiDimHead_0(
            pyr, model64.ResNetEncoder_0(pyr, xyz.double()))
    return got, want, want64, launches


@pytest.mark.cuda
def test_l1_model_kernel_matches_plain(card, monkeypatch):
    """Each output element within the larger of rtol 5e-4 / atol 5e-5 and
    three times its own float32 noise (grad_check.check_forward)."""
    got, want, want64, launches = _l1_model_outputs(card, monkeypatch)
    assert launches == 10
    grad_check.check_forward(got, want, want64, rtol=5e-4, atol=5e-5)


@pytest.mark.cuda
def test_forward_check_catches_one_scaled_aggregation(card, monkeypatch):
    """The whole-model forward check fails when the stem's aggregation
    returns its output 1e-3 too large."""
    calls = []

    def scaled(*args):
        out = tkp.kpconv_aggregate(*args)
        calls.append(1)
        return out * (1.0 + 1e-3) if len(calls) == 1 else out

    got, want, want64, _ = _l1_model_outputs(card, monkeypatch, scaled)
    assert len(calls) == 10
    with pytest.raises(AssertionError, match="forward: output"):
        grad_check.check_forward(got, want, want64, rtol=5e-4, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("case", [
    # (B, M, N, K, C, P): ragged M, C off the tile and off 4, K = 1 and
    # 65, P = 1 and 16, N = 1
    (2, 1, 20, 9, 24, 15), (2, 9, 20, 9, 24, 15), (4, 31, 40, 12, 40, 15),
    (2, 17, 30, 10, 8, 15), (2, 17, 30, 10, 72, 15),
    (2, 5, 30, 10, 1160, 15), (2, 17, 30, 10, 13, 15),
    (2, 17, 30, 10, 6, 15), (2, 17, 30, 1, 40, 15), (2, 17, 70, 65, 40, 15),
    (2, 17, 30, 10, 40, 1), (2, 17, 30, 10, 40, 16), (2, 17, 1, 10, 40, 15),
])
def test_kpconv_kernel_edges_match_plain(card, influence, case):
    """The forward kernel at the edges of its tiling, against plain at
    rtol 2e-4 / atol 2e-5; the first query row of each cloud has its mask
    all zero."""
    B, M, N, K, C, P = case
    rng = np.random.default_rng(7)
    arrays = _inputs(rng, B, M, N, K, C, P)
    arrays[3][:, 0] = 0.0
    arrays = [a.to(card) for a in arrays]
    with torch.no_grad():
        got = tkp.kpconv_aggregate(*arrays, 0.12, influence)
        want = tkp.kpconv_aggregate_plain(*arrays, 0.12, influence)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    assert got[:, 0].abs().max() == 0


def _l1_model_gradients(card):
    """grad_check's gradients of the l1.yaml model in train mode on one
    B=4 batch of points in a ball of radius 0.05."""
    cfg = load_config(L1_YAML)
    model = OffsetRegressionModel(
        cfg, generator=torch.Generator().manual_seed(0)).to(card).train()
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(4, 500, 3))
    xyz = 0.05 * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True) \
        * rng.random((4, 500, 1))
    xyz = torch.from_numpy(xyz.astype(np.float32)).to(card)
    mask = torch.ones(4, 500, device=card)
    mask[-1, -40:] = 0.0
    target = torch.from_numpy(rng.normal(size=(4, 500, 3)).astype(
        np.float32) * 0.01).to(card)
    pyr = model.make_pyramid(xyz, mask)
    return grad_check.model_gradients(model, pyr, xyz, target, mask)


@pytest.mark.cuda
def test_l1_model_gradients_kernel_match_plain(card):
    """Train-mode gradients of every parameter under the masked L1 loss on
    one batch and one pyramid: through the backward kernel against the
    plain backward on the same forward graph, and the kernel path against
    the plain path, each tensor within three times its own float32 noise
    (utils/grad_check.py)."""
    grads = _l1_model_gradients(card)
    assert grads["launches"] == (10, 10)
    torch.testing.assert_close(grads["loss"], grads["plain_loss"],
                               rtol=1e-5, atol=0)
    assert len(grad_check.check_model_gradients(grads)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1])   # d_features, d_kernel_weights
def test_grad_check_catches_a_scaled_backward(card, monkeypatch, which):
    """The whole-model check fails when every backward call returns one of
    its two gradients 10% too large."""
    backward = tkp.kpconv_aggregate_backward

    def scaled(*args, **kwargs):
        grads = list(backward(*args, **kwargs))
        if grads[which] is not None:
            grads[which] = grads[which] * 1.1
        return tuple(grads)

    scaled.launches = 0
    monkeypatch.setattr(tkp, "kpconv_aggregate_backward", scaled)
    grads = _l1_model_gradients(card)
    with pytest.raises(AssertionError, match="gradient of"):
        grad_check.check_model_gradients(grads)

def _backward_edge_inputs(rng, influence, case):
    """Backward inputs for one edge case: ``case`` is (B, M, N, K, C, P,
    layout); layout "sink" sends every edge of the first half of the
    queries (more than half of the live edges) to support 3, "holes" keeps
    every index in the lower half of the supports (the upper half has
    in-degree 0), "coincide" puts query 1's first and last neighbours
    exactly on the first and the last kernel point (d = 0, live), "clamp"
    moves every other neighbour four times as far out (most past the
    extent, where linear influence is clamped); the first query row of
    each cloud has its mask all zero."""
    B, M, N, K, C, P, layout = case
    arrays = _inputs(rng, B, M, N, K, C, P)
    if layout == "sink":
        arrays[1][:, :M // 2 + 1] = min(3, N - 1)
        arrays[3][:, :M // 2 + 1] = 1.0
    elif layout == "holes":
        arrays[1] = arrays[1] % max(1, N // 2)
    elif layout == "coincide":
        arrays[2][:, 1, 0] = arrays[4][0]
        arrays[2][:, 1, -1] = arrays[4][-1]
        arrays[3][:, 1] = 1.0
    elif layout == "clamp":
        arrays[2][:, :, ::2] *= 4.0
    arrays[3][:, 0] = 0.0
    g = torch.from_numpy(rng.normal(size=(B, M, C)).astype(np.float32))
    return arrays, g


BACKWARD_EDGE_CASES = [
    # (B, M, N, K, C, P, layout): a ragged support tile (N = 13, 60), C off
    # the tile and off 4 (6, 13) and at its edges (72, 1160), K = 1 and 65,
    # P = 1 and 16, N = 1 (every edge on one row), N = 2100 (two support
    # ranges in the inversion, and two slices of edge ids), sinks (one
    # across ten slices), in-degree-0 supports
    (2, 17, 13, 10, 40, 15, "random"), (4, 31, 60, 12, 24, 15, "random"),
    (2, 17, 30, 10, 6, 15, "random"), (2, 17, 30, 10, 13, 15, "random"),
    (2, 17, 30, 10, 72, 15, "random"), (2, 5, 30, 10, 1160, 15, "random"),
    (2, 17, 30, 1, 40, 15, "random"), (2, 17, 70, 65, 40, 15, "random"),
    (2, 17, 30, 10, 40, 1, "random"), (2, 17, 30, 10, 40, 16, "random"),
    (2, 17, 1, 10, 40, 15, "random"), (2, 400, 2100, 12, 24, 15, "random"),
    (2, 200, 40, 30, 72, 15, "sink"), (1, 1000, 50, 40, 16, 15, "sink"),
    (2, 17, 200, 3, 40, 15, "holes"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("case", BACKWARD_EDGE_CASES)
def test_kpconv_backward_kernel_edges_match_plain(card, influence, case):
    """The backward kernel at the edges of its tiling and of the inverted
    neighbourhoods, against plain at rtol 3e-4 and an atol of 1e-5 of the
    largest gradient; supports no live edge names get exact zeros."""
    arrays, g = _backward_edge_inputs(np.random.default_rng(8), influence,
                                      case)
    arrays, g = [a.to(card) for a in arrays], g.to(card)
    got = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, influence)
    want = tkp.kpconv_aggregate_backward_plain(*arrays, g, 0.12, influence)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        _assert_grad_close(a, b, 3e-4, 1e-5)
    N = arrays[0].shape[1]
    offsets, _ = tkp.invert_neighbors_plain(arrays[1].cpu(), arrays[3].cpu(),
                                            N)
    idle = (offsets[:, 1:] == offsets[:, :-1]).to(card)
    if idle.any():
        assert got[0][idle].abs().max().item() == 0
    if case[-1] == "holes":
        assert idle.sum().item() >= N // 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(16, 500, 500, 52, 72, 15, "random"),
                                  (16, 3, 3, 26, 1152, 15, "random"),
                                  (2, 200, 40, 30, 72, 15, "sink")])
def test_kpconv_backward_kernel_is_deterministic(card, case):
    """Two calls on the same inputs give bitwise equal d_features and
    d_kernel_weights: no float atomics on the training path."""
    arrays, g = _backward_edge_inputs(np.random.default_rng(9), "linear",
                                      case)
    arrays, g = [a.to(card) for a in arrays], g.to(card)
    first = tkp.kpconv_aggregate_backward(*arrays, g, 0.12)
    second = tkp.kpconv_aggregate_backward(*arrays, g, 0.12)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


# -- the deployed protocol's device paths -------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "near_duplicates"])
def test_device_nn_dists_match_kdtree(card, case):
    """The brute-force NN distances on the card against the host KD-tree at
    20,000 points, rtol 1e-6 (float32 against float64)."""
    from deep3dpointclouddenoising_torch import evaluate
    rng = np.random.default_rng(12)
    y = rng.normal(size=(20000, 3)).astype(np.float32)
    if case == "random":
        x = rng.normal(size=(20000, 3)).astype(np.float32)
    else:
        step = rng.normal(size=y.shape)
        step *= rng.uniform(1e-4, 1e-3, size=(len(y), 1)) / np.linalg.norm(
            step, axis=1, keepdims=True)
        x = (y + step).astype(np.float32)
    got = evaluate._nn_dists_device(x, y, device=card)
    np.testing.assert_allclose(got, evaluate._nn_dists(x, y), rtol=1e-6)
    table = evaluate.chamfer_ratio_table([y], [x], [x], device=True)
    want = evaluate.chamfer_ratio_table([y], [x], [x])
    np.testing.assert_allclose(table["mean"]["cd_noisy"],
                               want["mean"]["cd_noisy"], rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("num_votes", [1, 2])
def test_device_voting_matches_host_voting(card, tmp_path, num_votes):
    """Device voting through the kernel path of a small l1.yaml model
    against host voting on a two-shape tree: per point within rtol 1e-5 /
    atol 1e-6, with the same forward launches."""
    from deep3dpointclouddenoising_torch import infer
    from deep3dpointclouddenoising_torch.data.offset_dataset import \
        OffsetDataset
    from deep3dpointclouddenoising_torch.data.synthetic import (
        make_icosphere, make_torus)
    cfg = load_config(L1_YAML, {"width": 16, "num_points": 128})
    ds = OffsetDataset(str(tmp_path), "qualitative_test", in_radius=0.3,
                       num_points=128, num_points_per_shape=3000,
                       sample_dl_patches=0.2, seed=1,
                       shapes={"qualitative_test/sphere": make_icosphere(2),
                               "qualitative_test/torus": make_torus()})
    torch.manual_seed(0)
    predict = infer.make_predict_fn(OffsetRegressionModel(cfg).to(card))
    before = tkp.kpconv_aggregate.launches
    host = infer.predict_offsets_voting(predict, ds, 16, num_votes)
    mid = tkp.kpconv_aggregate.launches
    dev = infer.predict_offsets_voting_device(predict, ds, 16, num_votes,
                                              device=card)
    batches = -(-len(ds) // 16)
    assert mid - before == tkp.kpconv_aggregate.launches - mid \
        == 10 * batches * num_votes
    for h, d in zip(host, dev):
        assert np.isfinite(d).all() and np.abs(h).max() > 0
        np.testing.assert_allclose(d, h, rtol=1e-5, atol=1e-6)


# -- full cleaning and the Chamfer losses ------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("num_votes", [1, 2])
def test_device_cleaning_matches_host_cleaning(card, tmp_path, num_votes):
    """Full cleaning through the kernel path of a small four-output model
    (its final Dense at O(0.1), so the outlier logits spread) on a tree
    with 40% box outliers: device voting against host voting, offsets and
    outlier probabilities within rtol 1e-5 / atol 1e-6, ``keep`` equal but
    within 1e-6 of the threshold, the same forward launches."""
    from deep3dpointclouddenoising_torch import infer
    from deep3dpointclouddenoising_torch.data.offset_dataset import \
        OffsetDataset
    from deep3dpointclouddenoising_torch.data.synthetic import (
        make_icosphere, make_torus)
    from deep3dpointclouddenoising_torch.models import CompleteDenoisingModel
    cfg = load_config(L1_YAML, {"width": 16, "num_points": 128})
    ds = OffsetDataset(str(tmp_path), "qualitative_test", in_radius=0.3,
                       num_points=128, num_points_per_shape=3000,
                       outlier_proportion=0.4, sample_dl_patches=0.2, seed=1,
                       shapes={"qualitative_test/sphere": make_icosphere(2),
                               "qualitative_test/torus": make_torus()})
    gen = torch.Generator().manual_seed(0)
    model = CompleteDenoisingModel(cfg, gen)
    with torch.no_grad():
        model.MultiDimHead_0.Dense_0.weight.normal_(0.0, 0.1, generator=gen)
    predict = infer.make_predict_fn(model.to(card), scale_outputs=False)
    before = tkp.kpconv_aggregate.launches
    host = infer.clean_clouds(predict, ds, 16, num_votes=num_votes)
    mid = tkp.kpconv_aggregate.launches
    dev = infer.clean_clouds_device(predict, ds, 16, num_votes=num_votes,
                                    device=card)
    batches = -(-len(ds) // 16)
    assert mid - before == tkp.kpconv_aggregate.launches - mid \
        == 10 * batches * num_votes
    for h, d in zip(host, dev):
        assert 0 < h["keep"].sum() < len(h["keep"])
        np.testing.assert_allclose(d["offsets"], h["offsets"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(d["outlier_prob"], h["outlier_prob"],
                                   rtol=1e-5, atol=1e-6)
        near = np.abs(h["outlier_prob"] - 0.5) < 1e-6
        np.testing.assert_array_equal(d["keep"][~near], h["keep"][~near])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chamfer_L1", "chamfer_sparse",
                                  "l1_chamfer_adaptive_to_l1"])
def test_chamfer_losses_on_card_match_cpu(card, name):
    """A Chamfer loss and its gradient on the card against the same call on
    the CPU at B=16, N=500, patch-like clouds: the matched indices equal,
    the value within rtol 1e-5, the gradient within rtol 1e-4 / atol 1e-6
    of its max-abs (random points have no near-ties)."""
    from deep3dpointclouddenoising_torch.losses import chamfer
    from deep3dpointclouddenoising_torch.losses.build import \
        get_offset_regression_loss
    rng = np.random.default_rng(21)
    points = (rng.normal(size=(16, 500, 3)) * 0.02).astype(np.float32)
    target = (rng.normal(size=(16, 500, 3)) * 1e-3).astype(np.float32)
    pred = (target + rng.normal(size=target.shape) * 5e-4).astype(np.float32)
    mask = np.ones((16, 500), np.float32)
    mask[-1, 400:] = 0.0
    out = {}
    for dev in (card, torch.device("cpu")):
        p = torch.from_numpy(pred).to(dev).requires_grad_(True)
        t, m, x = (torch.from_numpy(a).to(dev) for a in (target, mask,
                                                         points))
        loss = get_offset_regression_loss(name)(p, t, m, x)
        loss.backward()
        idx = chamfer.nearest_indices(x + t, x + p.detach(), m)
        out[dev.type] = (loss.item(), p.grad.cpu(), idx.cpu())
    (lg, gg, ig), (lc, gc, ic) = out["cuda"], out["cpu"]
    assert torch.equal(ig, ic)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    torch.testing.assert_close(gg, gc, rtol=1e-4,
                               atol=1e-6 * gc.abs().max().item())


def _sparse_patch(rng, B, N, real, radius):
    """15k-like patches: ``real`` points in a ball, the other slots padding
    that copies real points (mask 0)."""
    xyz = rng.normal(size=(B, N, 3))
    xyz *= (radius * rng.random((B, N, 1)) ** (1 / 3)
            / np.linalg.norm(xyz, axis=-1, keepdims=True))
    pick = rng.integers(0, real, size=(B, N - real))
    xyz[:, real:] = np.take_along_axis(xyz[:, :real], pick[..., None], 1)
    mask = np.zeros((B, N), np.float32)
    mask[:, :real] = 1.0
    return torch.from_numpy(xyz.astype(np.float32)), torch.from_numpy(mask)


@pytest.mark.cuda
def test_grid_subsampling_on_card_is_reproducible_and_matches_cpu(card):
    """Subsampling 15,000-slot sparse patches to 4,096 and dense 500-point
    ones to 256, on voxels that hold ~8 points each: barycentres and
    masks on the card equal the CPU's bitwise, in two runs (the segment
    sums add in point order on both, so no run-to-run ulp moves a
    next-level neighbour)."""
    from deep3dpointclouddenoising_torch.ops.subsample import \
        masked_grid_subsampling
    rng = np.random.default_rng(34)
    xyz, mask = _sparse_patch(rng, 4, 15000, 900, 0.05)
    dense = torch.from_numpy(
        (rng.random((2, 500, 3)) * 0.1).astype(np.float32))
    for pts, msk, npoint, dl in ((xyz, mask, 4096, 0.02),
                                 (dense, torch.ones(2, 500), 256, 0.03)):
        want = masked_grid_subsampling(pts, msk, npoint=npoint,
                                       sample_dl=dl)
        assert 1.0 < float(want[1].sum(1).min()) < npoint
        for _ in range(2):
            got = masked_grid_subsampling(pts.to(card), msk.to(card),
                                          npoint=npoint, sample_dl=dl)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [None, False])
def test_15k_neighbour_queries_on_card_match_cpu(card, compact, monkeypatch):
    """The stem's ball query and the 1-NN upsample of two 15,000-slot
    patches (900 and 5,000 real points: the compacted supports take the
    stable sort and the int64 top-k) on the card equal the CPU's bitwise,
    chunked and, by default, over the compacted supports."""
    from deep3dpointclouddenoising_torch.ops import neighbors as tnb
    xyz, mask = _sparse_patch(np.random.default_rng(31), 2, 15000, 900,
                              0.05)
    more, more_mask = _sparse_patch(np.random.default_rng(32), 1, 15000,
                                    5000, 0.05)
    xyz, mask = torch.cat([xyz, more]), torch.cat([mask, more_mask])
    if compact is not None:  # force the choice auto_compact makes
        monkeypatch.setattr(tnb, "auto_compact", lambda b, m, n: compact)
    out = {}
    for dev in (torch.device("cpu"), card):
        x, m = xyz.to(dev), mask.to(dev)
        idx, msk = tnb.masked_ordered_ball_query(
            x, x, m, m, radius=0.025, nsample=26)
        up, _ = tnb.masked_nearest_query(x, x[:, :4096], m, m[:, :4096])
        out[dev.type] = [t.cpu() for t in (idx, msk, up)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kpconv_backward_kernel_at_a_sink_is_float32_accurate(card):
    """Four supports named by 6,500 edges each (like the few real points
    of a sparse patch, which its padding queries name): d_features and
    d_kernel_weights against the plain backward in float64 within three
    times the plain float32 backward's own distance from it (relative L2).
    The kernel adds each chunk's product to H in float32, where chaining
    one tensor-core accumulator over a support's chunks drifts."""
    rng = np.random.default_rng(33)
    B, M, N, K, C = 2, 1000, 1000, 26, 72
    arrays = _inputs(rng, B, M, N, K, C)
    arrays[1][:, :, :] = torch.from_numpy(
        rng.integers(0, 4, size=(B, M, K)).astype(np.int32))
    arrays[3][:] = 1.0
    g = torch.from_numpy(rng.normal(size=(B, M, C)).astype(np.float32))
    want = tkp.kpconv_aggregate_backward_plain(
        *[a.double() if a.is_floating_point() else a for a in arrays],
        g.double(), 0.12, "linear")
    plain = tkp.kpconv_aggregate_backward_plain(*arrays, g, 0.12, "linear")
    got = tkp.kpconv_aggregate_backward(*[a.to(card) for a in arrays],
                                        g.to(card), 0.12, "linear")
    torch.cuda.synchronize()
    for k in range(2):
        limit = grad_check.NOISE_FACTOR * grad_check.l2_distance(
            plain[k], want[k])
        assert grad_check.l2_distance(got[k].cpu(), want[k]) <= limit


@pytest.mark.cuda
def test_chamfer15k_train_step_gradients_are_bitwise_reproducible(card):
    """Two train steps of ``cfgs/synthetic_quality_chamfer15k.yaml`` (width
    144, B=8, 15,000 slots, the Chamfer loss) from the same weights on the
    same batch of sparse patches: the losses, every gradient and every
    updated parameter bitwise equal.  The Chamfer loss's matched points
    are gathered by advanced indexing, whose backward adds each point's
    gradients in a fixed order; a backward that adds them by float atomics
    (``torch.gather``'s) varies from run to run."""
    from deep3dpointclouddenoising_torch.train.trainer import Trainer
    cfg = load_config(os.path.join(os.path.dirname(L1_YAML),
                                   "synthetic_quality_chamfer15k.yaml"))
    assert (int(cfg.width), int(cfg.num_points), cfg.loss) == (144, 15000,
                                                               "chamfer")
    rng = np.random.default_rng(35)
    xyz, mask = _sparse_patch(rng, 8, 15000, 600, 0.05)
    batch = {"points": xyz, "mask": mask, "features": xyz.clone(),
             "offsets": torch.from_numpy(
                 (rng.normal(size=(8, 15000, 3)) * 1e-3).astype(np.float32)),
             "labels": torch.zeros(8, 15000, dtype=torch.int32)}
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, 1, torch.Generator().manual_seed(0), card)
        loss = trainer.train_step(batch)
        grads = [p.grad.clone() for p in trainer.model.parameters()]
        runs.append((loss.item(), grads, [p.detach().clone() for p in
                                          trainer.model.parameters()]))
    (l0, g0, p0), (l1, g1, p1) = runs
    assert l0 == l1
    for a, b in zip(g0 + p0, g1 + p1):
        assert torch.equal(a, b)


# -- bfloat16 compute and resume ----------------------------------------------

def _assert_bf16_close(got, want, atol):
    """Each element within one bf16 ulp of the plain value, plus ``atol``
    for sums that cancel: kernel and plain version each round a float32
    sum once."""
    grad_check.check_bf16(got, want, atol, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("M,N,K,C", [(131, 60, 7, 12), (500, 500, 52, 72),
                                     (3, 15, 26, 1152)])
def test_bf16_kpconv_kernels_match_plain(card, influence, M, N, K, C):
    """The bf16 forms (kpconv_fwd_bf16, kpconv_bwd_bf16) against the bf16
    plain versions: the output and d_features within one bf16 ulp (plus
    the float32 tolerances' atol), d_kernel_weights (float32) at rtol 3e-4
    / atol 1e-5 of its largest entry; counted as bf16 launches only.  C =
    12 takes the element-by-element copies (C % 8 != 0)."""
    arrays = [a.to(card) for a in _inputs(np.random.default_rng(41), 16, M,
                                          N, K, C)]
    arrays[0] = arrays[0].to(torch.bfloat16)
    g = torch.randn(16, M, C, device=card).to(torch.bfloat16)
    counts = [(w.launches, w.launches_bf16) for w in (
        tkp.kpconv_aggregate, tkp.kpconv_aggregate_backward)]
    with torch.no_grad():
        got = tkp.kpconv_aggregate(*arrays, 0.12, influence)
    got_b = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, influence)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_bf16) for w in (
        tkp.kpconv_aggregate, tkp.kpconv_aggregate_backward)] == [
            (f, b + 1) for f, b in counts]
    want = tkp.kpconv_aggregate_plain(*arrays, 0.12, influence)
    want_b = tkp.kpconv_aggregate_backward_plain(*arrays, g, 0.12, influence)
    _assert_bf16_close(got, want, 2e-5)
    _assert_bf16_close(got_b[0], want_b[0],
                       1e-5 * want_b[0].abs().max().item())
    assert got_b[1].dtype == torch.float32
    _assert_grad_close(got_b[1], want_b[1], 3e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(16, 500, 500, 52, 72, 15, "random"),
                                  (2, 200, 40, 30, 72, 15, "sink")])
def test_bf16_kpconv_backward_kernel_is_deterministic(card, case):
    arrays, g = _backward_edge_inputs(np.random.default_rng(43), "linear",
                                      case)
    arrays, g = [a.to(card) for a in arrays], g.to(card).to(torch.bfloat16)
    arrays[0] = arrays[0].to(torch.bfloat16)
    first = tkp.kpconv_aggregate_backward(*arrays, g, 0.12)
    second = tkp.kpconv_aggregate_backward(*arrays, g, 0.12)
    torch.cuda.synchronize()
    assert first[0].dtype == torch.bfloat16
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_bf16_kpconv_refuses_mixed_dtypes_and_the_gradient_in_rel(card):
    arrays = [a.to(card) for a in _inputs(np.random.default_rng(44), 2, 9, 20,
                                          5, 8)]
    arrays[0] = arrays[0].to(torch.bfloat16)
    with pytest.raises(TypeError, match="grad_out"):
        tkp.kpconv_aggregate_backward(
            *arrays, torch.ones(2, 9, 8, device=card), 0.1)
    with pytest.raises(NotImplementedError, match="no bfloat16 form"):
        tkp.kpconv_aggregate_backward(
            *arrays, torch.ones(2, 9, 8, device=card, dtype=torch.bfloat16),
            0.1, need_rel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["l1", "synthetic_quality_diverse_bf16"])
def test_resumed_steps_on_card_equal_straight_steps(card, tmp_path, config):
    """A width-144 run on the card (l1.yaml, and its bf16 twin of the
    deployed protocol): four straight train steps against two, a
    checkpoint, a restore into a trainer built afresh from another seed,
    and two more, bitwise: parameters, BatchNorm buffers, Adam's state,
    the update count and the LR."""
    from deep3dpointclouddenoising_torch.train.trainer import Trainer
    from deep3dpointclouddenoising_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    cfg = load_config(os.path.join(os.path.dirname(L1_YAML),
                                   config + ".yaml"))
    assert int(cfg.width) == 144
    rng = np.random.default_rng(45)
    batches = []
    for _ in range(4):
        xyz = rng.normal(size=(16, 500, 3))
        xyz = (0.05 * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
               * rng.random((16, 500, 1))).astype(np.float32)
        batches.append({"points": xyz, "mask": np.ones((16, 500), np.float32),
                        "features": xyz.copy(), "offsets": (rng.normal(
                            size=(16, 500, 3)) * 1e-3).astype(np.float32)})
    straight = Trainer(cfg, 1, torch.Generator().manual_seed(0), card)
    for b in batches:
        straight.train_step(b)
    first = Trainer(cfg, 1, torch.Generator().manual_seed(0), card)
    for b in batches[:2]:
        first.train_step(b)
    path = save_checkpoint(str(tmp_path / "half.pt"), first.model,
                           first.optimizer, first.step)
    resumed = Trainer(cfg, 1, torch.Generator().manual_seed(5), card)
    assert load_checkpoint(path, resumed) == 2
    for b in batches[2:]:
        resumed.train_step(b)
    torch.cuda.synchronize()
    assert resumed.step == straight.step == 4
    for a, b in ((resumed.model.state_dict(), straight.model.state_dict()),
                 (resumed.optimizer.state_dict(),
                  straight.optimizer.state_dict())):
        assert not grad_check.state_difference(a, b)
    assert [g["lr"] for g in resumed.optimizer.optimizer.param_groups] == \
        [g["lr"] for g in straight.optimizer.optimizer.param_groups]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BACKWARD_EDGE_CASES)
def test_bf16_kpconv_kernels_edges_match_plain(card, case):
    """The bf16 forms at the backward's edge cases (C off 8 and odd, K = 1
    and 65, P = 1 and 16, N = 1 and 2100, sinks, in-degree-0 supports),
    held as in test_bf16_kpconv_kernels_match_plain."""
    arrays, g = _backward_edge_inputs(np.random.default_rng(46), "linear",
                                      case)
    arrays, g = [a.to(card) for a in arrays], g.to(card).to(torch.bfloat16)
    arrays[0] = arrays[0].to(torch.bfloat16)
    with torch.no_grad():
        got = tkp.kpconv_aggregate(*arrays, 0.12)
    got_b = tkp.kpconv_aggregate_backward(*arrays, g, 0.12)
    torch.cuda.synchronize()
    want = tkp.kpconv_aggregate_plain(*arrays, 0.12)
    want_b = tkp.kpconv_aggregate_backward_plain(*arrays, g, 0.12)
    _assert_bf16_close(got, want, 2e-5)
    _assert_bf16_close(got_b[0], want_b[0],
                       1e-5 * want_b[0].abs().max().item())
    _assert_grad_close(got_b[1], want_b[1], 3e-4, 1e-5)


# -- the other aggregations and the attention operators -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["POTR", "CAA"])
def test_attention_train_steps_are_bitwise_reproducible(card, name):
    """Two train steps of ``cfgs/POTR.yaml`` (point-transformer) and
    ``cfgs/CAA.yaml`` (channel affinity attention) at width 144, B=16,
    N=500, twice from the same weights on the same patch-like batch: the
    losses, every gradient, parameter and BatchNorm buffer bitwise equal.
    The neighbour gathers' backward (advanced indexing) sorts its indices
    and adds in order; the attention's matmuls, softmaxes and BatchNorms
    reduce in a fixed order.  A failure names the first tensor, in the
    model's order, that differs."""
    from deep3dpointclouddenoising_torch.train.trainer import Trainer
    cfg = load_config(os.path.join(os.path.dirname(L1_YAML),
                                   name + ".yaml"))
    assert (int(cfg.width), int(cfg.batch_size), int(cfg.num_points),
            cfg.local_aggregation_type) == (144, 16, 500, "attention")
    rng = np.random.default_rng(43)
    xyz = rng.normal(size=(16, 500, 3))
    xyz = cfg.in_radius * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz = (xyz * rng.random((16, 500, 1))).astype(np.float32)
    mask = np.ones((16, 500), np.float32)
    mask[-1, -50:] = 0.0
    xyz[-1, -50:] = xyz[-1, :50]
    batch = {"points": xyz, "mask": mask, "features": xyz.copy(),
             "offsets": (rng.normal(size=(16, 500, 3)) * 0.01).astype(
                 np.float32)}
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, 1, torch.Generator().manual_seed(0), card)
        losses = [trainer.train_step(batch).item() for _ in range(2)]
        state = {n: p.grad.clone() for n, p in
                 trainer.model.named_parameters()}
        state.update({n + " (after)": t.detach().clone() for n, t in
                      trainer.model.state_dict().items()})
        runs.append((losses, state))
    assert runs[0][0] == runs[1][0], f"losses {runs[0][0]} {runs[1][0]}"
    differ = [n for n, t in runs[0][1].items()
              if not torch.equal(t, runs[1][1][n])]
    assert not differ, f"{len(differ)} tensors differ, first {differ[0]}"


# -- the GAN: the gradient in rel ---------------------------------------------

DREL_CASES = [
    # (B, M, N, K, C, P, layout): the GAN's level-0 shapes and a deep one;
    # a sink; chunks of 8 edges cut ragged (K = 1, 7, 9, 65); 4-byte copies
    # and ragged 8-channel groups (C = 6, 13); a long channel chain (C =
    # 1160, 17 tiles); P = 1; a ragged last query tile (M = 18); a query
    # with every edge masked (query 0, every case); rel exactly at a
    # kernel point; edges past the extent; N = 2100 with a sink
    (16, 500, 500, 52, 72, 15, "random"),
    (16, 500, 500, 52, 144, 15, "random"),
    (16, 3, 3, 26, 1152, 15, "random"), (2, 200, 40, 30, 72, 15, "sink"),
    (2, 17, 30, 1, 40, 15, "random"), (2, 17, 30, 7, 40, 15, "random"),
    (2, 17, 30, 9, 40, 15, "random"), (2, 17, 70, 65, 40, 15, "random"),
    (2, 17, 30, 10, 6, 15, "random"), (2, 17, 30, 10, 13, 15, "random"),
    (2, 5, 30, 10, 1160, 15, "random"), (2, 17, 30, 10, 40, 1, "random"),
    (2, 18, 30, 10, 40, 15, "random"), (2, 17, 30, 10, 40, 15, "coincide"),
    (2, 17, 30, 10, 40, 15, "clamp"), (2, 400, 2100, 12, 24, 15, "sink"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("influence", ["linear", "gaussian", "constant"])
@pytest.mark.parametrize("case", DREL_CASES)
def test_kpconv_drel_is_deterministic_and_matches_plain(card, influence,
                                                        case):
    """``kpconv_bwd_drel`` (C = 72 and 144, the GAN's level-0 widths, one
    and two channel tiles, and 1152, 16 tiles) and the edges of its tiling
    (DREL_CASES): d_rel, d_features and d_kernel_weights bitwise equal over
    two calls (d_rel has no float atomics), each within rtol 3e-4 and an
    atol of 1e-5 of its largest of the plain version, and d_rel so of the
    plain version in float64 too; constant influence gives exact zeros
    (written by the kernel: the wrapper zeroes nothing); one d_rel launch
    a call."""
    arrays, g = _backward_edge_inputs(np.random.default_rng(46), influence,
                                      case)
    arrays, g = [a.to(card) for a in arrays], g.to(card)
    before = tkp.kpconv_aggregate_backward.launches_drel
    first = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, influence,
                                          need_rel=True)
    second = tkp.kpconv_aggregate_backward(*arrays, g, 0.12, influence,
                                           need_rel=True)
    want = tkp.kpconv_aggregate_backward_plain(*arrays, g, 0.12, influence,
                                               need_rel=True)
    want64 = tkp.kpconv_aggregate_backward_plain(
        *[a.double() if a.is_floating_point() else a for a in arrays],
        g.double(), 0.12, influence, need_features=False,
        need_kernel_weights=False, need_rel=True)[2]
    torch.cuda.synchronize()
    assert tkp.kpconv_aggregate_backward.launches_drel == before + 2
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        _assert_grad_close(a, w, 3e-4, 1e-5)
    _assert_grad_close(first[2], want64.float(), 3e-4, 1e-5)
    if influence == "constant":
        assert first[2].abs().max().item() == 0
    else:
        assert first[2].abs().max().item() > 0
    # d_rel alone, in a block the allocator hands back full of NaNs: every
    # row written
    junk = torch.full_like(arrays[2], float("nan"))
    del junk
    d_rel_only = tkp.kpconv_aggregate_backward(
        *arrays, g, 0.12, influence, need_features=False,
        need_kernel_weights=False, need_rel=True)
    assert d_rel_only[0] is None and d_rel_only[1] is None
    assert torch.equal(d_rel_only[2], first[2])


@pytest.mark.cuda
def test_gan_g_step_asks_d_rel_at_level0_only(card, monkeypatch):
    """One GAN update of ``cfgs/synthetic_quality_gan_tuned.yaml`` at width
    144, B=16, N=500 on the card: the D-step's and the generator's
    backwards ask for d_kernel_weights and no d_rel; the G-step's
    discriminator backwards ask for no d_kernel_weights, and for d_rel
    exactly at the three calls whose support set is the input points
    (the stem, Bottleneck_0 and the first strided block): 40 forward, 30
    backward and 3 d_rel launches; a second update from the same state
    bitwise equal (d_rel has no atomics)."""
    from deep3dpointclouddenoising_torch.train.gan import GANTrainer
    cfg = load_config(os.path.join(os.path.dirname(L1_YAML),
                                   "synthetic_quality_gan_tuned.yaml"))
    assert (int(cfg.width), int(cfg.batch_size), int(cfg.num_points)) == \
        (144, 16, 500)
    rng = np.random.default_rng(47)
    xyz = rng.normal(size=(16, 500, 3))
    xyz = cfg.in_radius * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz = (xyz * rng.random((16, 500, 1))).astype(np.float32)
    mask = np.ones((16, 500), np.float32)
    mask[-1, -50:] = 0.0
    xyz[-1, -50:] = xyz[-1, :50]
    batch = {"points": xyz, "mask": mask, "features": xyz.copy(),
             "offsets": (rng.normal(size=(16, 500, 3)) * 0.01).astype(
                 np.float32)}
    calls = []
    backward = tkp.kpconv_aggregate_backward

    def spy(*args):
        calls.append((args[0].shape[1], args[9], args[10], args[11]))
        return backward(*args)

    # the wrapper counts its launches on the module's name, the spy here
    spy.launches = spy.launches_bf16 = spy.launches_drel = 0
    monkeypatch.setattr(tkp, "kpconv_aggregate_backward", spy)
    states = []
    for _ in range(2):
        trainer = GANTrainer(cfg, 1, torch.Generator().manual_seed(0), card)
        calls.clear()
        counts = [tkp.kpconv_aggregate.launches, spy.launches,
                  spy.launches_drel]
        metrics = trainer.update(batch)
        torch.cuda.synchronize()
        counts = [tkp.kpconv_aggregate.launches - counts[0],
                  spy.launches - counts[1], spy.launches_drel - counts[2]]
        assert counts == [40, 30, 3], counts
        g_step_disc = [c for c in calls if not c[2]]
        assert len(calls) == 30 and len(g_step_disc) == 10
        assert [c for c in calls if c[3]] == \
            [c for c in g_step_disc if c[0] == 500]
        assert all(np.isfinite(v.item()) for v in metrics.values())
        states.append({f"{k}/{n}": t.detach().clone()
                       for k, b in trainer.blocks.items()
                       for n, t in b.model.state_dict().items()})
    differ = [n for n, t in states[0].items()
              if not torch.equal(t, states[1][n])]
    assert not differ, f"{len(differ)} tensors differ, first {differ[0]}"


def _pcn_model(seed=0):
    """The PCN baseline with its own init and O(1) BatchNorm statistics,
    so that eval mode reads them."""
    from deep3dpointclouddenoising_torch.models.pcpnet import ResPCPNet
    model = ResPCPNet(generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(size=buf.shape).astype(np.float32) * 0.5))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 2.0, size=buf.shape).astype(np.float32)))
    return model


def _patches(rng, B, N, radius=0.05):
    """Patch-like clouds of differing extent and place."""
    x = rng.normal(size=(B, N, 3))
    x = radius * x / np.linalg.norm(x, axis=-1, keepdims=True) \
        * rng.random((B, N, 1)) * rng.uniform(0.3, 1.0, size=(B, 1, 1))
    return (x + rng.normal(size=(B, 1, 3)) * radius).astype(np.float32)


@pytest.mark.cuda
def test_pcn_forward_and_gradients_on_card_match_cpu(card):
    """The PCN baseline at B=64, N=500 on the card against the CPU: the
    eval forward element by element within the larger of rtol 5e-4 /
    atol 5e-5 and three times its own float32 noise (grad_check's
    forward rule; TF32 is off); every parameter's train-mode gradient of
    the L1 loss by ``grad_check.check_device_gradients``: the card's
    float64 within 1e-6 (relative L2) of the CPU's float64, and the
    card's float32 within three times the CPU's own float32-vs-float64
    distance (floor 2e-2) where float32 pins the tensor at all (train
    mode normalises over the batch after the max over points, which
    amplifies float32 rounding)."""
    from deep3dpointclouddenoising_torch.train.pcn import rotate_back
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(50)
    x = torch.from_numpy(_patches(rng, 64, 500))
    target = torch.from_numpy((rng.normal(size=(64, 3)) * 1e-3).astype(
        np.float32))
    model = _pcn_model()
    copies = {"card": copy.deepcopy(model).to(card), "cpu": model,
              "float64": grad_check.float64_copy(model),
              "card64": grad_check.float64_copy(model).to(card)}
    out, grads = {}, {}
    for key, m in copies.items():
        dev = next(m.parameters()).device
        dtype = next(m.parameters()).dtype
        xi = x.to(dev, dtype)
        m.eval()
        with torch.no_grad():
            out[key] = rotate_back(*m(xi)[:2]).cpu().double()
        m.train()
        pred, trans, _ = m(xi)
        loss = torch.mean(torch.abs(rotate_back(pred, trans)
                                    - target.to(dev, dtype)))
        grads[key] = [g.cpu().double() for g in torch.autograd.grad(
            loss, list(m.parameters()))]
    grad_check.check_forward(out["card"], out["cpu"], out["float64"],
                             rtol=5e-4, atol=5e-5)
    held = grad_check.check_device_gradients(
        [n for n, _ in model.named_parameters()], grads["card"],
        grads["cpu"], grads["float64"], grads["card64"])
    assert held["float64_max_l2"] <= grad_check.DEVICE_FLOAT64_TOL


def _sampler_dataset(tmp_path, fourier=False, num_steps=16):
    from deep3dpointclouddenoising_torch.data.offset_dataset import \
        OffsetDataset
    from deep3dpointclouddenoising_torch.data.synthetic import (
        make_icosphere, make_torus)
    return OffsetDataset(str(tmp_path), "train", in_radius=0.08,
                         num_points=64, num_steps=num_steps, num_epochs=2,
                         num_points_per_shape=3000, noise_type="gaussian",
                         noise_level=0.005, seed=0,
                         fourier_features=fourier,
                         shapes={"sphere": make_icosphere(2),
                                 "torus": make_torus(12, 8)})


@pytest.mark.cuda
@pytest.mark.parametrize("fourier", [False, True])
def test_device_sampler_on_card_matches_cpu(card, tmp_path, fourier):
    """``DeviceSampler.sample`` on the card with draws fixed on the CPU
    (augmentation with jitter, ``norm``) against the same call on the
    CPU: indices, mask and labels equal; points, offsets and features
    within rtol 1e-5 and an atol of 1e-6 of their max-abs (the card's
    sin and cos round otherwise)."""
    from deep3dpointclouddenoising_torch.config import default_config
    from deep3dpointclouddenoising_torch.data.device_sampler import (
        DeviceSampler, SamplerDraws, torch_draws)
    ds = _sampler_dataset(tmp_path, fourier)
    cfg = default_config()
    cfg.num_points, cfg.in_radius, cfg.jitter, cfg.norm = 64, 0.08, 1, 1
    cfg.scale_low, cfg.scale_high = 0.8, 1.2
    cfg.noise_std, cfg.noise_clip = 1e-3, 2e-3
    samplers = {d: DeviceSampler(ds, cfg, d) for d in ("cpu", card)}
    centers = samplers["cpu"].centers(0, 8)[0]
    fixed = {}

    def draws_on(device):
        def draws(cur):
            if "d" not in fixed:
                fixed["d"] = torch_draws(samplers["cpu"],
                                         torch.Generator().manual_seed(3),
                                         8)(cur.cpu())
            d = fixed["d"]
            return SamplerDraws(*(None if t is None else t.to(device)
                                  for t in (d.perm_keys, d.pad_picks,
                                            d.angles, d.scale, d.sym_u,
                                            d.noise_points,
                                            d.noise_offsets)))
        return draws

    got, want = (samplers[d].sample(centers, draws_on(d))
                 for d in (card, "cpu"))
    assert 0 < want["mask"].sum() < want["mask"].numel()
    for k, w in want.items():
        g = got[k].cpu()
        if w.is_floating_point() and k != "mask":
            torch.testing.assert_close(g, w, rtol=1e-5,
                                       atol=1e-6 * w.abs().max().item())
        else:
            assert torch.equal(g, w), k


@pytest.mark.cuda
def test_device_sampled_train_steps_are_bitwise_reproducible(card,
                                                             tmp_path):
    """Three device-sampled train steps of l1.yaml (width 144, B=16) on
    the card twice, each step's draws from ``sample_generator(seed,
    step)``: parameters, BatchNorm buffers and Adam's state bitwise
    equal, and 10 forward and 10 backward kernel launches per step."""
    from deep3dpointclouddenoising_torch.data.device_sampler import (
        DeviceSampler, sample_generator, torch_draws)
    from deep3dpointclouddenoising_torch.train.trainer import Trainer
    cfg = load_config(L1_YAML)
    ds = _sampler_dataset(tmp_path, num_steps=48)
    cfg.in_radius = 0.3  # the test clouds' scale
    sampler = DeviceSampler(ds, cfg, card)
    states = []
    for _ in range(2):
        trainer = Trainer(cfg, 1, torch.Generator().manual_seed(0), card)
        counts = (tkp.kpconv_aggregate.launches,
                  tkp.kpconv_aggregate_backward.launches)
        for step, centers in enumerate(sampler.centers(0, 16)[:3]):
            batch = sampler.sample(centers, torch_draws(
                sampler, sample_generator(7, step, card), 16))
            trainer.train_step(batch)
        torch.cuda.synchronize()
        assert (tkp.kpconv_aggregate.launches - counts[0],
                tkp.kpconv_aggregate_backward.launches - counts[1]) \
            == (30, 30)
        states.append((trainer.model.state_dict(),
                       trainer.optimizer.state_dict()))
    assert not grad_check.state_difference(states[0], states[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["kpconv_fwd", "kpconv_bwd"])
def test_kpconv_ops_pass_opcheck_on_card(card, op, dtype):
    """``torch.library.opcheck`` of both custom ops on CUDA tensors
    (schema, fake implementation against the kernels' outputs, autograd
    registration, AOT dispatch); the backward for each set of gradients
    asked, d_rel in float32 only; and each call launches the kernel."""
    arrays = [a.to(card) for a in _inputs(np.random.default_rng(8), 2, 40,
                                          30, 9, 24)]
    arrays[0] = arrays[0].to(dtype)
    target = getattr(torch.ops.d3pcd_torch, op).default
    if op == "kpconv_fwd":
        arrays[0].requires_grad_()
        arrays[5].requires_grad_()
        cases = [(*arrays, 0.12, "linear")]
    else:
        g = torch.randn(2, 40, 24, device=card).to(dtype)
        needs = [(True, True, False), (True, False, False),
                 (False, True, False)]
        if dtype == torch.float32:
            needs.append((True, True, True))
        cases = [(*arrays, g, 0.12, "gaussian", *n) for n in needs]
    wrapper = tkp.kpconv_aggregate if op == "kpconv_fwd" \
        else tkp.kpconv_aggregate_backward
    key = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(wrapper, key)
    for args in cases:
        result = torch.library.opcheck(target, args)
        assert set(result.values()) == {"SUCCESS"}, result
    torch.cuda.synchronize()
    assert getattr(wrapper, key) > before


@pytest.mark.cuda
def test_export_round_trip_on_card(card, tmp_path):
    """l1.yaml at width 144 (B=4, N=500, seeded weights with O(1) running
    statistics) exported on the card, saved and loaded: the graph holds
    ten forward ops, each call launches the forward kernel ten times and
    the backward none, and the output is within ``export_model --check``'s
    1e-5 * max(scale, 1) of the eager forward."""
    from deep3dpointclouddenoising_torch import infer, serving
    cfg = load_config(L1_YAML)
    model = OffsetRegressionModel(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(
                    rng.normal(size=buf.shape).astype(np.float32) * 0.5))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 2.0, size=buf.shape).astype(np.float32)))
    model = model.to(card).eval()
    xyz = rng.normal(size=(4, 500, 3))
    xyz = (0.03 * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
           * rng.random((4, 500, 1))).astype(np.float32)
    batch = {"points": xyz, "mask": np.ones((4, 500), np.float32),
             "features": xyz}
    path = str(tmp_path / "l1.pt2")
    exported = serving.export_denoiser(model, batch, device=card)
    serving.save_artifact(exported, path)
    assert serving.artifact_meta(path)["platforms"] == ["cuda"]
    predict = serving.load_denoiser(path)
    nodes = [str(n.target) for n in predict.exported.graph.nodes
             if n.op == "call_function"]
    assert sum(t.startswith("d3pcd_torch.kpconv_fwd") for t in nodes) == 10
    assert not any(t.startswith("d3pcd_torch.kpconv_bwd") for t in nodes)
    predict(batch["points"], batch["mask"], batch["features"])
    counts = (tkp.kpconv_aggregate.launches,
              tkp.kpconv_aggregate_backward.launches)
    got = predict(batch["points"], batch["mask"], batch["features"])
    torch.cuda.synchronize()
    assert (tkp.kpconv_aggregate.launches - counts[0],
            tkp.kpconv_aggregate_backward.launches - counts[1]) == (10, 0)
    assert got.device.type == "cuda"
    want = infer.make_predict_fn(model)(batch)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(want.abs().max().item(), 1.0)
