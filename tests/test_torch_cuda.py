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
    in-degree 0); the first query row of each cloud has its mask all zero."""
    B, M, N, K, C, P, layout = case
    arrays = _inputs(rng, B, M, N, K, C, P)
    if layout == "sink":
        arrays[1][:, :M // 2 + 1] = min(3, N - 1)
        arrays[3][:, :M // 2 + 1] = 1.0
    elif layout == "holes":
        arrays[1] = arrays[1] % max(1, N // 2)
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
