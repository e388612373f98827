"""The port's CUDA kernel against its plain PyTorch version on the card.

These tests import no JAX, so they run on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up).  Without a
card they skip.  Tolerances: the aggregation rtol 2e-4 / atol 2e-5, the
whole model rtol 5e-4 / atol 5e-5, as in the CPU tests against JAX.
"""
import os

import numpy as np
import pytest
import torch

from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.models import local_aggregation
from deep3dpointclouddenoising_torch.ops import kpconv as tkp

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
    with pytest.raises(NotImplementedError, match="backward"):
        tkp.kpconv_aggregate(arrays[0].requires_grad_(), *arrays[1:], 0.1)


@pytest.mark.cuda
def test_l1_model_kernel_matches_plain(card, monkeypatch):
    cfg = load_config(L1_YAML)
    torch.manual_seed(0)
    model = OffsetRegressionModel(cfg).to(card).eval()
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(4, 500, 3))
    xyz = 0.05 * xyz / np.linalg.norm(xyz, axis=-1, keepdims=True) \
        * rng.random((4, 500, 1))
    xyz = torch.from_numpy(xyz.astype(np.float32)).to(card)
    mask = torch.ones(4, 500, device=card)
    with torch.no_grad():
        pyr = model.make_pyramid(xyz, mask)
        before = tkp.kpconv_aggregate.launches
        got = model.MultiDimHead_0(pyr, model.ResNetEncoder_0(pyr, xyz))
        assert tkp.kpconv_aggregate.launches == before + 10
        monkeypatch.setattr(local_aggregation, "kpconv_aggregate",
                            tkp.kpconv_aggregate_plain)
        want = model.MultiDimHead_0(pyr, model.ResNetEncoder_0(pyr, xyz))
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-5)
