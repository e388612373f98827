"""``cfg.remat`` (``torch.utils.checkpoint`` around each encoder
bottleneck) against the step without it and against the JAX package's
``nn.remat``, on the same numpy inputs and converted weights.

One train step (forward, masked L1, backward) of the tiny model of
tests/test_torch_train.py, from weights with O(1) running statistics and
final Dense (as the other tests set them):

* with ``remat: 1`` it equals the step without it bitwise on the CPU:
  loss, every gradient, every running statistic and
  ``num_batches_tracked`` (the recomputed forward must not update the
  BatchNorm statistics a second time), and it launches the aggregation 19
  times against 10;
* against the JAX model with ``remat: 1`` (whose twin is
  tests/test_model.py::test_remat_matches_no_remat): the loss at rtol
  1e-5, the gradients at tests/test_torch_train.py's rtol 1e-3 and atol
  5e-3 of each tensor's max-abs (train-mode BatchNorm scale gradients
  cancel), the running statistics at rtol 1e-4 / atol 2e-5 of their
  max-abs.
"""
import numpy as np
import jax
import pytest
import torch

from deep3dpointclouddenoising_tpu.losses.masked import \
    masked_l1_loss as jax_l1
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.losses.masked import masked_l1_loss
from deep3dpointclouddenoising_torch.models import (build_offset_regression,
                                                    local_aggregation)
from test_torch_model import perturb
from test_torch_train import _batch, _configs


def _count_aggregations(monkeypatch):
    calls = [0]
    aggregate = local_aggregation.kpconv_aggregate

    def counting(*args, **kwargs):
        calls[0] += 1
        return aggregate(*args, **kwargs)

    monkeypatch.setattr(local_aggregation, "kpconv_aggregate", counting)
    return calls


def _init(tc):
    """The seed-0 model with O(1) running statistics and final Dense, and
    its Flax variables."""
    model = build_offset_regression(tc, torch.Generator().manual_seed(0))
    variables = perturb(flax_from_params(model.state_dict()),
                        np.random.default_rng(1))
    model.load_state_dict(params_from_flax(variables, model))
    return model, variables


def _torch_step(tc, batch, calls):
    """One train-mode forward and backward from ``_init``: loss,
    gradients, buffers and the aggregation's calls."""
    model, _ = _init(tc)
    model.train()
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls[0] = 0
    pred = model(b["points"], b["mask"], b["features"])
    loss = masked_l1_loss(pred, b["offsets"], b["mask"])
    loss.backward()
    return dict(loss=loss.item(), calls=calls[0],
                grads={n: p.grad for n, p in model.named_parameters()},
                buffers={n: t.clone() for n, t in model.named_buffers()},
                init=model)


@pytest.fixture(scope="module")
def remat_runs():
    batch = _batch(np.random.default_rng(7))
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_aggregations(mp)
        runs = {r: _torch_step(_configs(remat=r)[1], batch, calls)
                for r in (0, 1)}
    return batch, runs


def test_remat_step_equals_the_step_without_it(remat_runs):
    _, runs = remat_runs
    plain, remat = runs[0], runs[1]
    assert (plain["calls"], remat["calls"]) == (10, 19)
    assert remat["loss"] == plain["loss"]
    assert set(remat["grads"]) == set(plain["grads"])
    for name, g in plain["grads"].items():
        assert torch.equal(remat["grads"][name], g), name
    for name, t in plain["buffers"].items():
        assert torch.equal(remat["buffers"][name], t), name
    assert remat["buffers"][
        "ResNetEncoder_0.Bottleneck_0.ConvBN_0.BatchNorm_0."
        "num_batches_tracked"].item() == 1
    # the parameter tree is the Flax one either way
    assert set(remat["init"].state_dict()) == set(plain["init"].state_dict())


def test_remat_step_matches_jax_remat(remat_runs):
    batch, runs = remat_runs
    jc, _ = _configs(remat=1)
    jmodel = JaxModel(cfg=jc)
    _, init = _init(_configs(remat=1)[1])

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": init["batch_stats"]},
            batch["points"], batch["mask"], batch["features"], train=True,
            mutable=["batch_stats"])
        return jax_l1(out, batch["offsets"], batch["mask"]), mutated

    (loss, mutated), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(init["params"])
    got = runs[1]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    want = params_from_flax({"params": jax.device_get(grads)})
    assert set(want) == set(got["grads"])
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got["grads"][name].numpy(), w,
                                   rtol=1e-3, atol=5e-3 * np.abs(w).max(),
                                   err_msg=name)
    stats = params_from_flax({"batch_stats": jax.device_get(
        mutated["batch_stats"])})
    for name, w in stats.items():
        if name.endswith("num_batches_tracked"):  # Flax keeps no counter
            continue
        w = w.numpy()
        np.testing.assert_allclose(got["buffers"][name].numpy(), w,
                                   rtol=1e-4, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)
