"""The port's attention aggregation (every type of
``cfg.attention.type``) against the JAX package's, on the CPU.

The operators run as tests/test_torch_aggregation.py runs the other
aggregations, on its geometry and with its tolerances (forward rtol 2e-4 /
atol 2e-5; running statistics rtol 1e-4 / atol 1e-6; gradients rtol 1e-3,
atol 1e-3 of each tensor's max-abs, and those that vanish by construction
within 1e-4 of the largest gradient), at 16 channels (two latent
channels).  The gates ``gamma`` and ``alpha`` are set to O(1) values: at
their zero init the attention branch vanishes and would hide every error
in it.

Every attention config trains one step at a small size (the whole
attention models against JAX: test_torch_agg_model.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deep3dpointclouddenoising_tpu.models import attention as jax_att
from deep3dpointclouddenoising_tpu.models import \
    local_aggregation as jax_la
from deep3dpointclouddenoising_torch.convert import flax_from_params
from deep3dpointclouddenoising_torch.models import attention
from deep3dpointclouddenoising_torch.models.local_aggregation import \
    LocalAggregation
from test_torch_aggregation import (ATTENTION_CONFIGS, RADIUS,
                                    _config_ids, assert_forward,
                                    assert_gradients, cached,
                                    check_config_trains, configs, geometry,
                                    shape_tree)

ATTENTION_TYPES = ["Non-local", "Criss-cross", "SE", "CBAM",
                   "Dual-attention", "A-SCN", "Point-attention", "CAA",
                   "Offset-attention", "Point-transformer"]
GATED = {"Non-local": "NonLocalModule_0", "Criss-cross":
         "CrissCrossAttention_0", "Dual-attention": "DualAttention_0",
         "CAA": "CAA_Module_0"}


def _form(atype, pwmlp="dp_fj"):
    return (("attention__type", atype), ("pointwisemlp__feature_type",
                                         pwmlp))


@pytest.mark.parametrize("atype", ATTENTION_TYPES)
@pytest.mark.parametrize("what", ["forward", "gradients"])
def test_attention_matches_jax(atype, what):
    res = cached("attention", 16, _form(atype))
    (assert_forward if what == "forward" else assert_gradients)(res)


@pytest.mark.parametrize("what", ["forward", "gradients"])
def test_attention_over_dp_fi_df_matches_jax(what):
    """The custom configs' attention runs over a ``dp_fi_df``
    PointWiseMLP."""
    res = cached("attention", 16, _form("Non-local", "dp_fi_df"))
    (assert_forward if what == "forward" else assert_gradients)(res)


def test_attention_types_are_the_jax_package_s():
    assert set(attention.ATTENTION_TYPES) == set(ATTENTION_TYPES) == (
        set(jax_att._GLOBAL_ATTENTION) | {"CAA", "Point-transformer"})


@pytest.mark.parametrize("atype", ATTENTION_TYPES)
def test_fresh_operator_initialises_as_flax(atype):
    """The initial trees: the same names and shapes as Flax's init; gates
    zero (a fresh gated operator is the identity on its residual path),
    BatchNorms at scale 1 / bias 0 / mean 0 / var 1, Dense biases zero,
    and Dense kernels at Flax's ``lecun_normal`` spread (std
    1/sqrt(fan_in), within 25% over a kernel of 16 x 16)."""
    level, _, _ = geometry()
    jc, tc = configs("attention", attention__type=atype)
    feats = jnp.zeros((2, 48, 16), jnp.float32)
    jop = jax.eval_shape(lambda: jax_la.LocalAggregation(
        16, 16, RADIUS, jc).init(jax.random.PRNGKey(0), feats,
                                 level.self_nbr, level.mask, False))
    op = LocalAggregation(16, 16, RADIUS, tc,
                          torch.Generator().manual_seed(1), num_queries=48)
    tree = flax_from_params(op.state_dict())
    assert shape_tree(tree) == shape_tree(jop)
    for name, p in op.named_parameters():
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("gamma", "alpha"):
            assert torch.equal(p, torch.zeros(1))
        elif "BatchNorm_" in name:
            assert torch.equal(p, torch.ones_like(p) if leaf == "weight"
                               else torch.zeros_like(p))
        elif leaf == "bias":
            assert torch.equal(p, torch.zeros_like(p)), name
    for name, b in op.named_buffers():
        if name.endswith("running_mean"):
            assert torch.equal(b, torch.zeros_like(b))
        elif name.endswith("running_var"):
            assert torch.equal(b, torch.ones_like(b))
    if atype == "SE":
        return
    att = getattr(op.AttentionAggregation_0, op.AttentionAggregation_0.ops[-1])
    big = [m for m in att.modules() if isinstance(m, torch.nn.Linear)
           and m.in_features == 16 and m.out_features == 16]
    if atype in ("Offset-attention", "Point-transformer", "CAA"):
        w = torch.cat([m.weight.reshape(-1) for m in big])
        assert abs(w.std().item() * 4.0 - 1.0) < 0.25


def test_gated_attention_starts_as_its_residual():
    """With the gates at their zero init, a gated operator is the identity
    (dual attention, CAM + PAM, twice it): the aggregation equals
    PointWiseMLP + BN + ReLU alone."""
    _, tnbr, tmask = geometry()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 48, 16)).astype(np.float32))
    for atype, name in GATED.items():
        _, tc = configs("attention", attention__type=atype)
        op = LocalAggregation(16, 16, RADIUS, tc,
                              torch.Generator().manual_seed(3),
                              num_queries=48).eval()
        agg = op.AttentionAggregation_0
        with torch.no_grad():
            got = op(x, tnbr, tmask)
            scale = 2.0 if atype == "Dual-attention" else 1.0
            want = agg.BNReLU_0(scale * agg.PointWiseMLP_0(x, tnbr, tmask))
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=atype)


def test_batchnorm_momenta_are_flax_s():
    """Torch momentum 0.1 for the attention BatchNorms (Flax 0.9), 0.01
    for CBAM's spatial one (Flax 0.99)."""
    for atype in ATTENTION_TYPES:
        _, tc = configs("attention", attention__type=atype)
        op = LocalAggregation(16, 16, RADIUS, tc, num_queries=48)
        att = op.AttentionAggregation_0
        for name, m in getattr(att, att.ops[-1]).named_modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                want = 0.01 if atype == "CBAM" else 0.1
                assert m.momentum == want, (atype, name)


def test_caa_needs_the_level_size_and_refuses_a_channel_change():
    _, tc = configs("attention", attention__type="CAA")
    with pytest.raises(ValueError, match="num_queries"):
        LocalAggregation(16, 16, RADIUS, tc)
    op = LocalAggregation(16, 16, RADIUS, tc, num_queries=125)
    dense = op.AttentionAggregation_0.CAA_Module_0.Dense_0
    assert (dense.in_features, dense.out_features) == (125, 15)
    with pytest.raises(ValueError, match="channels"):
        LocalAggregation(16, 32, RADIUS, tc, num_queries=48)
    _, tc = configs("attention", attention__type="Point-transformer")
    op = LocalAggregation(16, 32, RADIUS, tc)   # ConvBN 16 -> 32
    assert op.AttentionAggregation_0.post == "ConvBN_0"
    _, tc = configs("attention", attention__type="Axial")
    with pytest.raises(NotImplementedError, match="Axial"):
        LocalAggregation(16, 16, RADIUS, tc)


def test_attention_convbn_gets_no_compute_dtype():
    """Under ``compute_dtype: bfloat16`` the PointWiseMLP's ConvBNs run in
    bfloat16 and the wrapper's closing ConvBN does not (JAX passes it no
    dtype)."""
    _, tc = configs("attention", attention__type="Point-transformer")
    tc.compute_dtype = "bfloat16"
    op = LocalAggregation(16, 32, RADIUS, tc).AttentionAggregation_0
    assert op.ConvBN_0.compute_dtype is None
    _, tc = configs("attention", attention__type="SE")
    tc.compute_dtype = "bfloat16"
    op = LocalAggregation(16, 16, RADIUS, tc).AttentionAggregation_0
    assert op.PointWiseMLP_0.ConvBN_0.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("path", ATTENTION_CONFIGS,
                         ids=_config_ids(ATTENTION_CONFIGS))
def test_attention_config_trains(path):
    """Every attention config (ten of 500 points and
    ``custom_cfgs/Non-local__std_``, each its own setting) takes a train
    step, as tests/test_torch_aggregation.py checks the others."""
    check_config_trains(path)
