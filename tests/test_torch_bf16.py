"""bfloat16 compute (``compute_dtype: bfloat16``) in the port against the
JAX package, on the CPU, on the same seeded numpy inputs and on weights
carried over by convert.py.  The JAX side runs its Pallas kernels in
interpret mode (``use_pallas: 1``): that is the path that casts the
aggregation's features to bfloat16 (``local_aggregation.py:119-126``); its
jnp reference, the CPU default, keeps them float32.

Tolerances, in bf16 ulps (the spacing of bfloat16 values at a value: 2^-7
of its binade, 8 significant bits):

* ``ConvBN``'s Dense before the BatchNorm: within one ulp of Flax's
  ``nn.Dense(dtype=bfloat16)``, plus the two float32 accumulations' own
  bound (``fan_in * 2^-24`` of ``|x| @ |W|`` each); after the BatchNorm,
  that difference times the BatchNorm's scale, plus float32 rounding.
* The aggregation, against the float32 result on the same bf16 values: the
  port rounds once, so within one ulp; **a known departure**: JAX's Pallas
  kernels add the neighbour axis's chunks in the output dtype
  (``pallas_kpconv.py:135-136,181-182``; ``dfeat_ref`` at :445-446,
  ``out_ref[0] + acc.astype(out_ref.dtype)``), so in bf16 they round each
  chunk's float32 sum and then the running sum, and JAX is held within one
  ulp of each chunk's sum plus one ulp of each running sum after the
  first, plus the float32 kernel tolerance's atol.  ``_pick_tiles``
  gives one chunk at the tiny shape and three at a flagship stem's
  (M = 128 of N = 500, K = 52, C = 72).  ``d_kernel_weights`` is
  float32 on both sides: the float32 gradient tolerance (rtol 3e-4 /
  atol 3e-5).
* The whole tiny model: no further from JAX's bf16 output than JAX's bf16
  output is from its float32 output (max-abs and L2), and within JAX's own
  bound against its float32 output (``tests/test_model.py:121-146``: 0.1
  of the max-abs, correlation above 0.99).
* Three train steps, beside a float32 run of the port from the same init
  on the same batches (which test_torch_train.py holds to JAX's float32
  run), whose distance from JAX's bf16 run is the scale of bf16 against
  float32.  The first step starts from equal weights, so it must tell the
  two apart: its loss at rtol 1e-5 (float32 misses by 4.5e-5; 1.2e-7
  seen), and Adam's moments and the BatchNorm running statistics after it
  each within a tenth of the float32 run's L2 distance from JAX's bf16
  run (2.5e-3 and 4.3e-6 of it seen), the statistics also per
  tensor at rtol 1e-4 / atol 2e-5 of the max-abs (test_torch_train.py's
  float32 tolerance).  After that, bf16 rounding flips some near-zero
  gradients' signs, which Adam turns into jumps of 2 * lr: the three
  losses' summed distance within half the float32 run's (0.28 seen); the
  parameters' change within 2 * lr * k everywhere, and in L2 over every
  parameter no further from JAX's bf16 run than the float32 run is (0.57
  of it seen).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from deep3dpointclouddenoising_tpu.config import default_config as jax_cfg
from deep3dpointclouddenoising_tpu.models import \
    build_offset_regression as jax_build
from deep3dpointclouddenoising_tpu.models.build import \
    OffsetRegressionModel as JaxModel
from deep3dpointclouddenoising_tpu.models.layers import ConvBN as JaxConvBN
from deep3dpointclouddenoising_tpu.ops.pallas_kpconv import _pick_tiles
from deep3dpointclouddenoising_tpu.ops.pallas_kpconv import \
    kpconv_aggregate as jax_kpconv
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch.config import default_config
from deep3dpointclouddenoising_torch.convert import flax_from_params, \
    params_from_flax
from deep3dpointclouddenoising_torch.models import OffsetRegressionModel
from deep3dpointclouddenoising_torch.models.layers import ConvBN, \
    compute_dtype
from deep3dpointclouddenoising_torch.ops import kpconv as tkp
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from deep3dpointclouddenoising_torch.utils.grad_check import bf16_ulp

from test_torch_model import perturb, small_config, small_inputs
from test_torch_train import TINY, _adam_moments, _batch, _optax_moments

BF16 = torch.bfloat16


def bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16, as float32 (exact)."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _f64(t) -> np.ndarray:
    return np.asarray(t.float().detach().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t).astype(np.float32), np.float64)


def test_compute_dtype():
    cfg = default_config()
    assert compute_dtype(cfg) is None
    cfg.compute_dtype = "bfloat16"
    assert compute_dtype(cfg) == BF16
    cfg.compute_dtype = "float16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        compute_dtype(cfg)


# -- ConvBN ------------------------------------------------------------------

def test_bf16_convbn_matches_flax():
    rng = np.random.default_rng(11)
    c_in, c_out = 72, 144
    x = rng.normal(size=(2, 64, c_in)).astype(np.float32)
    jm = JaxConvBN(c_out, dtype=jnp.bfloat16)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x, train=False))
    variables = jax.tree_util.tree_map(np.array, variables)
    stats = variables["batch_stats"]["BatchNorm_0"]
    stats["mean"] = (rng.normal(size=c_out) * 0.5).astype(np.float32)
    stats["var"] = rng.uniform(0.5, 2.0, size=c_out).astype(np.float32)
    params = variables["params"]
    kernel = params["Dense_0"]["kernel"]
    port = ConvBN(c_in, c_out, dtype=BF16).eval()
    with torch.no_grad():
        port.Dense_0.weight.copy_(torch.from_numpy(kernel.T))
        port.BatchNorm_0.weight.copy_(torch.from_numpy(
            params["BatchNorm_0"]["scale"]))
        port.BatchNorm_0.bias.copy_(torch.from_numpy(
            params["BatchNorm_0"]["bias"]))
        port.BatchNorm_0.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port.BatchNorm_0.running_var.copy_(torch.from_numpy(stats["var"]))
    seen = []
    port.BatchNorm_0.register_forward_pre_hook(
        lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    pre = seen[0]
    assert pre.dtype == BF16 and out.dtype == torch.float32
    want_pre = fnn.Dense(c_out, use_bias=False, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel}}, x)
    assert want_pre.dtype == jnp.bfloat16
    # before the BatchNorm: one ulp, plus each float32 accumulation's bound
    terms = np.abs(bf16_values(x).astype(np.float64)) @ np.abs(
        bf16_values(kernel).astype(np.float64))
    diff = np.abs(_f64(pre) - _f64(want_pre))
    limit = bf16_ulp(_f64(want_pre)).numpy() + 2 * c_in * 2.0 ** -24 * terms
    assert (diff <= limit).all(), (diff - limit).max()
    # after it: that difference through the BatchNorm's scale
    want = np.asarray(jm.apply(variables, x, train=False), np.float64)
    scale = np.abs(params["BatchNorm_0"]["scale"]) / np.sqrt(
        stats["var"] + 1e-5)
    np.testing.assert_array_less(
        np.abs(_f64(out) - want), diff * scale + 1e-6 * (1 + np.abs(want)))


# -- the aggregation ----------------------------------------------------------

KP_SHAPES = {"tiny": dict(B=2, M=50, K=7, C=12, N=60),
             "stem": dict(B=1, M=128, K=52, C=72, N=500)}
EXTENT = 0.12


def _kp_inputs(rng, B, M, K, C, N, P=15):
    """tests/test_torch_ops.py's inputs, features and upstream gradient on
    bf16 values."""
    feat = bf16_values(rng.normal(size=(B, N, C)).astype(np.float32))
    idx = rng.integers(0, N, size=(B, M, K)).astype(np.int32)
    rel = (rng.random((B, M, K, 3), dtype=np.float32) * 2 - 1) * 0.1
    mask = (rng.random((B, M, K)) > 0.3).astype(np.float32)
    idx[:, -1], mask[:, -1] = 0, 1.0
    kp = (rng.random((P, 3), dtype=np.float32) * 2 - 1) * 0.08
    kw = rng.normal(size=(P, C)).astype(np.float32) * 0.1
    g = bf16_values(rng.normal(size=(B, M, C)).astype(np.float32))
    return (feat, idx, rel, mask, kp, kw), g


def _jax_chunks(M, K, C, N):
    """JAX's neighbour chunk (and query tile) for bf16 features: the
    forward and the backward pad M to a multiple of 32 below 128."""
    Mp = -(-M // 32) * 32 if M <= 128 else M
    tm, kb = _pick_tiles(Mp, K, C, 2, onehot_n=N)
    assert -(-Mp // tm) == 1  # one query tile: its chunks are the steps
    return kb, -(-K // kb)


def _partials(arrays, g, kb, chunks):
    """Running float32 sums over JAX's chunks of the neighbour axis: the
    forward's output and the backward's d_features."""
    feat, idx, rel, mask, kp, kw = (torch.from_numpy(a) for a in arrays)
    fwd, bwd = [], []
    for c in range(1, chunks + 1):
        k = slice(0, c * kb)
        part = (feat, idx[:, :, k].contiguous(), rel[:, :, k].contiguous(),
                mask[:, :, k].contiguous(), kp, kw)
        fwd.append(_f64(tkp.kpconv_aggregate_plain(*part, EXTENT)))
        bwd.append(_f64(tkp.kpconv_aggregate_backward_plain(
            *part, torch.from_numpy(g), EXTENT,
            need_kernel_weights=False)[0]))
    return fwd, bwd


@pytest.mark.parametrize("shape", sorted(KP_SHAPES))
def test_bf16_kpconv_against_jax_interpret(shape):
    dims = KP_SHAPES[shape]
    arrays, g = _kp_inputs(np.random.default_rng(7), **dims)
    kb, chunks = _jax_chunks(dims["M"], dims["K"], dims["C"], dims["N"])
    assert chunks == {"tiny": 1, "stem": 3}[shape]
    feat, idx, rel, mask, kp, kw = arrays
    jidx, jrel, jmask, jkp = (jnp.asarray(a) for a in (idx, rel, mask, kp))
    out, vjp = jax.vjp(
        lambda f, w: jax_kpconv(f, jidx, jrel, jmask, jkp, w, EXTENT,
                                "linear", True),
        jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(kw))
    j_dfeat, j_dkw = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    assert out.dtype == j_dfeat.dtype == jnp.bfloat16
    tf = torch.from_numpy(feat).to(BF16).requires_grad_()
    tw = torch.from_numpy(kw).requires_grad_()
    got = tkp.kpconv_aggregate(tf, *(torch.from_numpy(a) for a in (
        idx, rel, mask, kp)), tw, EXTENT, "linear")
    assert got.dtype == BF16
    got.backward(torch.from_numpy(g).to(BF16))
    assert tf.grad.dtype == BF16 and tw.grad.dtype == torch.float32

    fwd, bwd = _partials(arrays, g, kb, chunks)
    for what, port, jx, parts in (("output", got, out, fwd),
                                  ("d_features", tf.grad, j_dfeat, bwd)):
        full = parts[-1]
        # the port: one rounding of the float32 result
        assert (np.abs(_f64(port) - full)
                <= bf16_ulp(full).numpy()).all(), what
        # JAX: each chunk's sum rounded, then each running sum after the
        # first
        chunk_sums = [parts[0]] + [b - a for a, b in zip(parts, parts[1:])]
        limit = sum(bf16_ulp(c).numpy() for c in chunk_sums) \
            + sum(bf16_ulp(p).numpy() for p in parts[1:]) + 2e-5
        assert (np.abs(_f64(jx) - full) <= limit).all(), what
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dkw),
                               rtol=3e-4, atol=3e-5)


def test_bf16_kpconv_refuses_the_gradient_in_rel():
    arrays, g = _kp_inputs(np.random.default_rng(8), **KP_SHAPES["tiny"])
    t = [torch.from_numpy(a) for a in arrays]
    t[0] = t[0].to(BF16)
    t[2].requires_grad_()
    out = tkp.kpconv_aggregate(*t, EXTENT, "linear")
    with pytest.raises(NotImplementedError, match="no bfloat16 form"):
        out.backward(torch.from_numpy(g).to(BF16))
    with pytest.raises(NotImplementedError, match="no bfloat16 form"):
        tkp.kpconv_aggregate_backward(*t, torch.from_numpy(g).to(BF16),
                                      EXTENT, need_rel=True)


# -- the whole model ---------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The tiny model with O(1) statistics and final Dense in the port
    (bfloat16) and in JAX (bfloat16 with its Pallas kernels in interpret
    mode; float32 by its jnp reference, the same function), one set of
    weights through convert.py, eval mode."""
    rng = np.random.default_rng(0)
    xyz, mask = small_inputs(rng)
    torch.manual_seed(0)
    tcfg = small_config(default_config())
    tcfg.compute_dtype = "bfloat16"
    tmodel = OffsetRegressionModel(tcfg).eval()
    variables = perturb(flax_from_params(tmodel.state_dict()), rng)
    tmodel.load_state_dict(params_from_flax(variables, tmodel))
    out = {}
    for dt in ("float32", "bfloat16"):
        jcfg = small_config(jax_cfg())
        jcfg.use_pallas = int(dt == "bfloat16")
        jcfg.compute_dtype = dt
        jmodel = JaxModel(cfg=jcfg)
        out[dt] = np.asarray(jax.jit(lambda v, m=jmodel: m.apply(
            v, xyz, mask, xyz, train=False))(variables), np.float64)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (xyz, mask, xyz)))
    return _f64(got), out


def test_bf16_model_against_jax(models):
    got, out = models
    j16, j32 = out["bfloat16"], out["float32"]
    assert np.isfinite(got).all() and got.shape == j16.shape
    assert 0 < np.abs(got - j16).max() <= np.abs(j16 - j32).max()
    assert np.linalg.norm(got - j16) <= np.linalg.norm(j16 - j32)
    scale = np.abs(j32).max()
    assert np.abs(got - j32).max() / scale < 0.1
    assert np.corrcoef(got.ravel(), j32.ravel())[0, 1] > 0.99


# -- three train steps -------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_runs():
    """Three bf16 train steps of each package from one init on the same
    batches (test_torch_train.py's run_both, in bfloat16)."""
    jc, tc = jax_cfg(), default_config()
    for c in (jc, tc):
        for k, v in TINY.items():
            c[k] = v
        c.compute_dtype = "bfloat16"
    tc.input_features_dim = 3
    jc.use_pallas = 1
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]
    jmodel, jloss = jax_build(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1))
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu")
    # copies: JAX's step donates its state, which may share no memory with
    # the port's parameters
    init = jax.tree_util.tree_map(np.array,
                                  flax_from_params(tt.model.state_dict()))
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"],
        batch_stats=init["batch_stats"],
        opt_state=jt.tx.init(init["params"])))
    key = jax.random.PRNGKey(0)
    init_params = {n: p.detach().clone()
                   for n, p in tt.model.named_parameters()}
    tc32 = default_config()
    for k, v in TINY.items():
        tc32[k] = v
    tc32.input_features_dim = 3
    t32 = Trainer(tc32, 10, torch.Generator().manual_seed(0), "cpu")
    losses = {"jax": [], "port": [], "port32": []}
    first = {}
    for i, b in enumerate(batches):
        state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
        losses["jax"].append(float(loss))
        losses["port"].append(tt.train_step(b).item())
        losses["port32"].append(t32.train_step(b).item())
        if i == 0:
            copy = _copy({"batch_stats": state.batch_stats,
                          "opt_state": state.opt_state})
            stats = params_from_flax({"batch_stats": copy["batch_stats"]})
            first = {"jax": (_optax_moments(copy["opt_state"]),
                             {k: v for k, v in stats.items()
                              if "running_" in k})}
            for name, t in (("port", tt), ("port32", t32)):
                first[name] = (_adam_moments(t), {
                    k: v.clone() for k, v in t.model.named_buffers()
                    if "running_" in k})
    after = params_from_flax({"params": _copy(state.params)})
    return dict(lr=float(tc.base_learning_rate), tt=tt, t32=t32,
                after=after, init=init_params, losses=losses, first=first)


def _copy(tree):
    """A JAX tree as numpy arrays that own their memory."""
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _l2(a, b) -> float:
    """The L2 distance of two {name: tensor or tuple of tensors} over all
    their entries."""
    def flat(d):
        return np.concatenate([np.asarray(x, np.float64).ravel()
                               for k in sorted(d)
                               for x in (d[k] if isinstance(d[k], tuple)
                                         else (d[k],))])
    return float(np.linalg.norm(flat(a) - flat(b)))


def test_three_bf16_steps_losses_match_jax(bf16_runs):
    assert bf16_runs["tt"].step == 3
    losses = {k: np.array(v) for k, v in bf16_runs["losses"].items()}
    # the first step, from equal weights, tells bf16 from float32
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0],
                               rtol=1e-5)
    assert abs(losses["port32"][0] / losses["jax"][0] - 1) > 1e-5
    # after it, bf16 rounding has moved the weights
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2.0 ** -7)
    assert np.abs(losses["port"] - losses["jax"]).sum() \
        <= 0.5 * np.abs(losses["port32"] - losses["jax"]).sum()


@pytest.mark.parametrize("what", ["adam_moments", "batch_stats"])
def test_first_bf16_step_state_matches_jax(bf16_runs, what):
    """After one step from equal weights: Adam's moments (the first step's
    gradients) and the BatchNorm running statistics within a tenth of the
    float32 run's L2 distance from JAX's bf16 run; the statistics also per
    tensor at test_torch_train.py's float32 tolerance."""
    i = ("adam_moments", "batch_stats").index(what)
    want, got, f32 = (bf16_runs["first"][k][i]
                      for k in ("jax", "port", "port32"))
    assert set(got) == set(want) == set(f32) and got
    assert _l2(got, want) <= 0.1 * _l2(f32, want)
    if what == "batch_stats":
        for name, value in got.items():
            w = want[name].numpy()
            np.testing.assert_allclose(value.numpy(), w, rtol=1e-4,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=name)


def test_three_bf16_steps_params_match_jax(bf16_runs):
    lr, k = bf16_runs["lr"], 3
    got = dict(bf16_runs["tt"].model.named_parameters())
    f32 = dict(bf16_runs["t32"].model.named_parameters())
    port, jax16, port32 = [], [], []
    for name, w in bf16_runs["after"].items():
        init = bf16_runs["init"][name].numpy()
        moved = got[name].detach().numpy() - init
        want_moved = w.numpy() - init
        np.testing.assert_allclose(moved, want_moved, rtol=0,
                                   atol=2 * lr * k, err_msg=name)
        port.append(moved.ravel())
        jax16.append(want_moved.ravel())
        port32.append((f32[name].detach().numpy() - init).ravel())
    port, jax16, port32 = (np.concatenate(a) for a in (port, jax16, port32))
    assert np.linalg.norm(port - jax16) <= np.linalg.norm(jax16 - port32)
