"""Three train steps of ``cfgs/synthetic_quality_chamfer15k.yaml`` (the
Chamfer loss, Adam) at width 16, B=1, on real 15,000-slot patches, by the
port's Trainer and the JAX package's from one converted init (O(1) running
statistics and final Dense) on the same batches: the loss curves at rtol
1e-5 at the first step (one forward from the same weights) and 1e-3
after it (the parameters drift by up to 2 * lr per element and step under
Adam, as in tests/test_torch_train.py).  The JAX model runs its jnp
reference (``use_pallas`` "auto" is off on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deep3dpointclouddenoising_tpu.config import load_config as jax_load
from deep3dpointclouddenoising_tpu.models import \
    build_offset_regression as jax_build
from deep3dpointclouddenoising_tpu.parallel.mesh import make_mesh
from deep3dpointclouddenoising_tpu.train import Trainer as JaxTrainer
from deep3dpointclouddenoising_tpu.train.trainer import \
    TrainState as JaxTrainState
from deep3dpointclouddenoising_torch.config import load_config
from deep3dpointclouddenoising_torch.convert import params_from_flax
from deep3dpointclouddenoising_torch.train.trainer import Trainer
from test_torch_15k_model import CHAMFER, patches_15k
from test_torch_remat import _init


def test_three_chamfer_steps_at_15k_match_jax(tmp_path):
    overrides = {"width": 16, "batch_size": 1}
    tc, jc = load_config(CHAMFER, overrides), jax_load(CHAMFER, overrides)
    assert (tc.loss, tc.optimizer, tc.num_points) == ("chamfer", "adam",
                                                      15000)
    batches = patches_15k(tmp_path, 3)
    _, variables = _init(tc)
    tt = Trainer(tc, 10, torch.Generator().manual_seed(0), "cpu")
    tt.model.load_state_dict(params_from_flax(variables, tt.model))
    jmodel, jloss = jax_build(jc)
    jt = JaxTrainer(jc, jmodel, jloss, n_iter_per_epoch=10,
                    mesh=make_mesh(1))
    state = jt.put_replicated(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jt.tx.init(variables["params"])))
    key = jax.random.PRNGKey(0)
    want = []
    for i, b in enumerate(batches):
        state, loss = jt.train_step(state, b, jax.random.fold_in(key, i))
        want.append(float(loss))
    got = [tt.train_step(b).item() for b in batches]
    assert tt.step == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert len(set(got)) == 3  # the steps moved the loss
