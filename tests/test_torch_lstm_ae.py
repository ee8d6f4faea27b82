"""Port parity: ``lstm_ae`` in ``arkflow_tpu_torch`` against the JAX model
on JAX's weights (``params_from_jax``) and the same numpy windows. The
model runs in float32 in both packages: scores and reconstructions are
held at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models.lstm_ae import _lstm_scan as jax_lstm_scan
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.lstm_ae import _lstm_scan

#: the JAX package's test shape (tests/test_models.py::test_lstm_ae_scores)
TINY_LSTM = dict(features=4, hidden=16, latent=8, window=10)
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def fams():
    jfam, tfam = jax_get_model("lstm_ae"), get_model("lstm_ae")
    return jfam, tfam, jfam.make_config(**TINY_LSTM), tfam.make_config(**TINY_LSTM)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_matches_jax(fams, seed):
    jfam, tfam, jcfg, tcfg = fams
    host = jax.device_get(jfam.init(jax.random.PRNGKey(seed), jcfg))
    vals = np.random.RandomState(seed).randn(5, 10, 4).astype(np.float32)
    want = jfam.apply(host, jcfg, values=jnp.asarray(vals))
    got = tfam.apply(params_from_jax(host), tcfg, values=torch.from_numpy(vals))
    assert got["score"].dtype == torch.float32 and got["score"].shape == (5,)
    assert got["reconstruction"].shape == (5, 10, 4)
    for k in ("score", "reconstruction"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=F32_TOL, rtol=F32_TOL)
    assert (got["score"] >= 0).all()


def test_lstm_scan_matches_jax(fams):
    jfam, _, jcfg, _ = fams
    host = jax.device_get(jfam.init(jax.random.PRNGKey(3), jcfg))
    xs = np.random.RandomState(3).randn(7, 3, 4).astype(np.float32)
    (jh, jc), jys = jax_lstm_scan(host["encoder"], jnp.asarray(xs), 16)
    (th, tc), tys = _lstm_scan(params_from_jax(host)["encoder"], torch.from_numpy(xs), 16)
    for g, w in ((th, jh), (tc, jc), (tys, jys)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL, rtol=F32_TOL)


def test_init_tree_layout_and_training_refusal(fams):
    jfam, tfam, jcfg, tcfg = fams
    want = jax.device_get(jfam.init(jax.random.PRNGKey(0), jcfg))
    got = tfam.init(torch.Generator().manual_seed(0), tcfg)
    flat_w = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v
              for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    for path, w in flat_w.items():
        assert tuple(flat_g[path].shape) == w.shape and flat_g[path].dtype == torch.float32, path
    assert tfam.input_spec(tcfg) == jfam.input_spec(jcfg) == {"values": ("float32", (10, 4))}
    with pytest.raises(ConfigError, match="unknown model_config"):
        tfam.make_config(bogus=1)
    for name, args in (("loss_fn", (got, tcfg, None)), ("make_train_step", (tcfg, None))):
        with pytest.raises(ConfigError, match="not yet ported"):
            tfam.extras[name](*args)
