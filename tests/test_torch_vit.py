"""Port parity: ``vit_embedder`` in ``arkflow_tpu_torch`` against the JAX
model on JAX's weights (``params_from_jax``) and the same numpy images.

The embedding is the final layer norm's CLS row in bf16, of magnitude up
to ~3, where one bf16 step is 1/64, and the two packages round the bf16
gelu differently (JAX op by op, torch once in float32): 40% of its outputs
differ by a step, and the differences pass through every later layer. So
embeddings are held to the bf16 floor 1/64 scaled to the batch's largest
embedding magnitude (``emb_atol``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.models.vit import _patchify as jax_patchify
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.vit import _patchify

#: the JAX package's test shape (tests/test_models.py::test_vit_embedding)
TINY_VIT = dict(image_size=32, patch=16, hidden=32, layers=2, heads=4, ffn=64)
EMB_TOL = 1.0 / 64


def emb_atol(want: np.ndarray) -> float:
    """The bf16 floor at the embeddings' scale."""
    return EMB_TOL * max(1.0, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def fams():
    jfam, tfam = jax_get_model("vit_embedder"), get_model("vit_embedder")
    return jfam, tfam, jfam.make_config(**TINY_VIT), tfam.make_config(**TINY_VIT)


@pytest.mark.parametrize("seed", [0, 2])
def test_apply_matches_jax(fams, seed):
    jfam, tfam, jcfg, tcfg = fams
    host = jax.device_get(jfam.init(jax.random.PRNGKey(seed), jcfg))
    imgs = np.random.RandomState(seed).rand(6, 32, 32, 3).astype(np.float32)
    want = np.asarray(jfam.apply(host, jcfg, images=jnp.asarray(imgs))["embedding"])
    with torch.inference_mode():
        got = tfam.apply(params_from_jax(host), tcfg, images=torch.from_numpy(imgs))["embedding"]
    assert got.dtype == torch.float32 and got.shape == (6, TINY_VIT["hidden"])
    np.testing.assert_allclose(got.numpy(), want, atol=emb_atol(want), rtol=0)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 48, 32, 3)])
def test_patchify_is_exactly_jax(fams, shape):
    _, _, jcfg, tcfg = fams
    imgs = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = np.asarray(jax_patchify(jnp.asarray(imgs), jcfg))
    got = _patchify(torch.from_numpy(imgs), tcfg).numpy()
    np.testing.assert_array_equal(got, want)
    # patch (r, c), element (i, j, ch) sits at (i * P + j) * C + ch
    p = tcfg.patch
    assert got[0, 1, (3 * p + 7) * 3 + 2] == imgs[0, 3, p + 7, 2]


def test_init_tree_layout_equals_jax(fams):
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
    assert tfam.input_spec(tcfg) == jfam.input_spec(jcfg)
    assert tcfg == type(tcfg)(**{k: getattr(jcfg, k) for k in TINY_VIT})
    assert tcfg.num_patches == jcfg.num_patches == 4
    with pytest.raises(ConfigError, match="unknown model_config"):
        tfam.make_config(bogus=1)
