"""Port parity: ``bert_classifier``'s apply in ``arkflow_tpu_torch`` against
the JAX model on the same weights (JAX ``init`` -> ``params_from_jax``) and
the same ids/masks, on the kernel path and on the plain attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu_torch.convert import params_from_jax, params_to_numpy
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from tests.test_tpu_layer import TINY_BERT

#: logits of the bf16 model: the bf16 floor of the parity rules
LOGIT_ATOL = 1.0 / 64
#: labels are compared only where the top-2 logit gap exceeds this
TIE_MARGIN = 0.05


def _jax_params(seed: int, dtype=None):
    fam = jax_get_model("bert_classifier")
    p = fam.init(jax.random.PRNGKey(seed), fam.make_config(**TINY_BERT))
    if dtype is not None:
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
    return jax.device_get(p)


def _batch(seed: int, rows: int, s: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, TINY_BERT["vocab_size"], (rows, s)).astype(np.int32)
    lengths = np.concatenate([[s, 1], rng.integers(1, s + 1, rows - 2)])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def _assert_parity(want: dict, got: dict):
    wl, gl = np.asarray(want["logits"]), got["logits"].numpy()
    np.testing.assert_allclose(gl, wl, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(wl, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    assert tie_free.sum() >= len(wl) // 2
    np.testing.assert_array_equal(got["label"].numpy()[tie_free],
                                  np.asarray(want["label"])[tie_free])
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("params_dtype", [None, jnp.bfloat16])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("s", [16, 24])
def test_apply_matches_jax(s, flash, params_dtype):
    jfam, tfam = jax_get_model("bert_classifier"), get_model("bert_classifier")
    jcfg = jfam.make_config(**TINY_BERT, use_flash_attention=flash, flash_interpret=flash)
    tcfg = tfam.make_config(**TINY_BERT, use_flash_attention=flash)
    host = _jax_params(0, params_dtype)
    ids, mask = _batch(s, 8, s)
    want = jfam.apply(host, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got = tfam.apply(params_from_jax(host), tcfg, input_ids=torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask))
    assert got["label"].dtype == torch.int32 and got["logits"].dtype == torch.float32
    _assert_parity(want, got)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_params_from_jax_round_trips_bitwise(dtype):
    host = _jax_params(1, dtype)
    back = params_to_numpy(params_from_jax(host))
    flat_host = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, leaf in flat_host:
        node = back
        for key in path:
            node = node[key.key]
        src = np.asarray(leaf).astype(np.float32)
        assert node.shape == src.shape, path
        np.testing.assert_array_equal(node.view(np.uint32), src.view(np.uint32))


def test_port_init_has_the_jax_layout():
    """Same nested paths and shapes as the JAX init, layers stacked on a
    leading axis; the draws come from a torch.Generator (seeded, repeatable)."""
    tfam = get_model("bert_classifier")
    cfg = tfam.make_config(**TINY_BERT)
    a = params_to_numpy(tfam.init(torch.Generator().manual_seed(0), cfg))
    b = params_to_numpy(tfam.init(torch.Generator().manual_seed(0), cfg))
    want = jax.tree_util.tree_map(lambda x: x.shape, _jax_params(0))
    got = jax.tree_util.tree_map(lambda x: x.shape, a)
    assert got == want
    assert a["layers"]["q"]["w"].shape[0] == TINY_BERT["layers"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    bound = 1.0 / np.sqrt(TINY_BERT["hidden"])
    assert np.abs(a["layers"]["q"]["w"]).max() <= bound
    assert not a["layers"]["q"]["b"].any()


def test_make_config_rejects_unported_and_unknown_fields():
    fam = get_model("bert_classifier")
    with pytest.raises(ConfigError, match="not yet ported"):
        fam.make_config(flash_interpret=True)
    assert fam.make_config(packed_flash=True).packed_flash is True
    with pytest.raises(ConfigError, match="unknown"):
        fam.make_config(hiden=32)
    with pytest.raises(ConfigError, match="softmax_dtype"):
        fam.make_config(softmax_dtype="float16")
