"""The port's torch-native checkpoints (``tpu/checkpoint.py``) and param
digests (``tpu/integrity.py``), and ``CompiledStep.copy_params_``: the
crash-atomic save and clean restore errors of ``tests/test_hotswap.py``,
round trips at f32, bf16 and int8 (the column-major ``w_q`` keeps its
strides), the digest manifest, and digest maps identical to the JAX
package's on the same params."""

import json
import os

import jax
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu.integrity import combined_digest as jax_combined_digest
from arkflow_tpu.tpu.integrity import tree_digests as jax_tree_digests
from arkflow_tpu.tpu.runner import convert_for_serving as jax_convert_for_serving
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.compiled_step import CompiledStep
from arkflow_tpu_torch.tpu.integrity import (combined_digest, diff_digests, flatten,
                                             tree_digests)
from arkflow_tpu_torch.tpu.runner import convert_for_serving
from tests.test_tpu_layer import TINY_BERT

SERVING_DTYPES = ["float32", "bfloat16", "int8"]


@pytest.fixture(scope="module")
def jax_host():
    fam = jax_get_model("bert_classifier")
    return fam.init(jax.random.PRNGKey(7), fam.make_config(**TINY_BERT))


def _port_tree(jax_host, dtype: str) -> dict:
    """The port's serving tree: the JAX init tree carried over, then the
    port's own conversion (int8: quantized, ``w_q`` column-major)."""
    return convert_for_serving(params_from_jax(jax.device_get(jax_host)), dtype)


def _equal_trees(a: dict, b: dict) -> None:
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].stride() == fb[k].stride(), k
        assert torch.equal(fa[k], fb[k]), k


# -- save and restore ---------------------------------------------------------


def test_save_is_atomic_and_replaces(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
    b = {"w": torch.full((2, 3), 7.0)}
    checkpoint.save(p, b)
    out = checkpoint.restore(p, {"w": torch.zeros(2, 3)})
    assert torch.equal(out["w"], b["w"])
    # nothing but the tree and its manifest survives a completed save
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.digests.json"]
    assert os.listdir(tmp_path / "ck") == [checkpoint.PARAMS_FILE]


def test_leftover_tmp_from_crashed_save_is_harmless(tmp_path):
    p = tmp_path / "ck"
    for stale in (f".ck.tmp-{os.getpid()}", ".ck.tmp-99999999", ".ck.old-99999999"):
        (tmp_path / stale).mkdir()
        (tmp_path / stale / "garbage").write_bytes(b"\x00\x01partial")
    (tmp_path / ".ck.digests.json.tmp-99999999").write_text("{")
    params = {"w": torch.ones(4)}
    checkpoint.save(str(p), params)
    assert torch.equal(checkpoint.restore(str(p), {"w": torch.zeros(4)})["w"], params["w"])
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.digests.json"]
    with pytest.raises(ConfigError, match="does not exist"):
        checkpoint.restore(str(tmp_path / "other"), params)


def test_restore_mismatch_names_offending_leaf(tmp_path):
    p = str(tmp_path / "ck")
    checkpoint.save(p, {"layer": {"w": torch.ones(2, 2)}})
    with pytest.raises(ConfigError) as ei:
        checkpoint.restore(p, {"layer": {"w_other": torch.zeros(2, 2)}})
    msg = str(ei.value)
    assert "failed to restore" in msg and "['layer']['w_other']" in msg
    assert "['layer']['w']" in msg
    with pytest.raises(ConfigError, match=r"shapes differ.*\['layer'\]\['w'\] \(2, 2\) vs \(3, 2\)"):
        checkpoint.restore(p, {"layer": {"w": torch.zeros(3, 2)}})


def test_restore_truncated_file_raises_config_error(tmp_path):
    p = tmp_path / "ck"
    checkpoint.save(str(p), {"w": torch.arange(1024, dtype=torch.float32)})
    with open(p / checkpoint.PARAMS_FILE, "r+b") as fh:
        fh.truncate(40)
    with pytest.raises(ConfigError, match="failed to restore"):
        checkpoint.restore(str(p), {"w": torch.zeros(1024)})


@pytest.mark.parametrize("like_device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", SERVING_DTYPES)
def test_roundtrip_serving_trees(tmp_path, jax_host, dtype, like_device):
    """Every leaf back bitwise with its dtype and strides, into a layout
    tree on the CPU or on the meta device (a swap's ``prepare``); the int8
    ``w_q`` stays column-major."""
    tree = _port_tree(jax_host, dtype)
    p = str(tmp_path / f"ck_{dtype}")
    checkpoint.save(p, tree)
    like = jax.tree_util.tree_map(lambda t: torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device=like_device), tree)
    out = checkpoint.restore(p, like)
    _equal_trees(out, tree)
    if dtype == "int8":
        w_q = out["layers"]["ffn_in"]["w_q"]
        assert w_q.dtype == torch.int8 and w_q[0].stride(0) == 1


def test_restore_casts_into_the_model_tree(tmp_path, jax_host):
    """A bf16 serving tree restores into the f32 init tree (the swap's
    prepare): bf16 values widen exactly, and converting back is bitwise."""
    bf16 = _port_tree(jax_host, "bfloat16")
    f32 = _port_tree(jax_host, "float32")
    p = str(tmp_path / "ck")
    checkpoint.save(p, bf16)
    out = checkpoint.restore(p, f32)
    assert flatten(out)["['pooler']['w']"].dtype == torch.float32
    _equal_trees(convert_for_serving(out, "bfloat16"), bf16)


def test_manifest_verifies_and_names_drifted_leaves(tmp_path):
    tree = {"layer": {"w": torch.arange(8, dtype=torch.float32), "b": torch.ones(2)}}
    like = {"layer": {"w": torch.zeros(8), "b": torch.zeros(2)}}
    ck = tmp_path / "ck"
    checkpoint.save(str(ck), tree)
    manifest = tmp_path / "ck.digests.json"
    doc = json.loads(manifest.read_text())
    assert doc["digests"] == tree_digests(tree)
    assert torch.equal(checkpoint.restore(str(ck), like)["layer"]["w"], tree["layer"]["w"])
    doc["digests"]["['layer']['w']"] = "0" * 32
    manifest.write_text(json.dumps(doc))
    with pytest.raises(ConfigError, match="digest verification") as ei:
        checkpoint.restore(str(ck), like)
    assert "['layer']['w']" in str(ei.value) and "['layer']['b']" not in str(ei.value)
    checkpoint.restore(str(ck), like, verify=False)
    manifest.write_text("{not json")
    with pytest.raises(ConfigError, match="unreadable"):
        checkpoint.restore(str(ck), like)
    manifest.unlink()
    checkpoint.restore(str(ck), like)


# -- digests against the JAX package ------------------------------------------


@pytest.mark.parametrize("dtype", SERVING_DTYPES)
def test_tree_digests_equal_jax(jax_host, dtype):
    """A port serving tree and the JAX serving tree of the same init give
    the same digest map: bf16 hashed from its raw words, int8 ``w_q`` in
    row-major order of its logical shape."""
    want = jax_tree_digests(jax_convert_for_serving(jax_host, dtype))
    got = tree_digests(_port_tree(jax_host, dtype))
    assert got == want
    assert combined_digest(got) == jax_combined_digest(want)
    # the JAX tree carried over as it is (row-major w_q) digests the same
    carried = params_from_jax(jax.device_get(jax_convert_for_serving(jax_host, dtype)))
    assert tree_digests(carried) == want


def test_tree_digests_detect_value_dtype_shape_and_missing_leaves():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": torch.zeros(3)}
    base = tree_digests(tree)
    assert set(base) == {"['w']", "['b']"} and diff_digests(base, tree_digests(tree)) == []
    flipped = {**tree, "w": tree["w"].clone()}
    flipped["w"][1, 2] += 1e-3
    assert diff_digests(base, tree_digests(flipped)) == ["['w']"]
    assert diff_digests(base, tree_digests({**tree, "b": tree["b"].half()})) == ["['b']"]
    assert diff_digests(base, tree_digests({**tree, "w": tree["w"].reshape(3, 2)})) == ["['w']"]
    assert diff_digests(base, tree_digests({"w": tree["w"]})) == ["['b']"]
    assert combined_digest({"x": "aa", "y": "bb"}) == combined_digest({"y": "bb", "x": "aa"})


# -- copy_params_: weights change in place -------------------------------------


def test_copy_params_keeps_addresses_and_checks_layout(jax_host):
    live = _port_tree(jax_host, "int8")
    ptrs = [t.data_ptr() for t in flatten(live).values()]
    new = jax.tree_util.tree_map(lambda t: t.clone(memory_format=torch.preserve_format) + 1
                                 if t.dtype != torch.int8 else t.clone(
                                     memory_format=torch.preserve_format), live)
    step = CompiledStep(torch.device("cpu"))
    kept = step.copy_params_(live, new, retain=True)
    assert [t.data_ptr() for t in flatten(live).values()] == ptrs
    _equal_trees(live, new)
    assert kept is not None and not torch.equal(flatten(kept)["['pooler']['b']"],
                                                flatten(live)["['pooler']['b']"])
    row_major = jax.tree_util.tree_map(lambda t: t.contiguous(), new)
    with pytest.raises(ConfigError, match=r"\['w_q'\].*strides"):
        step.copy_params_(live, row_major)
    with pytest.raises(ConfigError, match="pooler"):
        step.copy_params_(live, {**new, "pooler": {"w": torch.zeros(1)}})
    wrong = {**new, "pooler": {**new["pooler"], "b": new["pooler"]["b"].float()}}
    with pytest.raises(ConfigError, match=r"\['pooler'\]\['b'\]"):
        step.copy_params_(live, wrong)
    assert [t.data_ptr() for t in flatten(live).values()] == ptrs
