"""Port parity for kernel K2: the segment attention kernel's plain PyTorch
version against the JAX package's Pallas kernel in interpret mode, the
wrapper's CPU routing, and ``bert.apply_packed`` against JAX's (pair mask
and segment kernel) and against the port's own padded ``apply``. (The CUDA
kernel runs only on the card: chip_smoke.py holds it against this plain
version there.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.ops.segment_attention import segment_flash_attention as jax_segment
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.ops import segment_attention as sa
from arkflow_tpu_torch.tpu.packing import pack_tokens
from tests.test_tpu_layer import TINY_BERT

#: float32: online softmax (JAX kernel) against a full softmax (plain
#: version): a few f32 ulps on outputs of size ~1
F32_ATOL = 2e-5
#: bfloat16 inputs: both round the f32 result to bf16 once, one ulp apart
BF16_ATOL = 1.0 / 64
#: model logits: both packages run BERT's dense layers in bf16
#: (``common.dense``), so the bf16 floor of the parity rules applies
LOGIT_ATOL = 1.0 / 64
TIE_MARGIN = 0.05


def _layouts(seed: int, b: int, s: int) -> np.ndarray:
    """Row 0 dead, row 1 one segment spanning S, row 2 length-1 segments,
    row 3 interleaved (non-contiguous) ids, the rest packed by pack_tokens
    (out-of-order ids, dead tails)."""
    rng = np.random.RandomState(seed)
    lengths = np.where(rng.rand(4 * b) < 0.7, rng.randint(1, s // 4 + 1, 4 * b),
                       rng.randint(s // 2, s + 1, 4 * b))
    pk = pack_tokens(np.ones((4 * b, s), np.int32), lengths, s)
    seg = np.zeros((b, s), np.int32)
    rows = min(b - 4, pk.num_rows)
    seg[4:4 + rows] = pk.segment_ids[:rows]
    seg[1] = 1
    seg[2] = np.arange(1, s + 1)
    seg[3] = np.arange(s) % 3 + 1
    seg[3, ::5] = 0
    return seg


def _qkv(seed: int, b: int, h: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,tile", [(32, 8), (24, 8), (16, 16)])
def test_plain_matches_jax_kernel(s, tile, dtype):
    b, h, d = 8, 2, 8
    q, k, v = _qkv(s, b, h, s, d)
    seg = _layouts(s, b, s)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_segment(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(seg),
                       tile_q=tile, tile_k=tile, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = sa.segment_attention_reference(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                         torch.from_numpy(seg))
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL if dtype == "float32" else BF16_ATOL,
                               rtol=0)
    dead = np.broadcast_to((seg == 0)[:, None, :, None], got.shape)
    assert (got[dead] == 0).all() and (want[dead] == 0).all()
    assert (got[0] == 0).all()


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 8, 2, 16, 8))
    seg = torch.from_numpy(_layouts(3, 8, 16))
    before = sa.launches.value
    out = sa.segment_flash_attention(q, k, v, seg)
    assert sa.launches.value == before
    torch.testing.assert_close(out, sa.segment_attention_reference(q, k, v, seg), rtol=0, atol=0)


def test_wrapper_reads_strided_views_like_the_model_hands_them():
    x = [torch.from_numpy(a).transpose(1, 2) for a in _qkv(4, 8, 16, 2, 8)]  # [B,S,H,D] data
    seg = torch.from_numpy(_layouts(4, 8, 16))
    got = sa.segment_flash_attention(*x, seg)
    want = sa.segment_flash_attention(*(t.contiguous() for t in x), seg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sa.segment_flash_attention(q, q, q, torch.zeros(1, 4, dtype=torch.int32, device="meta"))


def _packed_inputs(seed: int, n: int, smax: int, seq: int):
    rng = np.random.RandomState(seed)
    lengths = np.where(rng.rand(n) < 0.8, rng.randint(2, max(3, smax // 4), n),
                       rng.randint(smax // 2, smax + 1, n)).astype(np.int64)
    ids = np.zeros((n, smax), np.int32)
    for i, length in enumerate(lengths):
        ids[i, :length] = rng.randint(4, TINY_BERT["vocab_size"], length)
    pk = pack_tokens(ids, lengths, seq)
    kw = {name: getattr(pk, name) for name in
          ("input_ids", "segment_ids", "position_ids", "example_row", "example_pos")}
    return ids, lengths, kw


def _assert_parity(want_logits, want_labels, got: dict):
    gl = got["logits"].numpy()
    np.testing.assert_allclose(gl, want_logits, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want_logits, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > TIE_MARGIN
    assert tie_free.sum() >= len(gl) // 2
    np.testing.assert_array_equal(got["label"].numpy()[tie_free], want_labels[tie_free])


@pytest.mark.parametrize("packed_flash", [False, True])
@pytest.mark.parametrize("seed,n,smax,seq", [(12, 40, 30, 32)])
def test_apply_packed_matches_jax(seed, n, smax, seq, packed_flash):
    """Pair mask against pair mask; the port's kernel path (its plain version
    on the CPU) against JAX's segment kernel in interpret mode."""
    jfam, tfam = jax_get_model("bert_classifier"), get_model("bert_classifier")
    jcfg = jfam.make_config(**TINY_BERT, packed_flash=packed_flash,
                            flash_interpret=packed_flash, flash_min_seq=1)
    tcfg = tfam.make_config(**TINY_BERT, packed_flash=packed_flash)
    host = jax.device_get(jfam.init(jax.random.PRNGKey(seed), jcfg))
    _, _, kw = _packed_inputs(seed, n, smax, seq)
    want = jfam.extras["apply_packed"](host, jcfg, **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        got = tfam.extras["apply_packed"](params_from_jax(host), tcfg,
                                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got["logits"].shape == (n, 2) and got["label"].dtype == torch.int32
    _assert_parity(np.asarray(want["logits"]), np.asarray(want["label"]), got)


@pytest.mark.parametrize("packed_flash", [False, True])
def test_apply_packed_matches_the_padded_apply(packed_flash):
    """Packing is a re-arrangement: per-example outputs equal the padded
    ``apply`` on the same texts, in example order."""
    fam = get_model("bert_classifier")
    jfam = jax_get_model("bert_classifier")
    params = params_from_jax(jax.device_get(
        jfam.init(jax.random.PRNGKey(3), jfam.make_config(**TINY_BERT))))
    ids, lengths, kw = _packed_inputs(3, 24, 24, 32)
    mask = (np.arange(24)[None, :] < lengths[:, None]).astype(np.int32)
    with torch.inference_mode():
        ref = fam.apply(params, fam.make_config(**TINY_BERT), input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask))
        got = fam.extras["apply_packed"](
            params, fam.make_config(**TINY_BERT, packed_flash=packed_flash),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    _assert_parity(ref["logits"].numpy(), ref["label"].numpy(), got)


def test_packed_flash_gate_is_a_cfg_field():
    """``packed_flash`` unset takes the pair mask in a direct call; set, the
    segment path; the two agree."""
    fam = get_model("bert_classifier")
    cfg = fam.make_config(**TINY_BERT)
    assert cfg.packed_flash is None
    params = fam.init(torch.Generator().manual_seed(0), cfg)
    _, _, kw = _packed_inputs(5, 12, 20, 32)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.inference_mode():
        ref = fam.extras["apply_packed"](params, cfg, **tkw)
        got = fam.extras["apply_packed"](params, dataclasses.replace(cfg, packed_flash=True),
                                         **tkw)
    _assert_parity(ref["logits"].numpy(), ref["label"].numpy(), got)
