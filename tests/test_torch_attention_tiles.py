"""The tensor-core tile of K1, K2 and K4 (``csrc/mma_tile.cuh``) as far as
the CPU can see it.

- **The rounding budget.** The tile runs both products on bf16 tensor cores
  with f32 sums and rounds P to bf16 before P V, over key tiles of
  ``MMA_BLOCK_K[D]`` keys. ``chip_smoke.emulate_mma_tile`` repeats that
  arithmetic in plain PyTorch.
  It stays within 1/64 of the Pallas kernels run in interpret mode (and of
  the port's plain versions, which ``chip_smoke.py`` holds the tile
  against on the card) for K1, K2 and K4, at D 16 and 64 (K4 also at 128,
  where the key tiles are 32 wide), causal on and off.
  That is the design: the TPU kernels' f32 dots run at the MXU's default
  precision, in bf16 passes, so rounding P to bf16 is the TPU's own
  rounding, and bf16 outputs are held to the bf16 floor (1/64) anyway.
  With P kept in f32 the emulation is the plain online softmax (2e-5).
- **The per-element limit.** ``chip_smoke.py`` also holds each bf16
  output of the tile against the emulation to one bf16 step of its size,
  2^-12, and room for two P values of its row rounded the other way
  (``tile_err_ratio``). The emulation with its sums in float64 (another
  order of sums, as the card's) stays inside that limit; one key tile
  weighted 1.5x for the late rows of a 4096-token causal prefill, which
  stays within 1/64 of the plain version, does not.
- **The variant chooser.** bf16 at D in {16, 32, 64, 128} runs the tile
  (``mma``); f32, and D = 8, the FMA body (``fma``); anything else raises
  before a launch. The header's constants match the wrapper's.
- **The per-variant counters** count nothing on the CPU path.
- **``chip_smoke.py``'s ptxas parser** names kernel, dtype, D, mask policy
  and variant for every instantiation.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import emulate_mma_tile, ragged_masks, segment_masks, tile_err_ratio
from arkflow_tpu.ops.flash_attention import flash_attention as jax_flash
from arkflow_tpu.ops.ragged_attention import ragged_flash_attention as jax_ragged
from arkflow_tpu.ops.segment_attention import segment_flash_attention as jax_segment
from arkflow_tpu_torch.ops import flash_attention, flash_attention_reference
from arkflow_tpu_torch.ops import ragged_attention as ra
from arkflow_tpu_torch.ops import segment_attention as sa

CSRC = Path(__file__).resolve().parent.parent / "arkflow_tpu_torch" / "csrc"
BF16_ATOL = 1.0 / 64  # the bf16 floor: the budget of the tile's rounding
F32_ATOL = 2e-5  # the f32 floor of the parity rules


def _qkv(seed: int, b: int, h: int, s: int, d: int):
    """bf16-valued float32 arrays, so every package starts from the same
    bf16 operands."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def _to_jax(x):
    return jnp.asarray(x, jnp.bfloat16)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_rounding_within_budget(d, causal):
    b, h, s = 3, 2, 128
    q, k, v = _qkv(d + causal, b, h, s, d)
    lengths = np.array([0, 77, s], np.int32)
    want = np.asarray(jax_ragged(*map(_to_jax, (q, k, v)), jnp.asarray(lengths), causal=causal,
                                 tile_q=32, tile_k=32, interpret=True).astype(jnp.float32))
    allowed, live = ragged_masks(lengths, s, causal)
    got = emulate_mma_tile(*map(_bf16, (q, k, v)), allowed, live).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    plain = ra.ragged_attention_reference(*map(_bf16, (q, k, v)), torch.from_numpy(lengths),
                                          causal=causal).float().numpy()
    np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)
    assert (got[0] == 0).all() and (got[1, :, 77:] == 0).all()


@pytest.mark.parametrize("d", [16, 64])
def test_segment_rounding_within_budget(d):
    b, h, s = 8, 2, 128
    q, k, v = _qkv(d, b, h, s, d)
    seg = chip_smoke.segment_layouts(np.random.default_rng(d), b, s)
    want = np.asarray(jax_segment(*map(_to_jax, (q, k, v)), jnp.asarray(seg), tile_q=32,
                                  tile_k=32, interpret=True).astype(jnp.float32))
    allowed, live = segment_masks(seg)
    got = emulate_mma_tile(*map(_bf16, (q, k, v)), allowed, live).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    plain = sa.segment_attention_reference(*map(_bf16, (q, k, v)),
                                           torch.from_numpy(seg)).float().numpy()
    np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)
    dead = np.broadcast_to((seg == 0)[:, None, :, None], got.shape)
    assert (got[dead] == 0).all()


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_rounding_within_budget(d, causal):
    b, h, s = 2, 2, 128
    q, k, v = _qkv(10 + d + causal, b, h, s, d)
    want = np.asarray(jax_flash(*map(_to_jax, (q, k, v)), causal=causal, tile_q=32, tile_k=32,
                                interpret=True).astype(jnp.float32))
    allowed, live = ragged_masks(np.full(b, s), s, causal)
    got = emulate_mma_tile(*map(_bf16, (q, k, v)), allowed, live).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    plain = flash_attention_reference(*map(_bf16, (q, k, v)), causal=causal).float().numpy()
    np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("block_k", [32, 64])
def test_emulation_without_p_rounding_is_the_plain_softmax(block_k):
    """The emulation's online softmax itself is exact in f32: with P left in
    f32 it is the plain version, so the budget above is the rounding's."""
    b, h, s, d = 3, 2, 100, 16
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float() for x in _qkv(5, b, h, s, d))
    lengths = np.array([0, 1, 63], np.int32)
    allowed, live = ragged_masks(lengths, s, True)
    got = emulate_mma_tile(q, k, v, allowed, live, block_k=block_k, round_p=False)
    want = ra.ragged_attention_reference(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                         v.to(torch.bfloat16), torch.from_numpy(lengths),
                                         causal=True)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("x,step", [(1.0, 2.0 ** -7), (-3.0, 2.0 ** -6), (0.03, 2.0 ** -13),
                                    (2.0 ** -6, 2.0 ** -13), (0.0, 2.0 ** -133)])
def test_bf16_step_is_the_spacing_of_bf16_values(x, step):
    got = chip_smoke.bf16_step(torch.tensor([x])).item()
    assert got == step
    if x:  # |x| in bf16 and the next bf16 value up lie one step apart
        xb = torch.tensor([abs(x)]).to(torch.bfloat16)
        up = (xb.view(torch.int16) + 1).view(torch.bfloat16)
        assert up.item() - xb.item() == step


@pytest.mark.parametrize("b,h,s,d,causal", [(8, 4, 256, 64, False), (4, 2, 37, 16, True),
                                            (2, 4, 512, 128, True), (2, 2, 2048, 128, True)])
def test_tile_limit_holds_sums_in_another_order(b, h, s, d, causal):
    """The card sums in another order than the emulation's f32 matmuls: the
    emulation in float64 stands in for it, and stays inside the limit."""
    q, k, v = map(_bf16, _qkv(s + d, b, h, s, d))
    lengths = np.random.default_rng(s).integers(0, s + 1, b)
    lengths[:2] = [1, s]
    allowed, live = ragged_masks(torch.from_numpy(lengths), s, causal)
    other_order = emulate_mma_tile(q, k, v, allowed, live, dtype=torch.float64)
    assert tile_err_ratio(other_order, q, k, v, allowed, live, "mma") < 1


def test_tile_limit_catches_a_misweighted_key_tile():
    """One key tile weighted 1.5x for the last quarter of a 4096-token
    causal prefill's rows: within the 1/64 ceiling of the plain version,
    because those rows' outputs are small, but far outside the per-element
    limit."""
    b, h, s, d = 1, 2, 4096, 128
    q, k, v = map(_bf16, _qkv(3, b, h, s, d))
    allowed, live = ragged_masks(torch.full((b,), s), s, True)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    w = torch.softmax(torch.where(allowed, scores, -1e30), dim=-1)
    w[:, :, 3 * s // 4:, :ra.MMA_BLOCK_K[d]] *= 1.5
    wrong = (torch.matmul(w, v.float()) / w.sum(-1, keepdim=True)).to(torch.bfloat16)
    plain = flash_attention_reference(q, k, v, causal=True)
    assert (wrong.float() - plain.float()).abs().max().item() <= BF16_ATOL
    assert tile_err_ratio(wrong, q, k, v, allowed, live, "mma") > 10


@pytest.mark.parametrize("d", ra.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_variant_chooser(d, dtype):
    want = "mma" if dtype == torch.bfloat16 and d >= 16 else "fma"
    assert ra.kernel_variant(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float64, 64), (torch.int32, 64),
                                     (torch.bfloat16, 4), (torch.bfloat16, 48),
                                     (torch.bfloat16, 256), (torch.float32, 0)])
def test_variant_chooser_raises_on_what_no_body_takes(dtype, d):
    with pytest.raises(ValueError):
        ra.kernel_variant(dtype, d)


def test_check_operands_raises_before_any_launch():
    """An unsupported dtype or head dim raises in the wrapper's checks,
    before a library is loaded."""
    for shape, dtype, what in (((1, 1, 8, 48), torch.bfloat16, "head dim 48"),
                               ((1, 1, 8, 64), torch.float16, "float32 or bfloat16")):
        x = torch.zeros(shape, dtype=dtype)
        with pytest.raises(ValueError, match=what):
            ra.check_operands("segment attention", x, x, x, x)
    x = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    assert ra.check_operands("k", x, x, x, x) == "mma"
    assert ra.check_operands("k", x.float(), x.float(), x.float(), x.float()) == "fma"


def test_header_constants_match_the_wrapper():
    """The key-tile widths and the tile's head dims in ``mma_tile.cuh`` are
    the ones ``MMA_BLOCK_K`` and ``kernel_variant`` state."""
    text = (CSRC / "mma_tile.cuh").read_text()
    big, at_big, other = re.search(
        r"constexpr int kMmaBlockK = D == (\d+) \? (\d+) : (\d+);", text).groups()
    assert ra.MMA_BLOCK_K == {d: int(at_big) if d == int(big) else int(other)
                              for d in ra.MMA_HEAD_DIMS}
    assert "kBlockK = %d;" % chip_smoke.FMA_BLOCK_K in (CSRC / "attention_common.cuh").read_text()
    rule = re.search(r"takes_mma_tile\(int is_bf16, int D\) \{\s*return is_bf16 && \(([^;]*)\);",
                     text).group(1)
    assert tuple(int(x) for x in re.findall(r"D == (\d+)", rule)) == ra.MMA_HEAD_DIMS
    # segment_attention.cu holds no kernel of its own: one tile serves K1, K2, K4
    for entry in ("ragged_attention.cu", "segment_attention.cu", "flash_attention.cu"):
        source = (CSRC / entry).read_text()
        assert "__global__" not in source and '#include "mma_tile.cuh"' in source


def test_launch_counter_counts_per_variant():
    c = ra.LaunchCounter(ra.VARIANTS)
    c.add("mma")
    c.add("mma")
    c.add("fma")
    assert c.value == 3 and c.variants == {"mma": 2, "fma": 1}
    with pytest.raises(KeyError):
        c.add("wgmma")
    c.reset()
    assert c.value == 0 and c.variants == {"mma": 0, "fma": 0}
    plain = ra.LaunchCounter()  # K3's: no variants
    plain.add()
    assert plain.value == 1 and plain.variants == {}


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 16), (torch.bfloat16, 64),
                                     (torch.float32, 64), (torch.bfloat16, 8)])
def test_counters_do_not_move_on_the_cpu_path(dtype, d):
    b, h, s = 2, 2, 16
    q = torch.randn(b, h, s, d).to(dtype)
    counters = (ra.launches, sa.launches, flash_attention.launches)
    before = [(c.value, dict(c.variants)) for c in counters]
    ra.ragged_flash_attention(q, q, q, torch.tensor([3, 16], dtype=torch.int32))
    sa.segment_flash_attention(q, q, q, torch.ones(b, s, dtype=torch.int32))
    flash_attention(q, q, q, causal=True)
    assert [(c.value, dict(c.variants)) for c in counters] == before
    assert all(set(c.variants) == set(ra.VARIANTS) for c in counters)


#: ``-Xptxas -v`` lines as nvcc prints them for the tiles and K3
PTXAS = """\
ptxas info    : Compiling entry function '_ZN7arkflow15mma_tile_kernelILi64ELi2EEEvPK13__nv_bfloat16S3_S3_PS1_PKiiifNS_7StridesES7_S7_S7_' for 'sm_90a'
ptxas info    : Function properties for _ZN7arkflow15mma_tile_kernelILi64ELi2EEEvPK13__nv_bfloat16S3_S3_PS1_PKiiifNS_7StridesES7_S7_S7_
    0 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, 16 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN7arkflow17flash_tile_kernelIfLi128ELi1EEEvPKT_S3_S3_PS1_PKiiifNS_7StridesES7_S7_S7_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, 4620 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN7arkflow17flash_tile_kernelI13__nv_bfloat16Li8ELi0EEEvPKT_S3_S3_PS1_PKiiifNS_7StridesES7_S7_S7_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 272 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122paged_attention_kernelI13__nv_bfloat16Li128ELi16EEEvPKT_PKS1_S6_PS2_PKiS9_iiiiifN7arkflow7StridesESB_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 109 registers, 16384 bytes smem, 440 bytes cmem[0]
"""


def test_ptxas_summary_names_every_instantiation():
    assert chip_smoke.ptxas_summary(PTXAS) == [
        {"kernel": "mma_tile", "dtype": "bf16", "D": 64, "mask": "segment", "variant": "mma",
         "spill_store_bytes": 20, "registers": 128},
        {"kernel": "flash_tile", "dtype": "f32", "D": 128, "mask": "ragged", "variant": "fma",
         "spill_store_bytes": 0, "registers": 126},
        {"kernel": "flash_tile", "dtype": "bf16", "D": 8, "mask": "dense", "variant": "fma",
         "spill_store_bytes": 0, "registers": 72},
        {"kernel": "paged_attention", "dtype": "bf16", "D": 128, "BQ": 16,
         "spill_store_bytes": 0, "registers": 109},
    ]
