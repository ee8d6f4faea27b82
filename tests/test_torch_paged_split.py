"""K3's split-context tensor-core body (``csrc/paged_attention.cu``) as far as
the CPU can see it.

- **The rounding budget.** The body cuts each row's context into splits of
  ``PAGED_SPLIT_K`` keys, takes a softmax tile of 16 keys a warp (decode
  form, at most ``PAGED_DECODE_ROWS`` folded queries) or the whole split
  (chunk form), rounds P to bf16 per tile, and merges tiles and splits in
  f32. ``chip_smoke.emulate_paged_split`` repeats that arithmetic in plain
  PyTorch; it stays within 1/64 of the Pallas ``paged_flash_attention`` in
  interpret mode: decode with GQA, chunks at offsets 0/128/384, stale pages
  past the bound. With P kept in f32 it is K3's plain version (2e-5), for
  any split size.
- **The merge.** A split in which a query sees no key (m = -1e30, O a sum of
  V rows) gets weight 0, and cannot move the output.
- **The body chooser** and the scratch the wrapper allocates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import emulate_paged_split, merge_partials
from arkflow_tpu.ops.ragged_attention import paged_flash_attention as jax_paged
from arkflow_tpu_torch.ops import ragged_attention as ra

BF16_ATOL = 1.0 / 64  # the bf16 floor: the budget of the body's rounding
F32_ATOL = 2e-5  # f32: the two differ only in summation order


def _inputs(seed: int, b: int, c: int, h: int, kvh: int, d: int, page: int, p: int, off):
    """bf16 q and pools, a shuffled table whose entries past each row's
    bound are the scratch page 0 (even rows) or stale pages (odd rows)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * p
    q = torch.from_numpy(rng.standard_normal((b, c, h, d)).astype(np.float32)).to(torch.bfloat16)
    kp, vp = (torch.from_numpy(rng.standard_normal((n_pages, page, kvh, d)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    table = rng.permutation(np.arange(1, n_pages))[: b * p].reshape(b, p).astype(np.int32)
    off = np.asarray(off, np.int32)
    last = np.minimum((off + c - 1) // page, p - 1)
    for r in range(0, b, 2):
        table[r, last[r] + 1:] = 0
    return q, kp, vp, torch.from_numpy(table), torch.from_numpy(off)


def _pallas(q, kp, vp, table, off) -> np.ndarray:
    def j(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    out = jax_paged(j(q), j(kp), j(vp), jnp.asarray(table.numpy()), jnp.asarray(off.numpy()),
                    interpret=True)
    return np.asarray(out.astype(jnp.float32))


#: (B, C, H, KVH, D, page, P, offsets): decode with GQA (group 4, ragged
#: contexts, one row at key 0), a decode fold of 3 positions, and chunks of
#: 32 positions x group 4 = 128 folded queries (the chunk form) at offsets
#: 0, 128 and 384
CASES = {
    "decode, GQA": (3, 1, 8, 2, 64, 16, 12, [0, 100, 191]),
    "decode fold of 3 positions": (2, 3, 8, 2, 64, 16, 6, [5, 64]),
    "chunk at 0": (1, 32, 8, 2, 64, 16, 27, [0]),
    "chunk at 128": (1, 32, 8, 2, 64, 16, 27, [128]),
    "chunk at 384": (1, 32, 8, 2, 64, 16, 27, [384]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_within_budget_of_the_pallas_kernel(case):
    q, kp, vp, table, off = _inputs(len(case), *CASES[case])
    got = emulate_paged_split(q, kp, vp, table, off)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), _pallas(q, kp, vp, table, off),
                               atol=BF16_ATOL, rtol=0)
    plain = ra.paged_attention_reference(q, kp, vp, table, off)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=BF16_ATOL, rtol=0)
    assert chip_smoke.paged_err_ratio(plain, q, kp, vp, table, off) <= 1


@pytest.mark.parametrize("case", ["decode, GQA", "chunk at 128"])
def test_stale_pages_past_the_bound_do_not_contribute(case):
    """Pages past each row's bound, and the scratch page, poisoned with large
    finite values: the emulation's output does not move by a bit, and still
    lies within 1/64 of the Pallas kernel's."""
    b, c, h, kvh, d, page, p, offs = CASES[case]
    q, kp, vp, table, off = _inputs(11, *CASES[case])
    base = emulate_paged_split(q, kp, vp, table, off)
    keys = np.minimum(off.numpy() + c, p * page)
    live = np.zeros(kp.shape[:2], bool)
    for r in range(b):
        for j in range(keys[r]):
            live[table[r, j // page], j % page] = True
    live[0] = False
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[torch.from_numpy(~live)], vp2[torch.from_numpy(~live)] = 1e4, -1e4
    poisoned = emulate_paged_split(q, kp2, vp2, table, off)
    assert torch.equal(poisoned, base)
    np.testing.assert_allclose(poisoned.float().numpy(), _pallas(q, kp2, vp2, table, off),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("split_k", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["decode, GQA", "decode fold of 3 positions", "chunk at 128"])
def test_emulation_without_p_rounding_is_the_plain_version(split_k, case):
    """The splits, tiles and merges are exact in f32: with P left in f32
    the emulation is K3's plain version, whatever the split size."""
    q, kp, vp, table, off = _inputs(3, *CASES[case])
    q = q.float()  # bf16 values, f32 arithmetic
    got = emulate_paged_split(q, kp, vp, table, off, split_k=split_k, round_p=False)
    assert got.dtype == torch.float32
    want = ra.paged_attention_reference(q, kp, vp, table, off)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)


def test_padded_chunk_queries_see_the_whole_table():
    """Chunk positions past P * page attend every key of the table and
    nothing past it, as in the plain version."""
    q, kp, vp, table, off = _inputs(5, 1, 24, 8, 2, 64, 16, 3, [40])  # positions 40..63 > 47
    got = emulate_paged_split(q.float(), kp, vp, table, off, round_p=False)
    want = ra.paged_attention_reference(q.float(), kp, vp, table, off)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)


def test_merge_gives_a_split_without_keys_weight_zero():
    """A split in which the query sees no key carries m = -1e30, a sum of V
    rows and their count: merged beside a split that holds a key it changes
    nothing. Dividing each split by its own normaliser first, or taking the
    max over every split's m, would let it in."""
    rng = np.random.default_rng(0)
    o_live = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    m_live = torch.tensor([0.7, -2.0])
    l_live = torch.tensor([3.5, 1.25])
    o_dead = torch.full((2, 8), 1e4)  # V rows summed under P = exp(0) = 1
    m_dead = torch.full((2,), -1e30)
    l_dead = torch.full((2,), 64.0)
    alone = merge_partials(o_live[:, None], m_live[:, None], l_live[:, None])
    for order in ((0, 1), (1, 0)):
        parts = [(o_live, m_live, l_live), (o_dead, m_dead, l_dead)]
        o, m, l = (torch.stack([parts[i][k] for i in order], dim=-2 if k == 0 else -1)
                   for k in range(3))
        merged = merge_partials(o, m, l)
        for got, want in zip(merged, alone):
            assert torch.equal(got, want)
    wrong = (o_live / l_live[:, None] + o_dead / l_dead[:, None]) / 2
    assert (wrong - alone[0] / alone[2][:, None]).abs().max() > 1


def test_rows_at_key_zero_read_only_key_zero():
    """At a chunk at offset 0 the first position's folded queries see key
    0 alone; every other split holds no key for them, so their output is
    key 0's V row exactly."""
    case = CASES["chunk at 0"]
    q, kp, vp, table, off = _inputs(2, *case)
    got = emulate_paged_split(q, kp, vp, table, off)
    group = case[2] // case[3]
    v0 = vp[table[0, 0].long(), 0]  # [KVH, D]
    assert torch.equal(got[0, 0], v0.repeat_interleave(group, dim=0))


@pytest.mark.parametrize("d", ra.PAGED_HEAD_DIMS)
def test_paged_variant_chooser(d):
    assert ra.paged_variant(torch.bfloat16, d) == "mma"
    assert ra.paged_variant(torch.float32, d) == "fma"


@pytest.mark.parametrize("dtype,d", [(torch.float16, 128), (torch.bfloat16, 32),
                                     (torch.float32, 256), (torch.int32, 64)])
def test_paged_variant_chooser_raises_on_what_no_body_takes(dtype, d):
    with pytest.raises(ValueError):
        ra.paged_variant(dtype, d)


def test_scratch_holds_every_split_of_every_folded_query():
    """The decode step of the generate stream: 16 rows, 8 KV heads, 10
    splits of a 640-key table, 4 folded queries, 128 + 2 floats each
    (2.7 MB)."""
    n = ra.paged_scratch_floats(16, 1, 32, 8, 128, 40, 16)
    assert n == 16 * 8 * 10 * 4 * 130 and 2.6e6 < 4 * n < 2.7e6
    assert ra.paged_scratch_floats(1, 128, 32, 8, 128, 40, 16) == 8 * 10 * 512 * 130
    assert ra.paged_scratch_floats(1, 1, 8, 8, 64, 1, 16) == 8 * 66  # one split


def test_the_counter_counts_per_body_and_not_on_the_cpu_path():
    """``paged_flash_attention.launches`` counts calls per body (a bf16 call
    launches the split kernel and its combine, and counts once); the plain
    version on CPU tensors counts nothing."""
    counter = ra.paged_flash_attention.launches
    assert set(counter.variants) == set(ra.VARIANTS)
    before = (counter.value, dict(counter.variants))
    q, kp, vp, table, off = _inputs(1, *CASES["decode, GQA"])
    ra.paged_flash_attention(q, kp, vp, table, off)
    ra.paged_flash_attention(q.float(), kp, vp, table, off)
    assert (counter.value, dict(counter.variants)) == before
