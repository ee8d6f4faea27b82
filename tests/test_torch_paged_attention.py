"""K3's plain version (``paged_attention_reference``, what the wrapper runs
on CPU tensors) against the JAX package's Pallas ``paged_flash_attention``
in interpret mode, in float32 on the same numpy inputs. The cases mirror
``tests/test_paged_kernel.py``: chunked C > 1 at nonzero offsets, decode
with GQA, and stale pages past the bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkflow_tpu.ops.ragged_attention import paged_flash_attention as jax_paged
from arkflow_tpu_torch.ops import ragged_attention as ra

ATOL = 2e-5  # f32: the two differ only in summation order


def _both(q, kp, vp, table, off):
    """The Pallas kernel (interpret) and the port's wrapper on CPU tensors."""
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
                                jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table),
                                jnp.asarray(off), interpret=True))
    got = ra.paged_flash_attention(
        torch.from_numpy(q), torch.from_numpy(kp).to(torch.bfloat16),
        torch.from_numpy(vp).to(torch.bfloat16), torch.from_numpy(table),
        torch.from_numpy(off)).numpy()
    return got, want


def test_chunked_prefill_at_nonzero_offsets():
    rng = np.random.RandomState(7)
    b, c, h, kvh, dh = 4, 4, 4, 2, 8
    page, pages_per = 4, 5
    n_pages = 1 + b * pages_per
    q = (rng.randn(b, c, h, dh) * 0.5).astype(np.float32)
    kp = (rng.randn(n_pages, page, kvh, dh) * 0.5).astype(np.float32)
    vp = (rng.randn(n_pages, page, kvh, dh) * 0.5).astype(np.float32)
    table = np.asarray([np.random.RandomState(i).permutation(np.arange(1, n_pages))[:pages_per]
                        for i in range(b)], np.int32)
    # mid-page, page-aligned, empty row, and a single-token tail
    off = np.asarray([6, 8, 0, pages_per * page - c], np.int32)
    got, want = _both(q, kp, vp, table, off)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pages_per,off", [(3, [9, 11, 0]), (4, [15, 3, 1])])
def test_decode_with_gqa(pages_per, off):
    rng = np.random.RandomState(9)
    b, h, kvh, dh, page = 3, 8, 2, 8, 4  # group 4 folded into the query tile
    n_pages = 1 + b * pages_per
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    kp = (rng.randn(n_pages, page, kvh, dh) * 0.5).astype(np.float32)
    vp = (rng.randn(n_pages, page, kvh, dh) * 0.5).astype(np.float32)
    table = np.zeros((b, pages_per), np.int32)
    for r, o in enumerate(off):  # scattered pages up to each row's bound
        used = o // page + 1
        table[r, :used] = rng.permutation(np.arange(1, n_pages))[:used]
    got, want = _both(q, kp, vp, table, np.asarray(off, np.int32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_stale_pages_past_the_bound_do_not_contribute():
    rng = np.random.RandomState(11)
    b, c, h, kvh, dh, page, pages_per = 2, 2, 4, 2, 8, 4, 4
    n_pages = 1 + b * pages_per
    q = rng.randn(b, c, h, dh).astype(np.float32)
    kp = (rng.randn(n_pages, page, kvh, dh) * 0.5).astype(np.float32)
    vp = kp.copy()
    table = np.asarray([[1, 2, 7, 8], [3, 4, 5, 6]], np.int32)
    off = np.asarray([3, 2], np.int32)  # row 0 reads pages 1 and 2 only
    base, want = _both(q, kp, vp, table, off)
    np.testing.assert_allclose(base, want, atol=ATOL, rtol=0)
    kp[[0, 7, 8]] = 1e4  # poison row 0's pages past its bound and the scratch page
    vp[[0, 7, 8]] = -1e4
    poisoned, _ = _both(q, kp, vp, table, off)
    np.testing.assert_array_equal(base[0], poisoned[0])


def test_padded_chunk_queries_stay_inside_the_table():
    """A chunk's padded queries can sit past P * page; they attend the whole
    table (the JAX grid never goes past P), never an index outside it."""
    rng = np.random.RandomState(5)
    b, c, h, kvh, dh, page, pages_per = 1, 8, 4, 2, 8, 4, 3
    q = rng.randn(b, c, h, dh).astype(np.float32)
    kp = (rng.randn(7, page, kvh, dh) * 0.5).astype(np.float32)
    vp = (rng.randn(7, page, kvh, dh) * 0.5).astype(np.float32)
    table = np.asarray([[4, 2, 6]], np.int32)
    off = np.asarray([8], np.int32)  # queries at 8..15, the table holds keys 0..11
    got, want = _both(q, kp, vp, table, off)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bfloat16_q_keeps_its_dtype_and_layout():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 1, 4, 16).astype(np.float32)).to(torch.bfloat16)
    kp = torch.from_numpy(rng.randn(5, 4, 2, 16).astype(np.float32)).to(torch.bfloat16)
    out = ra.paged_flash_attention(q, kp, kp.clone(), torch.tensor([[1, 2], [3, 4]],
                                                                   dtype=torch.int32),
                                   torch.tensor([5, 0], dtype=torch.int32))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and out.is_contiguous()
    assert torch.isfinite(out.float()).all()


def test_cpu_tensors_take_the_plain_version_without_counting():
    q = torch.zeros(1, 1, 2, 8)
    kp = torch.zeros(2, 4, 1, 8, dtype=torch.bfloat16)
    table = torch.ones(1, 1, dtype=torch.int32)
    before = ra.paged_flash_attention.launches.value
    ra.paged_flash_attention(q, kp, kp, table, torch.zeros(1, dtype=torch.int32))
    assert ra.paged_flash_attention.launches.value == before


def test_the_kernel_checks_its_operands_before_launching():
    q = torch.zeros(1, 1, 4, 32, dtype=torch.bfloat16)
    kp = torch.zeros(2, 4, 2, 32, dtype=torch.bfloat16)
    table = torch.ones(1, 1, dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        ra._check_paged(q, kp, kp, table, off, q)
    q64, kp64 = q.new_zeros(1, 1, 4, 64), kp.new_zeros(2, 4, 2, 64)
    ra._check_paged(q64, kp64, kp64, table, off, q64)
    with pytest.raises(ValueError, match="bfloat16"):
        ra._check_paged(q64, kp64.float(), kp64, table, off, q64)
    with pytest.raises(ValueError, match="int32"):
        ra._check_paged(q64, kp64, kp64, table.long(), off, q64)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ra._check_paged(q64[:, :, :3], kp64, kp64, table, off, q64[:, :, :3])
