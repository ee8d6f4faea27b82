"""Port parity for the packed path's host side: ``pack_tokens`` and
``carve_row_windows`` bitwise against the JAX package's (whose native tier
packs here), ``payload_token_estimates`` against JAX's and against the
port's own tokenizer, and the packed bucket grids."""

import numpy as np
import pyarrow as pa
import pytest

from arkflow_tpu.tpu import bucketing as jb
from arkflow_tpu.tpu.extract import payload_token_estimates as jax_estimates
from arkflow_tpu.tpu.packing import carve_row_windows as jax_carve
from arkflow_tpu.tpu.packing import pack_tokens as jax_pack
from arkflow_tpu_torch.batch import BinaryColumn, MessageBatch
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.tpu import bucketing as tb
from arkflow_tpu_torch.tpu.extract import payload_token_estimates
from arkflow_tpu_torch.tpu.packing import carve_row_windows, pack_tokens
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

FIELDS = ("input_ids", "segment_ids", "position_ids", "example_row", "example_pos")
WORD = b"sensor reading nominal "
TEXTS = ([WORD * k for k in (1, 2, 1, 3, 1, 2, 8, 1)] * 4
         + [b"", b"x", WORD * 12, b"a,b;c!", b"  spaced   out  ", b"123 abc 456",
            "café naïve — ok".encode(), b"tabs\tand\nnewlines"])


def _ragged(seed: int, n: int, smax: int, dist: str):
    rng = np.random.RandomState(seed)
    if dist == "mixed":  # mostly short, a long tail
        lengths = np.where(rng.rand(n) < 0.8, rng.randint(2, max(3, smax // 4), n),
                           rng.randint(smax // 2, smax + 1, n))
    elif dist == "with_empty":
        lengths = rng.randint(0, smax + 1, n)
    else:
        lengths = rng.randint(1, smax + 1, n)
    ids = np.zeros((n, smax), np.int32)
    for i, length in enumerate(lengths):
        ids[i, :length] = rng.randint(1, 500, length)
    return ids, lengths.astype(np.int64)


def _assert_same_layout(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed,n,smax,seq,dist", [
    (0, 64, 32, 32, "mixed"),
    (1, 200, 24, 32, "uniform"),
    (2, 50, 40, 16, "uniform"),      # truncation: lengths beyond seq
    (3, 30, 16, 16, "with_empty"),   # empty texts still take their [CLS] slot
    (4, 1, 8, 8, "uniform"),
    (5, 300, 256, 256, "mixed"),
])
def test_pack_tokens_bitwise_equals_jax(seed, n, smax, seq, dist):
    ids, lengths = _ragged(seed, n, smax, dist)
    _assert_same_layout(pack_tokens(ids, lengths, seq), jax_pack(ids, lengths, seq))


def test_pack_tokens_numbers_segments_out_of_position_order():
    """Rows fill longest first, segments are numbered in input order: the
    example of the layout notes in ``tpu/packing.py``."""
    lengths = np.array([3, 40, 5, 30, 7, 60, 2])
    ids = np.ones((7, 64), np.int32)
    pk = pack_tokens(ids, lengths, 64)
    _assert_same_layout(pk, jax_pack(ids, lengths, 64))
    runs = []
    for sid in pk.segment_ids[pk.example_row[1]]:  # the row of the 40-token example
        if runs and runs[-1][0] == sid:
            runs[-1][1] += 1
        else:
            runs.append([int(sid), 1])
    assert runs == [[1, 40], [3, 7], [2, 5], [4, 2], [0, 10]]


def test_pack_tokens_edges():
    empty = pack_tokens(np.zeros((0, 4), np.int32), np.zeros(0), 4)
    assert empty.num_rows == 0 and empty.num_examples == 0
    with pytest.raises(ValueError):
        pack_tokens(np.zeros((2, 0), np.int32), np.zeros(2), 4)
    pk = pack_tokens(np.arange(1, 11, dtype=np.int32).reshape(1, 10), np.array([10]), 4)
    np.testing.assert_array_equal(pk.input_ids[0], [1, 2, 3, 4])
    assert pk.fill_ratio == 1.0


@pytest.mark.parametrize("seed,n,smax,seq,max_rows,max_examples,buckets", [
    (11, 200, 24, 32, 32, 4096, (8, 16, 32)),   # cascade down the grid
    (12, 120, 24, 32, 16, 64, (8, 16)),
    (13, 150, 4, 32, 32, 16, (8, 16, 32)),      # the max_examples edge
    (14, 10, 8, 32, 1024, 4096, None),          # one window
    (15, 400, 256, 256, 64, 256, (8, 16, 32, 64)),
])
def test_carve_row_windows_bitwise_equals_jax(seed, n, smax, seq, max_rows, max_examples,
                                              buckets):
    ids, lengths = _ragged(seed, n, smax, "uniform" if smax > 4 else "mixed")
    if smax == 4:
        lengths = np.random.RandomState(seed).randint(2, 5, n).astype(np.int64)
    pk = pack_tokens(ids, lengths, seq)
    got = carve_row_windows(pk, max_rows, max_examples, buckets)
    want = jax_carve(jax_pack(ids, lengths, seq), max_rows, max_examples, buckets)
    assert len(got) == len(want)
    for (gi, gidx), (wi, widx) in zip(got, want):
        np.testing.assert_array_equal(gidx, widx)
        assert set(gi) == set(wi)
        for k in gi:
            assert gi[k].dtype == wi[k].dtype
            np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
        assert len(gidx) <= max_examples and gi["input_ids"].shape[0] <= max_rows
    seen = np.concatenate([idx for _, idx in got])
    np.testing.assert_array_equal(np.sort(seen), np.arange(n))


def test_carve_row_windows_edges():
    empty = pack_tokens(np.zeros((0, 8), np.int32), np.zeros(0, np.int64), 8)
    assert carve_row_windows(empty, 8, 8) == []
    with pytest.raises(ValueError):
        carve_row_windows(pack_tokens(np.ones((2, 4), np.int32), np.array([2, 3]), 4), 0, 8)


@pytest.mark.parametrize("kwargs", [{}, {"max_tokens": 5}, {"token_bytes": 4.0},
                                    {"token_bytes": 3.0, "max_tokens": 4}])
def test_token_estimates_equal_jax(kwargs):
    got = payload_token_estimates(BinaryColumn.from_pylist(TEXTS), **kwargs)
    want = jax_estimates(pa.array(TEXTS, pa.binary()), **kwargs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_token_estimates_equal_the_tokenizer_count_on_a_sliced_column():
    """Default mode is the hash tokenizer's exact count (+2 specials), also
    on a column sliced out of a larger buffer."""
    col = MessageBatch.new_binary(TEXTS).slice(3, len(TEXTS) - 5).column("__value__")
    est = payload_token_estimates(col)
    _, mask = HashTokenizer(512).encode_batch(TEXTS[3:-2], 1024)
    np.testing.assert_array_equal(est, mask.sum(axis=1))
    assert payload_token_estimates(BinaryColumn.from_pylist([])).shape == (0,)


@pytest.mark.parametrize("bb,sb,scale", [((8, 16), (32,), 4), ((8, 16), (32,), 1),
                                         ((8, 16, 32, 64), (256,), 4), ((4,), (512,), 2)])
def test_packed_grids_equal_jax(bb, sb, scale):
    got, want = tb.BucketPolicy(bb, sb, scale), jb.BucketPolicy(bb, sb, scale)
    assert got.example_buckets() == want.example_buckets()
    assert got.max_examples() == want.max_examples()
    assert [got.example_bucket(n) for n in (1, 9, 17, 10_000)] == \
        [want.example_bucket(n) for n in (1, 9, 17, 10_000)]
    assert got.token_buckets(sb[-1]) == want.token_buckets(sb[-1])
    assert got.token_budget(sb[-1]) == want.token_budget(sb[-1])


def test_example_scale_config():
    base = {"batch_buckets": [8], "seq_buckets": [16]}
    for bad in (0, True, 1.5):
        with pytest.raises(ConfigError):
            tb.BucketPolicy.from_config({**base, "example_scale": bad})
    assert tb.BucketPolicy.from_config(base, default_example_scale=4).example_scale == 4
    assert tb.BucketPolicy.from_config({**base, "example_scale": 2}).example_scale == 2
    with pytest.raises(ConfigError):
        tb.BucketPolicy((8,), (16,)).token_buckets(0)
