"""Port parity for the host-side modules of the slice: the hashing tokenizer,
the bucket grid and padding, and the message batch's payload layout, each
against its ``arkflow_tpu`` counterpart on the same inputs."""

import numpy as np
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.tpu import bucketing as jb
from arkflow_tpu.tpu.tokenizer import HashTokenizer as JaxTokenizer
from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.errors import ArkError
from arkflow_tpu_torch.tpu import bucketing as tb
from arkflow_tpu_torch.tpu.runner import _pad_into
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

TEXTS = [b"", b"hello world", b"Hello, WORLD!! 42 times", "café naïve — ok".encode(),
         b"tabs\tand\nnewlines  ", b" ".join(b"w%d" % i for i in range(100)), b"a-b_c.d/e"]


@pytest.mark.parametrize("max_len", [4, 16, 64])
def test_hash_tokenizer_ids_equal_the_jax_tokenizer(max_len):
    want_ids, want_mask = JaxTokenizer(30522).encode_batch(TEXTS, max_len)
    got_ids, got_mask = HashTokenizer(30522).encode_batch(TEXTS, max_len)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)


def test_tokenizer_reads_a_sliced_payload_view():
    batch = MessageBatch.new_binary(TEXTS).slice(2, 4)
    values, offsets = batch.payload_view()
    got = HashTokenizer(512).encode_batch_view(values, offsets, 32)
    want = JaxTokenizer(512).encode_batch(TEXTS[2:6], 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lo,hi", [(8, 128), (8, 100), (4, 4), (32, 512)])
def test_pow2_buckets(lo, hi):
    assert tb.pow2_buckets(lo, hi) == jb.pow2_buckets(lo, hi)


def test_bucket_policy_picks_and_pads_like_the_jax_policy():
    cfg = {"batch_buckets": [64, 16], "seq_buckets": [256, 64, 128]}
    mine = tb.BucketPolicy.from_config(cfg, max_seq=256)
    ref = jb.BucketPolicy.from_config(cfg, max_seq=256)
    assert (mine.batch_buckets, mine.seq_buckets) == (ref.batch_buckets, ref.seq_buckets)
    for n in (1, 16, 17, 64, 65, 300):
        assert mine.batch_bucket(n) == ref.batch_bucket(n)
        assert mine.seq_bucket(n) == ref.seq_bucket(n)
    assert mine.max_batch() == ref.max_batch() == 64
    defaults = tb.BucketPolicy.from_config({}, max_batch=32, max_seq=128)
    ref_defaults = jb.BucketPolicy.from_config({}, max_batch=32, max_seq=128)
    assert defaults.batch_buckets == ref_defaults.batch_buckets
    assert defaults.seq_buckets == ref_defaults.seq_buckets
    # the runner pads into its staging buffers in place, as the JAX policy's
    # pad_seq_dim then pad_batch_dim do
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    for rows, target in ((5, 2), (5, 4), (3, 7)):
        dst = np.full((rows, target), -1, np.int32)
        _pad_into(dst, arr)
        np.testing.assert_array_equal(dst, jb.pad_batch_dim(jb.pad_seq_dim(arr, target), rows))
    with pytest.raises(ValueError):
        _pad_into(np.zeros((2, 4), np.int32), arr)


def test_payload_layout_matches_the_arrow_batch():
    mine = MessageBatch.new_binary(TEXTS).slice(1, 5)
    ref = JaxBatch.new_binary(TEXTS).slice(1, 5)
    assert mine.to_binary() == ref.to_binary() == TEXTS[1:6]
    (mv, mo), (rv, ro) = mine.payload_view(), ref.payload_view()
    assert [mv[mo[i]:mo[i + 1]].tobytes() for i in range(5)] == \
           [rv[ro[i]:ro[i + 1]].tobytes() for i in range(5)]
    assert mo.dtype == np.int64 and mine.num_rows == ref.num_rows == 5


def test_batch_columns_concat_and_checks():
    a = MessageBatch.new_binary(TEXTS[:3]).with_column("label", np.array([0, 1, 0]))
    b = MessageBatch.new_binary(TEXTS[3:5]).with_column("label", np.array([1, 1]))
    both = MessageBatch.concat([a, MessageBatch.new_binary([]).with_column(
        "label", np.array([], np.int64)), b]).with_source("generate")
    assert both.to_binary() == TEXTS[:5]
    assert both.column("label").tolist() == [0, 1, 0, 1, 1]
    assert both.column("__meta_source").tolist() == ["generate"] * 5
    assert both.slice(3).to_binary() == TEXTS[3:5]
    with pytest.raises(ArkError, match="length"):
        a.with_column("label", np.array([1]))
    with pytest.raises(ArkError, match="no such column"):
        a.column("missing")
    with pytest.raises(ArkError, match="not a binary column"):
        a.payload_view("label")
