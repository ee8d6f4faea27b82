"""The port's json codec and column model against the JAX package's.

The same payloads go through ``arkflow_tpu``'s ``JsonCodec`` (pyarrow) and
``arkflow_tpu_torch``'s (numpy, no Arrow): the decoded columns' types (as
pyarrow spells them), ``to_pylist()`` values and Python value types must be
equal, ``encode`` must write the same bytes, and a payload one refuses the
other refuses with the same ``CodecError`` prefix. Both of the JAX codec's
inference routes are covered: pyarrow.json's NDJSON reader (several
payloads, none an array) and the row route (arrays, single payloads, and
the reader's failures and timestamp fallbacks).
"""

from __future__ import annotations

import json
import random

import numpy as np
import pyarrow as pa
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.errors import CodecError as JaxCodecError
from arkflow_tpu.plugins.codec.helper import encode_batch as jax_encode_batch
from arkflow_tpu.plugins.codec.json_codec import JsonCodec as JaxJsonCodec
from arkflow_tpu_torch.batch import (
    ColumnTypeError,
    MessageBatch,
    column_from_pylist,
    column_to_pylist,
    column_type,
    type_name,
)
from arkflow_tpu_torch.errors import ArkError, CodecError
from arkflow_tpu_torch.plugins.codec.helper import encode_batch
from arkflow_tpu_torch.plugins.codec.json_codec import JsonCodec

PREFIXES = ("cannot infer Arrow schema from JSON:", "invalid JSON:", "invalid JSON line:",
            "JSON array payload must contain objects", "JSON line must be an object, got ")

CASES = {
    # the issue's table: pyarrow.json's reader route
    "int_then_float": [b'{"a":1}', b'{"a":2.5}'],
    "int_beyond_int64": [b'{"a":18446744073709551615}', b'{"a":1}'],
    "nested_lists": [b'{"w":[[1,2],[3]]}', b'{"w":[[4.5]]}'],
    "struct_union": [b'{"m":{"x":1}}', b'{"m":{"y":2}}'],
    "all_null": [b'{"a":null}', b'{"a":null}'],
    "int_then_string": [b'{"a":1}', b'{"a":"x"}'],
    # more of the reader route
    "keys_first_seen": [b'{"a":1}', b'{"b":2,"a":3}', b'{"c":"z"}'],
    "bools": [b'{"b":true}', b'{"b":false,"c":null}'],
    "struct_in_list": [b'{"a":[{"x":1}]}', b'{"a":[{"y":"s"}]}', b'{"a":null}'],
    "empty_lists": [b'{"a":[]}', b'{"a":[]}'],
    "list_null_then_ints": [b'{"a":[null]}', b'{"a":[1]}'],
    "above_2_53_read": [b'{"a":9007199254740993}', b'{"a":1.5}'],
    "int64_max": [b'{"a":9223372036854775807}', b'{"a":1}'],
    "ndjson_in_payloads": [b'{"a":1}\n{"a":2}', b'{"a":3}'],
    "empty_objects": [b'{}', b'{}'],
    "unicode": ['{"s":"héllo ☃"}'.encode(), b'{"s":"\\u00e9\\ud83d\\ude00"}'],
    "whitespace_payloads": [b'{"a":1}', b'   ', b'', b'\n{"a":2}\n'],
    "nan_literal": [b'{"a":NaN}', b'{"a":1}'],
    "null_then_values": [b'{"a":null,"s":null}', b'{"a":1,"s":"x"}'],
    # the reader's timestamp inference sends these to the row route
    "iso_top_level": [b'{"t":"2024-01-01T10:00:00Z","n":1}', b'{"t":"2024-01-02","n":2}'],
    "iso_nested": [b'{"m":{"t":"2024-01-01"}}', b'{"m":{"t":"2024-01-02 10:00"}}'],
    "iso_in_list": [b'{"l":["2024-01-01","2024-02-29"]}', b'{"l":[]}'],
    "iso_mixed_with_text": [b'{"t":"2024-01-01"}', b'{"t":"soon"}'],
    "iso_fraction_stays_text": [b'{"t":"2024-01-01T10:00:00.123"}', b'{"t":"2024-13-01"}'],
    # reader failures the row route decides
    "float_then_bool": [b'{"a":1.5}', b'{"a":true}'],
    "bool_then_float": [b'{"a":true}', b'{"a":1.5}'],
    "int_then_bool": [b'{"a":1}', b'{"a":true}'],
    "list_then_scalar": [b'{"a":[1]}', b'{"a":2}'],
    "struct_field_conflict": [b'{"m":{"x":true}}', b'{"m":{"x":1.5}}'],
    "ndjson_mixed_with_array": [b'{"a":1}\n{"a":2}', b'[{"a":3},{"a":4.5}]'],
    "array_first": [b'[{"a":1}]', b'{"a":2}', b'{"b":[1,2]}'],
    "invalid_line_among_many": [b'{"a":1}', b'{"a":'],
    "scalar_line_among_many": [b'{"a":1}', b'3'],
    # single payloads: the row route
    "single_object": [b'{"a":1,"b":"x","c":[1.5],"d":{"e":null}}'],
    "single_array": [b'[{"a":1},{"a":2.5,"b":[1,2]}]'],
    "single_ndjson": [b'{"a":1}\n\n{"b":2}'],
    "single_empty": [b''],
    "single_whitespace": [b'  \n '],
    "single_empty_array": [b'[]'],
    "single_array_of_empty": [b'[{}, {}]'],
    "single_iso": [b'{"t":"2024-01-01T10:00:00"}'],
    "all_empty": [b'', b' '],
    # invalid forms
    "invalid_json_line": [b'{"a":'],
    "invalid_json_array": [b'[{"a":1}'],
    "array_of_scalars": [b'[1,2]'],
    "line_is_a_number": [b'3'],
    "line_is_a_string": [b'"x"'],
    "line_is_a_list_in_ndjson": [b'{"a":1}\n[1]'],
}


def _typed(v):
    """A value with the Python type of every part, NaN-safe."""
    if isinstance(v, list):
        return ["list", [_typed(x) for x in v]]
    if isinstance(v, tuple):
        return ["tuple", [_typed(x) for x in v]]
    if isinstance(v, dict):
        return ["dict", [(k, _typed(x)) for k, x in v.items()]]
    return [type(v).__name__, repr(v)]


def _decode(codec, payloads):
    return codec.decode_many(payloads) if len(payloads) > 1 else codec.decode(payloads[0])


def _run(codec, payloads):
    try:
        return _decode(codec, payloads), None
    except Exception as e:  # noqa: BLE001 - the test compares what each raises
        return None, e


def _prefix(msg: str) -> str:
    for p in PREFIXES:
        if msg.startswith(p):
            return p
    raise AssertionError(f"no known prefix: {msg!r}")


def assert_same_batch(jb: JaxBatch, pb: MessageBatch) -> None:
    assert pb.num_rows == jb.num_rows
    assert pb.column_names == jb.column_names
    assert pb.schema == {f.name: str(f.type) for f in jb.schema}
    want, got = jb.to_pydict(), pb.to_pydict()
    for name in jb.column_names:
        assert _typed(got[name]) == _typed(want[name]), name


@pytest.mark.parametrize("payloads", list(CASES.values()), ids=list(CASES))
def test_decode_matches_jax(payloads):
    jb, jerr = _run(JaxJsonCodec(), payloads)
    pb, perr = _run(JsonCodec(), payloads)
    if jerr is not None:
        assert isinstance(jerr, JaxCodecError), jerr
        assert isinstance(perr, CodecError), (jerr, pb)
        assert _prefix(str(perr)) == _prefix(str(jerr))
        if _prefix(str(jerr)) in PREFIXES[3:]:
            assert str(perr) == str(jerr)
        return
    assert perr is None, perr
    assert_same_batch(jb, pb)
    assert JsonCodec().encode(pb) == JaxJsonCodec().encode(jb)


@pytest.mark.parametrize("payloads", [[b'{"a":18446744073709551615}'],
                                      [b'[{"a":1.5},{"a":18446744073709551615}]'],
                                      [b'{"s":"\\ud800"}']],
                         ids=["int_beyond_int64", "beyond_int64_in_double", "lone_surrogate"])
def test_row_route_overflow_is_a_codec_error(payloads):
    """Where pyarrow raises a bare OverflowError or UnicodeEncodeError (the
    JAX codec lets it out) or ArrowInvalid, the port raises its
    ``CodecError`` with the inference prefix."""
    _, jerr = _run(JaxJsonCodec(), payloads)
    assert jerr is not None
    with pytest.raises(CodecError, match="^cannot infer Arrow schema from JSON:"):
        _decode(JsonCodec(), payloads)


def _random_value(rng: random.Random, depth: int = 0):
    r = rng.random()
    if depth < 2 and r < 0.15:
        return [_random_value(rng, depth + 1) for _ in range(rng.randint(0, 3))]
    if depth < 2 and r < 0.25:
        return {rng.choice("xyz"): _random_value(rng, depth + 1) for _ in range(rng.randint(0, 2))}
    return rng.choice([None, True, False, 0, 7, -3, 2 ** 53 + 1, 2 ** 63, 1.5, -0.25, "s", "",
                       "2024-01-01", "é"])


@pytest.mark.parametrize("seed", range(6))
def test_random_payloads_match_jax(seed):
    """Seeded random rows, a column at a time of one key (so many decode
    and many fail), on both routes."""
    rng = random.Random(seed)
    for _ in range(60):
        rows = [{"k": _random_value(rng)} if rng.random() < 0.9 else {}
                for _ in range(rng.randint(1, 4))]
        for payloads in ([json.dumps(r).encode() for r in rows], [json.dumps(rows).encode()]):
            jb, jerr = _run(JaxJsonCodec(), payloads)
            pb, perr = _run(JsonCodec(), payloads)
            if jerr is not None:
                assert isinstance(perr, CodecError), (payloads, jerr, pb)
                continue
            assert perr is None, (payloads, perr)
            assert_same_batch(jb, pb)
            assert JsonCodec().encode(pb) == JaxJsonCodec().encode(jb)


@pytest.mark.parametrize("seed", range(4))
def test_column_inference_matches_pyarrow(seed):
    """``column_from_pylist`` against ``pyarrow.array`` on seeded value
    lists: the same type and values, or both refuse."""
    rng = random.Random(100 + seed)
    for _ in range(300):
        values = [_random_value(rng) for _ in range(rng.randint(0, 4))]
        try:
            arr = pa.array(values)
        except Exception:  # noqa: BLE001 - pyarrow's refusals vary in class
            with pytest.raises(ColumnTypeError):
                column_from_pylist(values)
            continue
        col = column_from_pylist(values)
        assert type_name(column_type(col)) == str(arr.type)
        assert _typed(column_to_pylist(col)) == _typed(arr.to_pylist())


def _serving_batches(with_value: bool):
    """A batch shaped as ``gpu_inference`` leaves it (int label, float32
    score, a [B, 4] float32 embedding, the ``__value__`` payloads) in both
    packages."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 5)
    scores = rng.random(5).astype(np.float32)
    emb = rng.standard_normal((5, 4)).astype(np.float32)
    payloads = [b"plain text", "héllo".encode(), b"\xff\xfe raw", b"", b'{"a":1}']
    jb = JaxBatch.new_binary(payloads) if with_value else JaxBatch.from_pydict({"id": list(range(5))})
    pb = MessageBatch.new_binary(payloads) if with_value else MessageBatch.from_pydict(
        {"id": list(range(5))})
    jb = (jb.with_column("label", pa.array(labels)).with_column("score", pa.array(scores))
          .with_column("embedding", pa.FixedSizeListArray.from_arrays(pa.array(emb.reshape(-1)), 4)))
    pb = pb.with_column("label", labels).with_column("score", scores).with_column("embedding", emb)
    return jb, pb


@pytest.mark.parametrize("with_value", [True, False], ids=["with_value", "without_value"])
def test_encode_serving_outputs_matches_jax(with_value):
    jb, pb = _serving_batches(with_value)
    assert pb.schema == {f.name: str(f.type) for f in jb.schema}
    assert JsonCodec().encode(pb) == JaxJsonCodec().encode(jb)
    # the codec-less default: raw __value__, or one JSON document a row
    assert encode_batch(pb, None) == jax_encode_batch(jb, None)
    sub = ["label", "score"]
    assert (JsonCodec().encode(pb.filter_columns(sub))
            == JaxJsonCodec().encode(jb.filter_columns(sub)))


def test_encode_binary_without_value_matches_jax():
    """A binary column under the codec-less default: ``default=str``."""
    jb = JaxBatch.from_pydict({"k": [b"ab", b"\xff"], "n": [1, 2]})
    pb = MessageBatch.from_pydict({"k": [b"ab", b"\xff"], "n": [1, 2]})
    assert encode_batch(pb, None) == jax_encode_batch(jb, None)


CONCATS = {
    "same": ({"a": [1], "s": ["x"]}, {"a": [2], "s": [None]}),
    "int_vs_double": ({"a": [1]}, {"a": [2.5]}),
    "string_vs_binary": ({"a": ["x"]}, {"a": [b"x"]}),
    "other_names": ({"a": [1]}, {"b": [1]}),
    "other_order": ({"a": [1], "b": [2]}, {"b": [2], "a": [1]}),
    "struct_fields_differ": ({"m": [{"x": 1}]}, {"m": [{"y": 1}]}),
    "nullable_int_with_int": ({"a": [1, None]}, {"a": [3]}),
    "null_vs_int": ({"a": [None]}, {"a": [1]}),
    "list_widths": ({"l": [[1.5]]}, {"l": [[2.5, 3.0]]}),
}


@pytest.mark.parametrize("left,right", list(CONCATS.values()), ids=list(CONCATS))
def test_concat_refuses_where_arrow_does(left, right):
    """``MessageBatch.concat`` takes batches of one schema and refuses
    others, as ``pa.Table.from_batches`` does."""
    try:
        want = JaxBatch.concat([JaxBatch.from_pydict(left), JaxBatch.from_pydict(right)])
    except pa.ArrowInvalid:
        with pytest.raises(ArkError, match="schema at index 1 was different"):
            MessageBatch.concat([MessageBatch.from_pydict(left), MessageBatch.from_pydict(right)])
        return
    got = MessageBatch.concat([MessageBatch.from_pydict(left), MessageBatch.from_pydict(right)])
    assert got.schema == {f.name: str(f.type) for f in want.schema}
    assert _typed(got.to_pydict()) == _typed(want.to_pydict())


def test_batch_helpers_match_jax():
    data = {"a": [1, 2, 3, 4, 5], "s": ["p", None, "r", "s", "t"], "l": [[1], [], None, [2, 3], [4]]}
    jb, pb = JaxBatch.from_pydict(data), MessageBatch.from_pydict(data)
    jb, pb = jb.with_source("kafka:t"), pb.with_source("kafka:t")
    assert pb.metadata_columns() == jb.metadata_columns()
    assert pb.data_columns() == jb.data_columns()
    assert pb.strip_metadata().column_names == jb.strip_metadata().column_names
    assert pb.filter_columns(["l", "a"]).column_names == jb.filter_columns(["l", "a"]).column_names
    assert pb.drop_columns(["s"]).column_names == jb.drop_columns(["s"]).column_names
    assert [p.to_pydict() for p in pb.split(2)] == [j.to_pydict() for j in jb.split(2)]
    assert pb.slice(1, 3).to_pydict() == jb.slice(1, 3).to_pydict()
    assert pb.to_pylist() == jb.record_batch.to_pylist()
    assert pb.get_meta("__meta_source") == jb.get_meta("__meta_source")
    # a string column's payload view: its UTF-8 bytes, a null row empty
    assert pb.to_binary("s") == jb.to_binary("s")
