"""The port's ``file`` input and its readers against pyarrow and the JAX package.

The CSV and NDJSON readers (``utils/tabular.py``) are held to
``pyarrow.csv.open_csv`` and ``pyarrow.json.read_json`` themselves: each
batch's types spelled as ``str(pa.DataType)``, its ``to_pylist()`` and its
rows, on hand-written cases at several block sizes (the 1 MiB of the JAX
file input among them), on files over 1 MiB, and under ``hypothesis``. The
Avro module is held to JAX's on JAX's own cases; the ``file`` input to
JAX's ``FileInput`` on the same files, read by read to ``EndOfInput``,
with and without ``query``. The known differences (ROADMAP Queue C) have
tests of their own.
"""

from __future__ import annotations

import asyncio
import datetime as dt
import io
import json
import math

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import EndOfInput as JaxEndOfInput
from arkflow_tpu.utils import avro as javro
from arkflow_tpu_torch.batch import column_to_pylist
from arkflow_tpu_torch.components import Resource, build_component, check_component
from arkflow_tpu_torch.components import ensure_plugins_loaded
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, ReadError
from arkflow_tpu_torch.sql import SessionContext
from arkflow_tpu_torch.utils import avro as pavro
from arkflow_tpu_torch.utils import tabular

jax_plugins()
ensure_plugins_loaded()

MIB = 1 << 20


def same(a, b) -> bool:
    """Equal values, NaN equal to NaN, ints and floats kept apart."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, (bool, int, float)) or isinstance(b, (bool, int, float)):
        return type(a) is type(b) and a == b
    return a == b  # a pandas Timestamp equals the datetime it holds


def assert_batches(want: list[pa.RecordBatch], got: list) -> None:
    """pyarrow's record batches and the port's: types, rows, values."""
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    for w, g in zip(want, got):
        assert list(g.schema) == w.schema.names
        assert list(g.schema.values()) == [str(f.type) for f in w.schema]
        assert same(g.to_pylist(), w.to_pylist()), (g.to_pylist(), w.to_pylist())


def pyarrow_csv(data: bytes, block: int) -> list[pa.RecordBatch]:
    return list(pacsv.open_csv(io.BytesIO(data), read_options=pacsv.ReadOptions(
        block_size=block)))


def port_csv(data: bytes, block: int) -> list:
    return list(tabular.read_csv_blocks(io.BytesIO(data), block))


def pyarrow_json(data: bytes, block: int = MIB) -> list[pa.RecordBatch]:
    table = pajson.read_json(io.BytesIO(data), read_options=pajson.ReadOptions(block_size=block))
    return table.to_batches()


def port_json(data: bytes, block: int = MIB) -> list:
    return tabular.read_ndjson_blocks(io.BytesIO(data), block)


def csv_both(data: bytes, block: int) -> None:
    try:
        want = pyarrow_csv(data, block)
    except pa.ArrowInvalid:
        with pytest.raises(ReadError):
            port_csv(data, block)
        return
    assert_batches(want, port_csv(data, block))


def json_both(data: bytes, block: int = MIB) -> None:
    try:
        want = pyarrow_json(data, block)
    except pa.ArrowInvalid as e:
        with pytest.raises(ReadError) as err:
            port_json(data, block)
        assert str(err.value) == str(e)
        return
    assert_batches(want, port_json(data, block))


CSV_CASES = {
    "ints_and_strings": "a,b\n1,x\n2,y\n-3,z\n",
    "int_then_float": "a\n1\n2.5\n",
    "bools": "a,b\ntrue,1\nFalse,true\nTRUE,0\n",
    "nulls_per_type": "i,f,b,s,n\n1,1.5,true,x,\nNA,nan,N/A,NA,NULL\n,,,,#N/A\n",
    "empty_string_cell": "s,t\n,x\ny,\n",
    "dates_times_stamps": ("d,t,ts,tz,ns\n2024-01-01,10:00,2024-01-01 10:00:00,"
                           "2024-01-01T10:00:00Z,2024-01-01 10:00:00.5\n"
                           "2024-02-29,23:59:59,2024-02-29T23:59,2024-02-29T23:59:00+01:00,"
                           "2024-02-29T23:59:00.123456\n"),
    "date_then_stamp": "d\n2024-01-01\n2024-01-01 10:00:00\n",
    "mixed_zone_is_string": "d\n2024-01-01 10:00:00\n2024-01-01T10:00:00Z\n",
    "quoted_commas": 'a,b\n"x, y",1\n"say ""hi""",2\n"3",3\n',
    "numbers_trimmed": "a,b\n 1 ,\t2.5\n7 , 3\n",
    "hex_and_big": "a,b,c\n0x1f,9223372036854775808,-9223372036854775808\n",
    "specials": "f\ninf\n-Infinity\nNAN\n1e5\n.5\n1.\n",
    "crlf_blank_lines": "a,b\r\n1,2\r\n\r\n3,4\r\n",
    "no_trailing_newline": "a,b\n1,2\n3,4",
    "wrong_field_count": "a,b\n1,2\n3\n",
}


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_csv_reader_matches_pyarrow(name):
    data = CSV_CASES[name].encode()
    for block in (16, 24, 64, MIB):
        if block < 24 and name in ("dates_times_stamps", "quoted_commas", "nulls_per_type",
                                   "hex_and_big"):
            continue  # a row longer than the block: both raise "straddling"
        csv_both(data, block)


def test_csv_later_block_that_does_not_convert_raises():
    data = b"a\n" + b"1\n" * 100 + b"x\n"
    with pytest.raises(pa.ArrowInvalid):
        pyarrow_csv(data, 64)
    with pytest.raises(ReadError, match="CSV conversion error to int64: invalid value 'x'"):
        port_csv(data, 64)
    data = b"a,b\n" + b",1\n" * 40 + b"5,1\n"  # the first block types 'a' null
    with pytest.raises(ReadError, match="to null"):
        port_csv(data, 64)


def test_csv_over_a_mebibyte_cuts_as_pyarrow():
    """300000 rows of 9-byte lines: pyarrow's blocks of 116508, 116508 and
    66984 rows, then ``split(batch_rows)`` within each."""
    data = b"x\n" + b"".join(b"%08d\n" % i for i in range(300000))
    want, got = pyarrow_csv(data, MIB), port_csv(data, MIB)
    assert [b.num_rows for b in want] == [b.num_rows for b in got] == [116508, 116508, 66984]
    for w, g in zip(want, got):
        assert g.schema == {"x": "int64"} and str(w.schema.field(0).type) == "int64"
        assert (g.column("x") == w.column(0).to_numpy()).all()
    mixed = ("id,text,score\n" + "".join(f'{i},"w{i}, w{i * 7 % 13}",{i * 0.25}\n'
                                         for i in range(60000))).encode()
    assert len(mixed) > MIB
    assert_batches(pyarrow_csv(mixed, MIB), port_csv(mixed, MIB))


JSON_CASES = {
    "int_meets_float": '{"a":1}\n{"a":2.5}\n',
    "dates_are_stamps": '{"a":"2024-01-01"}\n{"a":"2024-01-02T10:00:00Z"}\n',
    "stamp_meets_text": '{"a":"2024-01-01"}\n{"a":"x"}\n',
    "offset_to_utc": '{"a":"2024-01-01T10:00:00+01:00"}\n',
    "fraction_is_text": '{"a":"2024-01-01T10:00:00.5"}\n',
    "structs_merge": '{"a":{"b":1}}\n{"a":{"c":"x"}}\n{"a":null}\n',
    "lists": '{"a":[1,2]}\n{"a":[]}\n{"a":[1.5]}\n',
    "missing_keys": '{"a":1}\n{"b":2}\n\n{"a":3,"b":null}\n',
    "nested_stamps": '{"a":["2024-01-01"],"b":{"c":"2024-01-01 10:00"}}\n',
    "big_int": '{"a":9223372036854775808}\n{"a":1}\n',
    "empty_struct_and_list": '{"a":{},"b":[]}\n',
    "kind_change": '{"a":1}\n{"a":"x"}\n',
    "bool_to_number": '{"a":true}\n{"a":1}\n',
    "twice": '{"a":1,"a":2}\n',
    "not_an_object": '[1,2]\n',
}


@pytest.mark.parametrize("name", sorted(JSON_CASES))
def test_ndjson_reader_matches_pyarrow(name):
    json_both(JSON_CASES[name].encode())


def test_ndjson_over_a_mebibyte_chunks_as_pyarrow():
    """The table's chunks follow 1 MiB blocks, and types unify across them:
    a late float makes the column double, a late key is null before it, a
    late text makes a column of dates text."""
    data = b"".join(b'{"a":%d,"s":"%08d"}\n' % (i, i) for i in range(45000))
    want, got = pyarrow_json(data), port_json(data)
    assert len(data) > MIB and len(got) == 2
    assert_batches(want, got)
    late = (b'{"t":1,"d":"2024-01-01"}\n' * 45000
            + b'{"t":1.5,"u":"2024-01-01","d":"x"}\n')
    assert_batches(pyarrow_json(late), port_json(late))
    for block in (64, 1000):
        json_both(b"".join(b'{"a":%d,"b":"v%d"}\n' % (i, i) for i in range(500)), block)


_NULLS = ["", "NA", "N/A", "null", "NaN", "nan", "NULL", "#N/A", "-nan"]
_CELLS = {
    "int": st.integers(-2 ** 70, 2 ** 70).map(str),
    "bool": st.sampled_from(["true", "false", "True", "FALSE", "1", "0"]),
    "float": st.one_of(st.floats(allow_nan=False, width=64).map(repr),
                       st.sampled_from(["1.", ".5", "inf", "-Infinity", "+2.5", "1e-3"])),
    "date": st.dates(dt.date(1970, 1, 1), dt.date(2099, 12, 31)).map(str),
    "stamp": st.tuples(st.datetimes(dt.datetime(1970, 1, 1), dt.datetime(2099, 1, 1)),
                       st.sampled_from(["T", " "]), st.sampled_from(["", ".5", ".123456"]),
                       st.sampled_from(["", "", "Z", "+01:00", "-0530"])).map(
        lambda t: t[0].strftime(f"%Y-%m-%d{t[1]}%H:%M:%S") + t[2] + t[3]),
    "null": st.sampled_from(_NULLS),
    "quoted": st.text("ab ,\"", min_size=1, max_size=6).map(
        lambda s: '"' + s.replace('"', '""') + '"'),
}


@st.composite
def csv_files(draw):
    ncol = draw(st.integers(1, 3))
    kinds = [draw(st.lists(st.sampled_from(sorted(_CELLS)), min_size=1, max_size=2))
             for _ in range(ncol)]
    rows = draw(st.integers(1, 10))
    lines = [",".join(f"c{i}" for i in range(ncol))]
    for _ in range(rows):
        lines.append(",".join(draw(_CELLS[draw(st.sampled_from(k))]) for k in kinds))
    return ("\n".join(lines) + "\n").encode()


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(csv_files(), st.sampled_from([64, 128, MIB]))
def test_csv_inference_matches_pyarrow_under_hypothesis(data, block):
    if any(len(line) + 1 > block // 2 for line in data.split(b"\n")):
        block = MIB  # no straddling rows: both readers raise on those
    csv_both(data, block)


_JSON_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-2 ** 64, 2 ** 64),
                          st.floats(allow_nan=False, allow_infinity=False),
                          st.sampled_from(["s", "2024-01-01", "2024-01-01T10:00:00Z",
                                           "2024-01-01 10:00"]))
#: list items are never null: pyarrow misplaces a null before a list's
#: first typed item (``test_pyarrow_json_misplaces_leading_null_list_items``)
_JSON_VALUES = st.recursive(
    _JSON_SCALARS,
    lambda inner: st.one_of(st.lists(inner.filter(lambda v: v is not None), max_size=2),
                            st.dictionaries(st.sampled_from(["x", "y"]), inner, max_size=2)),
    max_leaves=4)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.dictionaries(st.sampled_from(["a", "b", "c"]), _JSON_VALUES, max_size=3),
                min_size=1, max_size=5))
def test_ndjson_inference_matches_pyarrow_under_hypothesis(rows):
    json_both(("\n".join(json.dumps(r) for r in rows) + "\n").encode())


# -- Avro --------------------------------------------------------------------------

EVENT_SCHEMA = {
    "type": "record", "name": "Event", "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": "string"},
        {"name": "temp", "type": ["null", "double"]},
        {"name": "ok", "type": "boolean"},
    ],
}
COMPLEX_SCHEMA = {"type": "record", "name": "C", "fields": [
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "attrs", "type": {"type": "map", "values": "long"}},
    {"name": "color", "type": {"type": "enum", "name": "Color", "symbols": ["RED", "GREEN"]}},
    {"name": "raw", "type": "bytes"},
    {"name": "small", "type": ["null", "int"]},
    {"name": "f32", "type": "float"},
]}


def _events(n):
    return [{"id": i, "name": f"n{i}", "temp": None if i % 3 == 0 else i * 0.5,
             "ok": i % 2 == 0} for i in range(n)]


def _complex(n):
    return [{"tags": [f"t{i}"] * (i % 3), "attrs": {"x": i, "y": -i} if i % 2 else {},
             "color": ["RED", "GREEN"][i % 2], "raw": bytes([i % 256]) * (i % 4),
             "small": None if i % 4 == 0 else i, "f32": i / 3}
            for i in range(n)]


#: ``fixed`` decodes but JAX's writer has no branch for it: read side only
FIXED_SCHEMA = {"type": "record", "name": "X", "fields": [
    {"name": "fix", "type": {"type": "fixed", "name": "F", "size": 2}},
    {"name": "fixes", "type": {"type": "array", "items": {"type": "fixed", "name": "G",
                                                             "size": 1}}},
]}


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("schema,records", [(EVENT_SCHEMA, _events(2500)),
                                            (COMPLEX_SCHEMA, _complex(40))],
                         ids=["events", "complex"])
def test_avro_container_matches_jax(codec, schema, records):
    """Each package reads the other's container, and the bytes of a block
    are equal (the sync marker is random)."""
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    javro.write_container(jbuf, schema, records, codec=codec, block_records=512)
    pavro.write_container(pbuf, schema, records, codec=codec, block_records=512)
    for raw in (jbuf.getvalue(), pbuf.getvalue()):
        js, jit = javro.read_container(io.BytesIO(raw))
        ps, pit = pavro.read_container(io.BytesIO(raw))
        assert js == ps
        jrecs, precs = list(jit), list(pit)
        assert precs == jrecs
        assert len(precs) == len(records)
    body = io.BytesIO()
    for r in records[:5]:
        javro.encode_value(schema, r, body)
    pbody = io.BytesIO()
    for r in records[:5]:
        pavro.encode_value(schema, r, pbody)
    assert pbody.getvalue() == body.getvalue()
    with pytest.raises(Exception, match="magic"):
        pavro.read_container(io.BytesIO(b"not avro data"))


@pytest.mark.parametrize("rows_of", [
    lambda: _events(30),
    lambda: [{"id": i, "name": "x", "temp": None, "ok": True} for i in range(10)],
    lambda: _complex(12),
    lambda: [dict(r, small=None, tags=[]) for r in _complex(4)],
    lambda: [{"fix": bytes([i, 7]), "fixes": [bytes([i])] * i} for i in range(4)],
    lambda: [{"fix": b"abc", "fixes": []}],
], ids=["events", "all_null_temp", "complex", "all_null_and_empty", "fixed", "fixed_mis_sized"])
def test_avro_records_to_batch_matches_jax(rows_of):
    rows = rows_of()
    schema = (COMPLEX_SCHEMA if "tags" in rows[0] else FIXED_SCHEMA if "fix" in rows[0]
              else EVENT_SCHEMA)
    want = javro.records_to_batch(schema, rows)
    got = pavro.records_to_batch(schema, rows)
    assert_batches([want], [got])


# -- the file input ----------------------------------------------------------------


def _reads(inp, end) -> list:
    async def go():
        await inp.connect()
        out = []
        while True:
            try:
                batch, _ack = await inp.read()
            except end:
                return out
            out.append(batch)

    return asyncio.run(go())


def both_inputs(cfg: dict) -> None:
    """Every read of both inputs, to the end; where JAX's query fails on a
    file (a column it lacks), the port's fails too."""
    try:
        jb = _reads(jax_build("input", cfg, JaxResource()), JaxEndOfInput)
    except Exception as e:
        with pytest.raises(Exception, match="no such column|not found|unknown column") as err:
            _reads(build_component("input", cfg, Resource()), EndOfInput)
        assert "no such column" in str(e), (e, err.value)
        return
    pb = _reads(build_component("input", cfg, Resource()), EndOfInput)
    assert [b.num_rows for b in pb] == [b.num_rows for b in jb]
    for j, p in zip(jb, pb):
        rb = j.record_batch
        names = [n for n in rb.schema.names if n != "__meta_ingest_time"]
        assert [n for n in p.column_names if n != "__meta_ingest_time"] == names
        for n in names:
            assert p.schema[n] == str(rb.schema.field(n).type), n
            assert same(column_to_pylist(p.column(n)), rb.column(n).to_pylist()), n


@pytest.fixture
def files(tmp_path):
    csv = tmp_path / "d.csv"
    csv.write_text("a,b,when\n" + "".join(f"{i},w{i},2024-01-{1 + i % 28:02d}\n"
                                         for i in range(50)))
    ndjson = tmp_path / "d.ndjson"
    ndjson.write_text("".join(json.dumps({"a": i, "b": f"v{i}", "x": {"y": i * 0.5}}) + "\n"
                              for i in range(40)))
    avro = tmp_path / "e.avro"
    with open(avro, "wb") as f:
        pavro.write_container(f, EVENT_SCHEMA, _events(300), codec="deflate")
    nulls = tmp_path / "n.avro"
    with open(nulls, "wb") as f:
        pavro.write_container(f, EVENT_SCHEMA,
                              [{"id": i, "name": "x", "temp": None, "ok": True} for i in range(10)]
                              + [{"id": i, "name": "y", "temp": 1.5, "ok": False}
                                 for i in range(10)])
    small_csv = tmp_path / "s.csv"
    small_csv.write_text("a,b\n1,x\n2,y\n")
    small_json = tmp_path / "s.jsonl"
    small_json.write_text('{"a": 5}\n{"a": 6}\n')
    return {"csv": csv, "ndjson": ndjson, "avro": avro, "nulls": nulls,
            "pair": [small_csv, small_json]}


@pytest.mark.parametrize("batch_rows", [3, 8192])
@pytest.mark.parametrize("query", [None, "SELECT a, b FROM flow WHERE a % 4 <> 3",
                                   "SELECT a FROM flow WHERE a > 1000"])
@pytest.mark.parametrize("which", ["csv", "ndjson", "pair"])
def test_file_input_matches_jax(files, which, query, batch_rows):
    paths = files[which]
    cfg = {"type": "file", "path": [str(p) for p in paths] if isinstance(paths, list)
           else str(paths), "batch_rows": batch_rows}
    if query:
        cfg["query"] = query
    both_inputs(cfg)


@pytest.mark.parametrize("cfg", [
    {"batch_rows": 128, "query": "SELECT id, name FROM flow WHERE ok"},
    {"batch_rows": 128},
    {"batch_rows": 10, "which": "nulls"},
], ids=["query", "plain", "all_null_chunk"])
def test_file_input_avro_matches_jax(files, cfg):
    cfg = dict(cfg)
    path = files[cfg.pop("which", "avro")]
    both_inputs({"type": "file", "path": str(path), **cfg})


def test_file_input_over_a_mebibyte_matches_jax(tmp_path):
    """A CSV over 1 MiB and an NDJSON file over 1 MiB through both inputs:
    the same block cuts, hence the same batches."""
    csv = tmp_path / "big.csv"
    csv.write_text("id,text\n" + "".join(f'{i},"msg{i} w{i % 97}, w{i % 13}"\n'
                                         for i in range(50000)))
    ndjson = tmp_path / "big.ndjson"
    ndjson.write_text("".join(json.dumps({"id": i, "text": f"msg{i} w{i % 97}"}) + "\n"
                              for i in range(45000)))
    assert csv.stat().st_size > MIB and ndjson.stat().st_size > MIB
    both_inputs({"type": "file", "path": [str(csv), str(ndjson)], "batch_rows": 8192,
                 "query": "SELECT id, text FROM flow WHERE id % 4 <> 3"})


def test_batch_processor_drops_a_finite_files_tail_as_jax(tmp_path):
    """``avro_file_example.json``'s reads into its ``batch`` processor
    (10000 rows), in both packages: 25000 records give reads of 4096,
    4096, 4096 and 212 kept rows; the first three leave as one emission,
    and the 212 still held at close are dropped (ROADMAP Queue C, open in
    the reference)."""
    path = tmp_path / "tail.avro"
    with open(path, "wb") as f:
        pavro.write_container(f, EVENT_SCHEMA, _events(25000), codec="deflate")
    cfg = {"type": "file", "path": str(path), "batch_rows": 8192,
           "query": "SELECT id, name FROM flow WHERE ok"}

    def emitted(build, resource, end) -> tuple[list, list]:
        reads = _reads(build("input", cfg, resource()), end)
        proc = build("processor", {"type": "batch", "count": 10000}, resource())

        async def go():
            out = []
            for b in reads:
                out += await proc.process(b)
            await proc.close()
            return out

        out = asyncio.run(go())
        return ([b.num_rows for b in reads],
                [i for b in out for i in b.to_pydict()["id"]])

    jax_reads, jax_ids = emitted(jax_build, JaxResource, JaxEndOfInput)
    reads, ids = emitted(build_component, Resource, EndOfInput)
    assert reads == jax_reads == [4096, 4096, 4096, 212]
    assert ids == [int(i) for i in jax_ids] == list(range(0, 3 * 8192, 2))


@pytest.mark.parametrize("cfg,what", [
    ({"path": "/d/x.parquet"}, "format 'parquet'"),
    ({"path": "/d/x.feather"}, "format 'arrow'"),
    ({"path": "/d/x.ipc"}, "format 'arrow'"),
    ({"path": "/d/x.arrow"}, "format 'arrow'"),
    ({"path": "/d/x.csv", "format": "parquet"}, "format 'parquet'"),
    ({"path": "/d/x.csv", "format": "ipc"}, "format 'ipc'"),
    ({"path": "s3://bucket/x.csv"}, "object-store path"),
    ({"path": ["/d/a.csv", "gs://b/k.json"]}, "object-store path"),
    ({"path": "/d/x.csv", "fs": {"anonymous": True}}, "key 'fs'"),
    ({"path": "/d/x.csv", "remote_url": "arkflow://h:1"}, "key 'remote_url'"),
    ({"path": "/d/x.csv", "max_frame": 1024}, "key 'max_frame'"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_unported_formats_and_keys_refused(cfg, what):
    full = {"type": "file", **cfg}
    for call in (lambda: check_component("input", full),
                 lambda: build_component("input", full, Resource())):
        with pytest.raises(ConfigError, match="not yet ported") as err:
            call()
        assert what in str(err.value)


def test_file_input_refusals_as_jax(tmp_path):
    with pytest.raises(ConfigError, match="requires 'path'"):
        build_component("input", {"type": "file"}, Resource())
    odd = tmp_path / "x.data"
    odd.write_text("a\n1\n")
    inp = build_component("input", {"type": "file", "path": str(odd)}, Resource())
    with pytest.raises(ConfigError, match="cannot infer format"):
        asyncio.run(inp.connect())
    missing = build_component("input", {"type": "file", "path": str(tmp_path / "no.csv")},
                              Resource())
    with pytest.raises(ConfigError, match="does not exist"):
        asyncio.run(missing.connect())
    yml = build_component("input", {"type": "file", "path": str(tmp_path / "c.yaml")}, Resource())
    with pytest.raises(ConfigError, match="unsupported file format 'yaml'"):
        asyncio.run(yml.connect())


# -- known differences (ROADMAP Queue C) --------------------------------------------


def test_temporal_columns_in_sql():
    """Date, time and timestamp columns project, filter, compare with their
    own type and sort as in JAX; a comparison with a string is refused by
    both; min and max over them are not carried by the port's SQL engine."""
    data = (b"d,t,x,d2\n2024-01-01,2024-01-01 10:00:00,1,2024-01-05\n"
            b"2024-02-01,,2,2024-01-05\n")
    batch = port_csv(data, MIB)[0]

    def run(q):
        ctx = SessionContext()
        ctx.register_batch("flow", batch)
        return ctx.sql(q).to_pydict()

    assert run("SELECT d, t, x FROM flow WHERE t IS NOT NULL") == {
        "d": [dt.date(2024, 1, 1)], "t": [dt.datetime(2024, 1, 1, 10)], "x": [1]}
    assert run("SELECT x FROM flow WHERE d > d2 ORDER BY d DESC") == {"x": [2]}
    with pytest.raises(Exception, match="no kernel matching input types"):
        run("SELECT x FROM flow WHERE d > '2024-01-15'")
    with pytest.raises(Exception, match="date32"):
        run("SELECT max(d) AS m FROM flow")


def test_timestamp_ns_keeps_microseconds():
    """pyarrow keeps nanoseconds; Python's datetime holds microseconds."""
    data = b"t\n2024-01-01 10:00:00.123456789\n"
    want = pyarrow_csv(data, MIB)[0]
    got = port_csv(data, MIB)[0]
    assert got.schema["t"] == str(want.schema.field("t").type) == "timestamp[ns]"
    assert column_to_pylist(got.column("t")) == [dt.datetime(2024, 1, 1, 10, 0, 0, 123456)]


def test_pyarrow_json_misplaces_leading_null_list_items():
    """pyarrow's JSON reader drops or moves a null that comes before a
    list's first typed item; the port keeps every item where it was."""
    data = b'{"a": [null, 2]}\n{"a": [null, 1]}\n'
    assert pyarrow_json(data)[0].to_pylist() == [{"a": [2, None]}, {"a": [1]}]
    assert port_json(data)[0].to_pylist() == [{"a": [None, 2]}, {"a": [None, 1]}]


# -- the slice as a whole -------------------------------------------------------------

SCORE_TOL = 1.0 / 64
TIE_FREE_SCORE = 1.0 / (1.0 + math.exp(-0.05))


def test_file_bert_pulsar_matches_the_jax_stream(tmp_path):
    """``file_bert_pulsar.json`` at ``TINY_BERT`` on the CPU against the same
    stream built from the JAX package's components on JAX's fake broker,
    the weights carried over by ``convert.params_from_jax``: the same kept
    ids in the same order on each producer's topic, each once, labels equal
    on tie-free rows and scores within the bf16 floor. K2's plain version
    runs here (the tensors are on the CPU); K2 itself runs in the smoke."""
    import csv as csvmod

    import jax
    import numpy as np

    from arkflow_tpu.config import StreamConfig as JaxStreamConfig
    from arkflow_tpu.runtime import build_stream as jax_build_stream
    from arkflow_tpu_torch.config import StreamConfig
    from arkflow_tpu_torch.convert import params_from_jax
    from arkflow_tpu_torch.runtime.stream import build_stream
    from arkflow_tpu_torch.tpu.runner import ModelRunner
    from tests.test_pulsar import FakePulsarBroker
    from tests.test_tpu_layer import TINY_BERT

    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(60)]
    rows = [{"id": i, "text": f"msg{i} " + " ".join(rng.choice(vocab, size=int(n)))}
            for i, n in enumerate(rng.integers(1, 24, 48))]
    csv_path, json_path = tmp_path / "texts.csv", tmp_path / "texts.ndjson"
    with open(csv_path, "w", newline="") as f:
        w = csvmod.writer(f)
        w.writerow(["id", "text"])
        w.writerows([r["id"], r["text"]] for r in rows[:28])
    json_path.write_text("".join(json.dumps(r) + "\n" for r in rows[28:]))
    with open("arkflow_tpu_torch/examples/file_bert_pulsar.json") as f:
        port_raw = json.load(f)["streams"][0]
    kept = [r["id"] for r in rows if r["id"] % 4 != 3]

    async def go():
        broker = FakePulsarBroker()
        await broker.start()
        out = {}
        try:
            for kind in ("jax", "port"):
                raw = json.loads(json.dumps(port_raw))
                raw["input"].update(path=[str(csv_path), str(json_path)], batch_rows=8)
                raw["buffer"].update(capacity=8)
                raw["buffer"]["coalesce"].update(batch_buckets=[8], token_budget=256,
                                                 max_row_tokens=32)
                raw["output"].update(service_url=f"pulsar://127.0.0.1:{broker.port}",
                                     topic=f"scores-{kind}")
                raw["pipeline"]["processors"][0].update(
                    model_config=TINY_BERT, max_seq=32, batch_buckets=[4, 8],
                    seq_buckets=[32], warmup=False)
                if kind == "jax":
                    raw["pipeline"]["processors"][0]["type"] = "tpu_inference"
                    stream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
                    host = jax.device_get(stream.pipeline.processors[0].runner.host_params)
                else:
                    raw["pipeline"]["processors"][0]["device"] = "cpu"
                    stream = build_stream(StreamConfig.from_mapping(raw))
                    proc = stream.pipeline.processors[0]
                    proc.runner = ModelRunner("bert_classifier", TINY_BERT,
                                              buckets=proc.runner.buckets, device="cpu",
                                              host_params=params_from_jax(host),
                                              packed=True)
                await asyncio.wait_for(stream.run(asyncio.Event()), 60)
                assert stream.errors == 0 if kind == "port" else True
                out[kind] = [json.loads(p) for p, _ in
                             broker.topics.get(f"persistent://public/default/scores-{kind}", [])]
        finally:
            broker._server.close()
        return out

    out = asyncio.run(go())
    assert [r["id"] for r in out["port"]] == [r["id"] for r in out["jax"]]
    assert sorted(r["id"] for r in out["port"]) == kept
    for p, j in zip(out["port"], out["jax"]):
        assert list(p) == list(j) == ["id", "label", "score"]
        assert abs(p["score"] - j["score"]) <= SCORE_TOL
        if j["score"] > TIE_FREE_SCORE:
            assert p["label"] == j["label"]
