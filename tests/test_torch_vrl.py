"""The port's VRL (``arkflow_tpu_torch/sql/vrl.py`` and the ``vrl``
processor) against the JAX package's on the same batches.

Every program of ``tests/test_vrl.py`` runs through both packages' ``vrl``
processors on the same input, and the output batches must agree: column
names and order, Arrow types (``type_name`` against ``str(pa.DataType)``),
values and row order. Then ``tests/test_vrl_fuzz.py``'s generator drives
both compilers with FUZZ_SEEDS x FUZZ_TRIALS random programs (80; JAX's
own test runs 200 against its row oracle), each output held to JAX's and
to the oracle, and the build-time refusals give JAX's messages.
"""

from __future__ import annotations

import asyncio
import math

import numpy as np
import pyarrow as pa
import pytest

from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.sql.vrl import apply_vrl as jax_apply
from arkflow_tpu.sql.vrl import compile_vrl as jax_compile
from arkflow_tpu_torch.batch import MessageBatch, column_to_pylist
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.sql.vrl import VrlCompileError, apply_vrl, compile_vrl
from tests.test_vrl_fuzz import COLS, _Gen, _oracle_run

jax_plugins()
ensure_plugins_loaded()

#: the bounded fuzz: seeds x programs a seed
FUZZ_SEEDS = 4
FUZZ_TRIALS = 20


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def assert_same(jout: JaxBatch, pout: MessageBatch) -> None:
    rb = jout.record_batch
    assert pout.column_names == rb.schema.names
    assert list(pout.schema.values()) == [str(f.type) for f in rb.schema]
    for name, col in zip(rb.schema.names, rb.columns):
        want, got = col.to_pylist(), column_to_pylist(pout.column(name))
        assert len(want) == len(got) and all(map(_same_value, want, got)), (name, want, got)


def run_both(statement: str, data: dict) -> tuple:
    """The statement through each package's ``vrl`` processor on ``data``
    (a pydict, or a (jax batch, port batch) pair)."""
    jb, pb = data if isinstance(data, tuple) else (JaxBatch.from_pydict(data),
                                                  MessageBatch.from_pydict(data))
    cfg = {"type": "vrl", "statement": statement}
    jproc, pproc = jax_build("processor", cfg, JaxResource()), build_component(
        "processor", cfg, Resource())
    jout, pout = asyncio.run(jproc.process(jb)), asyncio.run(pproc.process(pb))
    assert len(jout) == len(pout)
    for j, p in zip(jout, pout):
        assert_same(j, p)
    return jout, pout


# -- tests/test_vrl.py, each program through both packages ------------------------

PROGRAMS = {
    "assignment_and_del": ('.fahrenheit = .temp * 1.8 + 32\n.device = upcase(.dev)\ndel(.temp)',
                           {"temp": [20.0, 30.0], "dev": ["A", "b"]}),
    "if_else_masked": ('if .v > 6 {\n .band = "high"\n .alert = true\n} else if .v > 3 {\n'
                       ' .band = "mid"\n} else {\n .band = "low"\n}', {"v": [1, 5, 9]}),
    "branch_snapshot_self_mutation": ('if .status == "error" {\n .status = "fatal"\n'
                                      ' .alert = true\n}', {"status": ["error", "ok", "error"]}),
    "else_snapshot_then_mutation": ('if .status == "error" {\n .status = "ok"\n} else {\n'
                                    ' .status = "was_fine"\n}', {"status": ["error", "ok"]}),
    "abort_after_mutation": ('if .level == "debug" {\n .level = "dropped"\n abort\n}\n'
                             '.seen = true', {"level": ["debug", "info", "debug"]}),
    "abort_then_masks_aligned": ("if .v > 8 { abort } else { .kept = true }",
                                 {"v": [1, 5, 9, 2]}),
    "local_binds_value": ("old = .a\n.a = .a * 100\n.saved = old", {"a": [1, 2]}),
    "local_swap": ("t = .a\n.a = .b\n.b = t", {"a": [1], "b": [9]}),
    "abort_filters_rows": ('if .level == "debug" { abort }\n.upper = upcase(.level)',
                           {"level": ["info", "debug", "error"]}),
    "fallible_coalesce_default": (".n = to_int(.x) ?? 0", {"x": ["12", "nope", None]}),
    "parse_json_path": (".b = parse_json!(.m).a.b",
                        {"m": ['{"a": {"b": 7}, "s": "x"}', '{"a": {"b": 8}}']}),
    "url_key_value_regex": ('.host = parse_url!(.u).host\n.lvl = parse_key_value!(.log).level\n'
                            ".code = parse_regex!(.line, r'code=(?P<code>\\d+)').code",
                            {"u": ["https://example.com:8443/p?q=1"],
                             "log": ["level=error msg=boom"], "line": ["code=500"]}),
    "timestamps_hashes_match": ('.epoch = parse_timestamp!(.t, format: "%Y-%m-%d %H:%M:%S")\n'
                                ".digest = md5(.s)\n.sha = sha2(.s)\n.hit = match(.s, r'^a')",
                                {"t": ["2024-01-02 03:04:05"], "s": ["abc"]}),
    "string_stdlib_and_locals": ('clean = trim(.name)\n.first = slice(clean, 0, 3)\n'
                                 '.short = truncate(clean, 7)\n.has = contains(clean, "Love")\n'
                                 '.len = length(clean)', {"name": ["  Ada Lovelace  "]}),
    "exists_and_null_checks": (".has_a = exists(.a)\n.an = is_null(.a)\n.d = .a ?? -1",
                               {"a": [1, None]}),
    "if_expression_value": ('.band = if .v > 5 { "hot" } else { "cold" }', {"v": [2, 8]}),
    "sequential_assignments": (".y = .x + 1\n.z = .y * 10", {"x": [1]}),
    "comments_and_separators": ("# double it\n.w = .v * 2  # trailing comment", {"v": [4]}),
    "literal_local_in_branch": ("t = 1\nif .c { t = 2 }\n.x = t", {"c": [True, False]}),
    "literal_local_both_branches": ("if .c { t = 2 } else { t = 3 }\n.x = t",
                                    {"c": [True, False]}),
    "local_first_bound_in_branch": ("if .c { t = 5 }\n.x = t", {"c": [True, False]}),
    "nonliteral_local_rebound": ("t = .v\nif .c { t = t + 1 }\n.x = t",
                                 {"c": [True, False], "v": [10, 20]}),
    "null_condition_to_else": ('if .status == "error" {\n .sev = "high"\n} else {\n'
                               ' .sev = "normal"\n}', {"status": ["error", None, "ok"]}),
    "null_condition_parent_mask": ('if .p {\n if .s == "e" { .r = "a" } else { .r = "b" }\n}',
                                   {"p": [True, True, False], "s": ["e", None, None]}),
    "split_join_indexing": ('.parts = split(.csv, ",")\n.first = split(.csv, ",")[0]\n'
                            '.last = split(.csv, ",")[-1]\n.third = split(.csv, ",")[2]\n'
                            '.joined = join(split(.csv, ","), "|")',
                            {"csv": ["a,b,c", "x,y", "solo"]}),
    "merge_json_objects": (".m = merge(.a, .b)", {"a": ['{"x": 1, "y": 2}', '{"x": 1}', "not json"],
                                                  "b": ['{"y": 9, "z": 3}', None, '{"k": 1}']}),
    "encode_json_list": ('.j = encode_json(split(.csv, ","))', {"csv": ["a,b", "c"]}),
    "hint_list_shrunk": ('.n = length(join(split(.x, " "), "-"))', {"x": ["a"]}),
    "list_get_all_out_of_range": ('.x = split(.csv, ",")[9]', {"csv": ["a,b", "c,d"]}),
    "parse_syslog_both_rfcs": (
        ".sev = parse_syslog!(.line).severity\n.fac = parse_syslog!(.line).facility\n"
        ".host = parse_syslog!(.line).hostname\n.app = parse_syslog!(.line).appname\n"
        ".pid = parse_syslog!(.line).procid\n.msg = parse_syslog!(.line).message",
        {"line": ["<34>1 2024-03-01T12:00:00Z web01 nginx 1234 ID47 - upstream timed out",
                  "<13>Feb  5 17:32:18 host42 sshd[991]: Accepted publickey for root",
                  "not syslog at all"]}),
    "parse_syslog_edge_rows": ('.msg = parse_syslog!(.line).message\n'
                               '.bad = parse_syslog!(.num).severity',
                               {"line": ['<34>1 2024-03-01T12:00:00Z h app 1 ID [a x="1"][b y="2"]'
                                         ' hello'], "num": [7]}),
    "kleene_and_not_null": (".a = .x && .y\n.o = .x || .y\n.n = !.x",
                            {"x": [True, False, None, None, True],
                             "y": [None, None, None, True, False]}),
    "all_rows_aborted": ("abort", {"v": [1, 2]}),
}


@pytest.mark.parametrize("statement,data", list(PROGRAMS.values()), ids=list(PROGRAMS))
def test_program_matches_jax(statement, data):
    run_both(statement, data)


def _binary(name: str, values: list) -> tuple:
    rb = pa.RecordBatch.from_arrays([pa.array(values, type=pa.binary())], names=[name])
    return JaxBatch(rb), MessageBatch.from_pydict({name: values})


def test_encode_json_on_a_binary_payload_column():
    run_both('.j = encode_json(split(.m, ","))', _binary("m", [b"a,b", b"c"]))


def test_whole_event_assignment_keeps_metadata_and_locals():
    rows = ['{"a": 1, "b": "x"}', '{"a": 2, "b": "y"}']
    rb = pa.RecordBatch.from_arrays([pa.array(rows), pa.array(["k", "k"])],
                                    names=["message", "__meta_source"])
    pb = MessageBatch.from_pydict({"message": rows, "__meta_source": ["k", "k"]})
    _, (out,) = run_both("keep = .message\n. = parse_json!(.message)\n.a2 = .a * 10\n"
                         ".orig_len = length(keep)", (JaxBatch(rb), pb))
    assert out.column_names == ["__meta_source", "a", "b", "a2", "orig_len"]


@pytest.mark.parametrize("rows", [
    ['{"a": 1}', "not json at all", '{"a": 3}'],              # a malformed row -> {}
    ['{"a": 5, "t": [1, 2]}', None, '{"a": 6}'],              # a list, a null row
    ['{"x": {"y": 1.5}, "s": "2024-01-01 00:00:00"}'] * 2,    # a struct and a timestamp text
], ids=["malformed", "list_and_null", "nested"])
def test_whole_event_assignment_types_as_jax(rows):
    run_both(". = parse_json!(.message)", {"message": rows})


def test_whole_event_assignment_of_two_objects_in_a_row_fails_as_jax():
    """A row holding two NDJSON objects decodes, strictly, into one row too
    many: both packages fail the batch with the same message."""
    from arkflow_tpu.errors import ProcessError as JaxProcessError
    from arkflow_tpu_torch.errors import ProcessError

    data = {"message": ['{"a": 1}\n{"a": 2}', '{"a": 3}']}
    cfg = {"type": "vrl", "statement": ". = parse_json!(.message)"}
    with pytest.raises(JaxProcessError) as jerr:
        asyncio.run(jax_build("processor", cfg, JaxResource()).process(
            JaxBatch.from_pydict(data)))
    with pytest.raises(ProcessError) as perr:
        asyncio.run(build_component("processor", cfg, Resource()).process(
            MessageBatch.from_pydict(data)))
    assert str(perr.value) == str(jerr.value)


def test_empty_batch_and_all_rows_dropped_give_no_batch():
    jout, pout = run_both("abort", {"v": [1]})
    assert jout == pout == []
    cfg = {"type": "vrl", "statement": ".x = 1"}
    proc = build_component("processor", cfg, Resource())
    assert asyncio.run(proc.process(MessageBatch.from_pydict({"v": []}))) == []


# -- tests/test_vrl_fuzz.py's generator through both compilers ---------------------


@pytest.mark.parametrize("seed", range(FUZZ_SEEDS))
def test_fuzz_programs_match_jax_and_the_row_oracle(seed):
    rng = np.random.RandomState(1000 + seed)
    for trial in range(FUZZ_TRIALS):
        program, nodes = _Gen(rng).program()
        rows = [{c: None if rng.rand() < 0.2 else int(rng.randint(-5, 10)) for c in COLS}
                for _ in range(12)]
        data = {c: [r[c] for r in rows] for c in COLS}
        jout = jax_apply(JaxBatch.from_pydict(data), jax_compile(program))
        pout = apply_vrl(MessageBatch.from_pydict(data), compile_vrl(program))
        assert_same(jout, pout)
        want = _oracle_run(nodes, rows)
        assert pout.num_rows == len(want), program
        got = pout.to_pydict()
        for key in sorted({k for r in want for k in r}):
            assert got.get(key, [None] * len(want)) == [r.get(key) for r in want], (
                f"seed {seed} trial {trial} column {key!r}\n{program}")


# -- refusals at build, with JAX's messages -------------------------------------------

REFUSALS = {
    "unknown_function": ".x = some_unknown_fn(.y)",
    "bad_character": "???",
    "del_in_branch": "if .c { del(.x) }",
    "whole_event_in_branch": "if .c { . = parse_json!(.m) }",
    "whole_event_not_json": ". = upcase(.m)",
    "object_without_path": ".x = parse_json!(.m)",
    "non_integer_index": '.x = split(.s, ",")[1.5]',
    "unknown_identifier": ".x = nope",
    "named_argument": ".x = upcase(.m, flag: true)",
    "unterminated_block": "if .c { .x = 1",
    "double_equals_statement": "x == 1",
    "bare_event_in_expression": ".x = .",
    "exists_arity": ".x = exists(.a, .b)",
    "only_comments": "# nothing",
}


@pytest.mark.parametrize("statement", list(REFUSALS.values()), ids=list(REFUSALS))
def test_refusal_messages_match_jax(statement):
    cfg = {"type": "vrl", "statement": statement}
    with pytest.raises(JaxConfigError) as jerr:
        jax_build("processor", cfg, JaxResource())
    with pytest.raises(ConfigError) as perr:
        build_component("processor", cfg, Resource())
    assert str(perr.value) == str(jerr.value)
    assert type(perr.value).__name__ == type(jerr.value).__name__


def test_missing_statement_and_compile_error_class():
    for cfg in ({"type": "vrl"}, {"type": "vrl", "statement": ""}):
        with pytest.raises(JaxConfigError) as jerr:
            jax_build("processor", cfg, JaxResource())
        with pytest.raises(ConfigError) as perr:
            build_component("processor", cfg, Resource())
        assert str(perr.value) == str(jerr.value)
    assert issubclass(VrlCompileError, ConfigError)
    with pytest.raises(VrlCompileError, match="supported"):
        compile_vrl(".x = some_unknown_fn(.y)")
