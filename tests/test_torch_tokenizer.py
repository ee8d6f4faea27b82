"""Port parity for the HuggingFace tokenizer and the ``tokenizer`` key:
``HFTokenizer`` and ``build_tokenizer`` against the JAX package's on a
WordPiece tokenizer built here and saved into a temporary directory (no
file is downloaded), and ``gpu_inference`` / ``gpu_generate`` (both serving
modes) with ``tokenizer:`` against ``tpu_inference`` / ``tpu_generate`` on
the same weights: labels, scores and generated texts."""

import asyncio
import sys

import jax
import numpy as np
import pytest

from arkflow_tpu.config import StreamConfig as JaxStreamConfig
from arkflow_tpu.runtime import build_stream as jax_build_stream
from arkflow_tpu.tpu import tokenizer as jtok
from arkflow_tpu_torch.batch import BinaryColumn
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.runtime.stream import build_stream
from arkflow_tpu_torch.tpu import tokenizer as ttok
from arkflow_tpu_torch.tpu.runner import ModelRunner
from tests.test_runtime import CollectOutput as JaxCollectOutput
from tests.test_torch_stream import Collect, _generate_stream, _processor, _stream
from tests.test_tpu_layer import TINY_BERT

WORDS = ["sensor", "reading", "looks", "fine", "pressure", "spike", "on", "line", "four",
         "check", "valve", "caf", "##e", "na", "##ive", "x", "alpha", "ok", ",", ".", "é"]
#: the decoder streams' vocabulary: every id a tiny decoder can generate
#: decodes to a token of this tokenizer
VOCAB_SIZE = 128
ASCII = [b"Sensor reading looks fine.", b"pressure spike on line four, check valve",
         b"", b"ok ok ok x alpha"]
NON_ASCII = [b"caf\xc3\xa9 na\xc3\xafve sensor", b"pressure \xc3\xa9 spike", b"\xff\xfe bad bytes"]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    filler = [f"w{i}" for i in range(VOCAB_SIZE - len(specials) - len(WORDS))]
    vocab = {t: i for i, t in enumerate(specials + WORDS + filler)}
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True, strip_accents=False)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok.decoder = decoders.WordPiece()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                                   cls_token="[CLS]", sep_token="[SEP]")
    path = tmp_path_factory.mktemp("wordpiece")
    fast.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def toks(tok_dir):
    return jtok.build_tokenizer(tok_dir), ttok.build_tokenizer(tok_dir)


def test_build_tokenizer_loads_the_local_files_in_both_packages(toks):
    jt, tt = toks
    assert isinstance(jt, jtok.HFTokenizer) and isinstance(tt, ttok.HFTokenizer)


@pytest.mark.parametrize("texts", [ASCII, NON_ASCII, ASCII + NON_ASCII],
                         ids=["ascii", "non_ascii", "mixed"])
@pytest.mark.parametrize("max_len", [4, 16])
def test_ids_masks_and_decode_equal_jax(toks, texts, max_len):
    jt, tt = toks
    want_ids, want_mask = jt.encode_batch(texts, max_len)
    got_ids, got_mask = tt.encode_batch(texts, max_len)
    assert got_ids.dtype == got_mask.dtype == np.int32
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    for row in got_ids:
        assert tt.decode(row) == jt.decode(row)
    col = BinaryColumn.from_pylist(texts)
    view_ids, view_mask = tt.encode_batch_view(col.values, col.offsets, max_len)
    np.testing.assert_array_equal(view_ids, want_ids)
    np.testing.assert_array_equal(view_mask, want_mask)


@pytest.mark.parametrize("offset,length", [(1, 3), (4, 2), (2, 5)])
def test_encode_batch_view_on_a_sliced_column(toks, offset, length):
    """A slice shares the parent buffer: only its own window is decoded,
    through the ASCII fast path or row by row."""
    _, tt = toks
    texts = ASCII + NON_ASCII
    part = BinaryColumn.from_pylist(texts).slice(offset, length)
    got = tt.encode_batch_view(part.values, part.offsets, 12)
    want = tt.encode_batch(texts[offset: offset + length], 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_missing_path_falls_back_to_hashing(tmp_path):
    for mod in (jtok, ttok):
        tok = mod.build_tokenizer(str(tmp_path / "absent"), vocab_size=777)
        assert isinstance(tok, mod.HashTokenizer) and tok.vocab_size == 777
    assert isinstance(ttok.build_tokenizer(None, 99), ttok.HashTokenizer)


def test_a_blocked_transformers_import_falls_back_to_hashing(tok_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    for mod in (jtok, ttok):
        tok = mod.build_tokenizer(tok_dir, vocab_size=321)
        assert isinstance(tok, mod.HashTokenizer) and tok.vocab_size == 321


def test_gpu_inference_with_tokenizer_gives_the_jax_labels(tok_dir):
    proc = {**_processor(tokenizer=tok_dir)}
    jax_cfg = _stream()
    jax_cfg["pipeline"]["processors"][0] = {**proc, "type": "tpu_inference"}
    del jax_cfg["pipeline"]["processors"][0]["device"]
    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(jax_cfg))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    host = jax.device_get(jax_stream.pipeline.processors[0].runner.host_params)

    stream = build_stream(StreamConfig.from_mapping(_stream(tokenizer=tok_dir)))
    tproc = stream.pipeline.processors[0]
    assert isinstance(tproc.tokenizer, ttok.HFTokenizer)
    tproc.runner = ModelRunner("bert_classifier", TINY_BERT, buckets=tproc.runner.buckets,
                               device="cpu", host_params=params_from_jax(host))
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))
    want_logits = np.concatenate([
        np.asarray(b.column("logits").flatten()).reshape(-1, 2) for b in jax_sink.batches])
    want_labels = np.concatenate([np.asarray(b.column("label")) for b in jax_sink.batches])
    want_scores = np.concatenate([np.asarray(b.column("score")) for b in jax_sink.batches])
    got_logits = np.concatenate([b.column("logits") for b in sink.batches])
    np.testing.assert_allclose(got_logits, want_logits, atol=1 / 64, rtol=0)
    np.testing.assert_allclose(np.concatenate([b.column("score") for b in sink.batches]),
                               want_scores, atol=1 / 64, rtol=0)
    top2 = np.sort(want_logits, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > 0.05
    got_labels = np.concatenate([b.column("label") for b in sink.batches])
    np.testing.assert_array_equal(got_labels[tie_free], want_labels[tie_free])
    assert stream.rows_out == 23 and stream.errors == 0


def _copy_into(live, new):
    for k, v in new.items():
        _copy_into(live[k], v) if isinstance(v, dict) else live[k].copy_(v)


#: a greedy step whose top-2 logit gap is at or below this is a near-tie
TIE_MARGIN = 0.05


def _record_port_generations(monkeypatch, proc) -> list:
    """Each row the port's processor generates, in row order (one worker):
    ``[ids, top-2 gap of each step]``. Continuous mode asks the server for
    its margins; batch mode records ``decoder.select_token``'s gaps inside
    each generation (the connect warmup left out)."""
    from arkflow_tpu_torch.models import decoder as dec

    rows: list = []
    if proc.server is not None:
        server, real_generate = proc.server, proc.server.generate
        server.record_margins = True

        async def generate(ids, max_new_tokens):
            row = []
            rows.append(row)  # at call time: the batch's row order
            row.extend(await real_generate(ids, max_new_tokens=max_new_tokens,
                                           with_margins=True))
            return row[0]

        monkeypatch.setattr(server, "generate", generate)
        return rows
    gens: list = []
    start, select = dec.start_generation, dec.select_token

    def recording_start(params, cfg, input_ids, lengths, n_real, *a, **kw):
        warm = bool((input_ids == 1).all() and (lengths == 1).all())
        gens.append((0 if warm else int(n_real.reshape(())), [], []))
        return start(params, cfg, input_ids, lengths, n_real, *a, **kw)

    def recording_select(logits, *a, **kw):
        top2 = logits.float().topk(2, dim=-1).values
        out = select(logits, *a, **kw)
        gens[-1][1].append(out.tolist())
        gens[-1][2].append((top2[:, 0] - top2[:, 1]).tolist())
        return out

    monkeypatch.setattr(dec, "start_generation", recording_start)
    monkeypatch.setattr(dec, "select_token", recording_select)
    real_generate = proc.generator.generate

    def generate(input_ids, lengths, n_real, key):
        tokens, counts, steps = real_generate(input_ids, lengths, n_real, key)
        n, picks, gaps = gens[-1]
        for r in range(n):
            k = int(counts[r])
            rows.append([[p[r] for p in picks][:k], [g[r] for g in gaps][:k]])
        return tokens, counts, steps

    monkeypatch.setattr(proc.generator, "generate", generate)
    return rows


#: prompts whose every greedy step has a top-2 gap above ``TIE_MARGIN`` on
#: the JAX stream's seeded tiny decoder (the smallest is the second text's:
#: 0.625 served continuously, 0.336 in batches of 4); the first is 12 tokens
#: with [CLS] and [SEP], longer than the prefill chunk of 8
TIE_FREE_TEXTS = ["w5 spike w33 w63 line w70 w20 w82 w30 w97", "w54 w59",
                  "on w54 w79 spike w33 caf w14"]


@pytest.mark.parametrize("serving", ["continuous", "batch"])
def test_gpu_generate_with_tokenizer_gives_the_jax_texts(tok_dir, serving, monkeypatch):
    """Both serving modes: the prompts tokenized by the HF tokenizer and the
    generated ids decoded row by row (an HF tokenizer has no
    ``decode_column``), on the JAX stream's weights. The prompts are pinned
    tie-free: every step of every row has a top-2 gap above ``TIE_MARGIN``
    in the port (checked here), so each whole text must equal JAX's. One
    worker in both packages, so the port's rows come in the order they were
    generated."""
    import torch

    patch = {"tokenizer": tok_dir, "serving": serving}
    if serving == "batch":
        patch["batch_buckets"] = [4]

    def raw(kind):
        r = _generate_stream(kind, **patch)
        r["pipeline"]["thread_num"] = 1
        r["input"]["payloads"] = TIE_FREE_TEXTS
        return r

    jax_stream = jax_build_stream(JaxStreamConfig.from_mapping(raw("tpu_generate")))
    jax_sink = jax_stream.output = JaxCollectOutput()
    asyncio.run(jax_stream.run(asyncio.Event()))
    host = params_from_jax(jax.device_get(jax_stream.pipeline.processors[0].params))

    stream = build_stream(StreamConfig.from_mapping(raw("gpu_generate")))
    proc = stream.pipeline.processors[0]
    assert isinstance(proc.tokenizer, ttok.HFTokenizer)
    with torch.no_grad():
        _copy_into(proc.params, host)
    rows = _record_port_generations(monkeypatch, proc)
    sink = stream.output = Collect()
    asyncio.run(stream.run(asyncio.Event()))
    want = [t for b in jax_sink.batches for t in b.column("generated").to_pylist()]
    got = [t.decode() for b in sink.batches for t in b.column("generated").to_pylist()]
    assert len(got) == len(want) == len(rows) == 7 and stream.errors == 0
    assert proc.tokens > 0
    for g, (ids, gaps) in zip(got, rows):
        assert proc.tokenizer.decode(ids) == g and g
        assert len(ids) == len(gaps) == 5 and min(gaps) > TIE_MARGIN, (g, gaps)
    assert got == want
