#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero before the
last line):

1. the card's identity (nvidia-smi name and power limit, torch's name);
2. building every CUDA kernel of the paths from ``arkflow_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. each kernel against its plain PyTorch version at BERT-base shapes, with
   its time, the plain version's, one PyTorch library call's and the bound:
   K1 (ragged) on random lengths, K2 (segment) on packed layouts;
4. the padded stream ``arkflow_tpu_torch/examples/bert_stream.json``
   (generate -> gpu_inference(bert_classifier, full BERT-base width, bf16)
   -> drop) through the port's ``Engine``, with the launch counts read
   around that run only, then the K1 path's outputs against the plain
   attention's on a few hundred rows;
5. the packed stream ``arkflow_tpu_torch/examples/bert_packed_stream.json``
   (generate -> memory buffer with token-budget coalescing ->
   gpu_inference(packing, BERT-base, bf16) -> drop) through ``Engine``:
   every row in order, K2 launches = layers x packed steps, no K1 launch,
   the packed steps' token fill; then K2 at the stream's own layout, and
   the same texts through the packed K2 path, the packed pair-mask path and
   the padded K1 path, whose outputs must agree;
6. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Needs one CUDA card and nvcc; imports nothing of JAX or ``arkflow_tpu``.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from arkflow_tpu_torch.batch import MessageBatch  # noqa: E402
from arkflow_tpu_torch.components import Output  # noqa: E402
from arkflow_tpu_torch.config import EngineConfig  # noqa: E402
from arkflow_tpu_torch.ops import ragged_attention as ra  # noqa: E402
from arkflow_tpu_torch.ops import segment_attention as sa  # noqa: E402
from arkflow_tpu_torch.ops.build import build_all  # noqa: E402
from arkflow_tpu_torch.plugins.processor.gpu_inference import (  # noqa: E402
    pack_windows,
    scatter_windows,
)
from arkflow_tpu_torch.runtime.engine import Engine  # noqa: E402
from arkflow_tpu_torch.tools.profile_step import first_emission  # noqa: E402
from arkflow_tpu_torch.tpu.packing import pack_tokens  # noqa: E402
from arkflow_tpu_torch.tpu.runner import ModelRunner  # noqa: E402
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "arkflow_tpu_torch", "examples")
CONFIG = os.path.join(EXAMPLES, "bert_stream.json")
PACKED_CONFIG = os.path.join(EXAMPLES, "bert_packed_stream.json")
#: H100 SXM published peaks from NVIDIA's datasheet: HBM bytes/s, and
#: dense flop/s by operand type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 1.0 / 64, torch.float32: 1e-4}
LABEL_MARGIN = 0.05
LOGIT_TOL = 1.0 / 64
KERNEL_SOURCES = ["ragged_attention", "segment_attention"]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def ptxas_summary(text: str) -> list[dict]:
    """Registers and spill bytes per kernel instantiation, from ``-Xptxas -v``."""
    out: list[dict] = []
    for line in text.splitlines():
        m = re.search(
            r"Compiling entry function '\S*?(ragged|segment)_attention_kernelI(\w+?)Li(\d+)E",
            line)
        if m:
            dtype = "bf16" if "bfloat16" in m.group(2) else "f32"
            out.append({"kernel": m.group(1), "dtype": dtype, "D": int(m.group(3))})
        elif out and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[-1]["spill_store_bytes"] = int(m.group(1))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warmup."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(lengths: torch.Tensor, h: int, s: int, d: int,
                       dtype: torch.dtype, causal: bool) -> tuple[float, str]:
    """Least time for this call's work: q/k/v rows inside the lengths read
    once, the whole output written once; 4*len^2*D flops per (row, head)
    (about half when causal)."""
    lens = lengths.to(torch.float64).cpu()
    size = torch.finfo(dtype).bits // 8
    b = lens.numel()
    nbytes = 3 * float(lens.sum()) * h * d * size + b * h * s * d * size + 4 * b
    flops = float((2 * lens * (lens + 1) if causal else 4 * lens * lens).sum()) * d * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, lengths, causal: bool):
    """The PyTorch library call for the same function (a yardstick only)."""
    s = q.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def kernel_case(gen, b, h, s, d, dtype, causal, lengths=None) -> dict:
    """K1 against its plain version on [B, S, H, D]-laid-out operands (the
    layout the model hands it), plus the timings."""
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))
    if lengths is None:
        lengths = torch.randint(0, s + 1, (b,), device="cuda", generator=gen)
        lengths[:3] = torch.tensor([0, 1, s])
    lengths = lengths.to(device="cuda", dtype=torch.int32)
    out = ra.ragged_flash_attention(q, k, v, lengths, causal=causal)
    ref = ra.ragged_attention_reference(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    pad_zero = all(bool((out[i, :, int(n):] == 0).all()) for i, n in enumerate(lengths.tolist()))
    bound, bound_by = attention_bound_ms(lengths, h, s, d, dtype, causal)
    case = {
        "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "max_abs_err": err, "tol": TOL[dtype], "pad_rows_zero": pad_zero,
        "kernel_ms": time_ms(lambda: ra.ragged_flash_attention(q, k, v, lengths, causal=causal)),
        "plain_ms": time_ms(lambda: ra.ragged_attention_reference(q, k, v, lengths, causal=causal)),
        "library_ms": time_ms(sdpa_call(q, k, v, lengths, causal)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    print("K1 case " + json.dumps(case), flush=True)
    check(err <= TOL[dtype], f"K1 disagrees with its plain version: {case}")
    check(pad_zero, f"K1 left pad queries non-zero: {case}")
    return case


def segment_layouts(rng: np.random.Generator, b: int, s: int) -> np.ndarray:
    """[b, s] segment ids: row 0 dead, row 1 one segment spanning S, row 2
    length-1 segments, row 3 interleaved (non-contiguous) ids with dead
    holes, then rows packed by ``pack_tokens`` from random lengths (ids out
    of position order, dead tails); rows past the packed ones stay dead."""
    n = 3 * b
    lengths = np.where(rng.random(n) < 0.7, rng.integers(1, s // 4 + 1, n),
                       rng.integers(s // 2, s + 1, n))
    pk = pack_tokens(np.ones((n, s), np.int32), lengths, s)
    seg = np.zeros((b, s), np.int32)
    rows = min(b - 6, pk.num_rows)
    seg[4:4 + rows] = pk.segment_ids[:rows]
    seg[1] = 1
    seg[2] = np.arange(1, s + 1)
    seg[3] = np.arange(s) % 3 + 1
    seg[3, ::7] = 0
    return seg


def segment_bound_ms(seg: np.ndarray, h: int, d: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for this call's work: live q/k/v rows read once, the whole
    output and the ids written/read once; 4*len^2*D*H flops per segment."""
    size = torch.finfo(dtype).bits // 8
    live = int((seg > 0).sum())
    nbytes = 3 * live * h * d * size + seg.size * h * d * size + seg.size * 4
    sq = 0
    for row in seg:
        _, counts = np.unique(row[row > 0], return_counts=True)
        sq += int((counts.astype(np.int64) ** 2).sum())
    flops = 4.0 * sq * d * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segment_case(gen, seg_np: np.ndarray, h: int, d: int, dtype: torch.dtype,
                 label: str) -> dict:
    """K2 against its plain version on [B, S, H, D]-laid-out operands, plus
    the timings; the library yardstick is ``scaled_dot_product_attention``
    with the block-diagonal boolean mask, compared on live rows only."""
    b, s = seg_np.shape
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))
    seg = torch.from_numpy(seg_np).to("cuda")
    out = sa.segment_flash_attention(q, k, v, seg)
    ref = sa.segment_attention_reference(q, k, v, seg)
    live = (seg > 0)[:, None, :, None].expand_as(out)
    pair = ((seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, :, None])[:, None]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=pair)  # noqa: E731
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    dead_zero = bool((out[~live] == 0).all())
    lib_err = (lib_out.float() - ref.float())[live].abs().max().item()
    bound, bound_by = segment_bound_ms(seg_np, h, d, dtype)
    case = {
        "case": label, "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
        "live_tokens": int((seg_np > 0).sum()), "max_abs_err": err, "tol": TOL[dtype],
        "dead_rows_zero": dead_zero, "library_live_max_abs_err": lib_err,
        "kernel_ms": time_ms(lambda: sa.segment_flash_attention(q, k, v, seg)),
        "plain_ms": time_ms(lambda: sa.segment_attention_reference(q, k, v, seg)),
        "library_ms": time_ms(lib),
        "bound_ms": bound, "bound_by": bound_by,
    }
    print("K2 case " + json.dumps(case), flush=True)
    check(err <= TOL[dtype], f"K2 disagrees with its plain version: {case}")
    check(dead_zero, f"K2 left dead queries non-zero: {case}")
    return case


def slice_lengths(cfg: dict, n: int) -> torch.Tensor:
    """True token lengths of one batch of the slice's stream: the generate
    input rotates its payload mix across the batch's rows."""
    inp = cfg["streams"][0]["input"]
    proc = cfg["streams"][0]["pipeline"]["processors"][0]
    payloads = [str(p).encode() for p in inp["payloads"]]
    _, mask = HashTokenizer().encode_batch(
        [payloads[i % len(payloads)] for i in range(n)], proc["max_seq"])
    return torch.from_numpy(mask.sum(axis=1))


def compare_paths(runner: ModelRunner, proc_cfg: dict, rows: int, seed: int) -> dict:
    """The stream's runner (kernel path) against the same weights on the
    plain attention, on ``rows`` distinct texts of mixed lengths."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(n))).encode()
             for n in rng.integers(1, proc_cfg["max_seq"] - 2, size=rows)]
    ids, mask = HashTokenizer(runner.cfg.vocab_size).encode_batch(texts, proc_cfg["max_seq"])
    plain = ModelRunner(
        proc_cfg["model"], {**proc_cfg["model_config"], "use_flash_attention": False},
        buckets=runner.buckets, seed=proc_cfg["seed"], device="cuda",
        serving_dtype=proc_cfg["serving_dtype"])
    a = runner.infer_sync({"input_ids": ids, "attention_mask": mask})
    b = plain.infer_sync({"input_ids": ids, "attention_mask": mask})
    la, lb = a["logits"], b["logits"]
    check(la.shape == (rows, 2) and np.isfinite(la).all(), f"kernel-path logits {la.shape} not finite")
    check(np.isfinite(lb).all(), "plain-path logits not finite")
    top2 = np.sort(lb, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > LABEL_MARGIN
    label_mismatch = int((a["label"][tie_free] != b["label"][tie_free]).sum())
    logit_err = float(np.abs(la - lb).max())
    report = {"rows": rows, "tie_free_rows": int(tie_free.sum()),
              "label_mismatches_tie_free": label_mismatch,
              "label_mismatches_all": int((a["label"] != b["label"]).sum()),
              "max_logit_abs_err": logit_err, "logit_tol": LOGIT_TOL,
              "scores_in_range": bool(((a["score"] >= 0.5) & (a["score"] <= 1.0)).all())}
    print("paths " + json.dumps(report), flush=True)
    check(label_mismatch == 0, f"kernel path changed tie-free labels: {report}")
    check(logit_err <= LOGIT_TOL, f"kernel-path logits off: {report}")
    check(report["scores_in_range"], f"scores out of range: {report}")
    # whole-model step time at the slice's shape, kernel vs plain attention
    one = {"input_ids": ids[:64], "attention_mask": mask[:64]}
    step_ms = {}
    for name, r in (("kernel", runner), ("plain", plain), ("kernel_again", runner)):
        step_ms[name] = time_ms(lambda: r.infer_sync(one), iters=10, warmup=2)
    print("step_ms " + json.dumps({"rows": 64, "seq_bucket": runner.buckets.seq_bucket(
        int(mask[:64].sum(1).max())), **step_ms}), flush=True)
    return report


def reset_counts() -> None:
    """Zero every kernel's launch count: counts read after a path's run then
    belong to that run alone."""
    ra.launches.reset()
    sa.launches.reset()


def run_slice(cfg_raw: dict) -> dict:
    cfg = EngineConfig.from_mapping(cfg_raw)
    engine = Engine(cfg)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ra.launches.value
    k2_launches = sa.launches.value
    stream = engine.streams[0]
    runner = stream.pipeline.processors[0].runner
    count = cfg_raw["streams"][0]["input"]["count"]
    layers = runner.cfg.layers
    report = {"rows_expected": count, "rows_out": stream.rows_out,
              "rows_dropped": stream.output.dropped_rows, "errors": stream.errors,
              "seconds": wall, "rows_per_s": stream.rows_out / wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "layers": layers,
              "k1_launches": launches, "k2_launches": k2_launches,
              "flash_fallbacks": runner.flash_fallbacks,
              "hidden": runner.cfg.hidden, "heads": runner.cfg.heads}
    print("slice " + json.dumps(report), flush=True)
    check(k2_launches == 0, f"the padded stream launched K2: {report}")
    check(stream.errors == 0, f"stream reported errors: {report}")
    check(stream.rows_out == count and stream.output.dropped_rows == count,
          f"not every row arrived: {report}")
    check(launches > 0 and launches == layers * runner.device_steps,
          f"K1 launches != layers x device steps: {report}")
    check(runner.flash_fallbacks == 0, f"the runner fell back from the kernel: {report}")
    return {"report": report, "runner": runner}


class OrderedSink(Output):
    """Wraps the stream's own output: records every payload it is handed,
    in order, then passes the batch on."""

    def __init__(self, inner: Output):
        self.inner = inner
        self.payloads: list[bytes] = []

    async def connect(self) -> None:
        await self.inner.connect()

    async def write(self, batch: MessageBatch) -> None:
        self.payloads.extend(batch.to_binary())
        await self.inner.write(batch)

    async def close(self) -> None:
        await self.inner.close()


def generated_rows(cfg_raw: dict) -> list[bytes]:
    """The rows the slice's generate input produces, in order: each batch
    rotates the payload mix from its first row."""
    inp = cfg_raw["streams"][0]["input"]
    payloads = [str(p).encode() for p in inp["payloads"]]
    rows, left = [], inp["count"]
    while left > 0:
        n = min(inp["batch_size"], left)
        rows += [payloads[i % len(payloads)] for i in range(n)]
        left -= n
    return rows


def run_packed_slice(cfg_raw: dict) -> dict:
    """The packed stream through ``Engine``, its sink wrapped to check order;
    the launch counts are zeroed just before the run and read just after."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = ra.launches.value, sa.launches.value
    runner = stream.pipeline.processors[0].runner
    expected = generated_rows(cfg_raw)
    count = len(expected)
    layers = runner.cfg.layers
    b = runner.buckets
    warmup_steps = len(b.seq_buckets) * sum(
        1 for eb in b.example_buckets() for pb in b.batch_buckets if pb <= eb)
    report = {"rows_expected": count, "rows_out": stream.rows_out,
              "rows_dropped": sink.inner.dropped_rows, "errors": stream.errors,
              "in_order": sink.payloads == expected,
              "seconds": wall, "rows_per_s": stream.rows_out / wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "packed_steps": runner.packed_steps,
              "traffic_packed_steps": runner.packed_steps - warmup_steps,
              "packed_token_fill": runner.packed_tokens / max(1, runner.packed_slots),
              "packed_tokens": runner.packed_tokens, "packed_slots": runner.packed_slots,
              "packed_flash": runner.cfg.packed_flash, "layers": layers,
              "k1_launches": k1, "k2_launches": k2}
    print("packed slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"packed stream reported errors: {report}")
    check(stream.rows_out == count and sink.inner.dropped_rows == count,
          f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(k2 > 0 and k2 == layers * runner.packed_steps,
          f"K2 launches != layers x packed steps: {report}")
    check(k1 == 0, f"the packed stream launched K1: {report}")
    return {"report": report, "runner": runner}


def stream_layout(cfg_raw: dict, buckets) -> list[tuple[dict, np.ndarray]]:
    """The packed windows of the stream's first emission, made as the stream
    makes them: the generate batches through the token-budget coalescer,
    then tokenize, pack and carve."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    texts = first_emission(cfg_raw["streams"][0])
    ids, mask = HashTokenizer().encode_batch(texts, proc["max_seq"])
    return pack_windows(ids, mask, buckets)


def compare_packed_paths(packed: ModelRunner, padded: ModelRunner, proc_cfg: dict,
                         rows: int, seed: int) -> dict:
    """The same ``rows`` distinct texts of mixed lengths through the packed
    K2 path (the packed stream's runner), the packed pair-mask path (same
    weights, ``packed_flash: false``) and the padded K1 path (the padded
    stream's runner, same seed): labels equal on tie-free rows, logits
    within 1/64; and the time each path takes to serve them."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(n))).encode()
             for n in rng.integers(1, proc_cfg["max_seq"] - 2, size=rows)]
    ids, mask = HashTokenizer(packed.cfg.vocab_size).encode_batch(texts, proc_cfg["max_seq"])
    windows = pack_windows(ids, mask, packed.buckets)
    pair = ModelRunner(
        proc_cfg["model"], {**proc_cfg["model_config"], "packed_flash": False},
        buckets=packed.buckets, seed=proc_cfg["seed"], device="cuda",
        serving_dtype=proc_cfg["serving_dtype"], packed=True)
    check(packed.cfg.packed_flash is True and pair.cfg.packed_flash is False,
          "the packed runners did not resolve packed_flash as asked")

    def serve_packed(r):
        return lambda: scatter_windows(windows, [r.infer_sync(w) for w, _ in windows], rows)

    def serve_padded():
        return padded.infer_sync({"input_ids": ids, "attention_mask": mask})

    paths = {"packed_k2": serve_packed(packed), "packed_pair_mask": serve_packed(pair),
             "padded_k1": serve_padded}
    outs = {name: fn() for name, fn in paths.items()}
    got = outs["packed_k2"]
    check(got["logits"].shape == (rows, 2) and np.isfinite(got["logits"]).all(),
          "packed-path logits not finite")
    report = {"rows": rows, "packed_windows": [int(w["input_ids"].shape[0]) for w, _ in windows]}
    for other in ("packed_pair_mask", "padded_k1"):
        ref = outs[other]
        top2 = np.sort(ref["logits"], axis=1)
        tie_free = (top2[:, -1] - top2[:, -2]) > LABEL_MARGIN
        report[other] = {
            "tie_free_rows": int(tie_free.sum()),
            "label_mismatches_tie_free": int((got["label"][tie_free] != ref["label"][tie_free]).sum()),
            "label_mismatches_all": int((got["label"] != ref["label"]).sum()),
            "max_logit_abs_err": float(np.abs(got["logits"] - ref["logits"]).max())}
    report["logit_tol"] = LOGIT_TOL
    print("packed paths " + json.dumps(report), flush=True)
    for other in ("packed_pair_mask", "padded_k1"):
        check(report[other]["label_mismatches_tie_free"] == 0,
              f"packed K2 path changed tie-free labels against {other}: {report}")
        check(report[other]["max_logit_abs_err"] <= LOGIT_TOL,
              f"packed K2 path logits off against {other}: {report}")
    # the three paths on the same texts, in turns (K2, pair, K1, K1, pair, K2)
    times = {name: [] for name in paths}
    for name in (*paths, *reversed(list(paths))):
        times[name].append(time_ms(paths[name], iters=5, warmup=1))
    steps = {"packed_k2": len(windows), "packed_pair_mask": len(windows),
             "padded_k1": -(-rows // padded.buckets.max_batch())}
    print("packed paths step_ms " + json.dumps({
        name: {"ms_per_call": statistics.median(t), "runs": t, "device_steps": steps[name],
               "ms_per_step": statistics.median(t) / steps[name]}
        for name, t in times.items()}), flush=True)
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)

    built = build_all(KERNEL_SOURCES, verbose=True)
    print("build " + json.dumps({k: round(v["seconds"], 3) for k, v in built.items()}), flush=True)
    for name, rep in built.items():
        print(f"ptxas {name} " + json.dumps(ptxas_summary(rep["output"])), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for s in (128, 256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            kernel_case(gen, 64, 12, s, 64, dtype, causal=False)
    kernel_case(gen, 64, 12, 256, 64, torch.bfloat16, causal=True)
    rng = np.random.default_rng(0)
    for s in (128, 256, 512):
        seg = segment_layouts(rng, 64, s)
        for dtype in (torch.bfloat16, torch.float32):
            segment_case(gen, seg, 12, 64, dtype, f"layouts S={s}")

    with open(CONFIG) as f:
        cfg_raw = json.load(f)
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    batch = cfg_raw["streams"][0]["input"]["batch_size"]
    result = run_slice(cfg_raw)
    runner = result["runner"]
    main_len = slice_lengths(cfg_raw, batch)
    main_seq = runner.buckets.seq_bucket(int(main_len.max()))
    main_case = kernel_case(gen, batch, runner.cfg.heads, main_seq,
                            runner.cfg.hidden // runner.cfg.heads, torch.bfloat16,
                            causal=False, lengths=main_len)
    compare_paths(runner, proc_cfg, rows=256, seed=1)

    with open(PACKED_CONFIG) as f:
        packed_raw = json.load(f)
    packed_proc = packed_raw["streams"][0]["pipeline"]["processors"][0]
    packed = run_packed_slice(packed_raw)
    prunner = packed["runner"]
    dh = prunner.cfg.hidden // prunner.cfg.heads
    k2_cases = []
    for w, _ in stream_layout(packed_raw, prunner.buckets):  # one emission's windows
        rows = w["input_ids"].shape[0]
        seg = np.zeros((prunner.buckets.batch_bucket(rows), w["segment_ids"].shape[1]), np.int32)
        seg[:rows] = w["segment_ids"]
        k2_cases.append(segment_case(gen, seg, prunner.cfg.heads, dh, torch.bfloat16,
                                     f"stream window {rows} rows"))
    k2_main = k2_cases[0]  # the largest window
    compare_packed_paths(prunner, runner, packed_proc, rows=320, seed=2)

    kernels = [{
        "name": "ragged_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "arkflow_tpu/ops/ragged_attention.py:95",
        "launches": result["report"]["k1_launches"], "ok": True,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
    }, {
        "name": "segment_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/segment_attention.cu",
        "replaces": "arkflow_tpu/ops/segment_attention.py:52",
        "launches": packed["report"]["k2_launches"], "ok": True,
        "max_abs_err": k2_main["max_abs_err"], "ms": k2_main["kernel_ms"],
        "plain_ms": k2_main["plain_ms"], "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"], "library_ms": k2_main["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
