#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero before the
last line):

1. the card's identity (nvidia-smi name and power limit, torch's name);
2. building every CUDA kernel of the path from ``arkflow_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. each kernel against its plain PyTorch version at BERT-base shapes, with
   its time, the plain version's, one PyTorch library call's and the bound;
4. the slice itself: ``arkflow_tpu_torch/examples/bert_stream.json``
   (generate -> gpu_inference(bert_classifier, full BERT-base width, bf16)
   -> drop) through the port's ``Engine``, with the launch counts read
   around that run only, then the kernel path's outputs against the plain
   attention's on a few hundred rows;
5. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

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

from arkflow_tpu_torch.config import EngineConfig  # noqa: E402
from arkflow_tpu_torch.ops import ragged_attention as ra  # noqa: E402
from arkflow_tpu_torch.ops.build import build_all  # noqa: E402
from arkflow_tpu_torch.runtime.engine import Engine  # noqa: E402
from arkflow_tpu_torch.tpu.runner import ModelRunner  # noqa: E402
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "arkflow_tpu_torch", "examples", "bert_stream.json")
#: H100 SXM published peaks from NVIDIA's datasheet: HBM bytes/s, and
#: dense flop/s by operand type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 1.0 / 64, torch.float32: 1e-4}
LABEL_MARGIN = 0.05
LOGIT_TOL = 1.0 / 64
KERNEL_SOURCES = ["ragged_attention"]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def ptxas_summary(text: str) -> list[dict]:
    """Registers and spill bytes per kernel instantiation, from ``-Xptxas -v``."""
    out: list[dict] = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?kernelI(\w+?)Li(\d+)E", line)
        if m:
            dtype = "bf16" if "bfloat16" in m.group(1) else "f32"
            out.append({"dtype": dtype, "D": int(m.group(2))})
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


def run_slice(cfg_raw: dict) -> dict:
    cfg = EngineConfig.from_mapping(cfg_raw)
    engine = Engine(cfg)
    ra.launches.reset()  # counts from here on belong to the main path's run
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ra.launches.value
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
              "k1_launches": launches, "flash_fallbacks": runner.flash_fallbacks,
              "hidden": runner.cfg.hidden, "heads": runner.cfg.heads}
    print("slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"stream reported errors: {report}")
    check(stream.rows_out == count and stream.output.dropped_rows == count,
          f"not every row arrived: {report}")
    check(launches > 0 and launches == layers * runner.device_steps,
          f"K1 launches != layers x device steps: {report}")
    check(runner.flash_fallbacks == 0, f"the runner fell back from the kernel: {report}")
    return {"report": report, "runner": runner}


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

    kernels = [{
        "name": "ragged_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "arkflow_tpu/ops/ragged_attention.py:95",
        "launches": result["report"]["k1_launches"], "ok": True,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
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
