"""Decompose the serving step of the slice on the card: where do the ms go?

    python -m arkflow_tpu_torch.tools.profile_step [--config FILE] [--trace DIR]

Builds the runner of the config's ``gpu_inference`` processor (default
``arkflow_tpu_torch/examples/bert_stream.json``: BERT-base, bf16) on CUDA and
takes one batch of the config's generate input (its payload mix rotated over
``batch_size`` rows). Then, with the ragged kernel and with the plain
attention, it prints one JSON line each of:

- ``step_ms``: ``ModelRunner.infer_sync`` (pad, host->device, forward,
  device->host), and ``forward_ms``: the model alone on device tensors,
  both medians of CUDA-event timings;
- ``host_ms``: tokenizing the batch and the runner's host prep;
- ``kernels``: a ``torch.profiler`` window over a few forwards -- device
  time per step by kernel name (top 12), the device's busy share of the
  window, and the number of kernel launches per step;
- ``matmul_ref_ms``: one bf16 matmul doing the forward's dense flops, the
  rate the dense layers could reach.

``--trace DIR`` also writes the chrome traces there. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.runner import ModelRunner
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "examples", "bert_stream.json")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters: int = 5) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_forward(forward, steps: int, trace_path=None) -> dict:
    """Device time by kernel name over ``steps`` forwards, and the busy
    share of the profiled window."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = defaultdict(float)
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            by_name[ev.name] += ev.device_time / 1e3  # us -> ms
            launches += 1
    if trace_path:
        prof.export_chrome_trace(trace_path)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ms_per_step": wall_ms / steps, "device_ms_per_step": busy / steps,
            "busy_share": busy / wall_ms if wall_ms else 0.0,
            "launches_per_step": launches / steps,
            "top_ms_per_step": {name[:80]: ms / steps for name, ms in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--trace", default=None, help="directory for chrome traces")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.config) as f:
        cfg = json.load(f)
    stream = cfg["streams"][0]
    proc = stream["pipeline"]["processors"][0]
    rows = stream["input"]["batch_size"]
    payloads = [str(p).encode() for p in stream["input"]["payloads"]]
    texts = [payloads[i % len(payloads)] for i in range(rows)]
    buckets = BucketPolicy.from_config(proc, max_seq=proc.get("max_seq", 128))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__}))

    for flash in (True, False):
        runner = ModelRunner(proc["model"], {**proc.get("model_config", {}),
                                             "use_flash_attention": flash},
                             buckets=buckets, seed=proc.get("seed", 0), device="cuda",
                             serving_dtype=proc.get("serving_dtype"))
        tok = HashTokenizer(runner.cfg.vocab_size)
        ids, mask = tok.encode_batch(texts, proc["max_seq"])
        sb = buckets.seq_bucket(int(mask.sum(1).max()))
        inputs = {"input_ids": ids[:, :sb], "attention_mask": mask[:, :sb]}
        padded, _ = runner._prep(inputs)
        dev = {k: torch.from_numpy(v).cuda() for k, v in padded.items()}

        def forward():
            with torch.inference_mode():
                return runner.family.apply(runner.params, runner.cfg, **dev)

        trace = (os.path.join(args.trace, f"profile_step_{'kernel' if flash else 'plain'}.json")
                 if args.trace else None)
        if trace:
            os.makedirs(args.trace, exist_ok=True)
        report = {
            "attention": "ragged_kernel" if flash else "plain", "rows": rows,
            "shape": list(padded["input_ids"].shape),
            "true_tokens": int(mask.sum()),
            "step_ms": cuda_ms(lambda: runner.infer_sync(inputs)),
            "forward_ms": cuda_ms(forward),
            "host_ms": {"tokenize": host_ms(lambda: tok.encode_batch(texts, proc["max_seq"])),
                        "prep": host_ms(lambda: runner._prep(inputs))},
            "kernels": profile_forward(forward, args.steps, trace),
        }
        c = runner.cfg
        b, s = padded["input_ids"].shape
        dense_flops = 2 * b * s * c.layers * (4 * c.hidden * c.hidden + 2 * c.hidden * c.ffn)
        a = torch.randn(b * s, c.hidden, device="cuda", dtype=torch.bfloat16)
        w = torch.randn(c.hidden, dense_flops // (2 * b * s * c.hidden), device="cuda",
                        dtype=torch.bfloat16)
        report["matmul_ref_ms"] = cuda_ms(lambda: a @ w)
        report["dense_gflop"] = dense_flops / 1e9
        print(json.dumps(report), flush=True)
        del runner, dev
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
