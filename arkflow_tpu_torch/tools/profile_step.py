"""Decompose the serving step of the slice on the card: where do the ms go?

    python -m arkflow_tpu_torch.tools.profile_step [--config FILE] [--trace DIR]
    python -m arkflow_tpu_torch.tools.profile_step --int8 [--stream] [--config FILE]
    python -m arkflow_tpu_torch.tools.profile_step --packed [--stream] [--config FILE]
    python -m arkflow_tpu_torch.tools.profile_step --generate [--stream] [--config FILE]
    python -m arkflow_tpu_torch.tools.profile_step --tensor [--config FILE]

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
  rate the dense layers could reach;
- ``modes``: the runner's own step, graphed (one CUDA graph per shape, the
  default) and eager (``eager=True``): ``host_ms`` (prep, prefetch and
  dispatch, nothing waited for), ``step_ms`` (dispatch plus fetch), and
  from a profiler window over a few steps ``device_ms``, ``busy_share`` and
  ``launches`` per step.

``--int8`` decomposes the int8 step the same way (default config
``arkflow_tpu_torch/examples/int8_bert_stream.json``: BERT-base, W8A8).

``--packed`` decomposes the packed step instead (default config
``arkflow_tpu_torch/examples/bert_packed_stream.json``), with the segment
kernel and with the pair-mask attention. It takes one emission of the
stream as the stream makes it (the generate batches through the
token-budget coalescer) and prints:

- ``host_ms``: per emission, the token estimates, tokenizing, packing and
  carving into windows;
- per window: ``step_ms`` (``infer_sync``), ``h2d_ms``, ``forward_ms`` and
  ``d2h_ms``;
- ``kernels``: a profiler window over one emission's forwards, with the
  segment kernel's share of the device time;
- ``modes``: the emission's steps through the runner, graphed and eager,
  as for the padded step (per emission).

``--generate`` decomposes the generation steps instead (default config
``arkflow_tpu_torch/examples/llama_generate_stream.json``: Llama-3-8B widths
and depth, random weights). It builds the config's ``gpu_generate``
processor and, with the paged kernel K3 and with the gather path, prints
for one lockstep decode step over every slot (ragged contexts up to the
server's ``max_seq``) and for one prefill chunk at offset 256:

- ``host_ms``: the step's dispatch (every launch issued, nothing waited
  for), and ``step_ms``: dispatch plus the fetch of its next tokens;
- ``device_ms``, ``busy_share`` and ``launches`` per step from a profiler
  window over a few steps issued back to back, ``k3_ms`` / ``k3_launches``:
  the paged kernels' share of them (a bf16 call launches the split kernel
  and its combine), and ``k3_calls``: the wrapper's calls per step;

each for the graphed steps (``mode``: one CUDA graph per step key, the
default) and the eager ones (a twin server on the same weights and pools,
``eager=True``).

``--tensor`` decomposes a tensor family's step instead (default config
``arkflow_tpu_torch/examples/vit_stream.json``: ViT-B/16;
``lstm_stream.json`` for the LSTM): for each batch bucket, on random
bytes scaled as ``tensor_field`` scales them, ``forward_ms``, ``kernels``
(the forward's device time by kernel name) and ``modes`` (the runner's
step graphed and eager).

``--stream`` also runs the config's whole stream through ``Engine`` under
the profiler, graphed and then eager (the processor's runner or server
swapped for its twin), and prints its traffic rows/s beside the device's
busy share of the traffic window (a low share means the host sets the
pace) and the runner's own ``duty_cycle()``.
``--stream-threads 1 2 4`` runs it once per worker count instead of the
config's ``thread_num``, to show how the workers contend on the host.

``--trace DIR`` also writes the chrome traces there. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import itertools

import numpy as np
import torch

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import NoopAck
from arkflow_tpu_torch.ops.ragged_attention import paged_flash_attention
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy, MicroBatchCoalescer
from arkflow_tpu_torch.tpu.extract import payload_token_estimates
from arkflow_tpu_torch.tpu.packing import carve_row_windows, pack_tokens
from arkflow_tpu_torch.tpu.runner import ModelRunner
from arkflow_tpu_torch.tpu.serving import GenerationServer
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
DEFAULT_CONFIG = os.path.join(EXAMPLES, "bert_stream.json")
PACKED_CONFIG = os.path.join(EXAMPLES, "bert_packed_stream.json")
INT8_CONFIG = os.path.join(EXAMPLES, "int8_bert_stream.json")
GENERATE_CONFIG = os.path.join(EXAMPLES, "llama_generate_stream.json")
TENSOR_CONFIG = os.path.join(EXAMPLES, "vit_stream.json")
#: K3's kernels in csrc/paged_attention.cu: the bf16 split kernel and its
#: combine, and the f32 FMA kernel
K3_KERNELS = ("paged_split_kernel", "paged_combine_kernel", "paged_attention_kernel")


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


def eager_twin(runner: ModelRunner) -> ModelRunner:
    """The same runner with graphs off (``eager=True``): its device params
    (already converted for serving), config, buckets and dispatch plane."""
    return ModelRunner(runner.family.name, dataclasses.asdict(runner.cfg),
                       buckets=runner.buckets, device=runner.device,
                       max_in_flight=runner.max_in_flight,
                       dispatch_depth=runner.dispatch_depth, host_params=runner.params,
                       packed=runner.packed, eager=True)


def server_twin(server: GenerationServer, eager: bool, params: dict | None = None,
                **overrides) -> GenerationServer:
    """A server on the same settings as ``server`` and on its weights, or on
    ``params`` (its own KV pools, no parity gate: ``server``'s ran),
    graphed or ``eager``."""
    kw = dict(slots=server.slots, page_size=server.page_size, num_pages=server.num_pages,
              max_seq=server.max_seq, eos_id=server.eos_id,
              prompt_buckets=server.prompt_buckets, prefill_chunk=server.prefill_chunk,
              decode_kernel=server.decode_kernel, dispatch_depth=server.dispatch_depth,
              record_margins=server.record_margins, temperature=server.temperature,
              top_k=server.top_k, seed=server.seed, check_top_k=server.check_top_k,
              speculative_tokens=server.speculative_tokens,
              prefix_cache_pages=server.prefix_cache_pages)
    return GenerationServer(server.params if params is None else params, server.cfg,
                            kernel_parity_check=False, eager=eager, **{**kw, **overrides})


def step_modes(runner: ModelRunner, batches: list[dict], steps: int) -> dict:
    """``batches`` (one step each, an emission's windows for the packed
    runner) through the runner's own step, graphed and eager: the host's
    dispatch (prep, prefetch, enqueue; nothing waited for), dispatch plus
    fetch, and a profiler window over ``steps`` rounds."""
    out = {}
    for mode, r in (("graphed", runner), ("eager", eager_twin(runner))):
        def dispatch(r=r):
            sets = []
            for inputs in batches:
                bufs, n = r._prep(inputs)
                r._to_device(bufs)
                r._enqueue(r._compiled, bufs)
                sets.append((bufs, n))
            return sets

        def fetch(sets, r=r):
            for bufs, n in sets:
                r._fetch(bufs, n)
                r._staging.release(bufs)

        def one_round():
            fetch(dispatch())

        one_round()  # the shapes' captures
        host, total = [], []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sets = dispatch()
            t1 = time.perf_counter()
            fetch(sets)
            host.append((t1 - t0) * 1e3)
            total.append((time.perf_counter() - t0) * 1e3)
        kernels = profile_forward(one_round, steps)
        out[mode] = {"host_ms": statistics.median(host), "step_ms": statistics.median(total),
                     "device_ms": kernels["device_ms_per_step"],
                     "busy_share": kernels["busy_share"],
                     "launches": kernels["launches_per_step"], "captures": r.captures}
    return out


def prep(runner: ModelRunner, inputs: dict) -> None:
    """The runner's host prep of one batch, its staging set recycled."""
    runner._staging.release(runner._prep(inputs)[0])


def host_ms(fn, iters: int = 5) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_forward(forward, steps: int, trace_path=None, match: tuple[str, ...] = ()) -> dict:
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
    return device_summary(prof, wall_ms, steps, trace_path, match)


def device_summary(prof, wall_ms: float, steps: int, trace_path=None,
                   match: tuple[str, ...] = ()) -> dict:
    """Per-step device time by kernel name (top 12), the busy share of a
    ``wall_ms`` window, and launches per step, from a profiler's events;
    with ``match``, also the ms and launches per step of the kernels whose
    name holds one of its strings."""
    by_name: dict[str, float] = defaultdict(float)
    launches = matched = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            by_name[ev.name] += ev.device_time / 1e3  # us -> ms
            launches += 1
            matched += any(m in ev.name for m in match)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"window_ms_per_step": wall_ms / steps, "device_ms_per_step": busy / steps,
           "busy_share": busy / wall_ms if wall_ms else 0.0,
           "launches_per_step": launches / steps,
           "top_ms_per_step": {name[:80]: ms / steps for name, ms in top}}
    if match:
        out["matched_ms_per_step"] = sum(ms for name, ms in by_name.items()
                                         if any(m in name for m in match)) / steps
        out["matched_launches_per_step"] = matched / steps
    return out


def first_emission(stream: dict) -> list[bytes]:
    """The texts of the stream's first emission, made as the stream makes
    them: generate batches into the token-budget coalescer until it pops."""
    inp, co = stream["input"], stream["buffer"]["coalesce"]
    payloads = [str(p).encode() for p in inp["payloads"]]
    coalescer = MicroBatchCoalescer(co["batch_buckets"], token_budget=co["token_budget"],
                                    max_row_tokens=co.get("max_row_tokens"))
    batch = MessageBatch.new_binary([payloads[i % len(payloads)]
                                     for i in range(inp["batch_size"])])
    while (emission := coalescer.pop_exact()) is None:
        coalescer.add(batch, NoopAck())
    return emission[0].to_binary()


def profile_packed(cfg: dict, args) -> None:
    stream = cfg["streams"][0]
    proc = stream["pipeline"]["processors"][0]
    texts = first_emission(stream)
    buckets = BucketPolicy.from_config(proc, max_seq=proc["max_seq"], default_example_scale=4)
    col = MessageBatch.new_binary(texts).column("__value__")
    co = stream["buffer"]["coalesce"]
    for packed_flash in (True, False):
        runner = ModelRunner(proc["model"], {**proc.get("model_config", {}),
                                             "packed_flash": packed_flash},
                             buckets=buckets, seed=proc.get("seed", 0), device="cuda",
                             serving_dtype=proc.get("serving_dtype"), packed=True)
        tok = HashTokenizer(runner.cfg.vocab_size)
        ids, mask = tok.encode_batch(texts, proc["max_seq"])
        lengths = mask.sum(axis=1).astype(np.int64)
        sb = buckets.seq_bucket(int(lengths.max()))
        pk = pack_tokens(ids, lengths, sb)
        windows = carve_row_windows(pk, buckets.max_batch(), buckets.max_examples(),
                                    buckets.batch_buckets)
        host = {
            "estimate": host_ms(lambda: payload_token_estimates(
                col, max_tokens=co.get("max_row_tokens"))),
            "tokenize": host_ms(lambda: tok.encode_batch(texts, proc["max_seq"])),
            "pack": host_ms(lambda: pack_tokens(ids, lengths, sb)),
            "carve": host_ms(lambda: carve_row_windows(
                pk, buckets.max_batch(), buckets.max_examples(), buckets.batch_buckets)),
        }
        per_window, forwards = [], []
        for inputs, _ in windows:
            padded = dict(runner._prep(inputs)[0].arrays)
            dev = {k: torch.from_numpy(v).cuda() for k, v in padded.items()}

            def forward(dev=dev):
                with torch.inference_mode():
                    return runner._apply(runner.params, runner.cfg, **dev)

            out = forward()
            forwards.append(forward)
            per_window.append({
                "rows": int(inputs["input_ids"].shape[0]),
                "examples": int(inputs["example_row"].shape[0]),
                "shape": list(padded["input_ids"].shape),
                "step_ms": cuda_ms(lambda inputs=inputs: runner.infer_sync(inputs)),
                "prep_ms": host_ms(lambda inputs=inputs: prep(runner, inputs)),
                "h2d_ms": cuda_ms(lambda padded=padded: [
                    torch.from_numpy(v).cuda() for v in padded.values()]),
                "forward_ms": cuda_ms(forward),
                "d2h_ms": cuda_ms(lambda out=out: [v.cpu() for v in out.values()]),
            })
        trace = (os.path.join(args.trace, f"profile_packed_{'kernel' if packed_flash else 'pair'}"
                              ".json") if args.trace else None)
        if trace:
            os.makedirs(args.trace, exist_ok=True)
        kernels = profile_forward(lambda: [f() for f in forwards], args.steps, trace)
        # K2 runs the attention tile (mma_tile_kernel for bf16,
        # flash_tile_kernel for f32), the only one in the packed step
        k2_ms = sum(ms for name, ms in kernels["top_ms_per_step"].items()
                    if "tile_kernel" in name)
        report = {
            "attention": "segment_kernel" if packed_flash else "pair_mask",
            "emission_texts": len(texts), "true_tokens": int(lengths.sum()),
            "packed_rows": pk.num_rows, "windows": len(windows),
            "token_fill": float((pk.segment_ids > 0).sum()) / sum(
                buckets.batch_bucket(w["rows"]) * sb for w in per_window),
            "host_ms": host, "per_window": per_window,
            "emission_step_ms": sum(w["step_ms"] for w in per_window),
            "emission_forward_ms": sum(w["forward_ms"] for w in per_window),
            "kernels": {**kernels, "segment_kernel_ms_per_emission": k2_ms},
            "modes": step_modes(runner, [w for w, _ in windows], args.steps),
        }
        print(json.dumps(report), flush=True)
        del runner, forwards
        torch.cuda.empty_cache()
    profile_streams(cfg, args)


def profile_generate(cfg: dict, args) -> None:
    from arkflow_tpu_torch.components import Resource
    from arkflow_tpu_torch.components.registry import build_component, ensure_plugins_loaded

    ensure_plugins_loaded()
    proc_cfg = cfg["streams"][0]["pipeline"]["processors"][0]
    server = build_component("processor", {**proc_cfg, "decode_kernel": "paged"},
                             Resource()).server
    s, p = server.slots, server.pages_per_slot
    table = (torch.randperm(server.num_pages - 1, generator=torch.Generator().manual_seed(3))
             + 1)[: s * p].reshape(s, p).numpy().astype(np.int32)
    lens = np.linspace(1, server.max_seq - 2, s).astype(np.int32)
    act = np.ones(s, bool)
    cur = torch.randint(3, server.cfg.vocab_size, (s,), generator=torch.Generator().manual_seed(7),
                        dtype=torch.int32).to(server.device)
    chunk = server.prefill_chunk or 128
    ids = np.random.default_rng(4).integers(3, server.cfg.vocab_size, (1, chunk)).astype(np.int32)
    eager = server_twin(server, eager=True)
    eager.k_pages, eager.v_pages = server.k_pages, server.v_pages  # the same context
    for (mode, srv), kernel in itertools.product((("graphed", server), ("eager", eager)),
                                                 ("paged", "gather")):
        srv.decode_kernel = kernel
        steps = {
            "decode": (lambda srv=srv: srv._decode(cur, lens, act, table),
                       {"slots": s, "mean_context": float(lens.mean() + 1)}),
            "chunk": (lambda srv=srv: srv._chunk(ids, 256, chunk, table[:1], True),
                      {"chunk": chunk, "offset": 256}),
        }
        for name, (dispatch, shape) in steps.items():
            host, total = [], []
            with torch.inference_mode():
                for i in range(12):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fetch = dispatch()
                    t1 = time.perf_counter()
                    fetch.wait()
                    if i >= 2:  # warmup
                        host.append((t1 - t0) * 1e3)
                        total.append((time.perf_counter() - t0) * 1e3)

                def back_to_back():
                    with torch.inference_mode():
                        return [dispatch() for _ in range(args.steps)][-1].wait()

                trace = (os.path.join(args.trace,
                                      f"profile_generate_{name}_{kernel}_{mode}.json")
                         if args.trace else None)
                if trace:
                    os.makedirs(args.trace, exist_ok=True)
                calls = paged_flash_attention.launches.value
                kernels = profile_forward(back_to_back, 1, trace, match=K3_KERNELS)
                calls = paged_flash_attention.launches.value - calls
            per = args.steps
            print(json.dumps({
                "step": name, "attention": kernel, "mode": mode, **shape,
                "layers": server.cfg.layers,
                "host_ms": statistics.median(host), "step_ms": statistics.median(total),
                "device_ms": kernels["device_ms_per_step"] / per,
                "busy_share": kernels["busy_share"],
                "launches": kernels["launches_per_step"] / per,
                "k3_ms": kernels["matched_ms_per_step"] / per,
                "k3_launches": kernels["matched_launches_per_step"] / per,
                "k3_calls": calls / (2 * per),  # back_to_back ran twice: warmup, then profiled
                "top_device_ms": {k: v / per for k, v in kernels["top_ms_per_step"].items()},
            }), flush=True)
    del server, eager
    torch.cuda.empty_cache()
    profile_streams(cfg, args)


def profile_tensor(cfg: dict, args) -> None:
    """``--tensor``: each batch bucket of a tensor example's runner."""
    proc = cfg["streams"][0]["pipeline"]["processors"][0]
    buckets = BucketPolicy.from_config(proc, max_seq=proc.get("max_seq", 128))
    runner = ModelRunner(proc["model"], proc.get("model_config"), buckets=buckets,
                         seed=proc.get("seed", 0), device="cuda",
                         serving_dtype=proc.get("serving_dtype"))
    (name, (_, trailing)), = runner.spec.items()
    rng = np.random.default_rng(0)
    for b in buckets.batch_buckets:
        x = rng.integers(0, 256, (b, *trailing), dtype=np.uint8) / np.float32(255.0)
        dev = {name: torch.from_numpy(x).cuda()}

        def forward():
            with torch.inference_mode():
                return runner.family.apply(runner.params, runner.cfg, **dev)

        trace = (os.path.join(args.trace, f"profile_step_{proc['model']}_{b}.json")
                 if args.trace else None)
        if trace:
            os.makedirs(args.trace, exist_ok=True)
        print(json.dumps({"model": proc["model"], "bucket": b, "shape": list(x.shape),
                          "forward_ms": cuda_ms(forward),
                          "kernels": profile_forward(forward, args.steps, trace),
                          "modes": step_modes(runner, [{name: x}], args.steps)}), flush=True)


def profile_streams(cfg: dict, args) -> None:
    if not (args.stream or args.stream_threads):
        return
    for threads, mode in itertools.product(args.stream_threads or [None], ("graphed", "eager")):
        if threads is not None:
            cfg["streams"][0]["pipeline"]["thread_num"] = threads
        report = profile_stream(cfg, args.trace, eager=mode == "eager")
        print(json.dumps({"thread_num": cfg["streams"][0]["pipeline"]["thread_num"],
                          "mode": mode, **report}), flush=True)


def profile_stream(cfg: dict, trace_dir=None, eager: bool = False) -> dict:
    """The config's stream through ``Engine`` under the profiler: traffic
    rows/s and the device's busy share of the traffic window (warmup
    excluded: the window opens at the stream's first read). ``eager``: the
    processor's runner (or server) swapped for its eager twin first."""
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    from arkflow_tpu_torch.config import EngineConfig
    from arkflow_tpu_torch.runtime.engine import Engine

    engine = Engine(EngineConfig.from_mapping(cfg))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    if eager and getattr(proc, "server", None) is not None:
        proc.server = proc.runner = server_twin(proc.server, eager=True)
    elif eager:
        proc.runner = eager_twin(proc.runner)
    # device activity only: recording every host op would slow the host
    # side this measures
    prof = profile(activities=[ProfilerActivity.CUDA])
    started = {}
    inner_connect = stream.output.connect

    async def connect_then_profile():
        # the output connects last, after the warmup: traffic starts here
        await inner_connect()
        torch.cuda.synchronize()
        prof.start()
        started["t"] = time.perf_counter()

    stream.output.connect = connect_then_profile
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started["t"]) * 1e3
    prof.stop()
    runner = stream.pipeline.processors[0].runner
    if hasattr(runner, "device_steps"):
        steps = {"device_steps": runner.device_steps}
    else:  # a generation server
        steps = {"decode_steps": runner.decode_steps, "chunk_steps": runner.chunk_steps,
                 "prefill_steps": runner.prefill_steps, "tokens": runner.tokens,
                 "traffic_tokens_per_s": runner.tokens / stream.traffic_seconds}
    trace = os.path.join(trace_dir, "profile_stream.json") if trace_dir else None
    summary = device_summary(prof, wall_ms, 1, trace)
    return {"stream": stream.name, "rows_out": stream.rows_out, "errors": stream.errors,
            "traffic_seconds": stream.traffic_seconds,
            "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds, **steps,
            "window_ms": wall_ms, "device_busy_ms": summary["device_ms_per_step"],
            "device_busy_share": summary["busy_share"],
            "launches": summary["launches_per_step"], "duty_cycle": runner.duty_cycle(),
            "top_device_ms": summary["top_ms_per_step"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--trace", default=None, help="directory for chrome traces")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--packed", action="store_true", help="decompose the packed step")
    ap.add_argument("--int8", action="store_true",
                    help="decompose the int8 step (default config: the int8 stream)")
    ap.add_argument("--generate", action="store_true",
                    help="decompose the generation decode and chunk steps")
    ap.add_argument("--tensor", action="store_true",
                    help="decompose a tensor family's step (default config: the ViT stream)")
    ap.add_argument("--stream", action="store_true",
                    help="also run the config's stream under the profiler")
    ap.add_argument("--stream-threads", type=int, nargs="*", default=None,
                    help="run the stream once per worker count")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    default = (GENERATE_CONFIG if args.generate else PACKED_CONFIG if args.packed
               else INT8_CONFIG if args.int8 else TENSOR_CONFIG if args.tensor
               else DEFAULT_CONFIG)
    with open(args.config or default) as f:
        cfg = json.load(f)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__}))
    if args.generate:
        profile_generate(cfg, args)
        return 0
    if args.packed:
        profile_packed(cfg, args)
        return 0
    if args.tensor:
        profile_tensor(cfg, args)
        return 0
    stream = cfg["streams"][0]
    proc = stream["pipeline"]["processors"][0]
    rows = stream["input"]["batch_size"]
    payloads = [str(p).encode() for p in stream["input"]["payloads"]]
    texts = [payloads[i % len(payloads)] for i in range(rows)]
    buckets = BucketPolicy.from_config(proc, max_seq=proc.get("max_seq", 128))

    for flash in (True, False):
        runner = ModelRunner(proc["model"], {**proc.get("model_config", {}),
                                             "use_flash_attention": flash},
                             buckets=buckets, seed=proc.get("seed", 0), device="cuda",
                             serving_dtype=proc.get("serving_dtype"))
        tok = HashTokenizer(runner.cfg.vocab_size)
        ids, mask = tok.encode_batch(texts, proc["max_seq"])
        sb = buckets.seq_bucket(int(mask.sum(1).max()))
        inputs = {"input_ids": ids[:, :sb], "attention_mask": mask[:, :sb]}
        padded = dict(runner._prep(inputs)[0].arrays)
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
                        "prep": host_ms(lambda: prep(runner, inputs))},
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
        report["serving_dtype"] = proc.get("serving_dtype")
        report["modes"] = step_modes(runner, [inputs], args.steps)
        print(json.dumps(report), flush=True)
        del runner, dev
        torch.cuda.empty_cache()
    profile_streams(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
