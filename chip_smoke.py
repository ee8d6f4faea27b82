#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero before the
last line):

1. the card's identity (nvidia-smi name and power limit, torch's name);
2. building every CUDA kernel of the paths from ``arkflow_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. K1, K2 and K4 against their plain versions at the tiles' edges (every
   head dim in bf16 and f32, S off the tile grid, lengths 0/1/S, causal,
   unsorted segment ids); then each kernel against its plain PyTorch
   version at BERT-base shapes, with its time, the plain version's, one
   PyTorch library call's (each as the device's own time, from a CUDA
   graph of many calls, and as one eager call timed by CUDA events) and
   the bound:
   K1 (ragged) on random lengths, K2 (segment) on packed layouts, and K2 at
   head dim 128 (the tensor-core tile's dynamic shared memory). Every K1,
   K2 and K4 case checks the variant its launch ran: ``mma`` (the bf16
   tensor-core tile) for bf16, ``fma`` for f32. Beside the 1/64 ceiling
   against the plain version, every bf16 output element is held to a limit
   scaled to its size and its row (``tile_err_ratio``) against
   ``emulate_mma_tile``, the plain version with the tile's rounding (P in
   bf16 over its key tiles);
4. K4 (dense flash attention) through its entry point
   ``arkflow_tpu_torch.ops.flash_attention``, once at each case's shape with
   the counts read around those calls (no other kernel may launch, and tiles
   that do not divide S raise before a launch); then each case against the
   plain version: the padded BERT-base step with every row full, Llama-3-8B's
   full-sequence forward at 512 and at 4096 tokens (causal), and the last in
   f32; and K1 with every length S at the BERT shape beside it;
5. the padded stream ``arkflow_tpu_torch/examples/bert_stream.json``
   (generate -> gpu_inference(bert_classifier, full BERT-base width, bf16)
   -> drop) through the port's ``Engine``, with the launch counts read
   around that run only; every step is a replay of one CUDA graph per
   shape key (``tpu/compiled_step.py``), captured at the processor's
   warmup, and the exact counts hold under replay. Then the same stream
   with the runner's eager twin (``eager=True``, same weights) for the
   A/B; every captured key's graph against the eager twin on random
   inputs of that shape (``graphs padded``: 0 differing elements, the
   captures, ``memory_reserved`` around them); then the K1 path's outputs
   against the plain attention's on a few hundred rows;
6. the packed stream ``arkflow_tpu_torch/examples/bert_packed_stream.json``
   (generate -> memory buffer with token-budget coalescing ->
   gpu_inference(packing, BERT-base, bf16) -> drop) through ``Engine``:
   every row in order, K2 launches = layers x packed steps, no K1 launch,
   the packed steps' token fill; the eager run and ``graphs packed`` as
   for the padded stream (18 keys); then K2 at the stream's own layout, and
   the same texts through the packed K2 path, the packed pair-mask path and
   the padded K1 path, whose outputs must agree (every K1 and K2 launch of
   the three BERT streams must be ``mma``); then the shape tuner
   (``arkflow_tpu_torch/examples/bert_adaptive_stream.json``, the packed
   BERT-base stream at max_seq 128 with the ``tuner`` block) over 16384
   seeded texts, 8192 of 8-24 tokens then 8192 of 60-120, static (the block
   removed) and tuned (cycles forced by ``POST /admin/tune`` on the health
   port, a commit after the short half, then a ``probe_fail`` rollback
   answering 409 and a commit in the long half, each cycle's warm captures
   and flip running between live replays): every row in order in both,
   K2 launches = layers x packed steps, 0 captures on the path after
   warmup, the tuned labels equal to the static run's on tie-free rows and
   the logits within 1/64; rows/s and the capacity-weighted padding waste
   of both beside the planner's prediction, the warm captures' ms, the
   graph counts and ``memory_reserved`` around each cycle; then K1 and K2
   at two minted seq buckets off the tile's 16-row grid and one off its
   64-key tile (from the run's proposals and the padded planner on the
   same snapshots), beside the next pow2 bucket, held per element to
   ``emulate_mma_tile`` (the ``tuner stream``, ``tuner cycles``, ``tuner
   outputs`` and ``tuner`` lines);
   the delivery phase, run between the packed stream and the tuner
   (``arkflow_tpu_torch/examples/bert_delivery_stream.json``:
   the packed stream behind a redelivering ``fault`` input over a
   ``memory`` source of one text a message, with one disconnect whose
   first reconnect probe fails, a processor fault failing every batch
   holding ``poison``, an output whose writes 5-7 fail under its retry and
   circuit breaker, ``max_delivery_attempts`` 3 and an ``error_output``)
   over ``DELIVERY_TEXTS`` (2048) seeded texts, ``DELIVERY_POISON`` (2) of
   them poisoned, graphed, beside a fault-free run of the same texts
   without the markers or faults: every clean row delivered exactly once,
   each poison row quarantined alone with ``delivery_attempts`` 3, no
   quarantine drop, 3 output retries, one breaker trip and the breaker
   closed, one reconnect after one failed probe, no delivery outstanding
   and no suspect left at EOF, labels equal to the fault-free run's on
   tie-free rows and logits within 1/64, K2 = layers x packed steps (all
   ``mma``, no K1) and 0 captures after warmup in both runs; the cost of a
   poison record (solo emissions, their steps and token fill, rows/s of
   both runs); then ``chaos_stream.json`` through the CLI (each healthy
   row printed once, the poison row once) and through ``Engine`` with JAX's
   example's counts (the ``delivery``, ``delivery cost`` and ``chaos
   example`` lines); the host-only ``sql`` phase (after the json phase):
   BASELINE config 1 (``generate_example.json``: generate -> json_to_arrow
   -> sql -> arrow_to_json) as written, then over ``SQL_MIX_ROWS`` (4096)
   seeded readings; exactly the rows with ``value > 10``, in order, with
   ``fahrenheit`` as float64 computes it, no kernel launched (``sql stream``
   and ``sql`` lines); the json phase, run right after the packed stream on
   the padded and packed streams' runners: ``bert_json_stream.json``
   (generate of ``{"id", "text"}`` JSON rows -> memory buffer with
   token-budget coalescing -> json_to_arrow -> gpu_inference(packing,
   ``text_field: text``) -> arrow_to_json(id, label, score)) over
   ``JSON_PACKED_ROWS`` (4096) rows, K2 = layers x packed steps, all
   ``mma``; ``bert_window_json_stream.json`` (a memory input with the json
   codec, ``JSON_WINDOW_ROWS`` (2048) messages -> tumbling_window 20ms ->
   gpu_inference padded -> arrow_to_json), K1 = layers x steps, all
   ``mma``, the windows' sizes; in both every payload an object of exactly
   id, label and score, every row once and in order, each label and score
   that of the same text through the padded runner (scores within 1/64,
   labels on tie-free rows); after the LSTM phase, its stream fed JSON
   ``window`` lists through a memory input with the json codec
   (``LSTM_JSON_WINDOWS``, 1024) and arrow_to_json(score) on its graphed
   runner, every score the raw-bytes run's at the float32 floor; rows/s
   of each beside the raw stream's (the ``json stream``, ``json rows``,
   ``json lstm`` and ``json`` lines; the protobuf codec is not driven:
   the card's machine has no protoc);
7. the int8 stream ``arkflow_tpu_torch/examples/int8_bert_stream.json``
   (generate -> memory buffer -> gpu_inference(BERT-base, serving_dtype
   int8) -> drop) through ``Engine``, and the same config at bfloat16: every
   row in order, K1 launches = layers x steps, int8 products = dense layers
   x steps (none at bf16); the int8 stream's eager run and ``graphs
   int8``; then int8 against bf16 on the same texts (labels
   equal wherever the bf16 top-2 gap exceeds twice the largest logit
   difference), their step times, and the int8 product against the bf16 one
   at BERT-base's FFN shape;
8. the lifecycle phase (BERT-base, bf16; the seed-0 and seed-1 init trees
   saved as port checkpoints in a temporary directory):
   the self-healing stream ``arkflow_tpu_torch/examples/bert_lifecycle_stream.json``
   (a redelivering fault input over 2048 rows; the 5th step hung 3 s past
   its 1 s deadline, the 9th out of memory; golden probes every second,
   digests every 2 s), with the counts zeroed after the build: every row
   delivered, exactly one nacked and redelivered batch, one miss, one rebuild (the
   graphs captured again), one OOM capping the 64-row bucket, HEALTHY at
   the end, every integrity probe passing, K1 = 12 x the runner's steps
   (probes, golden and recapture steps included), all ``mma``; then on
   that runner a bitflip and an ``sdc`` fault, each caught by the monitor
   (digest drift, a failing golden probe through the graphed step),
   quarantined, repaired, the outputs back bit for bit, with the digest
   pass and golden probe times; then a hot swap through the health
   server's ``POST /admin/swap`` while a stream runs, on the padded, the
   packed (K2) and the int8 runner: the seed-1 swap answers 200 with
   version 1, a fixed 256-row batch then equals an ``eager=True`` runner
   on the seed-1 weights (0 differing elements), the live tensors kept
   their addresses and no graph was captured again; ``swap_corrupt`` (and
   on the padded runner ``swap_crash``) answer 409 and the outputs stay bit
   for bit; then a real allocator OOM in a child process (``--oom-child``:
   the memory fraction capped halfway through the top bucket's capture
   growth): the failed capture leaves no entry, the grid is capped, the
   batch is split and delivered, the child exits 0; then the cost of the
   lifecycle keys: the plain padded stream, the lifecycle stream without
   faults and the plain one again, ``COST_ROWS`` rows each (several digest
   periods), with the digest passes and golden probes timed where the
   monitor calls them; and the ``lifecycle`` line. Every health server
   binds port 0 (a free port, read back from ``Engine.health_port``);
9. K3 (paged) against its plain version where its splits and folds have
   edges (both head dims in bf16 and f32, GQA groups 1 to 8, decode and
   chunk folds, pages that straddle a split, padded chunk queries past the
   table); then at Llama-3-8B width (32 heads, 8 KV heads, head dim 128,
   page 16, 40 pages a row): decode (16 rows, one query, ragged contexts
   on shuffled page tables), the same with every page past each row's
   bound and the scratch page poisoned (the output must not change), the
   same in f32 (the FMA body), and 128-query chunks at offsets
   0/128/256/384, each timed; then the forms speculative decoding and the
   prefix cache give it (``K3 verify cases``): C = 4 over 8 slots at
   offsets 0/15/16/63/64/500/256/636, the same over tables whose rows
   share their first 6 pages, and a 128-query chunk from a cached
   boundary over shared pages. Every bf16 case must run the split-context
   tensor-core body (``mma``) and is held per element to
   ``emulate_paged_split``, the plain version with that body's splits,
   softmax tiles and P rounded to bf16;
10. the generate stream ``arkflow_tpu_torch/examples/llama_generate_stream.json``
   (generate -> gpu_generate(decoder_lm, Llama-3-8B widths and depth,
   continuous batching on paged KV, chunked prefill, dispatch depth 2) ->
   drop) through ``Engine``: every row in order, at most max_new_tokens
   each, K3 launches = layers x (decode + chunk steps), every one on the
   tensor-core body, no page leaked (the counts zeroed when the output
   connects, after the processor captured the decode, chunk and prefill
   graphs); then the graphed and eager decode and chunk step times, in
   turns, and the same prompts through a paged and a gather
   server at depth 1 (streams equal up to the first near-tie) and a paged
   server at depth 2 (equal to depth 1), and one decode step's logits:
   K3's no further from the gather path's or its plain version's than
   those two lie from each other, plus 1/64; then ``graphs generate``:
   every step key (decode, chunk, each one-shot prefill bucket; paged and
   gather) of a graphed server against an eager twin on the same weights,
   pools and inputs, 0 differing elements in next tokens and top-2 gaps;
   then the generate stream's first ``GENERATE_EAGER_ROWS`` (24) rows
   again with an eager twin server, for the A/B;
11. the generate lifecycle phase (``llama_lifecycle_stream.json``: the
    generate stream of step 10 behind a redelivering ``fault`` input, with
    ``step_deadline`` 1 s, ``health``, ``swap`` and ``integrity``, at
    Llama-3-8B widths and depth): the stream without faults (the yardstick
    and the cost), then with them (a step hung 3 s past its deadline, one
    out of memory): every row in order, the nacked batches redelivered,
    exactly one miss, one rebuild over new pools (another ``data_ptr``) and
    one failed OOM step, HEALTHY with no zombie at the end, no page leaked,
    K3 launches = layers x (decode + chunk steps run on the card, recapture
    and abandoned steps included), all ``mma``, and every row's ids equal
    to the fault-free run's up to its first near-tie (``generate lifecycle
    stream``); then on an idle stream with its health server, at full
    width and ``GEN_SWAP_LAYERS`` (2) layers, a seed-1 checkpoint (3.0 GB,
    written to a temporary directory under ``checkpoints/`` and removed)
    swapped in through ``POST /admin/swap``
    while four clients keep requests in flight: none dropped, the streams
    after it equal an ``eager=True`` server on the seed-1 weights bit for
    bit, the live addresses and captures kept, the pools zero and every
    page free at the flip, a ``swap_corrupt`` swap rolled back (``generate
    lifecycle swap``: stage ms, peak memory); then a ``bitflip`` quarantined
    (``/readiness`` 503), repaired from the host copy and the streams back
    bit for bit (``generate lifecycle integrity``: digest pass, golden probe,
    golden margin); and ``generate lifecycle cost``: the fault-free
    lifecycle stream's tokens/s and TTFT beside the generate stream's of
    step 10 (same rows);
12. the generation features: the serving stream
    ``llama_serving_stream.json`` (8 slots, chunk 128, speculative 3,
    prefix cache 64 pages; ``SERVING_ROWS`` (16) rows behind one 96-token
    instruction) graphed: rows in order, the pages still held are the cache's alone,
    K3 = layers x (chunk + verify steps), all ``mma``, hits, reused pages,
    evictions, drafts and accepted drafts reported; its rows against a
    server with both features off, equal up to each row's first near-tie;
    ``graphs serving`` (the verify key's graph against eager); the stream
    eager. ``sampling``: the generate stream at temperature 0.8, top-k 50,
    depth 1, with the in-graph top-k check (0 misses); then on 16 prompts
    two graphed runs from one seed equal, eager equal to them, top-k 1
    equal to greedy up to the first exact tie. ``batch generate``:
    ``llama_batch_stream.json`` (``serving`` absent: batch mode, buckets 4
    and 16, 256 + 64 positions): rows in order, every generation replayed
    on an ``eager=True`` generator bit for bit, the ms per step of one
    generation graphed and eager, rows against the continuous server up to
    the first near-tie (padded rows up to their second token: the
    reference's mask lets them attend padding after it), no kernel
    launched; ``batch swap``: at full width and 4 layers, a seed-1 swap
    served bit for bit as a processor built on it, a ``swap_crash``
    rolled back;
13. the MoE phase (``llama_moe_stream.json``: the generate stream with a
    Switch MoE at Llama-3-8B widths, 8 experts, depth 1, its 16 layers cut
    to ``MOE_LAYERS`` (2); the dense models freed first, the peak memory
    read from the phase's start): the stream graphed through ``Engine``
    with the generate stream's checks (K3 = 4 x (decode + chunk steps),
    all ``mma``, the
    parity gate passed with the routing held), its step times against the
    bound of reading every expert, ``graphs moe``, a padded chunk's logits
    finite through K3, greedy streams of a graphed and an eager server
    equal bit for bit, K3 against the gather path with the expert routing
    held (``decoder.RoutingTrace``) up to the first near-tie plus the
    first decode step's yardstick rule, one ``serving: batch`` bucket
    graphed against eager, the stream eager, and the ``moe`` line;
14. model import and the tensor families. ``hf_import``: the padded
    stream's tree (step 5), a Llama-3-8B-width tree of ``HF_LLAMA_LAYERS``
    (2) layers drawn on the card and the ViT-B/16 tree exported into
    HuggingFace names and layouts as bf16 state dicts (the inverse maps are
    here, apart from the package's), imported by ``from_hf_state_dict``
    into float32 trees, every leaf equal to the original's bits, then
    served beside the original: BERT logits through ``ModelRunner`` (K1),
    greedy streams of 8 generate-stream prompts x 32 new tokens through
    ``GenerationServer`` (K3) and ViT embeddings, each bit for bit; the
    decoder import refuses MoE. ``tokenizer`` (after step 5):
    ``build_tokenizer("bert-base-uncased")`` as this machine resolves it
    (no ``transformers`` or no local files: the hashing tokenizer), and the
    padded stream with ``tokenizer:`` set giving the labels it gives
    without. ``vit``: ``vit_stream.json`` at ViT-B/16 (224 x 224 x 3) with
    2048 images of random bytes as the generate source's payloads, graphed
    then eager: images/s, each bucket's step against its bound, peak
    reserved memory; every image through the processor graphed and eager,
    equal bit for bit, and a sample held to the CPU plain path at the bf16
    floor. ``lstm``: ``lstm_stream.json`` (float32, TF32 off) with windows
    from a seed, one an outlier: windows/s, each bucket's step graphed and
    eager, graphed = eager, every score held to a CPU float32 run at
    1e-5, the outlier scoring highest;
15. the brokers phase: the eight broker examples through ``Engine`` against
    ``tools/fake_brokers.py`` (driven by ``tools/broker_streams.py``), each
    on a runner its phase keeps warm, its seconds carved out of that phase
    into ``phases.brokers``. After the json phase, ``kafka_bert_kafka.json``
    on the padded runner: ``BROKER_TEXTS`` (3072) texts produced into 4
    partitions (gzip, snappy, lz4, none) before the run; every id once in
    the output topic, the group's committed offsets at each log end, its
    generation unchanged, every label and score held to the padded runner
    (``check_json_rows``), each record keyed by its label (config 2's
    ``{expr: ...}`` key) on the partition that key hashes to, K1 = layers x
    steps, all ``mma``, 0 captures, the host ``crc32c`` timed over the
    stream's produces. After the batch
    generate stream, ``cdc_llm_nats.json`` on that stream's processor: its
    first ``CDC_PROMPTS`` (16) rows, every summary once on the subject and
    held to the continuous server's streams up to the first near-tie. After
    the ViT phase, ``http_vit_redis.json``: ``HTTP_IMAGES`` (256) images
    POSTed on one keep-alive connection, each 200, one more 429, the Redis
    list equal bit for bit to the processor on the stream's own batches.
    After the LSTM phase, ``mqtt_lstm_anomaly.json``: ``MQTT_WINDOWS``
    (1024) JSON windows at QoS 1, every 8th scaled by 30; the example's
    ``remap`` keeps exactly the rows scoring above 0.5, each score equal bit
    for bit to the runner's on the stream's own batches and each alert
    Arrow's text of ``round(score, 3)``. The other directions, after the Kafka stream:
    ``nats_bert_mqtt.json`` on the packed runner (``NATS_TEXTS`` (2048)
    JetStream rows pulled 64 at a time; every id once at a QoS 1 MQTT
    subscriber, the consumer's ack floor at the last sequence with no
    redelivery, labels and scores bit for bit the packed runner's on the
    stream's own emissions and held to the padded runner, K2 all ``mma``, 0
    captures), ``ws_redis_bert_http.json`` on the padded runner (a
    websocket and a Redis subscribe child, ``FANIN_TEXTS`` (256) texts each,
    each message its own batch; every id once at the HTTP sink, the bearer
    on every request, labels and scores bit for bit the runner's at the same
    shape, K1 all ``mma``) and ``modbus_influx.json`` (``MODBUS_POLLS``
    (64) polls at 10 ms, host only; every line ``encode_lines`` of the
    values served); after the LSTM's MQTT stream, ``redis_lstm_influx.json``
    (``REDIS_WINDOWS`` (1024) windows on two list keys, the sink's first
    write answered 500: exactly one retry, scores bit for bit the runner's
    on the stream's own batches). The ``brokers kafka|nats|fanin|modbus|
    cdc|http|mqtt|redis`` lines and the ``brokers`` line: each stream's
    rows/s beside its raw stream's, the host CRC's cost;
16. the ``overload`` phase (``run_overload``, ``phases.overload``), after
    the Modbus stream on the padded runner, before it is released. ``overload
    burst``: ``overload_stream.json`` with ``gpu_inference`` (the padded
    runner, swapped in) in place of its latency stand-in, two long texts,
    the example's 4x burst, 2 rows a read every ``OVERLOAD_INTERVAL`` (1 ms);
    first with ``overload: false`` (the control, ``OVERLOAD_CONTROL_ROWS``),
    then the example's controller (``OVERLOAD_ROWS``). Each batch the input hands out is stamped with an
    ``offer`` id. Exact: offered = delivered + shed in batches and rows,
    each offer once; every shed batch in error_output tagged ``overloaded``
    with a reason of ``SHED_REASONS``; the ``arkflow_shed_total`` deltas =
    the tagged counts by reason; labels and logits held to the padded
    runner; K1 = 12 x steps, all ``mma``, 0 captures; offered rows/s >= 1.5x
    the control's sustained rows/s; delivered p99 e2e <= 2x the deadline.
    ``overload tenants``: the multitenant example's buffer, pipeline and
    processor (response cache on) with ``generate`` of 3 tenants
    (``TENANT_ROWS``, 5 rows every 3 ms), ``tenant0`` at weight 8,
    ``tenant1`` at 50 rows/s: no emission mixes tenants, quota sheds on
    ``tenant1`` alone and counted, offered = delivered + shed per tenant,
    the quiet tenants' delivered p99 within the deadline; 16 concurrent
    identical batches through the cached processor: one device step, K1 =
    12, bitwise-equal outputs; then the example as written (HTTP with
    ``tenant_header``), about 100 POSTs (``TENANT_POSTS``) on keep-alive
    connections: each
    request's batch stamped with its tenant, every 429 ``free``'s with
    ``Retry-After`` = ceil of its bucket's wait (at least 1), every 200
    delivered or in error_output. ``overload restart``: ``RESTART_TEXTS``
    texts through a memory input under a crash at its third read,
    BERT-base on a one-bucket grid, ``restart: {max_retries: 3, backoff:
    10ms}``, through ``Engine`` with its health server on port 0, beside a
    crash-free run: the crash once, ``/health`` ``restarts`` 1 and
    ``restart_budget_remaining`` 2, every text delivered, the rebuilt
    stream's outputs = the crash-free run's bit for bit, K1 = 12 x steps of
    both runners, the crashed runner released, ``memory_reserved`` after
    the engine within one runner's footprint of before; the rebuild's ms.
    ``overload generate restart``: the same for ``gpu_generate``
    (``llama_generate_stream.json``'s processor at ``GEN_RESTART_LAYERS``
    (2) layers of Llama-3-8B widths, 4 slots, ``GEN_RESTART_PROMPTS`` (8)
    prompts): every prompt delivered, the rebuilt texts = the crash-free
    run's, the crashed server's weights, KV pools, graphs and host sets
    released, K3 launched, ``memory_reserved`` back within one server.
    The ``overload`` line sums them;
17. the ``obs`` part, after every other phase, on the Kafka stream's
    padded runner (kept for it), texts and fake broker (``run_obs``,
    ``phases.obs``; last, because a profile capture leaves CUPTI's
    callbacks installed and every later eager launch of the process would
    pay for them):
    ``kafka_bert_kafka.json`` through ``Engine`` with its health server on
    a loopback port 0 and ``profiling_dir`` in a temp dir, three times:
    traced (tracing as configured by default; ``POST /debug/profile?
    seconds=1`` during the traffic, then ``GET /metrics`` and ``GET
    /trace``), untraced (``tracing: {enabled: false}``) and traced again
    (no capture). The ``obs`` line: p50/p99 end-to-end latency per batch
    from ``arkflow_e2e_seconds``'s bucket deltas and from the traces'
    ``e2e_ms``; rows/s of the three runs; the stage breakdown; the device
    busy share (``arkflow_tpu_device_busy_seconds_total`` over the traffic
    seconds); what the profile held (device events, kernels by name, graph
    launches). Exact: the exposition parses line by line, every histogram
    cumulative with ``_count`` its ``+Inf`` bucket; rows in and out 3072 on
    the stream's label; batches out = the e2e count; ``arkflow_tpu_rows_total``
    3072; the infer count = the steps, K1 = 12 x steps all ``mma``; no
    process or write error; every traced batch's stages (``queue_wait``,
    ``process``, ``infeed_prep``, a device step, ``output_write``, and
    ``input_decode`` in it or in the sources its ``coalesce_wait`` links);
    root spans after the ingest stamp within the trace's e2e + 1 ms
    (``input_decode`` times the read, before the stamp); device events in
    the profile; no trace committed untraced; every output of the three
    runs the same bytes. Around every continuous generate stream, the
    ``arkflow_gen_tokens_total`` delta = the stream's tokens and the
    ``arkflow_gen_ttft_seconds`` count delta = its rows (``gen_metrics``);
18. the ``graphs`` line (per path: captures, keys checked, differing
    elements, ``memory_reserved`` before and after the captures) and the
    ``ab`` line (per stream, graphed and eager: traffic rows/s, or tokens/s,
    TTFT p50/p99 and traffic ms per decode step, and the runner's
    ``duty_cycle()``); the ``phases`` line (command seconds of each
    phase); one ``{"kernels": [...]}`` line (times are device
    times; ``eager_ms`` holds the eager calls' event times), then
    ``{"ok": true, "device": ...}``.

Needs one CUDA card and nvcc; imports nothing of JAX or ``arkflow_tpu``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from arkflow_tpu_torch.batch import MessageBatch  # noqa: E402
from arkflow_tpu_torch.components import Input, NoopAck, Output  # noqa: E402
from arkflow_tpu_torch.config import EngineConfig  # noqa: E402
from arkflow_tpu_torch.connect import kafka_client  # noqa: E402
from arkflow_tpu_torch.errors import EndOfInput  # noqa: E402
from arkflow_tpu_torch.models import decoder as dec  # noqa: E402
from arkflow_tpu_torch.models import get_model  # noqa: E402
from arkflow_tpu_torch.models import paged_decode as pd  # noqa: E402
from arkflow_tpu_torch.models.paged_decode import (  # noqa: E402
    init_page_pool,
    paged_decode_step,
    paged_prefill,
)
from arkflow_tpu_torch.models import quantize as q8  # noqa: E402
from arkflow_tpu_torch.models import common as model_common  # noqa: E402
from arkflow_tpu_torch.models.common import dense  # noqa: E402
from arkflow_tpu_torch.ops import flash_attention, flash_attention_reference  # noqa: E402
from arkflow_tpu_torch.ops import ragged_attention as ra  # noqa: E402
from arkflow_tpu_torch.ops import segment_attention as sa  # noqa: E402
from arkflow_tpu_torch.ops.build import KERNEL_SOURCES, build_all  # noqa: E402
from arkflow_tpu_torch.plugins.output.influxdb import encode_lines  # noqa: E402
from arkflow_tpu_torch.plugins.processor.gpu_inference import (  # noqa: E402
    GpuInferenceProcessor,
    pack_windows,
    scatter_windows,
)
from arkflow_tpu_torch.obs import global_registry  # noqa: E402
from arkflow_tpu_torch.obs.trace import TracingConfig, global_tracer  # noqa: E402
from arkflow_tpu_torch.runtime.engine import PROFILE_FILE, Engine  # noqa: E402
from arkflow_tpu_torch.tools import broker_streams  # noqa: E402
from arkflow_tpu_torch.tools.profile_step import (  # noqa: E402
    eager_twin,
    first_emission,
    server_twin,
)
from arkflow_tpu_torch.tpu import checkpoint  # noqa: E402
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy  # noqa: E402
from arkflow_tpu_torch.tpu.compiled_step import tree_map  # noqa: E402
from arkflow_tpu_torch.tpu.integrity import flatten, tree_digests  # noqa: E402
from arkflow_tpu_torch.tpu.packing import pack_tokens  # noqa: E402
from arkflow_tpu_torch.tpu.runner import ModelRunner, init_host_params, shape_key  # noqa: E402
from arkflow_tpu_torch.tpu.serving import GenerationServer  # noqa: E402
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer  # noqa: E402
from arkflow_tpu_torch.tpu.tuner import (  # noqa: E402
    ShapeConfig,
    SketchView,
    TunerConfig,
    plan_shapes,
    predict_waste,
)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "arkflow_tpu_torch", "examples")
CONFIG = os.path.join(EXAMPLES, "bert_stream.json")
PACKED_CONFIG = os.path.join(EXAMPLES, "bert_packed_stream.json")
GENERATE_CONFIG = os.path.join(EXAMPLES, "llama_generate_stream.json")
INT8_CONFIG = os.path.join(EXAMPLES, "int8_bert_stream.json")
LIFECYCLE_CONFIG = os.path.join(EXAMPLES, "bert_lifecycle_stream.json")
ADAPTIVE_CONFIG = os.path.join(EXAMPLES, "bert_adaptive_stream.json")
GEN_LIFECYCLE_CONFIG = os.path.join(EXAMPLES, "llama_lifecycle_stream.json")
SERVING_CONFIG = os.path.join(EXAMPLES, "llama_serving_stream.json")
BATCH_CONFIG = os.path.join(EXAMPLES, "llama_batch_stream.json")
MOE_CONFIG = os.path.join(EXAMPLES, "llama_moe_stream.json")
VIT_CONFIG = os.path.join(EXAMPLES, "vit_stream.json")
LSTM_CONFIG = os.path.join(EXAMPLES, "lstm_stream.json")
DELIVERY_CONFIG = os.path.join(EXAMPLES, "bert_delivery_stream.json")
CHAOS_CONFIG = os.path.join(EXAMPLES, "chaos_stream.json")
JSON_CONFIG = os.path.join(EXAMPLES, "bert_json_stream.json")
WINDOW_JSON_CONFIG = os.path.join(EXAMPLES, "bert_window_json_stream.json")
#: where the generate lifecycle phase writes its 16 GB checkpoint (in a
#: temporary directory it removes; the directory is ignored by git)
CHECKPOINT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")
#: prompts and new tokens of the generate lifecycle's swap and repair checks
#: depth of the generate lifecycle's swap and integrity checks (full width):
#: the checkpoint save, prepare, digest passes and repair scale with the
#: tree; the 32-layer (16 GB) swap ran green in earlier runs, 8 layers until
#: the import and tensor phases took the time, 4 until the tuner phase did
GEN_SWAP_LAYERS = 2
#: depth of the batch-mode swap (full width; 4 until the import and tensor
#: phases took the time)
BATCH_SWAP_LAYERS = 2
GEN_CHECK_PROMPTS = 16
#: rows of the serving stream and of the sampled generate stream (the
#: examples' 48 until the tuner phase took the time, 24 until the json
#: phase did; 16 serving rows, two waves of its 8 slots, still share the
#: instruction's cached pages)
SERVING_ROWS = 16
#: rows of the batch-mode stream (the example's 48, three generations of
#: the same 16 prompts, until the brokers phase took the time)
BATCH_ROWS = 32
GEN_CHECK_NEW = 32
#: the MoE phase: the generate stream's 12 distinct texts through the path
#: comparisons, 32 new tokens each (48 until the tuner phase took the
#: time); batch mode's one bucket
#: the MoE phase's depth (the example's 16 layers, cut to 8 to pay for the
#: delivery phase, to 4 for the json phase, to 2 for the brokers phase)
MOE_LAYERS = 2
MOE_CHECK_PROMPTS = 12
MOE_CHECK_NEW = 32
MOE_BATCH_ROWS, MOE_BATCH_NEW = 4, 32
#: rows of each stream of the lifecycle cost comparison: ~8 s of traffic,
#: three digest passes of the lifecycle example or more (40960 until the
#: import and tensor phases took the time)
COST_ROWS = 24576
#: H100 SXM published peaks from NVIDIA's datasheet: HBM bytes/s, and
#: dense flop/s by operand type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
INT8_PEAK_OPS = 1979e12  # dense int8 on the tensor cores
TOL = {torch.bfloat16: 1.0 / 64, torch.float32: 1e-4}
#: beside TOL's ceiling, a bf16 output of K1, K2 or K4 may lie from the
#: emulation of its body's rounding (``tile_err_ratio``) by one bf16 step
#: of its own size, this much for the f32 sums' order, and, on the tile,
#: P_FLIPS P values of its row that round to their other bf16 neighbour
#: (the card's __expf and sums differ from the emulation's by ~1e-6, which
#: tips a value lying at a rounding midpoint): one such flip moves o_i by
#: at most 2^-7 (|v_j| + |o_i|) / l_i, l_i the row's softmax normaliser
TILE_ATOL = 2.0 ** -12
P_FLIPS = 2
#: the FMA body's key tile (kBlockK in csrc/attention_common.cuh)
FMA_BLOCK_K = 32
#: the kernels line's mark on K1, K2 and K4, which run the tensor-core tile
REDESIGN = "bf16 mma.sync tile, arkflow_tpu_torch/csrc/mma_tile.cuh"
#: and on K3, which splits each row's context over blocks
PAGED_REDESIGN = ("split-context bf16 mma.sync flash-decoding (64-key splits, combine "
                  "kernel), arkflow_tpu_torch/csrc/paged_attention.cu")
#: the body every case here must run (all have head dims of 64 or 128)
EXPECTED_VARIANT = {torch.bfloat16: "mma", torch.float32: "fma"}
LABEL_MARGIN = 0.05
LOGIT_TOL = 1.0 / 64


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


#: the mask policies of csrc/flash_tile.cuh and csrc/mma_tile.cuh, by value
MASKS = {0: "dense", 1: "ragged", 2: "segment"}


def ptxas_summary(text: str) -> list[dict]:
    """Registers and spill bytes per kernel instantiation, from ``-Xptxas -v``:
    the kernel, dtype, D, the variant (``mma``: bf16 on the tensor cores;
    ``fma``: the f32 FMA body), for the flash tiles the mask policy, and for
    K3's split kernel (``paged_split``, whose partials ``paged_combine``
    merges) and its FMA kernel (``paged_attention``) the query tile."""
    out: list[dict] = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?(mma_tile|flash_tile|paged_attention"
                      r"|paged_split|paged_combine)_kernelI(13__nv_bfloat16|f)?((?:Li\d+E)+)", line)
        if m:
            kernel, ints = m.group(1), [int(x) for x in re.findall(r"Li(\d+)E", m.group(3))]
            mma = kernel in ("mma_tile", "paged_split", "paged_combine")
            bf16 = mma or m.group(2) == "13__nv_bfloat16"
            out.append({"kernel": kernel, "dtype": "bf16" if bf16 else "f32", "D": ints[0]})
            if kernel in ("paged_attention", "paged_split"):
                out[-1]["BQ"] = ints[1]
            elif kernel != "paged_combine":
                out[-1]["mask"] = MASKS[ints[1]]
            out[-1]["variant"] = "mma" if mma else "fma"
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


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Median device time of one call: ``calls`` calls captured into one CUDA
    graph (after a warmup on a side stream), the graph replayed and timed
    with CUDA events. The host's work for each call (a wrapper's checks, the
    launches) is done once at capture, so it is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def call_times(kernel, plain, library, plain_iters: int = 20, plain_calls: int = 20) -> dict:
    """A case's kernel, plain version and library call, each timed two
    ways: ``*_ms``, CUDA events around one eager call (the host's work
    before the launch included: where it exceeds the device's, that is
    what the event times), and ``*_device_ms``, the device's own time
    (``device_ms``)."""
    out = {}
    for name, fn, iters, calls in (("kernel", kernel, 20, 20),
                                   ("plain", plain, plain_iters, plain_calls),
                                   ("library", library, 20, 20)):
        out[f"{name}_ms"] = time_ms(fn, iters=iters)
        out[f"{name}_device_ms"] = device_ms(fn, calls=calls)
    return out


def kernel_line(case: dict) -> dict:
    """A case's numbers as the kernels line gives them: the device times,
    and the eager calls' event times beside them."""
    return {"max_abs_err": case["max_abs_err"], "ms": case["kernel_device_ms"],
            "plain_ms": case["plain_device_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_device_ms"],
            "eager_ms": {k: case[f"{k}_ms"] for k in ("kernel", "plain", "library")},
            "variant": case["variant"], "tile_err_ratio": case["tile_err_ratio"]}


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


def launched_variant(counter, call) -> tuple[str, torch.Tensor]:
    """Run ``call`` once; return the variant its launch counted, and its
    output. Fails unless exactly one launch was counted."""
    before = dict(counter.variants)
    out = call()
    delta = {k: n - before[k] for k, n in counter.variants.items() if n != before[k]}
    check(len(delta) == 1 and sum(delta.values()) == 1,
          f"expected one counted launch, got {delta}")
    return next(iter(delta)), out


def ragged_masks(lengths, s: int, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's visibility rule (K4's with every length S): ``allowed`` [B, 1,
    S, S], which keys each query sees, and ``live`` [B, S], the queries
    inside their row's length (the others are written as 0)."""
    lens = torch.as_tensor(lengths)
    pos = torch.arange(s, device=lens.device)
    live = pos[None, :] < lens[:, None]
    allowed = live[:, None, :, None] & live[:, None, None, :]
    if causal:
        allowed = allowed & (pos[None, :] <= pos[:, None])
    return allowed, live


def segment_masks(seg) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's rule: a query sees the keys of its own segment; id 0 is dead."""
    seg = torch.as_tensor(seg).long()
    live = seg > 0
    return ((seg[:, :, None] == seg[:, None, :]) & live[:, :, None])[:, None], live


def emulate_mma_tile(q, k, v, allowed, live, *, block_k=None, round_p=True,
                     dtype=torch.float32, return_norm=False):
    """The tensor-core tile's arithmetic in plain PyTorch, on q's device.
    q/k/v: [B, H, S, D] (bf16 values); allowed: [B, 1, Sq, Sk] bool, which
    keys a query sees; live: [B, Sq] bool, the queries that are not padding
    or dead (their rows are 0). Per key tile of ``block_k`` keys
    (``MMA_BLOCK_K[D]`` by default): S = Q K^T summed in ``dtype`` from bf16
    products, scaled by 1/sqrt(D), masked to -1e30; the online softmax; P
    rounded to bf16 (``round_p``), summed into the normaliser and multiplied
    by V. Returns bf16, and with ``return_norm`` also each row's normaliser
    [B, H, S] (the sum of its P, the largest of which is 1)."""
    qf, kf, vf = (x.to(torch.bfloat16).to(dtype) for x in (q, k, v))
    b, h, s, d = qf.shape
    block_k = block_k or ra.MMA_BLOCK_K[d]
    m = torch.full((b, h, s), -1e30, dtype=dtype, device=qf.device)
    l = torch.zeros(b, h, s, dtype=dtype, device=qf.device)
    o = torch.zeros(b, h, s, d, dtype=dtype, device=qf.device)
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        scores = torch.matmul(qf, kt.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        scores = torch.where(allowed[..., k0:k0 + block_k], scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        if round_p:
            p = p.to(torch.bfloat16).to(dtype)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p, vt)
        m = m_new
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = torch.where(live[:, None, :, None], out, 0.0).to(torch.bfloat16)
    return (out, l) if return_norm else out


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each |x| (2^-7 of its binade)."""
    _, e = torch.frexp(x.float().abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.exp2((e - 8).float())


def rounding_limit(ref: torch.Tensor, norm=None, v_max=None) -> torch.Tensor:
    """The per-element limit of a bf16 output against the emulation of its
    body's rounding: one bf16 step of the reference's element and
    ``TILE_ATOL``; with ``norm`` (each row's softmax normaliser, broadcast
    like ``ref`` without its last dim) also room for ``P_FLIPS`` P values
    rounded the other way, each moving the element by at most
    2^-7 (``v_max`` + |ref|) / max(norm, 1)."""
    limit = bf16_step(ref) + TILE_ATOL
    if norm is not None:
        limit = limit + P_FLIPS * 2.0 ** -7 * (v_max + ref.abs()) / norm.float().clamp_min(1.0)[..., None]
    return limit


def tile_err_ratio(out, q, k, v, allowed, live, variant: str) -> float:
    """A bf16 output's largest error over its per-element limit, against a
    reference that rounds as its body does: the tile's P in bf16 over its
    key tiles (``mma``), or only the output (``fma``). The limit is one
    bf16 step of the reference's element, ``TILE_ATOL``, and on the tile
    room for ``P_FLIPS`` P values rounded the other way; at most 1
    passes."""
    d = q.shape[-1]
    mma = variant == "mma"
    ref, norm = emulate_mma_tile(q, k, v, allowed, live, round_p=mma, return_norm=True,
                                 block_k=ra.MMA_BLOCK_K[d] if mma else FMA_BLOCK_K)
    ref = ref.float()
    v_max = v.float().abs().amax(dim=2, keepdim=True)  # [B, H, 1, D]: over every key
    limit = rounding_limit(ref, norm, v_max) if mma else rounding_limit(ref)
    return ((out.float() - ref).abs() / limit).max().item()


def merge_partials(o, m, l):
    """Merges partial softmax results along the last dim of ``m`` and ``l``
    (``o``: one more dim, D) as K3's split kernel and combine do: M = the
    largest m; each part weighted by exp(m - M). A part in which a query
    sees no key (m = -1e30, o a sum of V rows, l its count) gets weight 0
    as long as another part holds a key. Returns (o, M, l) merged."""
    mx = m.amax(dim=-1)
    w = torch.exp(m - mx[..., None])
    return (w[..., None] * o).sum(dim=-2), mx, (w * l).sum(dim=-1)


def emulate_paged_split(q, k_pages, v_pages, page_table, off, *, split_k=None, round_p=True,
                        dtype=torch.float32, return_norm=False):
    """K3's tensor-core body in plain PyTorch, on q's device. q: [B, C, H,
    D]; pools [pages, page, KVH, D]; page_table [B, P]; off [B]. Each row's
    context (P x page keys, padded with masked keys to whole splits) is cut
    into splits of ``split_k`` keys (``PAGED_SPLIT_K`` by default), and each
    split into softmax tiles: ``split_k / 4`` keys (one a warp) when the
    folded queries C x group number at most ``PAGED_DECODE_ROWS`` (the
    decode form), the whole split otherwise (the chunk form). Per tile, for
    folded query f = (chunk position f // group, group member f % group):
    S = Q K^T summed in ``dtype`` from bf16 values, scaled by 1/sqrt(D),
    masked to -1e30 past key off + f // group (clamped to the table); m =
    the tile's row max; P = exp(S - m), rounded to bf16 (``round_p``);
    l = sum P; O = P V. Tiles merge into their split, then splits into the
    row (``merge_partials``); the output is O / max(l, 1e-30). Returns
    [B, C, H, D] in q's dtype, and with ``return_norm`` also each query's merged
    normaliser [B, C, H] (its largest P is 1)."""
    split_k = split_k or ra.PAGED_SPLIT_K
    b, c, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    group, nq = h // kvh, c * h // kvh
    ctx = page_table.shape[1] * page
    splits = -(-ctx // split_k)
    tile = split_k // 4 if nq <= ra.PAGED_DECODE_ROWS else split_k
    dev = q.device
    table = page_table.to(device=dev, dtype=torch.int64)
    pad = splits * split_k - ctx

    def context(pool):  # [B, KVH, splits * split_k, D]
        x = pool[table].reshape(b, ctx, kvh, d).to(torch.bfloat16).to(dtype).transpose(1, 2)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    kk, vv = context(k_pages), context(v_pages)
    qf = (q.to(torch.bfloat16).to(dtype).reshape(b, c, kvh, group, d).transpose(1, 2)
          .reshape(b, kvh, nq, d))
    scores = torch.matmul(qf, kk.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # [B, KVH, nq, keys]
    pos = off.to(device=dev, dtype=torch.int64).clamp_min(0)[:, None] + torch.arange(
        nq, device=dev) // group
    keys = torch.arange(splits * split_k, device=dev)
    seen = (keys[None, None, :] <= pos[:, :, None]) & (keys < ctx)  # [B, nq, keys]
    scores = torch.where(seen[:, None], scores, -1e30).reshape(b, kvh, nq, splits, -1, tile)
    m = scores.amax(dim=-1)  # [B, KVH, nq, splits, tiles]
    p = torch.exp(scores - m[..., None])
    if round_p:
        p = p.to(torch.bfloat16).to(dtype)
    o = torch.einsum("bnfstk,bnstkd->bnfstd", p, vv.reshape(b, kvh, splits, -1, tile, d))
    o, m, l = merge_partials(o, m, p.sum(dim=-1))  # tiles into splits
    o, _, l = merge_partials(o, m, l)  # splits into rows
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = out.reshape(b, kvh, c, group, d).transpose(1, 2).reshape(b, c, h, d).to(q.dtype)
    if not return_norm:
        return out
    return out, l.reshape(b, kvh, c, group).transpose(1, 2).reshape(b, c, h)


def paged_err_ratio(out, q, k_pages, v_pages, page_table, off) -> float:
    """A bf16 K3 output's largest error over its per-element limit
    (``rounding_limit``, with the merged normaliser) against
    ``emulate_paged_split``; at most 1 passes."""
    ref, norm = emulate_paged_split(q, k_pages, v_pages, page_table, off, return_norm=True)
    ref = ref.float()
    b, c, h, d = q.shape
    kvh = k_pages.shape[2]
    vv = v_pages[page_table.to(device=q.device, dtype=torch.int64)].reshape(b, -1, kvh, d)
    v_max = vv.float().abs().amax(dim=1).repeat_interleave(h // kvh, dim=1)[:, None]  # [B, 1, H, D]
    return ((out.float() - ref).abs() / rounding_limit(ref, norm, v_max)).max().item()


def kernel_case(gen, b, h, s, d, dtype, causal, lengths=None) -> dict:
    """K1 against its plain version on [B, S, H, D]-laid-out operands (the
    layout the model hands it), plus the timings."""
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))
    if lengths is None:
        lengths = torch.randint(0, s + 1, (b,), device="cuda", generator=gen)
        lengths[:3] = torch.tensor([0, 1, s])
    lengths = lengths.to(device="cuda", dtype=torch.int32)
    variant, out = launched_variant(
        ra.launches, lambda: ra.ragged_flash_attention(q, k, v, lengths, causal=causal))
    ref = ra.ragged_attention_reference(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    pad_zero = all(bool((out[i, :, int(n):] == 0).all()) for i, n in enumerate(lengths.tolist()))
    ratio = (tile_err_ratio(out, q, k, v, *ragged_masks(lengths, s, causal), variant)
             if dtype == torch.bfloat16 else None)
    bound, bound_by = attention_bound_ms(lengths, h, s, d, dtype, causal)
    case = {
        "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "variant": variant, "max_abs_err": err, "tol": TOL[dtype], "tile_err_ratio": ratio,
        "pad_rows_zero": pad_zero,
        **call_times(lambda: ra.ragged_flash_attention(q, k, v, lengths, causal=causal),
                     lambda: ra.ragged_attention_reference(q, k, v, lengths, causal=causal),
                     sdpa_call(q, k, v, lengths, causal)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    print("K1 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K1 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K1 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K1 off its rounding emulation: {case}")
    check(pad_zero, f"K1 left pad queries non-zero: {case}")
    return case


#: K4's cases, [B, H, S, D], causal, dtype: the padded BERT-base step with
#: every row full; Llama-3-8B's full-sequence forward (KV heads repeated to
#: 32) at the generate smoke's 16 slots and max_input 512, and at 4096 tokens
#: (llama3_8b().max_seq is 8192); and that last in f32
K4_CASES = (((64, 12, 256, 64), False, torch.bfloat16),
            ((16, 32, 512, 128), True, torch.bfloat16),
            ((1, 32, 4096, 128), True, torch.bfloat16),
            ((1, 32, 4096, 128), True, torch.float32))


def dense_operands(gen, shape, dtype):
    """q, k, v [B, H, S, D] as views of [B, S, H, D] storage, the layout a
    model's projections hand over."""
    b, h, s, d = shape
    return [torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
            for _ in range(3)]


def run_dense_path(gen) -> dict:
    """K4's path: its entry point ``arkflow_tpu_torch.ops.flash_attention``,
    called as a user calls it, once at each case's shape, with the counts
    zeroed just before and read just after. No other kernel may launch; a
    sequence that does not divide the tiles raises before any launch."""
    operands = [(dense_operands(gen, shape, dtype), causal) for shape, causal, dtype in K4_CASES]
    reset_counts()
    for (q, k, v), causal in operands:
        flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    report = {"calls": len(operands), "k4_launches": flash_attention.launches.value,
              "k4_variants": dict(flash_attention.launches.variants),
              "k1_launches": ra.launches.value, "k2_launches": sa.launches.value,
              "k3_launches": ra.paged_flash_attention.launches.value}
    ragged = torch.zeros(1, 1, 30, 64, device="cuda", dtype=torch.bfloat16)
    try:
        flash_attention(ragged, ragged, ragged, tile_q=16, tile_k=16)
        report["ragged_tiles_raised"] = False
    except ValueError:
        report["ragged_tiles_raised"] = True
    report["k4_launches_after_ragged"] = flash_attention.launches.value
    print("K4 path " + json.dumps(report), flush=True)
    check(report["k4_launches"] == len(operands), f"K4 did not launch once a call: {report}")
    check(report["k4_variants"] == {
        v: sum(EXPECTED_VARIANT[dtype] == v for _, _, dtype in K4_CASES) for v in ra.VARIANTS},
        f"K4's launches ran the wrong variants: {report}")
    check(report["k1_launches"] == report["k2_launches"] == report["k3_launches"] == 0,
          f"the K4 path launched another kernel: {report}")
    check(report["ragged_tiles_raised"] and report["k4_launches_after_ragged"] == len(operands),
          f"ragged tiles did not raise before a launch: {report}")
    return report


def dense_case(gen, shape, causal: bool, dtype: torch.dtype) -> dict:
    """K4 against its plain version, plus its time, the plain version's,
    the library's (``scaled_dot_product_attention`` with ``is_causal``) and
    the bound (K1's with every length S). K1's count must not move."""
    b, h, s, d = shape
    q, k, v = dense_operands(gen, shape, dtype)
    k1_before = ra.launches.value
    variant, out = launched_variant(flash_attention.launches,
                                    lambda: flash_attention(q, k, v, causal=causal))
    ref = flash_attention_reference(q, k, v, causal=causal)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ratio = (tile_err_ratio(out, q, k, v, *ragged_masks(torch.full((b,), s, device="cuda"), s,
                                                         causal), variant)
             if dtype == torch.bfloat16 else None)
    bound, bound_by = attention_bound_ms(torch.full((b,), s), h, s, d, dtype, causal)
    case = {
        "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "variant": variant, "max_abs_err": err, "tol": TOL[dtype], "tile_err_ratio": ratio,
        "library_max_abs_err": (lib_out.float() - ref.float()).abs().max().item(),
        **call_times(lambda: flash_attention(q, k, v, causal=causal),
                     lambda: flash_attention_reference(q, k, v, causal=causal), lib,
                     plain_iters=5, plain_calls=2),
        "bound_ms": bound, "bound_by": bound_by,
        "k1_launches_during": ra.launches.value - k1_before,
    }
    print("K4 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K4 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K4 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K4 off its rounding emulation: {case}")
    check(case["k1_launches_during"] == 0, f"K1 launched during a K4 case: {case}")
    return case


def edge_cases(gen) -> dict:
    """K1, K2 and K4 against their plain versions where the tiles have
    edges: every head dim of both bodies in bf16 and f32, sequences off the
    64-query and key-tile grid (S = 1, 37, 100, 200), lengths 0, 1, S and
    random, causal on and off, and unsorted, interleaved segment ids with
    dead holes. Each launch must run the variant ``kernel_variant`` names,
    and pad and dead query rows must be exactly 0; bf16 outputs are also
    held per element to the emulation of their body's rounding."""
    rng = np.random.default_rng(7)
    worst: dict[str, float] = {}
    worst_ratio: dict[str, float] = {}
    launches = 0
    for d in ra.KERNEL_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            want = ra.kernel_variant(dtype, d)
            for s in (1, 37, 100, 200):
                b, h = 4, 2
                q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
                           .transpose(1, 2) for _ in range(3))
                lengths = torch.tensor([0, 1, s, int(rng.integers(0, s + 1))],
                                       device="cuda", dtype=torch.int32).clamp(max=s)
                seg_np = rng.integers(0, 5, (b, s)).astype(np.int32)
                seg_np[0], seg_np[1] = 0, 1
                seg = torch.from_numpy(seg_np).cuda()
                full = torch.full((b,), s, device="cuda")
                calls = []
                for causal in (False, True):
                    calls.append((f"K1 causal={causal}", ra.launches,
                                  lambda c=causal: ra.ragged_flash_attention(q, k, v, lengths, causal=c),
                                  ra.ragged_attention_reference(q, k, v, lengths, causal=causal),
                                  ragged_masks(lengths, s, causal), True))
                    calls.append((f"K4 causal={causal}", flash_attention.launches,
                                  lambda c=causal: flash_attention(q, k, v, causal=c, tile_q=s, tile_k=s),
                                  flash_attention_reference(q, k, v, causal=causal, tile_k=s),
                                  ragged_masks(full, s, causal), False))
                calls.append(("K2", sa.launches, lambda: sa.segment_flash_attention(q, k, v, seg),
                              sa.segment_attention_reference(q, k, v, seg), segment_masks(seg), True))
                for name, counter, call, ref, (allowed, live), has_dead in calls:
                    variant, out = launched_variant(counter, call)
                    launches += 1
                    err = (out.float() - ref.float()).abs().max().item()
                    key = f"{name} D={d} {str(dtype).replace('torch.', '')}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    where = f"{name} at D={d}, S={s}, {dtype}"
                    check(variant == want, f"{where} ran {variant}, not {want}")
                    check(err <= TOL[dtype], f"{where} off its plain version by {err}")
                    if dtype == torch.bfloat16:
                        ratio = tile_err_ratio(out, q, k, v, allowed, live, variant)
                        worst_ratio[key] = max(worst_ratio.get(key, 0.0), ratio)
                        check(ratio <= 1, f"{where} off its rounding emulation ({ratio} of the limit)")
                    if has_dead:
                        check(bool((out.transpose(1, 2)[~live] == 0).all()),
                              f"{where} left pad or dead query rows non-zero")
    report = {"launches": launches, "max_abs_err": worst, "tile_err_ratio": worst_ratio}
    print("edge cases " + json.dumps(report), flush=True)
    return report


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
    variant, out = launched_variant(sa.launches, lambda: sa.segment_flash_attention(q, k, v, seg))
    ref = sa.segment_attention_reference(q, k, v, seg)
    live = (seg > 0)[:, None, :, None].expand_as(out)
    pair = ((seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, :, None])[:, None]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=pair)  # noqa: E731
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    dead_zero = bool((out[~live] == 0).all())
    lib_err = (lib_out.float() - ref.float())[live].abs().max().item()
    ratio = (tile_err_ratio(out, q, k, v, *segment_masks(seg), variant)
             if dtype == torch.bfloat16 else None)
    bound, bound_by = segment_bound_ms(seg_np, h, d, dtype)
    case = {
        "case": label, "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
        "variant": variant, "live_tokens": int((seg_np > 0).sum()), "max_abs_err": err, "tol": TOL[dtype],
        "tile_err_ratio": ratio,
        "dead_rows_zero": dead_zero, "library_live_max_abs_err": lib_err,
        **call_times(lambda: sa.segment_flash_attention(q, k, v, seg),
                     lambda: sa.segment_attention_reference(q, k, v, seg), lib),
        "bound_ms": bound, "bound_by": bound_by,
    }
    print("K2 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K2 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K2 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K2 off its rounding emulation: {case}")
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
    ra.paged_flash_attention.launches.reset()
    flash_attention.launches.reset()
    q8.int8_products.reset()


def reserved_bytes() -> int:
    """``torch.cuda.memory_reserved()`` with the allocator's free cached
    blocks released first (each capture releases them too), so that two
    readings differ by what stays held: live tensors and graph pools."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def measure_warmup(obj, report: dict) -> None:
    """Wrap ``obj.warmup`` (a runner's or a server's, which the processor
    calls at connect) to record ``reserved_bytes()`` just before and just
    after it: the captures' memory."""
    inner = obj.warmup

    def warmup(*args):
        report["reserved_before_captures"] = reserved_bytes()
        n = inner(*args)
        report["reserved_after_captures"] = reserved_bytes()
        return n

    obj.warmup = warmup


def build_stream_runner(cfg_raw: dict, eager: bool):
    """The config's engine, built, with its runner swapped for its eager
    twin when ``eager``; the warmup's memory is recorded in ``memory``."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    if eager:
        proc.runner = eager_twin(proc.runner)
    memory: dict = {}
    measure_warmup(proc.runner, memory)
    return engine, stream, proc.runner, memory


def mode_report(runner, memory: dict) -> dict:
    """What each stream's report adds for the A/B: the mode, the captures,
    the traffic steps per shape key and the runner's duty cycle."""
    return {"mode": "eager" if runner._compiled.eager else "graphed",
            "captures": runner.captures, "traffic_keys": len(runner.dispatch_counts()),
            "duty_cycle": runner.duty_cycle(), **memory}


def run_slice(cfg_raw: dict, eager: bool = False) -> dict:
    engine, stream, runner, memory = build_stream_runner(cfg_raw, eager)
    sink = stream.output = ColumnSink(stream.output, ("label",))
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ra.launches.value
    k2_launches = sa.launches.value
    k1_variants = dict(ra.launches.variants)
    count = cfg_raw["streams"][0]["input"]["count"]
    layers = runner.cfg.layers
    report = {"rows_expected": count, "rows_out": stream.rows_out,
              "rows_dropped": sink.inner.dropped_rows, "errors": stream.errors,
              "seconds": wall, "rows_per_s": stream.rows_out / wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "layers": layers,
              "k1_launches": launches, "k1_variants": k1_variants, "k2_launches": k2_launches,
              "flash_fallbacks": runner.flash_fallbacks,
              "hidden": runner.cfg.hidden, "heads": runner.cfg.heads,
              **mode_report(runner, memory)}
    print("slice " + json.dumps(report), flush=True)
    check(k2_launches == 0, f"the padded stream launched K2: {report}")
    check(stream.errors == 0, f"stream reported errors: {report}")
    check(stream.rows_out == count and sink.inner.dropped_rows == count,
          f"not every row arrived: {report}")
    check(launches > 0 and launches == layers * runner.device_steps,
          f"K1 launches != layers x device steps: {report}")
    check(runner.flash_fallbacks == 0, f"the runner fell back from the kernel: {report}")
    check(k1_variants["mma"] == launches, f"a bf16 K1 launch missed the mma tile: {report}")
    return {"report": report, "runner": runner, "labels": np.concatenate(sink.columns["label"])}


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


class ColumnSink(Output):
    """Wraps the stream's own output: counts the rows it is handed and keeps
    the named output columns, in order, then passes the batch on."""

    def __init__(self, inner: Output, names: tuple):
        self.inner = inner
        self.rows = 0
        self.columns: dict[str, list] = {n: [] for n in names}

    async def connect(self) -> None:
        await self.inner.connect()

    async def write(self, batch: MessageBatch) -> None:
        self.rows += batch.num_rows
        for n, parts in self.columns.items():
            parts.append(np.asarray(batch.column(n)))
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


def run_packed_slice(cfg_raw: dict, eager: bool = False) -> dict:
    """The packed stream through ``Engine``, its sink wrapped to check order;
    the launch counts are zeroed just before the run and read just after."""
    engine, stream, runner, memory = build_stream_runner(cfg_raw, eager)
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = ra.launches.value, sa.launches.value
    k2_variants = dict(sa.launches.variants)
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
              "packed_token_fill": runner.true_tokens / max(1, runner.token_capacity),
              "packed_tokens": runner.true_tokens, "packed_slots": runner.token_capacity,
              "packed_flash": runner.cfg.packed_flash, "layers": layers,
              "k1_launches": k1, "k2_launches": k2, "k2_variants": k2_variants,
              **mode_report(runner, memory)}
    print("packed slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"packed stream reported errors: {report}")
    check(stream.rows_out == count and sink.inner.dropped_rows == count,
          f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(k2 > 0 and k2 == layers * runner.packed_steps,
          f"K2 launches != layers x packed steps: {report}")
    check(k1 == 0, f"the packed stream launched K1: {report}")
    check(k2_variants["mma"] == k2, f"a bf16 K2 launch missed the mma tile: {report}")
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


#: the delivery phase: ``bert_delivery_stream.json`` fed DELIVERY_TEXTS
#: seeded texts of 40-120 words, one a message; DELIVERY_POISON of them, one
#: in each quarter of the stream at a seeded position, carry the word
#: ``poison``, on which the stream's processor fault fails every batch
#: rows of the packed JSON stream, messages of the windowed one, windows of
#: the LSTM JSON stream (the first of the LSTM phase's)
JSON_PACKED_ROWS = 4096
JSON_WINDOW_ROWS = 2048
LSTM_JSON_WINDOWS = 1024
JSON_KEYS = ["id", "label", "score"]
#: a two-class score above sigmoid(LABEL_MARGIN) has a top-2 logit gap above it
TIE_FREE_SCORE = 1.0 / (1.0 + math.exp(-LABEL_MARGIN))


def run_json_stream(cfg_raw: dict, runner, label: str) -> dict:
    """A JSON example through ``Engine`` with its ``gpu_inference`` runner
    replaced by ``runner`` (warm already: the processor's warmup is off),
    its output wrapped to keep every payload in order and its buffer's
    emissions counted; the launch counts are zeroed just before the run and
    read just after."""
    raw = json.loads(json.dumps(cfg_raw))
    for proc in raw["streams"][0]["pipeline"]["processors"]:
        if proc["type"] == "gpu_inference":
            proc["warmup"] = False
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    proc = next(p for p in stream.pipeline.processors if hasattr(p, "runner"))
    proc.runner = runner
    sink = stream.output = OrderedSink(stream.output)
    emitted: list[int] = []
    inner_read = stream.buffer.read

    async def read():
        item = await inner_read()
        if item is not None:
            emitted.append(item[0].num_rows)
        return item

    stream.buffer.read = read
    before = {"device_steps": runner.device_steps, "packed_steps": runner.packed_steps,
              "captures": runner.captures}
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [json.loads(p) for p in sink.payloads]
    check(bool(emitted), f"the {label} JSON stream's buffer emitted nothing")
    report = {"rows_out": stream.rows_out, "errors": stream.errors, "seconds": wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "emissions": len(emitted),
              "emission_rows": {"min": min(emitted), "median": statistics.median(emitted),
                                "max": max(emitted)},
              "device_steps": runner.device_steps - before["device_steps"],
              "packed_steps": runner.packed_steps - before["packed_steps"],
              "captures_on_path": runner.captures - before["captures"],
              "layers": runner.cfg.layers,
              "k1_launches": ra.launches.value, "k1_variants": dict(ra.launches.variants),
              "k2_launches": sa.launches.value, "k2_variants": dict(sa.launches.variants)}
    print(f"json stream {label} " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"the {label} JSON stream reported errors: {report}")
    return {"report": report, "rows": rows}


def check_json_rows(rows: list[dict], ids: list[int], ref: dict, label: str) -> dict:
    """Every output payload a JSON object of exactly ``JSON_KEYS``, the ids
    in order and each once, and every label and score that of the same text
    through the padded runner (``ref``, by text index ``id % len``): scores
    within 1/64, labels equal where the reference's top-2 gap clears
    ``LABEL_MARGIN``."""
    n = len(ref["score"])
    keys_ok = all(isinstance(r, dict) and list(r) == JSON_KEYS for r in rows)
    got_ids = [r.get("id") for r in rows]
    want_score = ref["score"][[i % n for i in ids]]
    want_label = ref["label"][[i % n for i in ids]]
    score = np.array([r["score"] for r in rows], np.float64) if keys_ok else np.zeros(0)
    tie_free = want_score > TIE_FREE_SCORE
    report = {"rows": len(rows), "keys_exact": keys_ok, "ids_in_order_once": got_ids == ids,
              "tie_free_rows": int(tie_free.sum()),
              "max_score_abs_err": float(np.abs(score - want_score).max()) if keys_ok else None,
              "label_mismatches_tie_free": int(sum(
                  r["label"] != int(w) for r, w, t in zip(rows, want_label, tie_free) if t))
              if keys_ok else None}
    print(f"json rows {label} " + json.dumps(report), flush=True)
    check(keys_ok, f"{label}: an output payload is not an object of {JSON_KEYS}: {report}")
    check(report["ids_in_order_once"], f"{label}: rows lost, repeated or reordered: {report}")
    check(report["max_score_abs_err"] <= LOGIT_TOL, f"{label}: scores off the padded run: {report}")
    check(report["label_mismatches_tie_free"] == 0,
          f"{label}: tie-free labels differ from the padded run: {report}")
    return report


def run_json(runner: ModelRunner, prunner: ModelRunner, ab: dict) -> dict:
    """The packed JSON stream (``bert_json_stream.json``: generate of JSON
    rows -> memory buffer -> json_to_arrow -> gpu_inference packed, K2 ->
    arrow_to_json) on the packed stream's runner, and the windowed one
    (``bert_window_json_stream.json``: memory input with the json codec ->
    tumbling_window -> gpu_inference padded, K1 -> arrow_to_json) on the
    padded stream's runner; each row's label and score held to the same
    text through the padded runner, rows/s beside the raw stream's."""
    with open(JSON_CONFIG) as f:
        packed_raw = json.load(f)
    packed_in = packed_raw["streams"][0]["input"]
    packed_in["count"] = JSON_PACKED_ROWS
    texts = [p["text"] for p in packed_in["payloads"]]
    proc_cfg = next(p for p in packed_raw["streams"][0]["pipeline"]["processors"]
                    if p["type"] == "gpu_inference")
    ids, mask = HashTokenizer(runner.cfg.vocab_size).encode_batch(
        [t.encode() for t in texts], proc_cfg["max_seq"])
    ref = runner.infer_sync({"input_ids": ids, "attention_mask": mask})

    packed = run_json_stream(packed_raw, prunner, "packed")
    rep = packed["report"]
    check(rep["k2_launches"] > 0 and rep["k2_launches"] == rep["layers"] * rep["packed_steps"],
          f"packed JSON stream: K2 launches != layers x packed steps: {rep}")
    check(rep["k1_launches"] == 0, f"the packed JSON stream launched K1: {rep}")
    check(rep["k2_variants"].get("mma") == rep["k2_launches"],
          f"a packed JSON stream K2 launch missed the mma tile: {rep}")
    batch = packed_in["batch_size"]
    want_ids = [i % len(texts) for n in range(0, JSON_PACKED_ROWS, batch)
                for i in range(min(batch, JSON_PACKED_ROWS - n))]
    packed_rows = check_json_rows(packed["rows"], want_ids, ref, "packed")

    with open(WINDOW_JSON_CONFIG) as f:
        window_raw = json.load(f)
    window_raw["streams"][0]["input"]["messages"] = [
        {"id": i, "text": texts[i % len(texts)]} for i in range(JSON_WINDOW_ROWS)]
    window = run_json_stream(window_raw, runner, "window")
    rep = window["report"]
    check(rep["k1_launches"] > 0 and rep["k1_launches"] == rep["layers"] * rep["device_steps"],
          f"windowed JSON stream: K1 launches != layers x device steps: {rep}")
    check(rep["k2_launches"] == 0, f"the windowed JSON stream launched K2: {rep}")
    check(rep["k1_variants"].get("mma") == rep["k1_launches"],
          f"a windowed JSON stream K1 launch missed the mma tile: {rep}")
    window_rows = check_json_rows(window["rows"], list(range(JSON_WINDOW_ROWS)), ref, "window")
    return {"packed": {**packed["report"], **packed_rows},
            "window": {**window["report"], **window_rows},
            "rows_per_s": {
                "packed_json": packed["report"]["traffic_rows_per_s"],
                "packed_raw": ab["packed"]["graphed"]["traffic_rows_per_s"],
                "window_json": window["report"]["traffic_rows_per_s"],
                "padded_raw": ab["padded"]["graphed"]["traffic_rows_per_s"]}}


def run_lstm_json(cfg_raw: dict, lstm: dict) -> dict:
    """``lstm_stream.json`` with its windows as the JAX config has them: a
    memory input with the json codec, one ``{"window": [256 floats]}``
    message a window (the LSTM phase's first ``LSTM_JSON_WINDOWS``, the same
    float32 values its bytes scale to), ``tensor_field: window`` and
    ``arrow_to_json(score)``, on the LSTM phase's graphed runner; every
    score held to the raw-bytes run's at the float32 floor."""
    raw = json.loads(json.dumps(cfg_raw))
    stream_cfg = raw["streams"][0]
    values = lstm["values"][:LSTM_JSON_WINDOWS]
    stream_cfg["input"] = {"type": "memory", "codec": "json",
                           "messages": [{"window": v.reshape(-1).tolist()} for v in values]}
    stream_cfg["pipeline"]["processors"][0].update(tensor_field="window", warmup=False)
    stream_cfg["pipeline"]["processors"].append({"type": "arrow_to_json", "fields": ["score"]})
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    proc.runner = lstm["runner"]
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    rows = [json.loads(p) for p in sink.payloads]
    keys_ok = all(list(r) == ["score"] for r in rows)
    got = np.array([r["score"] for r in rows], np.float32) if keys_ok else np.zeros(0)
    want = lstm["scores"][:LSTM_JSON_WINDOWS]
    err = np.abs(got - want) if got.shape == want.shape else np.array([np.inf])
    report = {"windows": len(rows), "keys_exact": keys_ok, "errors": stream.errors,
              "traffic_windows_per_s": stream.rows_out / stream.traffic_seconds,
              "raw_traffic_windows_per_s": lstm["report"]["traffic_windows_per_s"],
              "max_abs_err_vs_raw": float(err.max()),
              "within_f32_floor": bool(np.all(err <= LSTM_TOL + LSTM_TOL * np.abs(want))),
              "launches": {"k1": ra.launches.value, "k2": sa.launches.value}}
    print("json lstm " + json.dumps(report), flush=True)
    check(stream.errors == 0 and keys_ok and len(rows) == LSTM_JSON_WINDOWS,
          f"the LSTM JSON stream lost or misshaped rows: {report}")
    check(report["within_f32_floor"], f"LSTM JSON scores off the raw-bytes run: {report}")
    return report



# -- brokers: the four BASELINE streams end to end against fake brokers ------

#: texts the Kafka -> BERT-base -> Kafka stream reads (4 partitions, gzip,
#: snappy, lz4 and none), MQTT windows of the LSTM stream (QoS 1), images
#: POSTed to the ViT stream, CDC prompts of the Llama-3-8B stream
#: BASELINE config 1 (``examples/generate_example.yaml``) on the port
SQL_CONFIG = os.path.join(EXAMPLES, "generate_example.json")
#: rows of the seeded reading mix the same query runs over
SQL_MIX_ROWS = 4096


def run_sql_stream(raw: dict, label: str, payloads: list[bytes] | None = None) -> dict:
    """A config-1 stream through ``Engine`` (host only: no kernel runs), its
    output's payloads kept in order; the launch counts read around it. With
    ``payloads`` its input reads those, 64 a read, in place of its own."""
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    if payloads is not None:
        stream.input = GatedListInput(payloads, 64, ())
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    wall = time.perf_counter() - t0
    report = {"rows_out": stream.rows_out, "errors": stream.errors, "seconds": wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "kernel_launches": (ra.launches.value + sa.launches.value
                                  + ra.paged_flash_attention.launches.value)}
    print(f"sql stream {label} " + json.dumps(report), flush=True)
    check(stream.errors == 0 and report["kernel_launches"] == 0,
          f"the {label} SQL stream reported errors or launched a kernel: {report}")
    return {"report": report, "rows": [json.loads(x) for x in sink.payloads]}


def run_sql() -> dict:
    """The ``sql`` phase, host only: BASELINE config 1
    (``generate_example.json``: the sensor payload, 320 rows, 64 a batch,
    ``json_to_arrow -> sql -> arrow_to_json``) as the YAML writes it, its
    stdout swapped for a recording ``drop``; then the same stream over
    SQL_MIX_ROWS seeded readings, 64 a read (values -20..60, each row's
    station its index). Exact: every row with ``value > 10`` comes out once, in order,
    with ``fahrenheit = value * 1.8 + 32`` as float64 computes it, and no
    other row."""
    with open(SQL_CONFIG) as f:
        raw = json.load(f)
    raw["health_check"] = {"enabled": False}
    raw["streams"][0]["output"] = {"type": "drop"}
    written = run_sql_stream(raw, "config1")
    rng = np.random.default_rng(51)
    values = [float(v) for v in np.round(rng.uniform(-20.0, 60.0, SQL_MIX_ROWS), 3)]
    mixed = run_sql_stream(raw, "mix", [
        json.dumps({"sensor": "temperature", "value": v, "station": f"st-{i}"}).encode()
        for i, v in enumerate(values)])
    want_written = [{"sensor": "temperature", "fahrenheit": 42.5 * 1.8 + 32,
                     "station": "eu-1"}] * 320
    want_mix = [{"sensor": "temperature", "fahrenheit": v * 1.8 + 32, "station": f"st-{i}"}
                for i, v in enumerate(values) if v > 10]
    report = {"config1": {**written["report"], "rows_equal": written["rows"] == want_written},
              "mix": {**mixed["report"], "rows_in": SQL_MIX_ROWS, "rows_expected": len(want_mix),
                      "rows_equal": mixed["rows"] == want_mix}}
    print("sql " + json.dumps(report), flush=True)
    check(report["config1"]["rows_equal"], f"sql: config 1's rows are not the query's: {report}")
    check(report["mix"]["rows_equal"], f"sql: the mix's rows are not exactly value > 10, "
                                       f"in order, with fahrenheit in float64: {report}")
    return report


#: the Kafka part's texts (and the obs part's four runs'): 4096 until the
#: SQL slice
BROKER_TEXTS = 3072
#: rows of the eager generate run (the graphed run serves all 48 of the
#: example): cut 48 -> 24 to pay for the obs part
GENERATE_EAGER_ROWS = 24
BROKER_CODECS = ["gzip", "snappy", "lz4", None]
MQTT_WINDOWS = 1024
#: every 8th MQTT window scaled by 30: the anomalies config 3's remap keeps
#: (the LSTM phase's random windows score below its 0.5)
MQTT_OUTLIER_EVERY, MQTT_OUTLIER_SCALE = 8, 30.0
HTTP_IMAGES = 256
CDC_PROMPTS = 16
KAFKA_BERT_CONFIG = os.path.join(EXAMPLES, "kafka_bert_kafka.json")
MQTT_LSTM_CONFIG = os.path.join(EXAMPLES, "mqtt_lstm_anomaly.json")
HTTP_VIT_CONFIG = os.path.join(EXAMPLES, "http_vit_redis.json")
CDC_NATS_CONFIG = os.path.join(EXAMPLES, "cdc_llm_nats.json")


def broker_config(path: str) -> dict:
    with open(path) as f:
        raw = json.load(f)
    raw["health_check"] = {"enabled": False}
    return raw


class CrcClock:
    """Times every ``crc32c`` the Kafka client runs while installed
    (``install`` / ``uninstall``): the host's cost of the record batches
    the stream produces."""

    def __init__(self):
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self._inner = kafka_client.crc32c

    def __call__(self, data: bytes, crc: int = 0) -> int:
        t0 = time.perf_counter()
        out = self._inner(data, crc)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += len(data)
        return out

    def install(self) -> None:
        kafka_client.crc32c = self

    def uninstall(self) -> None:
        kafka_client.crc32c = self._inner

    def report(self) -> dict:
        return {"batches": self.calls, "bytes": self.bytes, "seconds": self.seconds,
                "ms_per_batch": self.seconds * 1e3 / max(1, self.calls),
                "mb_per_s": self.bytes / 1e6 / self.seconds if self.seconds else None}


def broker_texts(n: int, seed: int) -> list[str]:
    """``msg<i>`` and 8-100 seeded words: distinct texts, each naming its id."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    return [f"msg{i} " + " ".join(rng.choice(vocab, size=int(k)))
            for i, k in enumerate(rng.integers(8, 100, size=n))]


def count_emissions(stream, emitted: list) -> None:
    """Record the rows of every emission of the stream's buffer, in order."""
    inner_read = stream.buffer.read

    async def read():
        item = await inner_read()
        if item is not None:
            emitted.append(item[0].num_rows)
        return item

    stream.buffer.read = read


def swap_in(stream, index: int, runner, counted: dict) -> None:
    """The stream's processor ``index`` on ``runner``; the launch counts
    zeroed and the runner's step and capture counts read just before the
    run."""
    stream.pipeline.processors[index].runner = runner
    counted.update(device_steps=runner.device_steps, captures=runner.captures)
    reset_counts()


async def kafka_key_cost(raw: dict, values: list[bytes], traffic_s: float) -> dict:
    """Config 2's key on its own, on this host: the Kafka part's output
    records, in batches of the input's ``batch_size``, written through the
    example's Kafka output with its key expression and without it, in turns
    (unkeyed, keyed, keyed, unkeyed), to a fake broker of 4 partitions; and
    the key expression alone on the same batches. The keyed writes' extra
    seconds over the part's traffic seconds bound the share of its time
    the key can explain (the output overlaps the device in the stream)."""
    from arkflow_tpu_torch.components import Resource
    from arkflow_tpu_torch.components.registry import build_component
    from arkflow_tpu_torch.tools.fake_brokers import FakeKafkaBroker
    from arkflow_tpu_torch.utils.expr import DynValue

    s = raw["streams"][0]
    rows = int(s["input"]["batch_size"])
    batches = [MessageBatch.new_binary(values[i:i + rows]) for i in range(0, len(values), rows)]
    broker = FakeKafkaBroker({s["output"]["topic"]: 4})
    await broker.start()
    secs: dict = {"keyed": [], "unkeyed": []}
    try:
        keyed = {**s["output"], "brokers": f"127.0.0.1:{broker.port}"}
        cfgs = {"keyed": keyed, "unkeyed": {k: v for k, v in keyed.items() if k != "key"}}
        for name in ("unkeyed", "keyed", "keyed", "unkeyed"):
            out = build_component("output", cfgs[name], Resource())
            await out.connect()
            t0 = time.perf_counter()
            for b in batches:
                await out.write(b)
            secs[name].append(time.perf_counter() - t0)
            await out.close()
    finally:
        await broker.stop()
    key = DynValue.from_config(s["output"]["key"], "key")
    t0 = time.perf_counter()
    for b in batches:
        key.eval_per_row(b)
    eval_s = time.perf_counter() - t0
    extra = statistics.mean(secs["keyed"]) - statistics.mean(secs["unkeyed"])
    return {"rows": len(values), "batch_rows": rows, "keyed_s": secs["keyed"],
            "unkeyed_s": secs["unkeyed"], "key_eval_s": eval_s,
            "extra_us_per_row": extra / max(1, len(values)) * 1e6,
            "key_eval_us_per_row": eval_s / max(1, len(values)) * 1e6,
            "extra_share_of_traffic": extra / traffic_s}


def run_kafka_bert(runner: ModelRunner, ab: dict) -> dict:
    """``kafka_bert_kafka.json`` on the padded BERT-base runner: BROKER_TEXTS
    texts produced before the run into 4 partitions (gzip, snappy, lz4,
    none); every id once in the output topic, the group's committed offsets
    at each log end and its generation unchanged, every label and score that
    of the same text through the padded runner (``check_json_rows``' rules),
    K1 = layers x device steps, all ``mma``, no capture on the path."""
    raw = broker_config(KAFKA_BERT_CONFIG)
    built_small(raw)
    texts = broker_texts(BROKER_TEXTS, seed=21)
    counted: dict = {}
    state: dict = {}
    crc = CrcClock()

    def prepare(stream) -> None:
        proc = stream.pipeline.processors[0]
        ids, mask = proc.tokenizer.encode_batch([t.encode() for t in texts], proc.max_seq)
        state["ref"] = runner.infer_sync({"input_ids": ids, "attention_mask": mask})
        torch.cuda.synchronize()
        swap_in(stream, 0, runner, counted)
        crc.install()  # the stream's own produces, not the seeding's

    try:
        rep = asyncio.run(broker_streams.kafka_to_kafka(
            raw, [t.encode() for t in texts], partitions=4, codecs=BROKER_CODECS,
            prepare=prepare))
    finally:
        crc.uninstall()
    torch.cuda.synchronize()
    launches = {"k1": ra.launches.value, "k1_variants": dict(ra.launches.variants),
                "k2": sa.launches.value, "k3": ra.paged_flash_attention.launches.value}
    steps = runner.device_steps - counted["device_steps"]
    rows = [json.loads(v) for v in rep["values"]]
    keys_ok = all(list(r) == ["__value__", "label", "score"] for r in rows)
    got_ids = sorted(int(r["__value__"].split()[0][3:]) for r in rows) if keys_ok else []
    by_id = sorted(rows, key=lambda r: int(r["__value__"].split()[0][3:])) if keys_ok else []
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "committed", "log_end", "generation_before",
                                  "generation_after", "input_codecs", "output_codecs")}
    report.update(records_out=len(rows), each_id_once=got_ids == list(range(BROKER_TEXTS)),
                  raw_rows_per_s=ab["padded"]["graphed"]["traffic_rows_per_s"],
                  device_steps=steps, captures_on_path=runner.captures - counted["captures"],
                  layers=runner.cfg.layers, launches=launches, host_crc=crc.report(),
                  output_bytes=sum(len(v) for v in rep["values"]))
    print("brokers kafka " + json.dumps(report), flush=True)
    check(keys_ok, f"kafka -> bert -> kafka: an output row is not __value__/label/score: "
                   f"{rows[:2]}")
    check(report["each_id_once"], f"kafka -> bert -> kafka: ids lost or repeated: {report}")
    check(rep["committed"] == rep["log_end"], f"kafka: commits short of the log end: {report}")
    check(rep["generation_before"] == rep["generation_after"] == 1,
          f"kafka: the consumer group rebalanced during the run: {report}")
    check(rep["errors"] == 0, f"kafka -> bert -> kafka reported errors: {report}")
    check(rep["input_codecs"] == [0, 1, 2, 3], f"kafka: the input codecs were not all driven: "
                                               f"{report}")
    check(launches["k1"] > 0 and launches["k1"] == runner.cfg.layers * steps,
          f"kafka -> bert -> kafka: K1 launches != layers x device steps: {report}")
    check(launches["k1_variants"].get("mma") == launches["k1"],
          f"kafka -> bert -> kafka: a K1 launch missed the mma tile: {report}")
    check(report["captures_on_path"] == 0, f"kafka -> bert -> kafka captured on the path: "
                                           f"{report}")
    check(launches["k2"] == launches["k3"] == 0, f"kafka -> bert launched K2 or K3: {report}")
    # config 2's key: json_get_str(__value__, 'label') on every record, and
    # a keyed record on the partition the port's partitioner gives its key
    keyed = [(k, p, r) for k, p, r in zip(rep["keys"], rep["partitions_out"], rows)]
    report["keys"] = {"records": len(keyed),
                      "equal_label": sum(k == str(r["label"]).encode() for k, _, r in keyed),
                      "on_key_partition": sum(
                          p == kafka_client.partition_for_key(k, 4) for k, p, _ in keyed
                          if k is not None)}
    check(report["keys"]["equal_label"] == report["keys"]["on_key_partition"] == BROKER_TEXTS,
          f"kafka: a record's key is not its label, or it sits off its key's partition: "
          f"{report['keys']}")
    report["key_cost"] = asyncio.run(kafka_key_cost(raw, rep["values"],
                                                    report["traffic_seconds"]))
    print("brokers kafka key_cost " + json.dumps(report["key_cost"]), flush=True)
    labels = check_json_rows([{"id": int(r["__value__"].split()[0][3:]), "label": r["label"],
                               "score": r["score"]} for r in by_id],
                             list(range(BROKER_TEXTS)), state["ref"], "kafka")
    return {**report, **{f"rows_{k}": v for k, v in labels.items()}}


#: seconds of the ``POST /debug/profile`` capture during the traced run
OBS_PROFILE_SECONDS = 1.0
_SAMPLE_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """The Prometheus text of ``GET /metrics``, parsed line by line:
    {(sample name, sorted labels): value}. Raises on a line that does not
    parse, a sample before its family's ``# TYPE``, a family that is not
    contiguous, a histogram whose buckets are not cumulative, or whose
    ``_count`` is not its ``+Inf`` bucket."""
    samples: dict = {}
    kinds: dict = {}
    current = None
    for line in text.splitlines():
        if not line or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            check(name not in kinds, f"/metrics: a second TYPE line for {name}")
            kinds[name], current = kind, name
            continue
        m = _SAMPLE_RE.match(line)
        check(m is not None, f"/metrics: a line that does not parse: {line!r}")
        name, _, labelstr, value = m.groups()
        base = next((name[: -len(x)] for x in ("_bucket", "_sum", "_count")
                     if name.endswith(x) and kinds.get(name[: -len(x)]) == "histogram"), name)
        check(base == current, f"/metrics: {name} is outside its family's block")
        labels = tuple(sorted(_LABEL_RE.findall(labelstr or "")))
        samples[(name, labels)] = float(value)
    for (name, labels), count in samples.items():
        if not name.endswith("_count") or kinds.get(name[:-6]) != "histogram":
            continue
        base = name[:-6]
        cum = [(float("inf") if dict(lab)["le"] == "+Inf" else float(dict(lab)["le"]), v)
               for (n, lab), v in samples.items() if n == base + "_bucket"
               and tuple(x for x in lab if x[0] != "le") == labels]
        cum.sort()
        counts = [v for _, v in cum]
        check(counts == sorted(counts) and cum and cum[-1][0] == float("inf")
              and counts[-1] == count,
              f"/metrics: {base}{dict(labels)} buckets not cumulative or _count != +Inf")
    return samples


def metric_value(samples: dict, name: str, **labels) -> float:
    """The sum of a sample over the label sets that include ``labels``."""
    want = set(labels.items())
    return sum(v for (n, lab), v in samples.items() if n == name and want <= set(lab))


def registry_samples() -> dict:
    """The process-global registry in the exposition's sample form."""
    return parse_exposition(global_registry().exposition())


def bucket_quantile(before: dict, after: dict, name: str, q: float, **labels) -> float:
    """``histogram_quantile`` over the bucket deltas of one run: linear
    inside the bucket the rank falls in, as Prometheus computes it."""
    want = set(labels.items())
    cum = []
    for (n, lab), v in after.items():
        if n == name + "_bucket" and want <= set(lab):
            le = dict(lab)["le"]
            cum.append((float("inf") if le == "+Inf" else float(le),
                        v - before.get((n, lab), 0.0)))
    cum.sort()
    total = cum[-1][1] if cum else 0.0
    if total <= 0:
        return float("nan")
    rank, lo, below = q * total, 0.0, 0.0
    for le, c in cum:
        if c >= rank:
            if le == float("inf"):
                return lo
            return lo + (le - lo) * ((rank - below) / (c - below) if c > below else 0.0)
        lo, below = le, c
    return lo


def quantile_ms(values: list, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))] if ordered else float("nan")


async def http_call(port: int, method: str, target: str) -> tuple[int, bytes]:
    """One request to the engine's health server on 127.0.0.1."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"{method} {target} HTTP/1.1\r\nHost: smoke\r\n"
                     "Content-Length: 0\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 60)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def profile_contents(trace_dir: str) -> dict:
    """What a ``/debug/profile`` capture holds: device events (kernels,
    copies, sets), the kernels by name, the graph launches, whether the
    tile kernel (``mma_tile_kernel``, K1 here) shows by name."""
    path = os.path.join(trace_dir, PROFILE_FILE)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels: dict = {}
    for e in device:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"file_bytes": os.path.getsize(path), "events": len(events),
            "device_events": len(device), "kernel_events": sum(kernels.values()),
            "graph_launches": sum(1 for e in events if e.get("name") == "cudaGraphLaunch"),
            "tile_kernel_events": sum(n for k, n in kernels.items() if "mma_tile_kernel" in k),
            "device_us": round(sum(float(e.get("dur", 0)) for e in device), 1),
            "top_kernels": [[k[:80], n] for k, n in top]}


def run_obs_stream(runner: ModelRunner, texts: list[str], mode: str, prof_dir: str) -> dict:
    """``kafka_bert_kafka.json`` through the port's ``Engine`` with its
    health server on a loopback port 0: ``traced`` (tracing as configured
    by default, a ``POST /debug/profile`` capture during the traffic, then
    ``GET /metrics`` and ``GET /trace``), ``untraced`` or
    ``untraced_again`` (``tracing: {enabled: false}``) or ``traced_again``
    (no capture). The registry and the committed traces are read
    in-process after every run too."""
    raw = broker_config(KAFKA_BERT_CONFIG)
    built_small(raw)
    raw["health_check"] = {"enabled": True, "host": "127.0.0.1", "port": 0,
                           "profiling_dir": prof_dir}
    if mode.startswith("untraced"):
        raw["tracing"] = {"enabled": False}
    counted: dict = {}
    seen: dict = {}

    def prepare(stream) -> None:
        seen["stream"] = stream
        seen["emissions"] = []
        count_emissions(stream, seen["emissions"])
        swap_in(stream, 0, runner, counted)
        seen["before"] = registry_samples()
        seen["seq"] = global_tracer().commit_seq()

    async def feed(engine) -> None:
        while engine.health_port is None or not engine._ready:
            await asyncio.sleep(0.002)
        port = engine.health_port
        if mode == "traced":
            status, body = await http_call(port, "POST",
                                           f"/debug/profile?seconds={OBS_PROFILE_SECONDS}")
            check(status == 200, f"obs: /debug/profile answered {status}: {body[:200]!r}")
            seen["profile"] = json.loads(body)
        stream = seen["stream"]
        t0 = time.perf_counter()
        while stream.rows_out < len(texts):
            check(time.perf_counter() - t0 < 120, "obs: the stream did not finish")
            await asyncio.sleep(0.002)
        if mode == "traced":
            status, body = await http_call(port, "GET", "/metrics")
            check(status == 200, f"obs: /metrics answered {status}")
            seen["metrics"] = body.decode()
            status, body = await http_call(port, "GET", f"/trace?n=1000&min_seq={seen['seq']}")
            check(status == 200, f"obs: /trace answered {status}")
            seen["trace"] = json.loads(body)

    rep = asyncio.run(broker_streams.kafka_to_kafka(
        raw, [t.encode() for t in texts], partitions=4, codecs=BROKER_CODECS,
        prepare=prepare, feed=feed))
    torch.cuda.synchronize()
    seen["seq_after"] = global_tracer().commit_seq()
    seen["after"] = registry_samples()
    seen["traces"] = global_tracer().slowest(1000, seen["seq"])
    return {"rep": rep, "seen": seen, "counted": counted,
            "launches": {"k1": ra.launches.value, "k1_variants": dict(ra.launches.variants)},
            "steps": runner.device_steps - counted["device_steps"]}


def obs_run_summary(run: dict) -> dict:
    """One obs run's end-to-end latency (per batch) from the in-process
    registry's bucket deltas and from its committed traces, rows/s and the
    device busy share over its traffic."""
    seen, rep = run["seen"], run["rep"]
    before, after = seen["before"], seen["after"]
    lab = {"stream": "classify"}
    e2e_ms = [r["e2e_ms"] for r in seen["traces"] if r["status"] == "ok"]
    busy = (metric_value(after, "arkflow_tpu_device_busy_seconds_total", model="bert_classifier")
            - metric_value(before, "arkflow_tpu_device_busy_seconds_total",
                           model="bert_classifier"))
    return {"rows_per_s": rep["rows_per_s"], "traffic_seconds": rep["traffic_seconds"],
            "e2e_hist_p50_ms": bucket_quantile(before, after, "arkflow_e2e_seconds", 0.5,
                                               **lab) * 1e3,
            "e2e_hist_p99_ms": bucket_quantile(before, after, "arkflow_e2e_seconds", 0.99,
                                               **lab) * 1e3,
            "e2e_trace_p50_ms": quantile_ms(e2e_ms, 0.5),
            "e2e_trace_p99_ms": quantile_ms(e2e_ms, 0.99), "traced_batches": len(e2e_ms),
            "device_busy_share": busy / rep["traffic_seconds"] if rep["traffic_seconds"] else None,
            "emission_rows": seen["emissions"]}


def run_obs(runner: ModelRunner) -> dict:
    """The observability plane on the Kafka -> BERT-base -> Kafka stream
    (the ``brokers kafka`` part's texts, broker and warm padded runner),
    four runs: traced with a profile capture, untraced, traced again,
    untraced again (tracing's cost: the second pair). Exact: the exposition
    parses and its histograms conform; rows in and out BROKER_TEXTS on the
    stream's label; batches out = the e2e count; ``arkflow_tpu_rows_total``
    BROKER_TEXTS; the
    infer count = the steps, K1 = 12 x steps all ``mma``; no process or
    write error; every traced batch's stages; root spans after the ingest
    stamp within e2e + 1 ms; device events in the profile; no trace from
    an untraced run; the outputs of every run bit for bit the same."""
    texts = broker_texts(BROKER_TEXTS, seed=21)
    prof_dir = tempfile.mkdtemp(prefix="arkflow-profile-")
    try:
        runs = {mode: run_obs_stream(runner, texts, mode, prof_dir)
                for mode in ("traced", "untraced", "traced_again", "untraced_again")}
        traced = runs["traced"]
        seen = traced["seen"]
        profile = profile_contents(seen["profile"]["trace_dir"])
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
        # later phases trace as the default configures it
        global_tracer().configure(TracingConfig.from_mapping(None))
    before, after = seen["before"], parse_exposition(seen["metrics"])
    lab = {"stream": "classify"}
    model = {"model": "bert_classifier"}

    def delta(name: str, **labels) -> float:
        return metric_value(after, name, **labels) - metric_value(before, name, **labels)

    steps = traced["steps"]
    counts = {
        "rows_in": delta("arkflow_rows_in_total", **lab),
        "rows_out": delta("arkflow_rows_out_total", **lab),
        "batches_out": delta("arkflow_batches_out_total", **lab),
        "e2e_count": delta("arkflow_e2e_seconds_count", **lab),
        "process_errors": delta("arkflow_process_errors_total", **lab),
        "write_errors": delta("arkflow_write_errors_total", **lab),
        "tpu_rows": delta("arkflow_tpu_rows_total", **model),
        "infer_count": delta("arkflow_tpu_infer_seconds_count", **model),
        "steps": steps, "k1": traced["launches"]["k1"],
        "k1_mma": traced["launches"]["k1_variants"].get("mma", 0)}
    recs = [r for r in seen["trace"]["slowest"] if r["status"] == "ok"]
    sources = {r["trace_id"]: r for r in seen["trace"]["slowest"] if r["status"] == "coalesced"}
    needed = {"queue_wait", "process", "infeed_prep", "output_write"}
    missing, over_all, over_ingest = [], [], []
    for r in recs:
        stages = {s["stage"] for s in r["spans"]}
        links = [ln for s in r["spans"] if s["stage"] == "coalesce_wait"
                 for ln in s["attrs"]["links"]]
        decoded = "input_decode" in stages or (links and all(
            any(s["stage"] == "input_decode" for s in sources.get(ln, {"spans": []})["spans"])
            for ln in links))
        if not (needed <= stages and stages & {"device_step", "device_step_first"} and decoded):
            missing.append(sorted(stages))
        roots = [s for s in r["spans"] if not s["parent_id"]]
        over_all.append(sum(s["dur_ms"] for s in roots) - r["e2e_ms"])
        over_ingest.append(sum(s["dur_ms"] for s in roots if s["stage"] != "input_decode")
                           - r["e2e_ms"])
    outputs = {mode: {int(json.loads(v)["__value__"].split()[0][3:]): v
                      for v in run["rep"]["values"]} for mode, run in runs.items()}
    differ = {mode: sum(1 for i, v in outputs["traced"].items() if outputs[mode].get(i) != v)
              for mode in runs if mode != "traced"}
    summaries = {mode: obs_run_summary(run) for mode, run in runs.items()}
    untraced_rate = statistics.mean([summaries["untraced"]["rows_per_s"],
                                     summaries["untraced_again"]["rows_per_s"]])
    breakdown = {stage: {k: e[k] for k in ("count", "p50_ms", "p99_ms", "share_of_e2e")
                         if k in e} | ({"nested_under": e["nested_under"]}
                                       if "nested_under" in e else {})
                 for stage, e in seen["trace"]["stage_breakdown"]["stages"].items()}
    clean = summaries["traced_again"]
    report = {
        "e2e_per": "batch", "batch_rows": 256,
        "e2e_hist_p50_ms": clean["e2e_hist_p50_ms"], "e2e_hist_p99_ms": clean["e2e_hist_p99_ms"],
        "e2e_trace_p50_ms": clean["e2e_trace_p50_ms"],
        "e2e_trace_p99_ms": clean["e2e_trace_p99_ms"],
        "traced_over_untraced": clean["rows_per_s"] / untraced_rate,
        "profiled_over_untraced": summaries["traced"]["rows_per_s"] / untraced_rate,
        "runs": summaries,
        "stage_breakdown_profiled_run": breakdown, "counts": counts,
        "roots_over_e2e_ms_max": max(over_all, default=0.0),
        "roots_after_ingest_over_e2e_ms_max": max(over_ingest, default=0.0),
        "traces_missing_stages": missing[:4], "coalesced_sources": len(sources),
        "outputs_differing": differ, "profile": profile,
        "profile_seconds": seen["profile"]["seconds"],
        "untraced_commits": sum(runs[m]["seen"]["seq_after"] - runs[m]["seen"]["seq"]
                                for m in ("untraced", "untraced_again")),
        "metrics_bytes": len(seen["metrics"]),
        "tracing_summary": seen["trace"]["summary"]}
    stages_clean = {}
    for r in runs["traced_again"]["seen"]["traces"]:
        for sp in r["spans"]:
            if not sp["parent_id"] or sp["stage"] == "device_step":
                stages_clean.setdefault(sp["stage"], []).append(sp["dur_ms"])
    report["stage_ms_traced_again"] = {
        k: {"p50": quantile_ms(v, 0.5), "p99": quantile_ms(v, 0.99), "count": len(v)}
        for k, v in sorted(stages_clean.items())}
    print("obs " + json.dumps(report), flush=True)
    check(counts["rows_in"] == counts["rows_out"] == BROKER_TEXTS,
          f"obs: rows in/out deltas are not {BROKER_TEXTS}: {counts}")
    check(counts["batches_out"] == counts["e2e_count"] > 0,
          f"obs: batches out != arkflow_e2e_seconds_count: {counts}")
    check(counts["tpu_rows"] == BROKER_TEXTS, f"obs: arkflow_tpu_rows_total delta: {counts}")
    check(counts["infer_count"] == steps > 0, f"obs: infer count != steps run: {counts}")
    check(counts["k1"] == runner.cfg.layers * steps == counts["k1_mma"],
          f"obs: K1 != layers x steps, or a launch missed the mma tile: {counts}")
    check(counts["process_errors"] == counts["write_errors"] == 0, f"obs: errors: {counts}")
    check(len(recs) == counts["batches_out"] and not missing,
          f"obs: a traced batch lacks a stage, or a batch was not traced: {report}")
    check(report["roots_after_ingest_over_e2e_ms_max"] <= 1.0,
          f"obs: a trace's root spans after the ingest stamp exceed its e2e by > 1 ms: {report}")
    check(profile["device_events"] > 0, f"obs: the profile holds no device event: {profile}")
    check(report["untraced_commits"] == 0, f"obs: an untraced run committed traces: {report}")
    check(all(n == 0 for n in differ.values()) and all(
        len(o) == BROKER_TEXTS for o in outputs.values()),
        f"obs: traced and untraced outputs differ: {report}")
    return report


def arrow_alert_text(score) -> str:
    """The text Arrow writes for ``cast(round(score, 3) as string)`` of a
    float32 score in [0, 1e9), worked apart from the port's SQL engine, one
    score at a time: Arrow's round scales by 10^3 in float32, rounds only a
    value with a fraction (to nearest, half to even on an exact tie: what
    Python's ``round`` does) and scales back; its cast writes the shortest
    float32 digits, positional in this range, with no trailing ``.0``.
    ``tests/test_torch_sql.py`` holds it to pyarrow."""
    x = np.float32(score)
    if not 0 <= x < 1e9:
        raise ValueError(f"score {x} is outside [0, 1e9), where Arrow writes positional digits")
    scaled = x * np.float32(1000)
    if scaled != np.float32(math.floor(scaled)):
        x = np.float32(round(float(scaled))) / np.float32(1000)
    return np.format_float_positional(x, unique=True, trim="-")


def run_mqtt_lstm(lstm: dict) -> dict:
    """``mqtt_lstm_anomaly.json`` on the LSTM phase's graphed runner:
    MQTT_WINDOWS ``{"window": [...]}`` messages (the LSTM phase's windows'
    float32 values, every MQTT_OUTLIER_EVERY-th scaled by
    MQTT_OUTLIER_SCALE) published at QoS 1. The example's ``remap`` keeps
    exactly the rows whose score, the runner's on the same windows in the
    stream's own batches, is above 0.5 (bit for bit: a batch bucket is a
    GEMM shape, and float32 GEMMs of two shapes may round apart), in order,
    each with the alert text Arrow writes for ``round(score, 3)``; their
    scores equal the runner's in batches of 64 (the raw-bytes run's) at
    the float32 floor."""
    raw = broker_config(MQTT_LSTM_CONFIG)
    values = lstm["values"][:MQTT_WINDOWS].copy()
    values[::MQTT_OUTLIER_EVERY] *= MQTT_OUTLIER_SCALE  # a sensor fault: the anomalies
    payloads = [json.dumps({"window": v.reshape(-1).tolist()}).encode() for v in values]
    runner = lstm["runner"]
    counted: dict = {}
    emitted: list[int] = []

    def prepare(stream) -> None:
        count_emissions(stream, emitted)
        swap_in(stream, 0, runner, counted)

    rep = asyncio.run(broker_streams.mqtt_to_stdout(raw, payloads, qos=1, prepare=prepare))
    torch.cuda.synchronize()
    lines = [json.loads(x) for x in rep["lines"]]
    keys_ok = all(list(r) == ["window", "score", "alert"] for r in lines)
    got = np.array([r["score"] for r in lines], np.float32) if keys_ok else np.zeros(0)
    ref, at = [], 0
    for n in emitted:  # the stream's own batches, through the same runner
        ref.append(np.asarray(runner.infer_sync({"values": values[at:at + n]})["score"]))
        at += n
    ref = np.concatenate(ref).astype(np.float32) if ref else np.zeros(0, np.float32)
    # config 3's remap: the rows with score > 0.5, each with the text Arrow
    # writes for round(score, 3)
    kept = np.flatnonzero(ref > 0.5)
    alerts = ["anomaly: " + arrow_alert_text(x) for x in ref[kept]]
    ref_kept = ref[kept]
    # the raw-bytes stream's batches of 64 on the same windows
    want = np.concatenate([
        np.asarray(runner.infer_sync({"values": values[i:i + 64]})["score"])
        for i in range(0, len(values), 64)]).astype(np.float32)[kept]
    err = np.abs(got - want) if got.shape == want.shape else np.array([np.inf])
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "published", "filtered")}
    report.update(lines=len(lines), keys_exact=keys_ok, anomalies_expected=len(kept),
                  raw_rows_per_s=lstm["report"]["traffic_windows_per_s"],
                  emissions=len(emitted),
                  emission_rows={"min": min(emitted), "max": max(emitted)} if emitted else None,
                  equal_bitwise_same_batches=bool(got.shape == ref_kept.shape and np.array_equal(
                      got.view(np.int32), ref_kept.view(np.int32))),
                  equal_bitwise_raw_run=bool(got.shape == want.shape and np.array_equal(
                      got.view(np.int32), want.view(np.int32))),
                  max_abs_err_vs_raw_run=float(err.max()) if err.size else 0.0,
                  alerts_equal=keys_ok and [r["alert"] for r in lines] == alerts,
                  alert_examples=alerts[:3],
                  windows_in_order=keys_ok and len(lines) == len(kept) and all(
                      np.array_equal(np.float32(r["window"]), values[i].reshape(-1))
                      for r, i in zip(lines, kept)),
                  captures_on_path=runner.captures - counted["captures"])
    print("brokers mqtt " + json.dumps(report), flush=True)
    check(keys_ok and len(lines) == len(kept) and len(lines) + rep["filtered"] == MQTT_WINDOWS
          and rep["errors"] == 0, f"mqtt -> lstm -> remap -> stdout lost, kept or misshaped "
                                  f"rows: {report}")
    check(report["alerts_equal"], f"mqtt -> lstm -> remap: an alert is not Arrow's text of "
                                  f"round(score, 3): {report}")
    check(len(kept) >= MQTT_WINDOWS // MQTT_OUTLIER_EVERY // 2,
          f"mqtt -> lstm -> remap: too few anomalies to hold the remap to: {report}")
    check(report["windows_in_order"], f"mqtt -> lstm: windows out of order: {report}")
    check(report["equal_bitwise_same_batches"],
          f"mqtt -> lstm scores != the runner's on the same batches: {report}")
    check(bool(np.all(err <= LSTM_TOL + LSTM_TOL * np.abs(want))) if len(kept) else True,
          f"mqtt -> lstm scores off the raw-bytes run's float32 floor: {report}")
    check(report["captures_on_path"] == 0, f"mqtt -> lstm captured on the path: {report}")
    return report


def run_http_vit(proc, payloads: list[bytes], embeddings: np.ndarray,
                 raw_rows_per_s: float) -> dict:
    """``http_vit_redis.json`` on the ViT phase's graphed processor:
    HTTP_IMAGES images POSTed on one keep-alive connection of a stdlib
    client, then one past the rate limit (capacity HTTP_IMAGES, refill
    0.01/s in place of the example's 200 at 100/s, which would bound the
    stream at 100 images/s); each image answers 200 and the extra 429, the
    list holds every embedding once, in order, equal bit for bit to the same
    images through the processor in the stream's own batches, and within
    ``VIT_EMB_TOL`` of the ViT phase's (its batches of 32)."""
    raw = broker_config(HTTP_VIT_CONFIG)
    raw["streams"][0]["input"]["rate_limit"] = {"capacity": HTTP_IMAGES, "per_second": 0.01}
    runner = proc.runner
    counted: dict = {}
    emitted: list[int] = []

    def prepare(stream) -> None:
        count_emissions(stream, emitted)
        swap_in(stream, 0, runner, counted)

    bodies = payloads[:HTTP_IMAGES]
    rep = asyncio.run(broker_streams.http_to_redis(raw, bodies, extra=1, prepare=prepare))
    torch.cuda.synchronize()
    steps = runner.device_steps - counted["device_steps"]
    got = np.array([json.loads(v)["embedding"] for v in rep["values"]], np.float32)
    ref, at = [], 0
    for n in emitted:  # the stream's own batches, through the same processor
        ref.append(through_processor(proc, bodies[at:at + n], n, "embedding"))
        at += n
    ref = np.concatenate(ref) if ref else np.zeros((0, got.shape[-1]), np.float32)
    phase = embeddings[:HTTP_IMAGES]
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "connections")}
    report.update(statuses={str(s): rep["statuses"].count(s) for s in set(rep["statuses"])},
                  last_status=rep["statuses"][-1], list_len=len(rep["values"]),
                  raw_rows_per_s=raw_rows_per_s, emissions=len(emitted),
                  emission_rows={"min": min(emitted), "max": max(emitted)} if emitted else None,
                  device_steps=steps,
                  equal_bitwise_same_batches=bool(got.shape == ref.shape and np.array_equal(
                      got.view(np.int32), ref.view(np.int32))),
                  max_abs_err_vs_phase=float(np.abs(got - phase).max())
                  if got.shape == phase.shape else None,
                  captures_on_path=runner.captures - counted["captures"])
    print("brokers http " + json.dumps(report), flush=True)
    check(rep["statuses"] == [200] * HTTP_IMAGES + [429],
          f"http -> vit: a POST did not answer 200, or the extra not 429: {report}")
    check(rep["connections"] == 1, f"http -> vit: the client did not keep its connection: "
                                   f"{report}")
    check(len(rep["values"]) == HTTP_IMAGES and rep["errors"] == 0,
          f"http -> vit -> redis lost or repeated embeddings: {report}")
    check(report["equal_bitwise_same_batches"],
          f"http -> vit embeddings != the processor's on the same batches: {report}")
    check(report["max_abs_err_vs_phase"] is not None
          and report["max_abs_err_vs_phase"] <= VIT_EMB_TOL * float(np.abs(phase).max()),
          f"http -> vit embeddings off the ViT phase's: {report}")
    check(report["captures_on_path"] == 0, f"http -> vit captured on the path: {report}")
    return report


def run_cdc_nats(proc, rows: list[bytes], generated: list[bytes], ref: list,
                 limits: list, raw_rows_per_s: float) -> dict:
    """``cdc_llm_nats.json`` on the batch stream's ``serving: batch``
    Llama-3-8B processor (its graphs captured by that stream): the batch
    stream's first CDC_PROMPTS rows produced into a one-partition topic
    (one fetch, one buffer emission of 16: the batch stream's first batch),
    every ``summary`` on the subject once, equal to the batch stream's
    tokens for the same prompt up to the first near-tie of the continuous
    server's reference (``compare_to_first_tie``, padded rows to token 2)."""
    raw = broker_config(CDC_NATS_CONFIG)
    # built small and swapped for the warm processor before it connects
    raw["streams"][0]["pipeline"]["processors"][0]["model_config"] = {
        "vocab_size": 256, "dim": 64, "layers": 1, "heads": 4, "kv_heads": 2, "ffn": 128}
    gen = proc.generator
    counted = {"captures": gen.captures, "generations": gen.generations}

    def prepare(stream) -> None:
        stream.pipeline.processors[0] = proc
        reset_counts()

    rep = asyncio.run(broker_streams.kafka_to_nats(raw, rows[:CDC_PROMPTS], prepare=prepare))
    torch.cuda.synchronize()
    summaries = [json.loads(p) for p in rep["payloads"]]
    keys_ok = all(list(s) == ["summary"] for s in summaries)
    got = [[int(t) for t in s["summary"].split()] for s in summaries] if keys_ok else []
    streams = compare_to_first_tie(got, ref[:CDC_PROMPTS], limits=limits[:CDC_PROMPTS])
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "committed", "log_end", "generation_after")}
    report.update(summaries=len(summaries), raw_rows_per_s=raw_rows_per_s,
                  equal_to_batch_stream=got == row_ids(generated[:CDC_PROMPTS]),
                  generations=gen.generations - counted["generations"],
                  captures_on_path=gen.captures - counted["captures"],
                  launches={"k1": ra.launches.value, "k2": sa.launches.value,
                            "k3": ra.paged_flash_attention.launches.value},
                  vs_continuous=streams)
    print("brokers cdc " + json.dumps(report), flush=True)
    check(keys_ok and len(summaries) == CDC_PROMPTS and rep["errors"] == 0,
          f"kafka cdc -> llama -> nats lost, repeated or misshaped summaries: {report}")
    check(rep["committed"] == rep["log_end"], f"cdc: commits short of the log end: {report}")
    check(not streams["rows_mismatched_before_a_tie"],
          f"cdc summaries differ from the reference before a near-tie: {report}")
    check(report["captures_on_path"] == 0, f"cdc -> llama captured on the path: {report}")
    return report


#: the other directions of the brokers: JetStream texts into the packed
#: runner, Redis list windows into the LSTM, the websocket + Redis
#: subscribe fan-in's texts into the padded runner, Modbus polls
NATS_TEXTS = 2048
REDIS_WINDOWS = 1024
FANIN_TEXTS = 256
MODBUS_POLLS = 64
NATS_BERT_CONFIG = os.path.join(EXAMPLES, "nats_bert_mqtt.json")
REDIS_LSTM_CONFIG = os.path.join(EXAMPLES, "redis_lstm_influx.json")
FANIN_BERT_CONFIG = os.path.join(EXAMPLES, "ws_redis_bert_http.json")
MODBUS_INFLUX_CONFIG = os.path.join(EXAMPLES, "modbus_influx.json")


def built_small(raw: dict) -> None:
    """The example's BERT-base ``gpu_inference`` built at one layer and
    without warmup: its runner is swapped for a warm full-depth one before
    the run, and the tokenizer (BERT-base's vocabulary) is the same."""
    for proc in raw["streams"][0]["pipeline"]["processors"]:
        if proc["type"] == "gpu_inference" and proc["model"] == "bert_classifier":
            proc.update(warmup=False, model_config={"layers": 1})


def scores_by_id(rows: list[dict]) -> dict[int, tuple[int, float]]:
    return {r["id"]: (r["label"], r["score"]) for r in rows}


def run_nats_bert(prunner: ModelRunner, runner: ModelRunner, ab: dict) -> dict:
    """``nats_bert_mqtt.json`` on the packed BERT-base runner: NATS_TEXTS
    ``{"id", "text"}`` rows of 8-100 words stored in the JetStream stream
    before the run, pulled 64 at a time; every id once at an MQTT
    subscriber (QoS 1), in order; the consumer's ack floor at the stream's
    last sequence with no redelivery; every label and score equal bit for
    bit to the same emissions through the processor on the packed runner
    again, labels the padded runner's on tie-free rows and scores within
    1/64 of it; K2 = layers x packed steps, all ``mma``, K1 0, 0 captures."""
    raw = broker_config(NATS_BERT_CONFIG)
    built_small(raw)
    texts = broker_texts(NATS_TEXTS, seed=22)
    values = [json.dumps({"id": i, "text": t}).encode() for i, t in enumerate(texts)]
    counted: dict = {}
    state: dict = {"emitted": []}

    def prepare(stream) -> None:
        proc = stream.pipeline.processors[0]
        state["proc"] = proc
        ids, mask = proc.tokenizer.encode_batch([t.encode() for t in texts], proc.max_seq)
        state["ref"] = runner.infer_sync({"input_ids": ids, "attention_mask": mask})
        inner_read = stream.buffer.read

        async def read():
            item = await inner_read()
            if item is not None:
                state["emitted"].append(item[0])
            return item

        stream.buffer.read = read
        counted["packed_steps"] = prunner.packed_steps
        torch.cuda.synchronize()
        swap_in(stream, 0, prunner, counted)

    rep = asyncio.run(broker_streams.nats_to_mqtt(raw, values, prepare=prepare))
    torch.cuda.synchronize()
    launches = {"k1": ra.launches.value, "k2": sa.launches.value,
                "k2_variants": dict(sa.launches.variants)}
    steps = prunner.packed_steps - counted["packed_steps"]
    captures = prunner.captures - counted["captures"]
    rows = [json.loads(p) for p in rep["payloads"]]
    keys_ok = all(list(r) == JSON_KEYS for r in rows)
    async def emissions_again() -> dict:
        out = {}
        for batch in state["emitted"]:  # the stream's own emissions, through the same processor
            for b in await state["proc"].process(batch):
                cols = b.to_pydict()
                out.update(zip(cols["id"], zip(cols["label"], cols["score"])))
        return out

    again = asyncio.run(emissions_again())
    got = scores_by_id(rows) if keys_ok else {}
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "ack_floor", "last_seq", "redelivered",
                                  "naks", "ack_pending", "published")}
    report.update(payloads=len(rows), raw_rows_per_s=ab["packed"]["graphed"]["traffic_rows_per_s"],
                  in_order=keys_ok and [r["id"] for r in rows] == list(range(NATS_TEXTS)),
                  emissions=len(state["emitted"]), packed_steps=steps, layers=prunner.cfg.layers,
                  captures_on_path=captures, launches=launches,
                  equal_bitwise_same_emissions=bool(got) and got == again)
    print("brokers nats " + json.dumps(report), flush=True)
    check(keys_ok and sorted(got) == list(range(NATS_TEXTS)) and len(rows) == NATS_TEXTS,
          f"nats -> bert -> mqtt lost, repeated or misshaped rows: {report}")
    check(rep["ack_floor"] == rep["last_seq"] == NATS_TEXTS and rep["redelivered"] == 0
          and rep["ack_pending"] == 0, f"nats: the consumer's acks fell short: {report}")
    check(rep["errors"] == 0, f"nats -> bert -> mqtt reported errors: {report}")
    check(report["equal_bitwise_same_emissions"],
          f"nats -> bert: labels or scores != the packed runner's on the same emissions: {report}")
    check(launches["k2"] > 0 and launches["k2"] == prunner.cfg.layers * steps,
          f"nats -> bert: K2 launches != layers x packed steps: {report}")
    check(launches["k2_variants"].get("mma") == launches["k2"],
          f"nats -> bert: a K2 launch missed the mma tile: {report}")
    check(launches["k1"] == 0, f"nats -> bert launched K1: {report}")
    check(captures == 0, f"nats -> bert captured on the path: {report}")
    by_id = sorted(rows, key=lambda r: r["id"])
    labels = check_json_rows(by_id, list(range(NATS_TEXTS)), state["ref"], "nats")
    return {**report, **{f"rows_{k}": v for k, v in labels.items()}}


def run_fanin_bert(runner: ModelRunner, ab: dict) -> dict:
    """``ws_redis_bert_http.json`` on the padded BERT-base runner:
    ``multiple_inputs`` of a websocket feed (FANIN_TEXTS texts, ids from 0)
    and a Redis pub/sub channel (FANIN_TEXTS more, ids from FANIN_TEXTS),
    each message its own batch (no buffer: the children's metadata
    differ); every id once at the HTTP sink, each child's range whole, the
    bearer header on every request, every label and score equal bit for bit
    to the runner's on the same texts at the same shape (batch bucket 16,
    the text's own seq bucket); K1 = layers x steps, all ``mma``."""
    raw = broker_config(FANIN_BERT_CONFIG)
    built_small(raw)
    texts = broker_texts(2 * FANIN_TEXTS, seed=23)
    rows_in = [{"id": i, "text": t} for i, t in enumerate(texts)]
    counted: dict = {}
    state: dict = {}

    def prepare(stream) -> None:
        proc = stream.pipeline.processors[0]
        ids, mask = proc.tokenizer.encode_batch([t.encode() for t in texts], proc.max_seq)
        lengths = mask.sum(axis=1)
        label, score = np.zeros(len(texts), np.int64), np.zeros(len(texts), np.float32)
        rows = runner.buckets.batch_bucket(1)
        by_bucket: dict = {}
        for i, n in enumerate(lengths):
            by_bucket.setdefault(runner.buckets.seq_bucket(int(n)), []).append(i)
        for idx in by_bucket.values():  # one shape key a call, as each 1-row batch runs
            for at in range(0, len(idx), rows):
                part = idx[at:at + rows]
                out = runner.infer_sync({"input_ids": ids[part], "attention_mask": mask[part]})
                label[part], score[part] = np.asarray(out["label"]), np.asarray(out["score"])
        state["label"], state["score"] = label, score
        torch.cuda.synchronize()
        swap_in(stream, 0, runner, counted)

    rep = asyncio.run(broker_streams.ws_redis_to_http(
        raw, [json.dumps(r) for r in rows_in[:FANIN_TEXTS]],
        [json.dumps(r).encode() for r in rows_in[FANIN_TEXTS:]], prepare=prepare))
    torch.cuda.synchronize()
    launches = {"k1": ra.launches.value, "k1_variants": dict(ra.launches.variants),
                "k2": sa.launches.value}
    steps = runner.device_steps - counted["device_steps"]
    rows = [json.loads(r) for r in rep["rows"]]
    keys_ok = all(list(r) == JSON_KEYS for r in rows)
    got = scores_by_id(rows) if keys_ok else {}
    want = {i: (int(state["label"][i]), float(state["score"][i])) for i in range(len(texts))}
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "requests", "connections", "ws_handshakes",
                                  "redis_published")}
    report.update(rows=len(rows), raw_rows_per_s=ab["padded"]["graphed"]["traffic_rows_per_s"],
                  ws_ids_whole=sorted(i for i in got if i < FANIN_TEXTS) == list(
                      range(FANIN_TEXTS)),
                  redis_ids_whole=sorted(i for i in got if i >= FANIN_TEXTS) == list(
                      range(FANIN_TEXTS, 2 * FANIN_TEXTS)),
                  bearer_on_every_request=all(h.get("authorization") == "Bearer dev-token"
                                              for h in rep["headers"]),
                  statuses=sorted(set(rep["answered"])), device_steps=steps,
                  layers=runner.cfg.layers, launches=launches,
                  captures_on_path=runner.captures - counted["captures"],
                  equal_bitwise_runner=got == want,
                  max_score_abs_err=max((abs(got[i][1] - want[i][1]) for i in got), default=None))
    print("brokers fanin " + json.dumps(report), flush=True)
    check(keys_ok and len(rows) == 2 * FANIN_TEXTS and report["ws_ids_whole"]
          and report["redis_ids_whole"], f"ws + redis -> bert -> http lost, repeated or "
                                         f"misshaped rows: {report}")
    check(report["bearer_on_every_request"] and report["statuses"] == [200],
          f"ws + redis -> http: a request without the bearer, or not answered 200: {report}")
    check(rep["errors"] == 0, f"ws + redis -> bert -> http reported errors: {report}")
    check(report["equal_bitwise_runner"],
          f"ws + redis -> bert: labels or scores != the padded runner's: {report}")
    check(launches["k1"] > 0 and launches["k1"] == runner.cfg.layers * steps,
          f"ws + redis -> bert: K1 launches != layers x device steps: {report}")
    check(launches["k1_variants"].get("mma") == launches["k1"],
          f"ws + redis -> bert: a K1 launch missed the mma tile: {report}")
    check(launches["k2"] == 0 and report["captures_on_path"] == 0,
          f"ws + redis -> bert launched K2 or captured on the path: {report}")
    return report


def run_modbus_influx() -> dict:
    """``modbus_influx.json`` polled every 10 ms (the example's 1 s) into an
    InfluxDB sink (flush every 50 ms), MODBUS_POLLS polls; every line equal
    to ``encode_lines`` of the values the fake served for its poll. Host
    only: a point holds at most 125 registers, no LSTM window."""
    raw = broker_config(MODBUS_INFLUX_CONFIG)
    s = raw["streams"][0]
    s["input"]["interval"] = "10ms"
    s["output"]["flush_interval"] = "50ms"
    points, out_cfg = s["input"]["points"], s["output"]
    rep = asyncio.run(broker_streams.modbus_to_influx(raw, MODBUS_POLLS))
    served = rep["served"]
    want = [encode_lines(MessageBatch.from_pydict(
        {p["name"]: [served[len(points) * i + j][3][0]] for j, p in enumerate(points)}),
        out_cfg["measurement"], out_cfg.get("tags", {}), out_cfg["fields"], None)[0]
        for i in range(len(rep["lines"]))]
    got = [line.decode() for line in rep["lines"]]
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s")}
    report.update(lines=len(got), requests_served=len(served),
                  statuses=sorted(set(rep["answered"])), lines_equal=got == want,
                  first_line=got[0] if got else None)
    print("brokers modbus " + json.dumps(report), flush=True)
    check(len(got) >= MODBUS_POLLS and report["lines_equal"] and rep["errors"] == 0,
          f"modbus -> influxdb lines != encode_lines of the served values: {report}")
    return report


def run_redis_lstm(lstm: dict) -> dict:
    """``redis_lstm_influx.json`` on the LSTM phase's graphed runner:
    REDIS_WINDOWS ``{"id", "window"}`` messages (the LSTM phase's windows'
    float32 values) on two list keys, an InfluxDB sink that answers the
    first write 500; one line a window, exactly one retry (the same body
    again), every score equal bit for bit to the runner on the same windows
    in the stream's own batches, and to the raw-bytes run's at the float32
    floor."""
    raw = broker_config(REDIS_LSTM_CONFIG)
    values = lstm["values"][:REDIS_WINDOWS]
    payloads = [json.dumps({"id": i, "window": v.reshape(-1).tolist()}).encode()
                for i, v in enumerate(values)]
    runner = lstm["runner"]
    counted: dict = {}
    emitted: list[int] = []

    def prepare(stream) -> None:
        count_emissions(stream, emitted)
        swap_in(stream, 0, runner, counted)

    rep = asyncio.run(broker_streams.redis_to_influx(raw, payloads, statuses=[500],
                                                      prepare=prepare))
    torch.cuda.synchronize()
    parsed = [line.split(b" ") for line in rep["lines"]]
    ids = [int(p[0].split(b"id=")[1]) for p in parsed]
    got = np.array([float(p[1].split(b"score=")[1]) for p in parsed], np.float32)
    ref, at = [], 0
    for n in emitted:  # the stream's own batches, through the same runner
        ref.append(np.asarray(runner.infer_sync({"values": values[at:at + n]})["score"]))
        at += n
    ref = np.concatenate(ref).astype(np.float32) if ref else np.zeros(0, np.float32)
    want = lstm["scores"][:REDIS_WINDOWS]
    err = np.abs(got - want) if got.shape == want.shape else np.array([np.inf])
    answered = rep["answered"]
    report = {k: rep[k] for k in ("rows_out", "errors", "wall_s", "traffic_seconds",
                                  "rows_per_s", "connections", "left_in_lists")}
    report.update(lines=len(got), raw_rows_per_s=lstm["report"]["traffic_windows_per_s"],
                  requests=len(answered), retries=answered.count(500),
                  retry_resent_body=len(rep["bodies"]) > 1
                  and rep["bodies"][0] == rep["bodies"][1],
                  ids_in_order=ids == list(range(REDIS_WINDOWS)),
                  emissions=len(emitted),
                  emission_rows={"min": min(emitted), "max": max(emitted)} if emitted else None,
                  equal_bitwise_same_batches=bool(got.shape == ref.shape and np.array_equal(
                      got.view(np.int32), ref.view(np.int32))),
                  max_abs_err_vs_raw_run=float(err.max()),
                  captures_on_path=runner.captures - counted["captures"])
    print("brokers redis " + json.dumps(report), flush=True)
    check(len(got) == REDIS_WINDOWS and report["ids_in_order"] and rep["errors"] == 0,
          f"redis -> lstm -> influxdb lost, repeated or reordered lines: {report}")
    check(report["retries"] == 1 and answered[0] == 500 and report["retry_resent_body"],
          f"redis -> influxdb: not exactly one retry of the failed write: {report}")
    check(report["equal_bitwise_same_batches"],
          f"redis -> lstm scores != the runner's on the same batches: {report}")
    check(bool(np.all(err <= LSTM_TOL + LSTM_TOL * np.abs(want))),
          f"redis -> lstm scores off the raw-bytes run's float32 floor: {report}")
    check(report["captures_on_path"] == 0, f"redis -> lstm captured on the path: {report}")
    return report


OVERLOAD_CONFIG = os.path.join(EXAMPLES, "overload_stream.json")
MULTITENANT_CONFIG = os.path.join(EXAMPLES, "multitenant_bert_stream.json")
#: rows the burst part's generate input makes (x 4 offered by the burst),
#: 2 a read every ``OVERLOAD_INTERVAL`` (the example's 5 ms leaves the offered
#: rate bound by the event loop at 1.5-2x the control's on the card); the
#: control run without the controller drains fewer
OVERLOAD_ROWS = 1600
OVERLOAD_CONTROL_ROWS = 400
OVERLOAD_INTERVAL = "1ms"
#: the tenants part: 3 generate tenants, 5 rows a read every 3 ms (about
#: 550 rows/s each, 11x tenant1's 50 rows/s quota)
TENANT_ROWS = 4500
TENANT_BATCH = 5
TENANT_INTERVAL = "3ms"
#: the example run as written: POSTs per tenant on keep-alive connections,
#: back to back, then one every ``TENANT_POST_GAP_S``. ``free``'s first 40
#: spend most of its 50-row burst; its later ones (4x its quota's rate)
#: meet a bucket its admissions keep under one row at times, and those are
#: answered 429. It goes on, up to ``TENANT_POSTS_MAX`` slow ones, until
#: three were
TENANT_POSTS = {"premium": (8, 0), "free": (40, 45), "other": (7, 0)}
TENANT_POST_GAP_S = 0.005
TENANT_POSTS_MAX = 160
CACHE_DUPLICATES = 16
#: texts of the BERT restart part, one a read (1024 until the SQL slice)
RESTART_TEXTS = 512


class ShedSink(Output):
    """Wraps a stream's output or error_output: per batch its ``offer`` ids
    (the smoke's per-delivery stamp), tenant, shed tags, rows, e2e seconds
    from the ingest stamp, and the named output columns."""

    def __init__(self, inner: Output, names: tuple = ()):
        self.inner = inner
        self.names = names
        self.batches: list[dict] = []

    async def connect(self) -> None:
        await self.inner.connect()

    async def write(self, batch: MessageBatch) -> None:
        d = batch.to_pydict()
        ingest = batch.get_meta("__meta_ingest_time")
        self.batches.append({
            "offer": d.get("__meta_ext_offer", [None])[0], "tenant": batch.tenant(),
            "tenants": sorted(set(d.get("__meta_ext_tenant") or [None]), key=str),
            "error": batch.get_meta("__meta_ext_error"),
            "reason": batch.get_meta("__meta_ext_shed_reason"), "rows": batch.num_rows,
            "texts": batch.to_binary(),
            "e2e_s": None if ingest is None else time.time() - ingest / 1000.0,
            **{n: (np.asarray(batch.column(n)) if isinstance(batch.column(n), np.ndarray)
                   else batch.column(n).to_pylist()) for n in self.names}})
        await self.inner.write(batch)

    async def close(self) -> None:
        await self.inner.close()


def stamp_offers(stream) -> dict:
    """Each batch the stream's input hands out gets its own ``offer`` id in
    ``__meta_ext_offer`` (burst duplicates included): a delivery is then
    counted once, wherever it ends."""
    read, state = stream.input.read, {"n": 0}

    async def stamped():
        batch, ack = await read()
        state["n"] += 1
        return batch.with_ext_metadata({"offer": str(state["n"])}), ack

    stream.input.read = stamped
    return state


def overload_processor(**kw) -> dict:
    """``gpu_inference`` of the padded stream's grid, built at one layer and
    without warmup: the padded runner is swapped in before each run."""
    return {"type": "gpu_inference", "model": "bert_classifier", "model_config": {"layers": 1},
            "serving_dtype": "bfloat16", "max_seq": 256, "seq_buckets": [64, 128, 256],
            "batch_buckets": [16, 64], "outputs": ["label", "logits"], "warmup": False, **kw}


def held_to_reference(rows: list[dict], ref: dict, what: str) -> dict:
    """Every delivered row's label and logits against the padded runner's on
    the same text: logits within 1/64, labels equal on tie-free rows."""
    err, mismatches, tie_free, n = 0.0, 0, 0, 0
    for b in rows:
        for text, label, logits in zip(b["texts"], b["label"], b["logits"]):
            want = ref[text]
            err = max(err, float(np.abs(np.asarray(logits, np.float32) - want["logits"]).max()))
            if want["gap"] > LABEL_MARGIN:
                tie_free += 1
                mismatches += int(label) != want["label"]
            n += 1
    out = {"rows": n, "max_logit_abs_err": err, "tie_free_rows": tie_free,
           "label_mismatches_tie_free": mismatches}
    check(err <= LOGIT_TOL, f"{what}: logits off the padded runner's: {out}")
    check(mismatches == 0, f"{what}: tie-free labels differ from the padded runner's: {out}")
    return out


def stream_tokenizer(runner: ModelRunner):
    """The tokenizer a ``gpu_inference`` without ``tokenizer`` builds."""
    from arkflow_tpu_torch.tpu.tokenizer import build_tokenizer

    return build_tokenizer(None, vocab_size=runner.cfg.vocab_size)


def reference_outputs(runner: ModelRunner, tokenizer, texts: list[bytes], max_seq: int) -> dict:
    """The padded runner's label, logits and top-2 gap for each text."""
    ids, mask = tokenizer.encode_batch(texts, max_seq)
    out = runner.infer_sync({"input_ids": ids, "attention_mask": mask})
    torch.cuda.synchronize()
    ref = {}
    for i, t in enumerate(texts):
        logits = np.asarray(out["logits"][i], np.float32)
        top2 = np.sort(logits)
        ref[t] = {"label": int(out["label"][i]), "logits": logits,
                  "gap": float(top2[-1] - top2[-2])}
    return ref


class GcWatch:
    """Python's collections and the first steps of one admission stream.
    ``collect_before`` runs the ``gc.collect()`` the stream starts after
    and times it: the full pass that would otherwise fall due inside the
    run, and one that lands in a first step sets the controller's step
    estimate (JAX's rule, ROADMAP Queue C). While the watch is entered it
    records every collection (generation, ms) through ``gc.callbacks`` and
    each step time the controller observes, so the report shows whether a
    collection overlapped the first step and how long that step took."""

    def __init__(self, ctrl) -> None:
        self.ctrl = ctrl
        self.before: dict = {}
        self.passes: list = []  # (generation, start, seconds)
        self.steps: list = []  # (end, seconds)
        self._start: dict = {}

    def collect_before(self) -> None:
        counts = gc.get_count()
        t0 = time.perf_counter()
        found = gc.collect()
        self.before = {"ms": (time.perf_counter() - t0) * 1e3, "found": found,
                       "counts": list(counts)}

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start[info["generation"]] = time.monotonic()
        elif info["generation"] in self._start:
            t0 = self._start.pop(info["generation"])
            self.passes.append((info["generation"], t0, time.monotonic() - t0))

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self._on_gc)
        if self.ctrl is not None:
            inner = self.ctrl.observe_step

            def observe_step(dt_s: float) -> None:
                self.steps.append((time.monotonic(), dt_s))
                inner(dt_s)

            self.ctrl.observe_step = observe_step
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._on_gc)
        if self.ctrl is not None:
            del self.ctrl.observe_step

    def report(self) -> dict:
        first = self.steps[0] if self.steps else None
        in_first = sum(max(0.0, min(t0 + d, first[0]) - max(t0, first[0] - first[1]))
                       for _, t0, d in self.passes) if first else 0.0
        return {"gc_before": self.before, "gc_in_run": len(self.passes),
                "gc_in_run_gen2": sum(1 for g, _, _ in self.passes if g == 2),
                "gc_in_run_max_ms": max((d for _, _, d in self.passes), default=0.0) * 1e3,
                "gc_in_run_total_ms": sum(d for _, _, d in self.passes) * 1e3,
                "gc_in_first_step_ms": in_first * 1e3,
                "first_steps_ms": [d * 1e3 for _, d in self.steps[:5]],
                "max_step_ms": max((d for _, d in self.steps), default=0.0) * 1e3}


def run_burst_stream(runner: ModelRunner, texts: list[str], controller: bool) -> dict:
    """``overload_stream.json`` with its latency stand-in replaced by
    ``gpu_inference`` on the padded runner: generate (the example's 2 rows
    every 5 ms, here two long texts) under the example's 4x burst fault;
    ``controller`` False runs it with ``overload: false``."""
    raw = broker_config(OVERLOAD_CONFIG)
    s = raw["streams"][0]
    s["name"] = f"overload-burst-{'on' if controller else 'off'}"
    s["input"]["inner"].update(payloads=texts, interval=OVERLOAD_INTERVAL, count=(
        OVERLOAD_ROWS if controller else OVERLOAD_CONTROL_ROWS))
    s["input"]["inner"].pop("payload")
    s["pipeline"]["processors"] = [overload_processor()]
    if not controller:
        s["pipeline"]["overload"] = False
    s["output"] = s["error_output"] = {"type": "drop"}
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    sink = stream.output = ShedSink(stream.output, ("label", "logits"))
    shed = stream.error_output = ShedSink(stream.error_output)
    offers = stamp_offers(stream)
    counted: dict = {}
    rows_in0 = stream.m_rows_in.value
    swap_in(stream, 0, runner, counted)
    ctrl = stream.overload
    shed0 = {r: c.value for r, c in ctrl.m_shed.items()} if ctrl else {}
    windows: list = []

    async def go():
        async def sample():
            while True:
                windows.append(ctrl.window)
                await asyncio.sleep(0.005)

        sampler = asyncio.ensure_future(sample()) if ctrl else None
        try:
            await engine.run()
        finally:
            if sampler is not None:
                sampler.cancel()

    watch = GcWatch(ctrl)
    watch.collect_before()
    with watch:
        asyncio.run(go())
    torch.cuda.synchronize()
    steps = runner.device_steps - counted["device_steps"]
    delivered_rows = sum(b["rows"] for b in sink.batches)
    e2e = [b["e2e_s"] * 1e3 for b in sink.batches]
    offered_rows = stream.m_rows_in.value - rows_in0
    report = {"controller": controller, "offered_batches": offers["n"],
              "offered_rows": offered_rows, "delivered_batches": len(sink.batches),
              "delivered_rows": delivered_rows, "shed_batches": len(shed.batches),
              "shed_rows": sum(b["rows"] for b in shed.batches),
              "traffic_seconds": stream.traffic_seconds,
              "offered_rows_per_s": offered_rows / stream.traffic_seconds,
              "delivered_rows_per_s": delivered_rows / stream.traffic_seconds,
              "e2e_p50_ms": quantile_ms(e2e, 0.50), "e2e_p99_ms": quantile_ms(e2e, 0.99),
              "device_steps": steps, "captures_on_path": runner.captures - counted["captures"],
              "k1_launches": ra.launches.value, "k1_variants": dict(ra.launches.variants),
              "errors": stream.errors, **watch.report()}
    if ctrl is not None:
        reasons = [b["reason"] for b in shed.batches]
        report.update(
            shed_by_reason={r: reasons.count(r) for r in sorted(set(reasons))},
            shed_total_delta={r: int(c.value - shed0[r]) for r, c in ctrl.m_shed.items()
                              if c.value - shed0[r]},
            window_min=min(windows), window_max=max(windows),
            paused_s=ctrl.m_paused_s.value, final_state=ctrl.report()["state"])
    ids = [b["offer"] for b in sink.batches] + [b["offer"] for b in shed.batches]
    report["each_offer_once"] = sorted(ids, key=int) == [str(i) for i in range(1, offers["n"] + 1)]
    return {"report": report, "sink": sink, "shed": shed}


def run_overload_burst(runner: ModelRunner) -> dict:
    """The ``overload burst`` part: the control without the controller, then
    the example's controller at its knobs. Exact: offered batches = delivered
    + shed, in batches and rows; every shed batch tagged ``overloaded`` with
    a reason of ``SHED_REASONS``, the ``arkflow_shed_total`` deltas equal to
    the tagged counts by reason; each delivery once; labels and logits held
    to the padded runner; K1 = 12 x steps, all ``mma``, no capture on the
    path; offered rows/s at least 1.5x the control's sustained rows/s;
    delivered-batch p99 e2e at most 2x the deadline."""
    from arkflow_tpu_torch.runtime.overload import SHED_REASONS

    mix = json.load(open(CONFIG))["streams"][0]["input"]["payloads"]
    texts = sorted(mix, key=len)[-3:-1]  # two long texts: the 256 seq bucket
    ref = reference_outputs(runner, stream_tokenizer(runner), [t.encode() for t in texts], 256)
    control = run_burst_stream(runner, texts, controller=False)["report"]
    run = run_burst_stream(runner, texts, controller=True)
    rep = run["report"]
    deadline = json.load(open(OVERLOAD_CONFIG))["streams"][0]["pipeline"]["deadline_ms"]
    rep["control_sustained_rows_per_s"] = control["delivered_rows_per_s"]
    rep["offered_over_sustained"] = rep["offered_rows_per_s"] / control["delivered_rows_per_s"]
    rep["rows"] = held_to_reference(run["sink"].batches, ref, "overload burst")
    print("overload burst " + json.dumps({"controlled": rep, "control": control}), flush=True)
    for r in (rep, control):
        check(r["offered_batches"] == r["delivered_batches"] + r["shed_batches"]
              and r["offered_rows"] == r["delivered_rows"] + r["shed_rows"],
              f"overload burst: offered != delivered + shed: {r}")
        check(r["each_offer_once"], f"overload burst: a delivery lost or repeated: {r}")
        check(r["errors"] == 0, f"overload burst: processing errors: {r}")
        check(r["k1_launches"] == runner.cfg.layers * r["device_steps"] > 0
              and r["k1_variants"].get("mma") == r["k1_launches"],
              f"overload burst: K1 != 12 x steps or not all mma: {r}")
        check(r["captures_on_path"] == 0, f"overload burst: captured on the path: {r}")
    check(control["shed_batches"] == 0, f"overload burst: the control shed: {control}")
    check(all(b["error"] == "overloaded" and b["reason"] in SHED_REASONS
              for b in run["shed"].batches), f"overload burst: a shed batch untagged: {rep}")
    check(rep["shed_by_reason"] == rep["shed_total_delta"] and rep["shed_batches"] > 0,
          f"overload burst: arkflow_shed_total != error_output by reason: {rep}")
    check(rep["offered_over_sustained"] >= 1.5,
          f"overload burst: offered under 1.5x the sustained rate: {rep}")
    check(rep["e2e_p99_ms"] <= 2 * deadline,
          f"overload burst: delivered p99 over 2x the deadline: {rep}")
    return {"controlled": rep, "control": control}


def tenant_config() -> dict:
    """``multitenant_bert_stream.json``'s buffer, pipeline, processor and
    error_output, with ``generate`` (3 tenants) in place of its HTTP input;
    ``tenant0`` takes the example's premium contract (weight 8), ``tenant1``
    its free one (50 rows/s), ``tenant2`` no quota."""
    raw = broker_config(MULTITENANT_CONFIG)
    s = raw["streams"][0]
    tenants = s["pipeline"]["overload"]["tenants"]
    per = tenants["per_tenant"]
    tenants["per_tenant"] = {"tenant0": per["premium"], "tenant1": per["free"]}
    tenants.pop("default_quota")
    s["pipeline"]["processors"][0].update(warmup=False, model_config={"layers": 1},
                                          outputs=["label", "logits"])
    s["output"] = s["error_output"] = {"type": "drop"}
    return raw


def tenant_texts() -> list[str]:
    return [t for t in broker_texts(256, seed=31) if len(t.split()) <= 30][:TENANT_BATCH]


def run_tenant_stream(runner: ModelRunner, ref: dict) -> dict:
    """Three generate tenants, each offered about 11x ``tenant1``'s quota:
    no emission mixes tenants, quota sheds hit ``tenant1`` only, offered =
    delivered + shed per tenant, the quiet tenants' delivered p99 within
    the deadline, labels and logits held to the padded runner."""
    raw = tenant_config()
    s = raw["streams"][0]
    s["input"] = {"type": "generate", "payloads": tenant_texts(), "batch_size": TENANT_BATCH,
                  "interval": TENANT_INTERVAL, "count": TENANT_ROWS, "tenants": 3}
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    sink = stream.output = ShedSink(stream.output, ("label", "logits"))
    shed = stream.error_output = ShedSink(stream.error_output)
    counted: dict = {}
    swap_in(stream, 0, runner, counted)
    ctrl = stream.overload
    quota0 = ctrl.m_shed["quota"].value
    watch = GcWatch(ctrl)
    watch.collect_before()
    with watch:
        asyncio.run(engine.run())
    torch.cuda.synchronize()
    deadline = s["pipeline"]["deadline_ms"]
    tenants = {}
    for name in ("tenant0", "tenant1", "tenant2"):
        out = [b for b in sink.batches if b["tenant"] == name]
        sh = [b for b in shed.batches if b["tenant"] == name]
        e2e = [b["e2e_s"] * 1e3 for b in out]
        tenants[name] = {"offered_rows": TENANT_ROWS // 3,
                         "delivered_rows": sum(b["rows"] for b in out),
                         "shed_rows": sum(b["rows"] for b in sh),
                         "shed_by_reason": {r: sum(b["rows"] for b in sh if b["reason"] == r)
                                            for r in sorted({b["reason"] for b in sh})},
                         "e2e_p50_ms": quantile_ms(e2e, 0.5), "e2e_p99_ms": quantile_ms(e2e, 0.99)}
    mixed = sum(1 for b in sink.batches + shed.batches if len(b["tenants"]) != 1)
    cache = stream.pipeline.processors[0].cache.report()
    steps = runner.device_steps - counted["device_steps"]
    report = {"tenants": tenants, "quota_shed_total_delta": ctrl.m_shed["quota"].value - quota0,
              "emissions": len(sink.batches) + len(shed.batches), "mixed_emissions": mixed,
              "cache": cache, "device_steps": steps, "k1_launches": ra.launches.value,
              "k1_variants": dict(ra.launches.variants),
              "captures_on_path": runner.captures - counted["captures"],
              "traffic_seconds": stream.traffic_seconds, "errors": stream.errors,
              **watch.report()}
    report["rows"] = held_to_reference(sink.batches, ref, "overload tenants")
    print("overload tenants stream " + json.dumps(report), flush=True)
    check(mixed == 0 and all(b["tenant"] in tenants for b in sink.batches + shed.batches),
          f"overload tenants: an emission mixes tenants or has none: {report}")
    for name, t in tenants.items():
        check(t["offered_rows"] == t["delivered_rows"] + t["shed_rows"],
              f"overload tenants: {name} offered != delivered + shed: {report}")
        check(("quota" in t["shed_by_reason"]) == (name == "tenant1"),
              f"overload tenants: quota sheds not on tenant1 alone: {report}")
        if name != "tenant1":
            check(t["e2e_p99_ms"] <= deadline,
                  f"overload tenants: quiet {name}'s delivered p99 over the deadline: {report}")
    check(report["quota_shed_total_delta"] > 0, f"overload tenants: no quota shed: {report}")
    check(report["k1_launches"] == runner.cfg.layers * steps
          and report["k1_variants"].get("mma") == report["k1_launches"],
          f"overload tenants: K1 != 12 x steps or not all mma: {report}")
    check(report["captures_on_path"] == 0 and stream.errors == 0,
          f"overload tenants: captured on the path or errors: {report}")
    return {"report": report, "proc": stream.pipeline.processors[0]}


def cached_duplicates(proc, runner: ModelRunner) -> dict:
    """16 concurrent identical batches through the cached processor: one
    device step, K1 = 12 x 1, 16 bitwise-equal outputs."""
    texts = [t.encode() for t in broker_texts(8, seed=37)]
    batch = MessageBatch.new_binary(texts).with_tenant("tenant0")
    steps0, cache0 = runner.device_steps, dict(proc.cache.report())
    reset_counts()

    async def go():
        return await asyncio.gather(*[proc.process(batch) for _ in range(CACHE_DUPLICATES)])

    outs = asyncio.run(go())
    torch.cuda.synchronize()
    cols = [o[0].to_pydict() for o in outs]
    first = np.asarray(cols[0]["logits"], np.float32)
    equal = all(c["label"] == cols[0]["label"]
                and np.asarray(c["logits"], np.float32).tobytes() == first.tobytes() for c in cols)
    cache = proc.cache.report()
    report = {"duplicates": CACHE_DUPLICATES, "device_steps": runner.device_steps - steps0,
              "k1_launches": ra.launches.value, "bitwise_equal": equal,
              "misses": cache["misses"] - cache0["misses"],
              "collapsed": cache["collapsed"] - cache0["collapsed"]}
    print("overload cache " + json.dumps(report), flush=True)
    check(report["device_steps"] == 1 and report["k1_launches"] == runner.cfg.layers and equal
          and report["misses"] == 1 and report["collapsed"] == CACHE_DUPLICATES - 1,
          f"overload cache: duplicates did not collapse onto one step: {report}")
    return report


def run_tenant_http(runner: ModelRunner) -> dict:
    """The example as written (HTTP with ``tenant_header``, its tenants,
    quotas and cache) on the padded runner: about 100 POSTs from three
    tenants on keep-alive connections. Each request's batch carries its
    tenant; every 429 is ``free``'s, with ``Retry-After`` the ceiling (at
    least 1) of the wait its bucket gave at the check; every 200 is delivered
    or in error_output."""
    raw = broker_config(MULTITENANT_CONFIG)
    s = raw["streams"][0]
    s["input"]["port"] = 0
    s["pipeline"]["processors"][0].update(warmup=False, model_config={"layers": 1})
    s["output"] = s["error_output"] = {"type": "drop"}
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    sink = stream.output = ShedSink(stream.output)
    shed = stream.error_output = ShedSink(stream.error_output)
    counted: dict = {}
    swap_in(stream, 0, runner, counted)
    waits: list = []
    quota_wait = stream.overload.quota_retry_after_s

    def logged(tenant, *a, **kw):
        w = quota_wait(tenant, *a, **kw)
        waits.append((tenant, w))
        return w

    stream.overload.quota_retry_after_s = logged

    async def client(port: int, tenant: str, fast: int, slow: int) -> list:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        try:
            i = 0
            while i < fast + slow or (slow and i < fast + TENANT_POSTS_MAX
                                      and sum(a[0] == 429 for a in out) < 3):
                if i >= fast:
                    await asyncio.sleep(TENANT_POST_GAP_S)
                body = f"{tenant} request {i} classify this text".encode()
                writer.write((f"POST /infer HTTP/1.1\r\nHost: smoke\r\nConnection: keep-alive"
                              f"\r\nX-Tenant-Id: {tenant}\r\nContent-Length: {len(body)}\r\n\r\n")
                             .encode() + body)
                await writer.drain()
                head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
                hdrs = {k.strip().lower(): v.strip() for k, _, v in
                        (h.partition(":") for h in head[1:] if h)}
                text = await reader.readexactly(int(hdrs.get("content-length", "0")))
                out.append((int(head[0].split()[1]), hdrs.get("retry-after"), body,
                            text.decode()))
                i += 1
        finally:
            writer.close()
        return out

    async def go():
        task = asyncio.ensure_future(engine.run())
        while not stream.input.port:
            await asyncio.sleep(0.01)
        res = await asyncio.gather(*[client(stream.input.port, t, *n)
                                     for t, n in TENANT_POSTS.items()])
        await asyncio.sleep(0.5)
        engine.shutdown()
        await asyncio.wait_for(task, 60)
        return dict(zip(TENANT_POSTS, res))

    answers = asyncio.run(go())
    torch.cuda.synchronize()
    free_waits = [w for t, w in waits if t == "free" and w > 0]
    got_429 = [(t, r, msg) for t, rs in answers.items() for s_, r, _, msg in rs if s_ == 429]
    retry_free = [int(r) for t, r, msg in got_429
                  if t == "free" and msg == "tenant quota exceeded"]
    want_retry = [max(1, math.ceil(w)) for w in free_waits]
    seen = {}
    for b in sink.batches + shed.batches:
        for text in b["texts"]:
            seen[text] = b["tenant"]
    ok = [(t, body) for t, rs in answers.items() for s_, _, body, _ in rs if s_ == 200]
    report = {"posts": sum(map(len, answers.values())), "ok": len(ok),
              "rejected_429": len(got_429),
              "retry_after": sorted(set(retry_free)), "delivered_rows": sum(
                  b["rows"] for b in sink.batches), "shed_rows": sum(b["rows"] for b in shed.batches),
              "shed_by_reason": sorted({b["reason"] for b in shed.batches}),
              "device_steps": runner.device_steps - counted["device_steps"],
              "k1_launches": ra.launches.value}
    print("overload tenants http " + json.dumps(report), flush=True)
    check(len(got_429) > 0 and all(t == "free" and msg == "tenant quota exceeded"
                                   for t, _, msg in got_429),
          f"overload tenants http: 429s not free's quota alone: {report}")
    check(retry_free == want_retry, f"overload tenants http: Retry-After != ceil(time_until): "
                                    f"{retry_free} vs {want_retry}")
    check(all(seen.get(body) == t for t, body in ok),
          f"overload tenants http: a 200 lost or stamped with another tenant: {report}")
    check({s_ for rs in answers.values() for s_, _, _, _ in rs} <= {200, 429},
          f"overload tenants http: a status other than 200/429: {answers}")
    return report


def run_overload_tenants(runner: ModelRunner) -> dict:
    mt = json.load(open(MULTITENANT_CONFIG))["streams"][0]["pipeline"]["processors"][0]
    ref = reference_outputs(runner, stream_tokenizer(runner),
                            [t.encode() for t in tenant_texts()], mt["max_seq"])
    reset_counts()
    stream = run_tenant_stream(runner, ref)
    cache = cached_duplicates(stream["proc"], runner)
    reset_counts()
    http = run_tenant_http(runner)
    return {"stream": stream["report"], "cache": cache, "http": http}


def restart_config(name: str, texts: list[str], crash: bool) -> dict:
    """A memory input of the texts (one a read) under a crash fault at its
    third read, ``gpu_inference`` at BERT-base width on a one-bucket grid (one
    graph a build), restart ``{max_retries: 3, backoff: 10ms}``, the health
    server on loopback port 0."""
    return {"health_check": {"enabled": True, "host": "127.0.0.1", "port": 0},
            "streams": [{
                "name": name, "restart": {"max_retries": 3, "backoff": "10ms"},
                "input": {"type": "fault", "faults": [{"kind": "crash", "at": 3}] if crash else [],
                          "inner": {"type": "memory", "messages": texts}},
                "pipeline": {"thread_num": 1, "processors": [{
                    "type": "gpu_inference", "model": "bert_classifier", "model_config": {},
                    "serving_dtype": "bfloat16", "max_seq": 64, "batch_buckets": [1],
                    "seq_buckets": [64], "outputs": ["label", "logits"], "warmup": True,
                    "seed": 0}]},
                "output": {"type": "drop"}}]}


def run_restart_engine(raw: dict, health: bool = False,
                       names: tuple = ("label", "logits")) -> dict:
    """The engine over ``raw``; every build's output wrapped (the rebuild's
    too) to keep the ``names`` columns, ``/health`` read once the rebuilt
    stream runs."""
    import arkflow_tpu_torch.runtime.engine as engine_mod

    engine = Engine(EngineConfig.from_mapping(raw))
    first = engine.build()[0]
    sinks = [ShedSink(first.output, names)]
    first.output = sinks[0]
    built = engine_mod.build_stream

    def rebuild(cfg, name=None):
        stream = built(cfg, name=name)
        stream.output = ShedSink(stream.output, names)
        sinks.append(stream.output)
        return stream

    body: dict = {}

    async def go():
        task = asyncio.ensure_future(engine.run())
        while health and not task.done():
            await asyncio.sleep(0.01)
            if engine.health_port and engine.streams[0] is not first:
                status, raw_body = await http_call(engine.health_port, "GET", "/health")
                body.update(json.loads(raw_body)["stream_health"][first.name], status=status)
                break
        await task

    engine_mod.build_stream = rebuild
    try:
        asyncio.run(go())
    finally:
        engine_mod.build_stream = built
    torch.cuda.synchronize()
    return {"engine": engine, "first": first, "sinks": sinks, "health": body}


def outputs_by_text(sinks) -> dict:
    out = {}
    for sink in sinks:
        for b in sink.batches:
            for text, label, logits in zip(b["texts"], b["label"], b["logits"]):
                out.setdefault(text, []).append(
                    (int(label), np.asarray(logits, np.float32).tobytes()))
    return out


def run_overload_restart() -> dict:
    """The ``restart`` part: a crash-free run (the reference, and one
    runner's footprint in ``memory_reserved``), then the crashing one through
    the port's ``Engine``. Exact: the crash fires once; ``/health`` shows
    ``restarts`` 1 and ``restart_budget_remaining`` 2; every text delivered;
    the rebuilt stream's outputs equal the crash-free run's bit for bit;
    K1 = 12 x steps of both runners; after the engine stops,
    ``memory_reserved`` within one runner's footprint of its value before."""
    texts = broker_texts(RESTART_TEXTS, seed=41)
    release_memory()
    before_ref = reserved_bytes()
    ref = run_restart_engine(restart_config("restart-reference", texts, crash=False))
    footprint = reserved_bytes() - before_ref
    clean = outputs_by_text(ref["sinks"])
    ref["engine"].streams[0].release()
    del ref
    release_memory()
    raw = restart_config("restart-crash", texts, crash=True)
    before = reserved_bytes()
    reset_counts()
    run = run_restart_engine(raw, health=True)
    engine, first = run["engine"], run["first"]
    live = engine.streams[0]
    release_memory()
    after = reserved_bytes()
    steps = (first.pipeline.processors[0].runner.device_steps
             + live.pipeline.processors[0].runner.device_steps)
    crashed = outputs_by_text(run["sinks"])
    rebuilt = outputs_by_text(run["sinks"][1:])
    fault = raw["streams"][0]["input"]["faults"][0]
    report = {"fired": fault["_state"]["fired"], "health": run["health"],
              "texts": len(texts), "delivered_texts": len(crashed),
              "rebuilt_texts": len(rebuilt),
              "rebuilt_equal_clean": all(rebuilt[t][-1] == clean[t][0] for t in rebuilt),
              "rebuild_ms": engine.rebuild_ms.get("restart-crash"),
              "device_steps": steps, "k1_launches": ra.launches.value,
              "k1_variants": dict(ra.launches.variants),
              "crashed_runner_released": first.pipeline.processors[0].runner.params == {},
              "reserved_before": before, "reserved_after": after, "runner_footprint": footprint}
    print("overload restart " + json.dumps(report), flush=True)
    check(report["fired"] == 1, f"restart: the crash did not fire once: {report}")
    check(run["health"].get("restarts") == 1 and run["health"].get("restart_budget_remaining") == 2,
          f"restart: /health's restart counts: {report}")
    check(set(crashed) == {t.encode() for t in texts} and len(clean) == len(texts),
          f"restart: a text was not delivered: {report}")
    check(report["rebuilt_equal_clean"] and len(rebuilt) == len(texts),
          f"restart: the rebuilt stream's outputs differ from the crash-free run's: {report}")
    check(report["k1_launches"] == 12 * steps
          and report["k1_variants"].get("mma") == report["k1_launches"],
          f"restart: K1 != 12 x steps or not all mma: {report}")
    check(report["crashed_runner_released"], f"restart: the crashed runner kept its weights: "
                                             f"{report}")
    check(after - before <= footprint * 1.02 + (4 << 20),
          f"restart: memory_reserved grew past one runner's footprint: {report}")
    live.release()
    del run, engine, first, live
    release_memory()
    return report


#: the generate restart's decoder depth (Llama-3-8B widths) and prompts
GEN_RESTART_LAYERS = 2
GEN_RESTART_PROMPTS = 8


def gen_restart_config(name: str, prompts: list[str], crash: bool) -> dict:
    """``llama_generate_stream.json``'s ``gpu_generate`` (continuous, paged
    KV, Llama-3-8B widths, random weights from seed 0) cut to
    GEN_RESTART_LAYERS layers, 4 slots and 16 new tokens, behind a memory
    input of the prompts (one a read) under a crash fault at its third
    read; restart ``{max_retries: 3, backoff: 10ms}``."""
    with open(GENERATE_CONFIG) as f:
        proc = json.load(f)["streams"][0]["pipeline"]["processors"][0]
    proc["model_config"]["layers"] = GEN_RESTART_LAYERS
    proc.update(slots=4, max_new_tokens=16)
    return {"health_check": {"enabled": False},
            "streams": [{
                "name": name, "restart": {"max_retries": 3, "backoff": "10ms"},
                "input": {"type": "fault", "faults": [{"kind": "crash", "at": 3}] if crash else [],
                          "inner": {"type": "memory", "messages": prompts}},
                "pipeline": {"thread_num": 1, "processors": [proc]},
                "output": {"type": "drop"}}]}


def generated_by_text(sinks) -> dict:
    out: dict = {}
    for sink in sinks:
        for b in sink.batches:
            for text, gen_ in zip(b["texts"], b["generated"]):
                out.setdefault(text, []).append(gen_)
    return out


def run_generate_restart() -> dict:
    """The generate restart: a crash-free run (the reference, and one
    server's footprint in ``memory_reserved``), then the crashing one. Exact:
    the crash fires once; the crashed stream's server released before the
    rebuild (weights, KV pools, graphs, the processor's tree); every prompt
    delivered, the rebuilt stream's text equal to the crash-free run's;
    K3 launched; after the engine stops, ``memory_reserved`` within one
    server's footprint of its value before."""
    prompts = broker_texts(GEN_RESTART_PROMPTS, seed=43)
    release_memory()
    before_ref = reserved_bytes()
    ref = run_restart_engine(gen_restart_config("gen-restart-reference", prompts, False),
                             names=("generated",))
    footprint = reserved_bytes() - before_ref
    clean = generated_by_text(ref["sinks"])
    ref["engine"].streams[0].release()
    del ref
    release_memory()
    raw = gen_restart_config("gen-restart-crash", prompts, True)
    before = reserved_bytes()
    reset_counts()
    run = run_restart_engine(raw, names=("generated",))
    k3 = ra.paged_flash_attention.launches.value
    engine, first = run["engine"], run["first"]
    live = engine.streams[0]
    release_memory()
    after = reserved_bytes()
    proc = first.pipeline.processors[0]
    server = proc.server
    crashed = generated_by_text(run["sinks"])
    rebuilt = generated_by_text(run["sinks"][1:])
    report = {"fired": raw["streams"][0]["input"]["faults"][0]["_state"]["fired"],
              "layers": GEN_RESTART_LAYERS, "prompts": len(prompts),
              "delivered_prompts": len(crashed), "rebuilt_prompts": len(rebuilt),
              "rebuilt_equal_clean": all(rebuilt[t][-1] == clean[t][0] for t in rebuilt),
              "rebuild_ms": engine.rebuild_ms.get("gen-restart-crash"), "k3_launches": k3,
              "released": {"weights": server.params == {} and proc.params == {},
                           "kv_pools": server.k_pages is None and server.v_pages is None,
                           "graphs": len(server._compiled) == 0,
                           "host_sets": not server._host.by_key},
              "reserved_before": before, "reserved_after": after, "server_footprint": footprint}
    print("overload generate restart " + json.dumps(report), flush=True)
    check(report["fired"] == 1, f"generate restart: the crash did not fire once: {report}")
    check(set(crashed) == {t.encode() for t in prompts} and len(clean) == len(prompts),
          f"generate restart: a prompt was not delivered: {report}")
    check(report["rebuilt_equal_clean"] and len(rebuilt) == len(prompts),
          f"generate restart: the rebuilt stream's texts differ from the crash-free run's: "
          f"{report}")
    check(all(report["released"].values()),
          f"generate restart: the crashed server kept device state: {report}")
    check(k3 > 0, f"generate restart: K3 never launched: {report}")
    check(after - before <= footprint * 1.02 + (4 << 20),
          f"generate restart: memory_reserved grew past one server's footprint: {report}")
    live.release()
    del run, engine, first, live, server, proc
    release_memory()
    return report


def run_overload(runner: ModelRunner) -> dict:
    """The ``overload`` phase's parts, then its summary line."""
    burst = run_overload_burst(runner)
    tenants = run_overload_tenants(runner)
    restart = run_overload_restart()
    gen_restart = run_generate_restart()
    b = burst["controlled"]
    summary = {
        "burst": {"e2e_p50_ms": b["e2e_p50_ms"], "e2e_p99_ms": b["e2e_p99_ms"],
                  "control_e2e_p50_ms": burst["control"]["e2e_p50_ms"],
                  "control_e2e_p99_ms": burst["control"]["e2e_p99_ms"],
                  "offered_over_sustained": b["offered_over_sustained"],
                  "window": [b["window_min"], b["window_max"]], "paused_s": b["paused_s"],
                  "shed_by_reason": b["shed_by_reason"],
                  "delivered_batches": b["delivered_batches"],
                  "shed_batches": b["shed_batches"]},
        "tenants": {name: {k: t[k] for k in ("delivered_rows", "shed_by_reason", "e2e_p99_ms")}
                    for name, t in tenants["stream"]["tenants"].items()},
        "cache": {k: tenants["cache"][k] for k in ("device_steps", "k1_launches",
                                                   "bitwise_equal")},
        "http": {k: tenants["http"][k] for k in ("ok", "rejected_429", "retry_after")},
        "restart": {k: restart[k] for k in ("fired", "rebuild_ms", "rebuilt_equal_clean",
                                            "reserved_before", "reserved_after",
                                            "runner_footprint")},
        "generate_restart": {k: gen_restart[k] for k in (
            "fired", "rebuild_ms", "rebuilt_equal_clean", "released", "reserved_before",
            "reserved_after", "server_footprint")},
        "k3_launches": gen_restart["k3_launches"],
        "k1_launches": (b["k1_launches"] + burst["control"]["k1_launches"]
                        + tenants["stream"]["k1_launches"] + tenants["cache"]["k1_launches"]
                        + tenants["http"]["k1_launches"] + restart["k1_launches"])}
    print("overload " + json.dumps(summary), flush=True)
    return summary


DELIVERY_TEXTS = 2048
#: poisoned texts (4 until the brokers' other directions took the time)
DELIVERY_POISON = 2
DELIVERY_ATTEMPTS = 3


def delivery_texts(seed: int) -> tuple[list[str], list[int]]:
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [f"msg{i} " + " ".join(rng.choice(vocab, size=int(n)))
             for i, n in enumerate(rng.integers(40, 120, size=DELIVERY_TEXTS))]
    quarter = DELIVERY_TEXTS // DELIVERY_POISON
    poison_at = [q * quarter + int(rng.integers(quarter // 8, quarter - quarter // 8))
                 for q in range(DELIVERY_POISON)]
    return texts, poison_at


def delivery_config(cfg_raw: dict, texts: list[str], faults: bool) -> dict:
    """The delivery stream over ``texts`` with logits among its outputs;
    without ``faults``, every fault wrapper and the error_output removed
    (the fault-free run of the same texts)."""
    raw = json.loads(json.dumps(cfg_raw))
    s = raw["streams"][0]
    proc = s["pipeline"]["processors"][0]["inner"]
    proc["outputs"] = ["label", "score", "logits"]
    if faults:
        s["input"]["inner"]["messages"] = texts
    else:
        s["input"] = {"type": "memory", "messages": texts}
        s["pipeline"]["processors"] = [proc]
        s["output"] = s["output"]["inner"]
        del s["error_output"]
    return raw


class TaggedSink(Output):
    """Wraps an output: keeps every batch it is handed (payloads, the named
    columns and the quarantine tags), then passes it on."""

    def __init__(self, inner: Output, names: tuple = ()):
        self.inner = inner
        self.names = names
        self.rows: list[tuple] = []
        self.batches: list[tuple] = []

    async def connect(self) -> None:
        await self.inner.connect()

    async def write(self, batch: MessageBatch) -> None:
        cols = [np.asarray(batch.column(n)) for n in self.names]
        for i, p in enumerate(batch.to_binary()):
            self.rows.append((p, *(c[i] for c in cols)))
        self.batches.append((batch.num_rows, batch.get_meta("__meta_ext_error"),
                             batch.get_meta("__meta_ext_delivery_attempts")))
        await self.inner.write(batch)

    async def close(self) -> None:
        await self.inner.close()


def run_delivery_stream(raw: dict, label: str) -> dict:
    """One delivery run through ``Engine``, graphed: the counts zeroed just
    before it and read just after; the captures at warmup and at the end;
    each traffic step's examples and token fill."""
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    runner = getattr(proc, "_inner", proc).runner
    memory: dict = {}
    measure_warmup(runner, memory)
    warm = runner.warmup

    def warmup(*args):
        n = warm(*args)
        memory["captures_at_warmup"] = runner.captures
        return n

    runner.warmup = warmup
    steps: list[tuple[int, int, int]] = []
    count_padding = runner._count_padding

    def counted(inputs, bufs):
        count_padding(inputs, bufs)
        steps.append((int(inputs["example_row"].shape[0]),
                      int(np.count_nonzero(np.asarray(inputs["segment_ids"]) > 0)),
                      int(bufs.arrays["input_ids"].size)))

    runner._count_padding = counted
    names = ("label", "logits")
    if stream.error_output is not None:
        stream.output._inner = sink = TaggedSink(stream.output._inner, names)
        stream.error_output = quarantine = TaggedSink(stream.error_output)
    else:
        stream.output = sink = TaggedSink(stream.output, names)
        quarantine = None
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    single = [s for s in steps if s[0] == 1]
    report = {
        "label": label, "rows_out": stream.rows_out, "seconds": seconds,
        "traffic_seconds": stream.traffic_seconds,
        "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
        "packed_steps": runner.packed_steps, "traffic_steps": len(steps),
        "k1_launches": ra.launches.value, "k2_launches": sa.launches.value,
        "k2_variants": dict(sa.launches.variants), "layers": runner.cfg.layers,
        "captures_after_warmup": runner.captures - memory.get("captures_at_warmup", 0),
        "single_text_steps": len(single),
        "single_text_token_fill": (sum(s[1] for s in single) / max(1, sum(s[2] for s in single))),
        "token_fill": runner.true_tokens / max(1, runner.token_capacity),
        "duty_cycle": runner.duty_cycle(), **memory}
    return {"report": report, "stream": stream, "sink": sink, "quarantine": quarantine}


def run_chaos_example() -> dict:
    """``chaos_stream.json`` through the CLI (the printed rows), and through
    ``Engine`` with its outputs kept (the counts): each healthy row once,
    the poison row quarantined after 3 attempts, 3 write retries, one trip."""
    cli = subprocess.run([sys.executable, "-m", "arkflow_tpu_torch", "--config", CHAOS_CONFIG],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    printed = sorted(line for line in cli.stdout.splitlines() if line.startswith("{"))
    with open(CHAOS_CONFIG) as f:
        raw = json.load(f)
    raw["health_check"]["enabled"] = False
    raw["streams"][0]["output"]["inner"] = raw["streams"][0]["error_output"] = {"type": "drop"}
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    stream.output._inner = sink = TaggedSink(stream.output._inner)
    stream.error_output = quarantine = TaggedSink(stream.error_output)
    asyncio.run(engine.run())
    breaker = stream._out_breaker
    report = {"cli_rc": cli.returncode, "cli_printed": printed,
              "delivered": len(sink.rows), "quarantined": quarantine.batches,
              "output_retries": stream.output_retries, "errors": stream.errors,
              "breaker": breaker.history, "trips": breaker.trips,
              "reconnect_probes": stream.input._reconnects}
    print("chaos example " + json.dumps(report), flush=True)
    want = sorted(json.dumps({"id": i, "kind": "poison" if i == 3 else "ok"})
                  for i in range(1, 7))
    check(cli.returncode == 0 and printed == want,
          f"the chaos example's CLI run printed other rows: {report} {cli.stderr[-2000:]}")
    check(report["delivered"] == 5 and len(sink.rows) == len({r[0] for r in sink.rows}),
          f"the chaos example delivered other rows: {report}")
    check(quarantine.batches == [(1, "chaos: injected error", "3")],
          f"the chaos example's poison row was not quarantined after 3 attempts: {report}")
    check(stream.output_retries == 3 and breaker.trips == 1 and breaker.state == "closed"
          and stream.errors == 3 and stream.input._reconnects == 1,
          f"the chaos example's counts differ from the JAX example's: {report}")
    return report


def run_delivery(cfg_raw: dict) -> dict:
    """The delivery phase: the delivery stream over DELIVERY_TEXTS texts,
    DELIVERY_POISON poisoned, beside a fault-free run of the same texts without the
    markers; then the chaos example."""
    t_phase = time.perf_counter()
    texts, poison_at = delivery_texts(seed=15)
    faulty = list(texts)
    for i in poison_at:
        faulty[i] = texts[i].replace(" ", " poison ", 1)
    clean_run = run_delivery_stream(delivery_config(cfg_raw, texts, faults=False), "fault-free")
    fault_run = run_delivery_stream(delivery_config(cfg_raw, faulty, faults=True), "delivery")
    stream, sink, quarantine = fault_run["stream"], fault_run["sink"], fault_run["quarantine"]
    rep, clean_rep = fault_run["report"], clean_run["report"]
    inp = stream.input
    breaker = stream._out_breaker
    coalescer = stream.buffer.coalescer
    poison = sorted(faulty[i].encode() for i in poison_at)
    clean = sorted(t.encode() for i, t in enumerate(texts) if i not in poison_at)
    delivered = sorted(r[0] for r in sink.rows)
    quarantined = sorted(p for p in (r[0] for r in quarantine.rows))
    want = {r[0]: (int(r[1]), np.asarray(r[2], np.float32)) for r in clean_run["sink"].rows}
    got = {r[0]: (int(r[1]), np.asarray(r[2], np.float32)) for r in sink.rows}
    tie_free = mismatches = 0
    max_err = 0.0
    for p, (label, logits) in got.items():
        ref_label, ref_logits = want[p]
        max_err = max(max_err, float(np.abs(logits - ref_logits).max()))
        top2 = np.sort(ref_logits)
        if top2[-1] - top2[-2] > LABEL_MARGIN:
            tie_free += 1
            mismatches += int(label != ref_label)
    report = {
        **rep, "texts": len(texts), "poison_at": poison_at,
        "clean_delivered_once": delivered == clean,
        "quarantined_batches": stream.quarantined_batches, "quarantine": quarantine.batches,
        "quarantined_are_the_poison": quarantined == poison,
        "errors": stream.errors, "write_errors": stream.write_errors,
        "quarantine_drops": stream.quarantine_drops, "output_retries": stream.output_retries,
        "ack_failures": stream.ack_failures,
        "breaker_trips": breaker.trips, "breaker_state": breaker.state,
        "breaker_history": breaker.history,
        "reconnects": stream.reconnects, "reconnect_failures": stream.reconnect_failures,
        "outstanding_at_eof": inp._outstanding, "redeliveries": inp.redeliveries,
        "solo_emissions": coalescer.solo_emissions, "suspects_at_end": coalescer.suspects,
        "tie_free_rows": tie_free, "label_mismatches_tie_free": mismatches,
        "max_logit_abs_err": max_err, "logit_tol": LOGIT_TOL,
        "fault_free": {k: clean_rep[k] for k in (
            "rows_out", "traffic_rows_per_s", "packed_steps", "traffic_steps", "k2_launches",
            "captures_after_warmup", "single_text_steps", "token_fill", "duty_cycle")}}
    print("delivery " + json.dumps(report), flush=True)
    check(report["clean_delivered_once"] and stream.rows_out == len(clean),
          f"not every clean row was delivered exactly once: {report}")
    check(report["quarantined_are_the_poison"]
          and quarantine.batches == [(1, "chaos: injected error", str(DELIVERY_ATTEMPTS))]
          * DELIVERY_POISON and stream.quarantined_batches == DELIVERY_POISON,
          f"the poison rows were not each quarantined alone after "
          f"{DELIVERY_ATTEMPTS} attempts: {report}")
    check(stream.quarantine_drops == 0 and stream.output_retries == 3
          and stream.write_errors == 0 and breaker.trips == 1 and breaker.state == "closed",
          f"the output's retries or breaker differ: {report}")
    check(stream.reconnects == 1 and stream.reconnect_failures == 1,
          f"the input did not reconnect once after one failed probe: {report}")
    check(inp._outstanding == 0 and coalescer.suspects == 0,
          f"deliveries or suspects left over at EOF: {report}")
    check(tie_free >= len(got) // 2 and mismatches == 0 and max_err <= LOGIT_TOL,
          f"delivered outputs differ from the fault-free run's: {report}")
    for r in (rep, clean_rep):
        check(r["k2_launches"] > 0 and r["k2_launches"] == r["layers"] * r["packed_steps"]
              and r["k2_variants"].get("mma") == r["k2_launches"] and r["k1_launches"] == 0,
              f"K2 launches != layers x packed steps, or a non-mma or K1 launch: {r}")
        check(r["captures_after_warmup"] == 0, f"a graph was captured on the path: {r}")
    check(clean_rep["rows_out"] == len(texts) and clean_run["stream"].errors == 0,
          f"the fault-free run lost rows: {clean_rep}")
    chaos = run_chaos_example()
    cost = {"solo_emissions": coalescer.solo_emissions,
            "single_text_steps": rep["single_text_steps"],
            "single_text_token_fill": rep["single_text_token_fill"],
            "traffic_steps": rep["traffic_steps"],
            "fault_free_traffic_steps": clean_rep["traffic_steps"],
            "traffic_rows_per_s": rep["traffic_rows_per_s"],
            "fault_free_traffic_rows_per_s": clean_rep["traffic_rows_per_s"],
            "token_fill": rep["token_fill"], "fault_free_token_fill": clean_rep["token_fill"],
            "k2_launches": rep["k2_launches"] + clean_rep["k2_launches"],
            "seconds": rep["seconds"], "fault_free_seconds": clean_rep["seconds"],
            "phase_seconds": time.perf_counter() - t_phase}
    print("delivery cost " + json.dumps(cost), flush=True)
    return {"report": report, "cost": cost, "chaos": chaos}


#: the tuner phase's stream: ``bert_adaptive_stream.json`` fed TUNER_ROWS
#: seeded texts in order, the first half short, the second long (true token
#: lengths, [CLS] and [SEP] included). The input holds at each gate (A, A2,
#: B, B2, and its end) until it is released. A cycle is forced once every
#: row before A (then B) was written out, so the sketch it reads is the same
#: in every run; its snapshot releases A (B), and the rows up to A2 (B2)
#: run through its warm captures, flip and probe; A2 (B2) opens when the
#: grid it commits serves. At B a ``probe_fail`` cycle rolls back first.
TUNER_ROWS = 16384
TUNER_SHORT = (8, 24)
TUNER_LONG = (60, 120)
TUNER_BATCH = 64
TUNER_GATES = (8192, 9216, 12288, 13312)


def shifting_texts(seed: int) -> tuple[list[bytes], np.ndarray]:
    """Distinct texts (a row id each) and their true token lengths."""
    rng = np.random.default_rng(seed)
    half = TUNER_ROWS // 2
    lengths = np.concatenate([rng.integers(TUNER_SHORT[0], TUNER_SHORT[1] + 1, half),
                              rng.integers(TUNER_LONG[0], TUNER_LONG[1] + 1, half)])
    vocab = [f"w{i}" for i in range(5000)]
    texts = [(" ".join(rng.choice(vocab, size=int(n) - 3)) + f" r{i}").encode()
             for i, n in enumerate(lengths)]
    return texts, lengths


class GatedListInput(Input):
    """The texts in order, ``batch`` rows a read; at each gate row it waits
    for the gate's event."""

    def __init__(self, texts: list[bytes], batch: int, gates: tuple[int, ...]):
        self.texts, self.batch = texts, batch
        self.gates = {g: asyncio.Event() for g in gates}
        self.pos = 0

    async def connect(self) -> None:
        pass

    async def read(self):
        if self.pos in self.gates:
            await self.gates[self.pos].wait()
        if self.pos >= len(self.texts):
            raise EndOfInput()
        end = min([self.pos + self.batch, len(self.texts)]
                  + [g for g in self.gates if g > self.pos])
        batch = MessageBatch.new_binary(self.texts[self.pos:end])
        self.pos = end
        return batch, NoopAck()

    async def close(self) -> None:
        pass


class RowSink(OrderedSink):
    """Records every payload in order and the label and logits columns."""

    def __init__(self, inner: Output):
        super().__init__(inner)
        self.labels: list[np.ndarray] = []
        self.logits: list[np.ndarray] = []

    async def write(self, batch: MessageBatch) -> None:
        self.labels.append(np.asarray(batch.column("label")))
        self.logits.append(np.asarray(batch.column("logits")))
        await super().write(batch)


async def forced_cycle(port: int, stream_name: str, tuner, runner: ModelRunner,
                       gate, views: list) -> dict:
    """``POST /admin/tune``; the ``gate`` (if any) opens once the cycle took
    its sketch snapshot, so traffic runs through the warm, the flip and the
    probe. The graph counts and ``memory_reserved`` before and after."""
    snapshot = tuner.sketch.snapshot
    taken = asyncio.Event()

    def recorded():
        view = snapshot()
        views.append(view)
        taken.set()
        return view

    before = {"reserved": torch.cuda.memory_reserved(), **runner.graph_counts(),
              "seq_buckets": list(runner.buckets.seq_buckets)}
    tuner.sketch.snapshot = recorded
    post = asyncio.create_task(http(port, "POST", "/admin/tune", {}))
    try:
        await asyncio.wait_for(taken.wait(), 60)
    finally:
        tuner.sketch.snapshot = snapshot
        if gate is not None:
            gate.set()
    status, body = await post
    decision = tuner.report()["last_decision"]
    return {"status": status, "action": decision["action"],
            "error": body["results"][stream_name][0].get("error"),
            "proposal": decision.get("proposal"), "warmed_shapes": decision.get("warmed_shapes"),
            "before": before,
            "after": {"reserved": torch.cuda.memory_reserved(), **runner.graph_counts(),
                      "seq_buckets": list(runner.buckets.seq_buckets)}}


def run_tuner_stream(cfg_raw: dict, texts: list[bytes], tune: bool) -> dict:
    """The adaptive stream through ``Engine`` over ``texts``: with the tuner
    (``tune``: a commit at the first gate, then at the second a
    ``probe_fail`` rollback and a commit) or on the static grid (the tuner
    block removed, the gates opened as the rows reach them)."""
    raw = json.loads(json.dumps(cfg_raw))
    raw["health_check"]["port"] = 0
    stream_raw = raw["streams"][0]
    proc_raw = stream_raw["pipeline"]["processors"][0]
    proc_raw["outputs"] = ["label", "score", "logits"]
    if tune:
        proc_raw["tuner"]["interval"] = 0  # cycles only when forced
    else:
        del proc_raw["tuner"]
    engine = Engine(EngineConfig.from_mapping(raw))
    stream = engine.build()[0]
    runner = stream.pipeline.processors[0].runner
    memory: dict = {}
    measure_warmup(runner, memory)
    warmup = runner.warmup

    def counted_warmup(*args):
        n = warmup(*args)
        memory["captures_at_warmup"] = runner.captures
        return n

    runner.warmup = counted_warmup
    end = len(texts)
    inp = stream.input = GatedListInput(texts, TUNER_BATCH, (*TUNER_GATES, end))
    sink = stream.output = RowSink(stream.output)
    tuner = stream.tuners()[0] if tune else None
    warm_ms: list[float] = []
    warm_key = runner._warm_key

    def timed_warm(compiled, key):
        t0 = time.perf_counter()
        warm_key(compiled, key)
        warm_ms.append((time.perf_counter() - t0) * 1e3)

    runner._warm_key = timed_warm
    cycles: list[dict] = []
    views: list = []

    async def drive():
        task = asyncio.create_task(engine.run())

        async def reach(rows: int) -> None:
            while len(sink.payloads) < rows:
                check(not task.done(), "the tuner stream ended before a gate")
                await asyncio.sleep(0.005)

        async def cycle(release, effective) -> None:
            cycles.append({"effective_from": effective, **await forced_cycle(
                engine.health_port, stream.name, tuner, runner, release, views)})

        a, a2, b, b2 = TUNER_GATES
        try:
            if tune:
                await reach(a)
                await cycle(inp.gates[a], a2)
                inp.gates[a2].set()
                await reach(b)
                tuner.inject_fault("probe_fail")
                await cycle(inp.gates[b], None)
                await cycle(None, b2)
            for gate in TUNER_GATES:
                await reach(gate)
                inp.gates[gate].set()
            # the rows after B2, on the grid the last commit left
            t0, tokens, slots = time.perf_counter(), runner.true_tokens, runner.token_capacity
            await reach(end)
            memory["tail_rows_per_s"] = (end - b2) / (time.perf_counter() - t0)
            memory["tail_waste"] = 1.0 - ((runner.true_tokens - tokens)
                                          / (runner.token_capacity - slots))
        finally:
            for g in inp.gates.values():
                g.set()
            await task

    reset_counts()
    asyncio.run(drive())
    torch.cuda.synchronize()
    k1, k2 = ra.launches.value, sa.launches.value
    report = {
        "mode": "tuned" if tune else "static", "rows_expected": len(texts),
        "rows_out": stream.rows_out, "rows_dropped": sink.inner.dropped_rows,
        "errors": stream.errors, "in_order": sink.payloads == texts,
        "traffic_seconds": stream.traffic_seconds,
        "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
        "tail_rows_per_s": memory.pop("tail_rows_per_s"),
        "tail_waste": memory.pop("tail_waste"),
        "waste": 1.0 - runner.true_tokens / max(1, runner.token_capacity),
        "true_tokens": runner.true_tokens, "token_capacity": runner.token_capacity,
        "padded_rows": runner.padded_rows, "executed_rows": runner.executed_rows,
        "captures": runner.captures,
        "captures_after_warmup": runner.captures - memory.pop("captures_at_warmup"),
        "warm_captures": runner.warm_captures,
        "warm_capture_ms": warm_ms, "keys": len(runner._compiled),
        "released": runner.released_graphs,
        # graphs of no grid that may still serve (the live one, the kept
        # rollback grid), left once every step has drained
        "stale_keys_at_end": len(set(runner._compiled.keys()) - {
            shape_key(s) for g in (runner.buckets, *runner._kept)
            for s in runner.grid_shapes(g)}),
        "grid": {"seq_buckets": list(runner.buckets.seq_buckets),
                 "example_scale": runner.buckets.example_scale,
                 "token_budget": stream.buffer._coalescer.token_budget,
                 "deadline_s": stream.buffer._deadline_s},
        "packed_steps": runner.packed_steps, "layers": runner.cfg.layers,
        "k1_launches": k1, "k2_launches": k2, "k2_variants": dict(sa.launches.variants),
        "duty_cycle": runner.duty_cycle(), "reserved_end": torch.cuda.memory_reserved(),
        **{k: v for k, v in memory.items() if k.startswith("reserved")},
    }
    print("tuner stream " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"the tuner stream reported errors: {report}")
    check(stream.rows_out == len(texts) and sink.inner.dropped_rows == len(texts),
          f"rows lost in the tuner stream: {report}")
    check(report["in_order"], f"the tuner stream's rows arrived out of order: {report}")
    check(k1 == 0 and k2 > 0 and k2 == runner.cfg.layers * runner.packed_steps,
          f"K2 launches != layers x packed steps in the tuner stream: {report}")
    check(report["k2_variants"]["mma"] == k2, f"a K2 launch missed the mma tile: {report}")
    check(report["stale_keys_at_end"] == 0, f"graphs no grid serves were kept: {report}")
    return {"report": report, "cycles": cycles, "views": views, "runner": runner,
            "labels": np.concatenate(sink.labels), "logits": np.concatenate(sink.logits)}


def predicted_run_waste(lengths: np.ndarray, segments: list) -> float:
    """The planner's capacity-weighted waste of a run whose rows ``[start,
    end)`` were served under each segment's shape."""
    true = cap = 0.0
    for start, end, shape in segments:
        part = lengths[start:end]
        _, fill = predict_waste(SketchView(part, 0.0, part.size), shape)
        true += float(part.sum())
        cap += float(part.sum()) / fill
    return 1.0 - true / cap


def minted_cases(gen, minted: set, heads: int, dh: int, known: dict) -> dict:
    """K1 and K2 at two minted buckets off the tile's 16-row grid and one on
    it but off the 64-key tile, beside the next pow2 bucket (taken from
    ``known``, {S: {"K1": case, "K2": case}}, where this run has it): each
    held to its plain version and per element to ``emulate_mma_tile``; the
    device ms against the bound."""
    odd = sorted(s for s in minted if s % 16)[:2]
    mid = sorted(s for s in minted if s % 16 == 0 and s % 64)[-1:]
    check(len(odd) == 2 and len(mid) == 1,
          f"the tuner minted no two S % 16 != 0 buckets and one S % 64 != 0: {sorted(minted)}")
    rng = np.random.default_rng(14)
    out = {}
    sizes = [*odd, *mid]
    for s in sorted(set(sizes) | {1 << (s - 1).bit_length() for s in sizes}):
        if s in known:
            k1, k2 = known[s]["K1"], known[s]["K2"]
        else:
            k1 = kernel_case(gen, TUNER_BATCH, heads, s, dh, torch.bfloat16, causal=False)
            k2 = segment_case(gen, segment_layouts(rng, TUNER_BATCH, s), heads, dh,
                              torch.bfloat16, f"tuner S={s}")
        out[s] = {name: {"device_ms": c["kernel_device_ms"], "bound_ms": c["bound_ms"],
                         "over_bound": c["kernel_device_ms"] / c["bound_ms"],
                         "max_abs_err": c["max_abs_err"], "tile_err_ratio": c["tile_err_ratio"],
                         "plain_ms": c["plain_device_ms"], "library_ms": c["library_device_ms"]}
                  for name, c in (("K1", k1), ("K2", k2))}
        out[s]["minted"] = s in sizes
    return out


def run_tuner(gen, cfg_raw: dict, known: dict) -> dict:
    """The tuner phase: the adaptive stream static, then tuned, over the same
    seeded texts; their rows/s and padding waste beside the planner's; the
    commits, the rollback, the warm captures and the memory; tie-free labels
    equal and logits within 1/64; then K1 and K2 at the minted buckets
    (``minted_cases``, beside ``known``'s pow2 cases)."""
    texts, lengths = shifting_texts(seed=14)
    tok_lengths = HashTokenizer().encode_batch(texts[:64], 128)[1].sum(axis=1)
    check(np.array_equal(tok_lengths, lengths[:64]), "the shifting texts' lengths are off")
    static = run_tuner_stream(cfg_raw, texts, tune=False)
    del static["runner"]
    torch.cuda.empty_cache()
    tuned = run_tuner_stream(cfg_raw, texts, tune=True)
    runner, cycles = tuned["runner"], tuned["cycles"]
    print("tuner cycles " + json.dumps(cycles), flush=True)
    commits = [c for c in cycles if c["action"] == "committed"]
    rollbacks = [c for c in cycles if c["action"] == "rolled_back"]
    check(len(commits) >= 1 and all(c["status"] == 200 for c in commits),
          f"the tuner committed nothing: {cycles}")
    check(len(rollbacks) == 1 and rollbacks[0]["status"] == 409
          and rollbacks[0]["after"]["seq_buckets"] == rollbacks[0]["before"]["seq_buckets"],
          f"the probe_fail cycle did not roll back with the grid serving: {cycles}")
    check(tuned["report"]["captures_after_warmup"] == 0,
          f"the tuned stream captured on the path: {tuned['report']}")

    ref, got = static["logits"], tuned["logits"]
    top2 = np.sort(ref, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > LABEL_MARGIN
    outputs = {"rows": len(texts), "tie_free_rows": int(tie_free.sum()),
               "label_mismatches_tie_free": int((tuned["labels"][tie_free]
                                                 != static["labels"][tie_free]).sum()),
               "max_logit_abs_err": float(np.abs(got - ref).max()), "logit_tol": LOGIT_TOL}
    print("tuner outputs " + json.dumps(outputs), flush=True)
    check(outputs["label_mismatches_tie_free"] == 0 and outputs["max_logit_abs_err"] <= LOGIT_TOL,
          f"the tuned stream's outputs left the static run's: {outputs}")

    bb = tuple(runner.buckets.batch_buckets)
    budget = cfg_raw["streams"][0]["buffer"]["coalesce"]["token_budget"]
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    first = ShapeConfig(bb, tuple(proc["seq_buckets"]), proc.get("example_scale", 4), True,
                        budget)
    # each stretch of rows under the grid last committed before it
    bounds = sorted({0, len(texts), *(c["effective_from"] for c in commits)})
    segments, shape = [], first
    for start, end in zip(bounds, bounds[1:]):
        for c in commits:
            if c["effective_from"] == start:
                s = c["proposal"]["shape"]
                shape = ShapeConfig(tuple(s["batch_buckets"]), tuple(s["seq_buckets"]),
                                    s["example_scale"], True, s.get("token_budget"))
        segments.append((start, end, shape))
    # the buckets the planner minted: the run's proposals, and what it
    # proposes for the padded path (K1) on the same snapshots
    minted = {e for c in cycles if c["proposal"] for e in c["proposal"]["shape"]["seq_buckets"]}
    padded_inc = ShapeConfig(bb, first.seq_buckets)
    for view in tuned["views"]:
        minted |= set(plan_shapes(view, padded_inc, TunerConfig()).shape.seq_buckets)
    minted -= set(first.seq_buckets)
    summary = {
        "rows": len(texts), "short": TUNER_SHORT, "long": TUNER_LONG, "gates": TUNER_GATES,
        "traffic_rows_per_s": {"static": static["report"]["traffic_rows_per_s"],
                               "tuned": tuned["report"]["traffic_rows_per_s"]},
        "tail_rows_per_s": {"static": static["report"]["tail_rows_per_s"],
                            "tuned": tuned["report"]["tail_rows_per_s"]},
        "waste": {"static": static["report"]["waste"], "tuned": tuned["report"]["waste"],
                  "predicted_static": predicted_run_waste(lengths, [(0, len(texts), first)]),
                  "predicted_tuned": predicted_run_waste(lengths, segments)},
        "tail_waste": {"static": static["report"]["tail_waste"],
                       "tuned": tuned["report"]["tail_waste"],
                       "predicted_static": predicted_run_waste(
                           lengths, [(TUNER_GATES[-1], len(texts), first)]),
                       "predicted_tuned": predicted_run_waste(lengths, segments[-1:])},
        "commits": len(commits), "rollbacks": len(rollbacks),
        "grids": [list(seg[2].seq_buckets) for seg in segments], "minted": sorted(minted),
        "warm_captures": tuned["report"]["warm_captures"],
        "warm_capture_ms": {"n": len(tuned["report"]["warm_capture_ms"]),
                            "median": statistics.median(tuned["report"]["warm_capture_ms"] or [0]),
                            "max": max(tuned["report"]["warm_capture_ms"] or [0])},
        "reserved": [{"action": c["action"], "before": c["before"]["reserved"],
                      "after": c["after"]["reserved"], "keys_before": c["before"]["keys"],
                      "keys_after": c["after"]["keys"],
                      "released_before": c["before"]["released"],
                      "released_after": c["after"]["released"]} for c in cycles],
        "released_at_end": tuned["report"]["released"],
        "reserved_end": {"static": static["report"]["reserved_end"],
                         "tuned": tuned["report"]["reserved_end"]},
        "captures_after_warmup": {"static": static["report"]["captures_after_warmup"],
                                  "tuned": tuned["report"]["captures_after_warmup"]},
        "k2_launches": static["report"]["k2_launches"] + tuned["report"]["k2_launches"],
        "outputs": outputs,
    }
    heads, dh = runner.cfg.heads, runner.cfg.hidden // runner.cfg.heads
    del tuned["runner"], runner
    torch.cuda.empty_cache()
    summary["kernels"] = minted_cases(gen, minted, heads, dh, known)
    print("tuner " + json.dumps(summary), flush=True)
    return summary


def run_int8_slice(cfg_raw: dict, eager: bool = False) -> dict:
    """The int8 stream (or the same config at another serving dtype) through
    ``Engine``, its sink wrapped to check order; the counts are zeroed just
    before the run and read just after. Every step runs K1 once a layer, and
    at int8 every dense layer runs an int8 product and none a float one: six
    a layer, then the pooler and the classifier."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    engine, stream, runner, memory = build_stream_runner(cfg_raw, eager)
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, products = ra.launches.value, sa.launches.value, q8.int8_products.value
    k1_variants = dict(ra.launches.variants)
    expected = generated_rows(cfg_raw)
    layers = runner.cfg.layers
    per_step = 6 * layers + 2 if proc["serving_dtype"] == "int8" else 0
    report = {"serving_dtype": proc["serving_dtype"], "rows_expected": len(expected),
              "rows_out": stream.rows_out, "rows_dropped": sink.inner.dropped_rows,
              "errors": stream.errors, "in_order": sink.payloads == expected,
              "seconds": wall, "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "layers": layers, "hidden": runner.cfg.hidden,
              "k1_launches": k1, "k1_variants": k1_variants, "k2_launches": k2,
              "int8_products": products,
              "int8_products_per_step": per_step, "flash_fallbacks": runner.flash_fallbacks,
              **mode_report(runner, memory)}
    print("int8 slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"int8-config stream reported errors: {report}")
    check(stream.rows_out == len(expected) and sink.inner.dropped_rows == len(expected),
          f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(k1 > 0 and k1 == layers * runner.device_steps and k2 == 0,
          f"K1 launches != layers x device steps: {report}")
    check(products == per_step * runner.device_steps,
          f"int8 products != dense layers x device steps: {report}")
    check(k1_variants["mma"] == k1, f"a bf16 K1 launch missed the mma tile: {report}")
    if per_step:
        w_q = runner.params["layers"]["ffn_in"]["w_q"][0]
        check(w_q.is_cuda and w_q.stride(0) == 1,
              f"the int8 weights lost their column-major layout on the card: {w_q.stride()}")
    return {"report": report, "runner": runner}


def compare_int8(int8: ModelRunner, bf16: ModelRunner, proc_cfg: dict, rows: int,
                 seed: int) -> dict:
    """The same ``rows`` texts of mixed lengths through the int8 stream's
    runner and the bf16 one (same seed, so the same float weights before
    quantization): labels equal on every row whose bf16 top-2 gap exceeds
    twice the largest |logit difference|; then both runners' step times at
    the two batch buckets, in turns."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(n))).encode()
             for n in rng.integers(1, proc_cfg["max_seq"] - 2, size=rows)]
    ids, mask = HashTokenizer(int8.cfg.vocab_size).encode_batch(texts, proc_cfg["max_seq"])
    a = int8.infer_sync({"input_ids": ids, "attention_mask": mask})
    b = bf16.infer_sync({"input_ids": ids, "attention_mask": mask})
    check(np.isfinite(a["logits"]).all() and a["logits"].shape == (rows, 2),
          "int8 logits not finite")
    delta = float(np.abs(a["logits"] - b["logits"]).max())
    top2 = np.sort(b["logits"], axis=1)
    clear = (top2[:, -1] - top2[:, -2]) > 2 * delta
    report = {"rows": rows, "max_logit_abs_delta": delta,
              "max_abs_logit": float(np.abs(b["logits"]).max()),
              "rows_gap_above_2x_delta": int(clear.sum()),
              "rows_gap_at_or_below_2x_delta": int((~clear).sum()),
              "label_mismatches_above_gap": int((a["label"][clear] != b["label"][clear]).sum()),
              "label_mismatches_all": int((a["label"] != b["label"]).sum())}
    print("int8 vs bf16 " + json.dumps(report), flush=True)
    check(report["label_mismatches_above_gap"] == 0,
          f"int8 changed a label whose bf16 gap exceeds twice the logit delta: {report}")
    steps = {}
    for n in (256, 32):
        one = {"input_ids": ids[:n], "attention_mask": mask[:n]}
        seq = int8.buckets.seq_bucket(int(mask[:n].sum(1).max()))
        times = {"int8": [], "bf16": []}
        for name in ("int8", "bf16", "bf16", "int8"):
            r = int8 if name == "int8" else bf16
            times[name].append(time_ms(lambda: r.infer_sync(one), iters=10, warmup=2))
        steps[f"{n}x{seq}"] = {k: statistics.median(v) for k, v in times.items()}
        steps[f"{n}x{seq}"]["runs"] = times
    print("int8 step_ms " + json.dumps(steps), flush=True)
    return report


def product_times(gen) -> dict:
    """``torch._int_mm``'s limits on the card (it refuses rows <= 16 and K
    or N off a multiple of 8), ``int8_matmul`` exact on and off them, then
    the int8 product and the whole W8A8 dense against the bf16 ones at
    BERT-base's FFN shape, [16384, 768] x [768, 3072], each beside its
    bound."""
    refused = {}
    for m, k, n in ((16, 768, 768), (32, 768, 2), (32, 12, 16)):
        try:
            torch._int_mm(torch.ones(m, k, device="cuda", dtype=torch.int8),
                          torch.ones(k, n, device="cuda", dtype=torch.int8))
            refused[f"{m}x{k}x{n}"] = False
        except RuntimeError:
            refused[f"{m}x{k}x{n}"] = True
    exact = {}
    for m, k, n in ((4, 768, 2), (32, 768, 2), (256, 768, 768), (17, 13, 5)):
        a = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8, generator=gen)
        w = torch.randint(-127, 128, (k, n), device="cuda", dtype=torch.int8, generator=gen)
        got = q8.int8_matmul(a, w).cpu()
        exact[f"{m}x{k}x{n}"] = bool(torch.equal(got.long(), a.cpu().long() @ w.cpu().long()))
    m, k, n = 16384, 768, 3072
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
    p_bf16 = {"w": w.to(torch.bfloat16), "b": torch.zeros(n, device="cuda", dtype=torch.bfloat16)}
    p_int8 = q8.quantize_dense({"w": w, "b": p_bf16["b"]})
    x_q = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8, generator=gen)
    flops = 2.0 * m * k * n

    def bound(nbytes: float, peak: float) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    i8_bound, i8_by = bound(m * k + k * n + 4 * m * n, INT8_PEAK_OPS)
    bf_bound, bf_by = bound(2 * (m * k + k * n + m * n), PEAK_FLOPS[torch.bfloat16])
    w_rows = p_int8["w_q"].contiguous()  # the same weight, row-major
    report = {
        "int_mm_refuses": refused, "exact": exact, "shape": [m, k, n],
        "w_q_strides": list(p_int8["w_q"].stride()),
        "int8_product_ms": time_ms(lambda: q8.int8_matmul(x_q, p_int8["w_q"])),
        "int8_product_row_major_w_ms": time_ms(lambda: q8.int8_matmul(x_q, w_rows)),
        "int8_product_bound_ms": i8_bound, "int8_product_bound_by": i8_by,
        "bf16_product_ms": time_ms(lambda: x @ p_bf16["w"]),
        "bf16_product_bound_ms": bf_bound, "bf16_product_bound_by": bf_by,
        "int8_dense_ms": time_ms(lambda: dense(p_int8, x)),
        "bf16_dense_ms": time_ms(lambda: dense(p_bf16, x)),
    }
    print("int8 product " + json.dumps(report), flush=True)
    check(all(exact.values()), f"the int8 product is not exact on the card: {report}")
    return report


def paged_bound_ms(off: torch.Tensor, c: int, h: int, kvh: int, d: int, page: int,
                   p: int, table: torch.Tensor | None = None) -> tuple[float, str]:
    """Least time for one K3 call: the live K/V pages (every page a row's
    last query reaches, clamped to the table; a page two rows' tables share
    counted once) read once, q read and out written once, the table and
    offsets read; 4*D flops per (query, head, admissible key)."""
    offs = off.to(torch.int64).cpu()
    b, ctx = offs.numel(), p * page
    keys = (offs + c).clamp(max=ctx)
    pages = -(-keys // page)
    live = float(pages.sum())
    if table is not None:
        rows = table.cpu().tolist()
        live = float(len({pg for r, n in enumerate(pages.tolist()) for pg in rows[r][:n]}))
    nbytes = (2 * live * page * kvh * d * 2 + 2 * b * c * h * d * 2
              + b * p * 4 + b * 4)
    attended = (offs[:, None] + torch.arange(1, c + 1)[None, :]).clamp(max=ctx)
    flops = 4.0 * float(attended.sum()) * d * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_library_call(q, kp, vp, table, off):
    """The PyTorch library yardstick for K3 (timed as one): gather each
    row's context through its table, then ``scaled_dot_product_attention``
    with ``enable_gqa`` and the offset mask."""
    b, c, h, d = q.shape
    kvh, ctx = kp.shape[2], table.shape[1] * kp.shape[1]

    def call():
        t = table.long()
        k = kp[t].reshape(b, ctx, kvh, d).transpose(1, 2).to(q.dtype)
        v = vp[t].reshape(b, ctx, kvh, d).transpose(1, 2).to(q.dtype)
        pos = off.long()[:, None] + torch.arange(c, device=q.device)
        mask = (torch.arange(ctx, device=q.device)[None, None, :] <= pos[:, :, None])[:, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True).transpose(1, 2)

    return call


def paged_case(gen, b: int, c: int, offs: list[int], label: str, h: int = 32, kvh: int = 8,
               d: int = 128, page: int = 16, p: int = 40, poison: bool = False,
               dtype: torch.dtype = torch.bfloat16, shared: int = 0) -> dict:
    """K3 against its plain version on shuffled, non-contiguous page tables
    (bf16 pools; q bf16, the serving type, or f32 for the FMA body). Table
    entries past a row's bound are the scratch page 0 on even rows and stale
    pool pages on odd rows; with ``shared`` every row's first ``shared``
    entries are row 0's (the prefix cache's aliased pages). The launch must
    run ``EXPECTED_VARIANT``'s body, and a bf16 output is held per element
    to ``emulate_paged_split``. With ``poison`` the kernel also runs on
    pools in which every slot no row may read, and the scratch page, hold
    large finite values: its output must not change by a bit."""
    npages = 1 + b * p
    q = torch.randn(b, c, h, d, device="cuda", generator=gen).to(dtype)
    kp, vp = (torch.randn(npages, page, kvh, d, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(npages - 1, device="cuda", generator=gen) + 1).reshape(b, p)
    if shared:
        table[:, :shared] = table[0, :shared]
    off = torch.tensor(offs, device="cuda", dtype=torch.int32)
    last = ((off.long() + c - 1) // page).clamp(max=p - 1)
    past = torch.arange(p, device="cuda")[None, :] > last[:, None]
    even = (torch.arange(b, device="cuda") % 2 == 0)[:, None]
    table = torch.where(past & even, 0, table).to(torch.int32).contiguous()
    call = lambda: ra.paged_flash_attention(q, kp, vp, table, off)  # noqa: E731
    variant, out = launched_variant(ra.paged_flash_attention.launches, call)
    ref = ra.paged_attention_reference(q, kp, vp, table, off)
    lib = paged_library_call(q, kp, vp, table, off)
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ratio = paged_err_ratio(out, q, kp, vp, table, off) if dtype == torch.bfloat16 else None
    case = {"case": label, "B": b, "C": c, "H": h, "kv_heads": kvh, "D": d, "page": page,
            "P": p, "off": offs, "shared_pages": shared,
            "dtype": str(dtype).replace("torch.", ""), "variant": variant,
            "max_abs_err": err, "tol": TOL[dtype], "tile_err_ratio": ratio,
            "library_max_abs_err": (lib_out.float() - ref.float()).abs().max().item()}
    if poison:
        keys = (off.long() + c).clamp(max=p * page)
        pos = torch.arange(p * page, device="cuda")
        valid = pos[None, :] < keys[:, None]
        live = torch.zeros(npages, page, dtype=torch.bool, device="cuda")
        live[table.long()[:, pos // page][valid], (pos % page).expand(b, -1)[valid]] = True
        live[0] = False
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[~live], vp2[~live] = 3.0e4, -3.0e4
        again = ra.paged_flash_attention(q, kp2, vp2, table, off)
        torch.cuda.synchronize()
        case["poisoned_slots"] = int((~live).sum()) * kvh
        case["poisoned_equal"] = bool(torch.equal(again, out))
    else:
        bound, bound_by = paged_bound_ms(off, c, h, kvh, d, page, p, table)
        case.update({
            **call_times(call, lambda: ra.paged_attention_reference(q, kp, vp, table, off), lib),
            "library": "gather + sdpa(enable_gqa, offset mask)",
            "bound_ms": bound, "bound_by": bound_by})
    print("K3 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K3 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K3 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K3 off its rounding emulation: {case}")
    check(case.get("poisoned_equal", True), f"K3 read past a row's bound: {case}")
    return case


def paged_edge_cases(gen) -> dict:
    """K3 against its plain version where its splits and folds have edges:
    both head dims in bf16 (the split kernel) and f32 (the FMA body), GQA
    groups of 1 to 8, decode and chunk folds on both sides of 16 folded
    queries, pages of 16 and of 12 (pages that straddle a split), contexts
    from 1 key to past the table (padded chunk queries), on shuffled tables.
    Each launch must run the variant ``paged_variant`` names; bf16 outputs
    are also held per element to ``emulate_paged_split``."""
    rng = np.random.default_rng(8)
    worst: dict[str, float] = {}
    worst_ratio: dict[str, float] = {}
    launches = 0
    for d in ra.PAGED_HEAD_DIMS:
        for c, h, kvh in ((1, 4, 4), (1, 32, 8), (3, 8, 2), (5, 16, 2), (40, 8, 2)):
            for page in (16, 12):
                b, p = 3, 7
                npages = 1 + b * p
                ctx = p * page
                kp, vp = (torch.randn(npages, page, kvh, d, device="cuda", generator=gen)
                          .to(torch.bfloat16) for _ in range(2))
                table = (torch.randperm(npages - 1, device="cuda", generator=gen) + 1)
                table = table.reshape(b, p).to(torch.int32).contiguous()
                off = torch.tensor([0, int(rng.integers(0, ctx)), ctx - 1 - c // 2],
                                   device="cuda", dtype=torch.int32)
                for dtype in (torch.bfloat16, torch.float32):
                    q = torch.randn(b, c, h, d, device="cuda", generator=gen).to(dtype)
                    want = ra.paged_variant(dtype, d)
                    variant, out = launched_variant(
                        ra.paged_flash_attention.launches,
                        lambda: ra.paged_flash_attention(q, kp, vp, table, off))
                    launches += 1
                    ref = ra.paged_attention_reference(q, kp, vp, table, off)
                    err = (out.float() - ref.float()).abs().max().item()
                    key = f"D={d} {str(dtype).replace('torch.', '')}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    where = f"K3 at D={d}, C={c}, H={h}, KVH={kvh}, page={page}, {dtype}"
                    check(variant == want, f"{where} ran {variant}, not {want}")
                    check(err <= TOL[dtype], f"{where} off its plain version by {err}")
                    if dtype == torch.bfloat16:
                        ratio = paged_err_ratio(out, q, kp, vp, table, off)
                        worst_ratio[key] = max(worst_ratio.get(key, 0.0), ratio)
                        check(ratio <= 1, f"{where} off its rounding emulation ({ratio} of the limit)")
    report = {"launches": launches, "max_abs_err": worst, "tile_err_ratio": worst_ratio}
    print("K3 edge cases " + json.dumps(report), flush=True)
    return report


class GeneratedSink(OrderedSink):
    """Also records the generated column of every batch, in order, and zeroes
    the launch counts when it connects: the output connects last, after the
    processor's warmup, so the counts read after the run are the traffic's."""

    def __init__(self, inner: Output, field: str):
        super().__init__(inner)
        self.field = field
        self.generated: list[bytes] = []

    async def connect(self) -> None:
        await super().connect()
        torch.cuda.synchronize()
        reset_counts()

    async def write(self, batch: MessageBatch) -> None:
        self.generated.extend(batch.column(self.field).to_pylist())
        await super().write(batch)


def run_generate_slice(cfg_raw: dict, eager: bool = False, label: str = "generate",
                       prepare=None) -> dict:
    """A continuous generate stream through ``Engine`` (its server swapped
    for an eager twin on the same weights when ``eager``; ``prepare`` called
    on the server before the run). The server's init-time parity gate runs
    at build and its K3 launches are read apart; the processor's connect
    captures the step graphs; the counts are zeroed when the output
    connects, after that, and read just after the run. K3 launches = layers
    x (decode + chunk + verify steps); the pages still held are the prefix
    cache's alone."""
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    reset_counts()
    t0 = time.perf_counter()
    stream = engine.build()[0]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gate_launches = ra.paged_flash_attention.launches.value
    proc = stream.pipeline.processors[0]
    if eager:
        proc.server = proc.runner = server_twin(proc.server, eager=True)
        torch.cuda.empty_cache()
    server = proc.server
    if prepare is not None:
        prepare(server)
    memory: dict = {}
    measure_warmup(server, memory)
    sink = stream.output = GeneratedSink(stream.output, proc_cfg["output_field"])
    reg = global_registry()
    gen_before = (reg.sum_values("arkflow_gen_tokens_total"),
                  sum(m.count for m in reg.collect() if m.name == "arkflow_gen_ttft_seconds"))
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_metrics = {
        "tokens": reg.sum_values("arkflow_gen_tokens_total") - gen_before[0],
        "ttft_count": sum(m.count for m in reg.collect()
                          if m.name == "arkflow_gen_ttft_seconds") - gen_before[1]}
    k3, k1, k2 = ra.paged_flash_attention.launches.value, ra.launches.value, sa.launches.value
    k3_variants = dict(ra.paged_flash_attention.launches.variants)
    expected = generated_rows(cfg_raw)
    counts = [len(g.split()) for g in sink.generated]
    layers = server.cfg.layers
    traffic = stream.traffic_seconds
    report = {
        "rows_expected": len(expected), "rows_out": stream.rows_out,
        "rows_dropped": sink.inner.dropped_rows, "errors": stream.errors,
        "in_order": sink.payloads == expected, "generated_rows": len(counts),
        "max_tokens_per_row": max(counts, default=0), "max_new_tokens": proc_cfg["max_new_tokens"],
        "tokens": server.tokens, "build_seconds": build_s, "seconds": wall,
        "traffic_seconds": traffic, "traffic_tokens_per_s": server.tokens / traffic,
        "traffic_rows_per_s": stream.rows_out / traffic,
        "ttft_p50_ms": server.ttft_ms(0.5), "ttft_p99_ms": server.ttft_ms(0.99),
        "decode_steps": server.decode_steps, "chunk_steps": server.chunk_steps,
        "prefill_steps": server.prefill_steps, "verify_steps": server.verify_steps,
        "pipelined_dispatches": server.pipelined_dispatches,
        "traffic_ms_per_decode_step": traffic * 1e3 / max(1, server.decode_steps
                                                          + server.verify_steps),
        "spec_drafted": server.spec_drafted, "spec_accepted": server.spec_accepted,
        "prefix_hits": server.prefix_hits, "prefix_pages_shared": server.prefix_pages_shared,
        "prefix_evictions": server.prefix_evictions,
        "prefix_cache": server.health_report()["prefix_cache"],
        "temperature": server.temperature, "top_k": server.top_k,
        "top_k_misses": server.top_k_misses if server.check_top_k else None,
        "truncations": server.truncations, "decode_kernel": server.decode_kernel,
        "free_pages": len(server._free_pages), "num_pages": server.num_pages,
        "layers": layers, "dim": server.cfg.dim, "vocab": server.cfg.vocab_size,
        "k3_launches": k3, "k3_variants": k3_variants, "k3_gate_launches": gate_launches,
        "parity_gate": server.parity_report,
        "k1_launches": k1, "k2_launches": k2,
        "mode": "eager" if eager else "graphed", "captures": server.captures,
        "replays": {" ".join(map(str, k)): n for k, n in server.replay_counts().items()},
        "duty_cycle": server.duty_cycle(), "gen_metrics": gen_metrics, **memory}
    print(f"{label} slice " + json.dumps(report), flush=True)
    check(gen_metrics == {"tokens": sum(counts), "ttft_count": len(expected)},
          f"arkflow_gen_tokens_total / arkflow_gen_ttft_seconds_count deltas are not the "
          f"stream's tokens and rows: {report}")
    check(stream.errors == 0, f"generate stream reported errors: {report}")
    check(stream.rows_out == len(expected) and sink.inner.dropped_rows == len(expected)
          and len(counts) == len(expected), f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(report["max_tokens_per_row"] <= proc_cfg["max_new_tokens"],
          f"a row got more than max_new_tokens: {report}")
    check(server.decode_kernel == "paged", f"the server did not take the paged kernel: {report}")
    check(server.decode_steps + server.verify_steps > 0 and server.chunk_steps > 0,
          f"the stream ran no decode or no chunk step: {report}")
    check(k3 == layers * (server.decode_steps + server.chunk_steps + server.verify_steps),
          f"K3 launches != layers x (decode + chunk + verify steps): {report}")
    check(k3_variants["mma"] == k3, f"a bf16 K3 launch missed the tensor-core body: {report}")
    check(gate_launches > 0, f"the parity gate launched no K3: {report}")
    check(k1 == 0 and k2 == 0, f"the generate stream launched K1 or K2: {report}")
    check(report["free_pages"] + server._cache_held == server.num_pages - 1
          and all(n == server._cache_pages.get(pg) for pg, n in server._page_refs.items()),
          f"pages leaked: {report}")
    check(not server.check_top_k or server.top_k_misses == 0,
          f"a sampled token fell outside its step's top-k set: {report}")
    return {"report": report, "server": server, "rows": sink.generated}


def step_times(server: GenerationServer, label: str = "generate") -> dict:
    """One lockstep decode step over every slot (ragged contexts of up to
    the server's max_seq) and one 128-token chunk at offset 256, each
    dispatched and fetched as the server does it, graphed (``server``) and
    eager (a twin on its weights and pools), in turns: median ms."""
    eager = server_twin(server, eager=True)
    eager.k_pages, eager.v_pages = server.k_pages, server.v_pages
    out = {}
    for name, srv in (("graphed", server), ("eager", eager), ("graphed_again", server),
                      ("eager_again", eager)):
        out[name] = step_times_of(srv)
    print(f"{label} step_ms " + json.dumps(out), flush=True)
    return out


def step_times_of(server: GenerationServer) -> dict:
    s, p = server.slots, server.pages_per_slot
    table = (torch.randperm(server.num_pages - 1, generator=torch.Generator().manual_seed(3))
             + 1)[: s * p].reshape(s, p).numpy().astype(np.int32)
    lens = np.linspace(1, server.max_seq - 2, s).astype(np.int32)
    act = np.ones(s, bool)
    cur = torch.randint(3, server.cfg.vocab_size, (s,), generator=torch.Generator().manual_seed(7),
                        dtype=torch.int32).to(server.device)
    chunk = server.prefill_chunk or 128
    ids = np.random.default_rng(4).integers(3, server.cfg.vocab_size, (1, chunk)).astype(np.int32)

    def decode():
        with torch.inference_mode():
            return server._decode(cur, lens, act, table).wait()

    def chunk_step():
        with torch.inference_mode():
            return server._chunk(ids, 256, chunk, table[:1], True).wait()

    return {"decode_step_ms": time_ms(decode, iters=10, warmup=2),
            "decode_slots": s, "decode_mean_context": float(lens.mean() + 1),
            "chunk_step_ms": time_ms(chunk_step, iters=5, warmup=1), "chunk": chunk,
            "chunk_offset": 256}


def generate_prompts(cfg_raw: dict, n: int) -> list[list[int]]:
    """The first ``n`` rows of the generate stream, tokenized as the
    processor tokenizes them."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    tok = HashTokenizer(proc["model_config"]["vocab_size"])
    ids, mask = tok.encode_batch(generated_rows(cfg_raw)[:n], proc["max_input"])
    return [ids[i, : int(mask[i].sum())].tolist() for i in range(n)]


def serve_prompts(server: GenerationServer, prompts: list[list[int]], max_new: int):
    async def go():
        outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new,
                                                      with_margins=True) for p in prompts])
        await server.close()
        return outs

    outs = asyncio.run(go())
    check(len(server._free_pages) == server.num_pages - 1, "a paths server leaked pages")
    return outs


def compare_generation_paths(params, cfg, proc_cfg: dict, prompts: list[list[int]],
                             max_new: int) -> dict:
    """The same prompts through a paged and a gather server at depth 1 and a
    paged server at depth 2 (same weights, the stream's slots, pages and
    chunking): the paged streams equal the gather streams up to each
    request's first step whose gather top-2 gap is below the tie margin,
    and depth 2 equals depth 1 bit for bit. Then one decode step over the
    prompts' prefilled pools with the gather path, with K3, and with K3's
    plain version in K3's place. Two correct attention paths that round
    differently (the gather path rounds scores to bf16; K3 and its plain
    version sum in f32 in different orders) move logits of magnitude ~3,
    where one bf16 step is 1/64, by ~2 steps over 32 bf16 layers, so 1/64
    holds only per kernel call (the K3 cases). Here K3's logits must lie
    no further from either yardstick than the two yardsticks lie from each
    other, plus 1/64."""
    def server(kernel: str, depth: int) -> GenerationServer:
        return GenerationServer(
            params, cfg, slots=proc_cfg["slots"], page_size=proc_cfg["page_size"],
            max_seq=proc_cfg["max_input"] + proc_cfg["max_new_tokens"],
            eos_id=proc_cfg.get("eos_id", 2), prefill_chunk=proc_cfg["prefill_chunk"],
            decode_kernel=kernel, dispatch_depth=depth, record_margins=True)

    runs, seconds = {}, {}
    for name, kernel, depth in (("paged_d1", "paged", 1), ("gather_d1", "gather", 1),
                                ("paged_d2", "paged", 2)):
        srv = server(kernel, depth)
        t0 = time.perf_counter()
        runs[name] = serve_prompts(srv, prompts, max_new)
        seconds[name] = time.perf_counter() - t0
        del srv
        torch.cuda.empty_cache()
    streams = compare_to_first_tie([t for t, _ in runs["paged_d1"]], runs["gather_d1"])
    depth_equal = [t for t, _ in runs["paged_d2"]] == [t for t, _ in runs["paged_d1"]]

    b, page = len(prompts), proc_cfg["page_size"]
    p = -(-(proc_cfg["max_input"] + proc_cfg["max_new_tokens"]) // page)
    device = params["embed"]["table"].device
    kp, vp = init_page_pool(cfg, 1 + b * p, page, device)
    table = (torch.randperm(b * p, generator=torch.Generator().manual_seed(5)) + 1).reshape(b, p)
    lens = np.asarray([len(x) for x in prompts], np.int32)
    ids = np.zeros((b, int(lens.max())), np.int32)
    for i, x in enumerate(prompts):
        ids[i, : len(x)] = x
    dev = {"ids": torch.from_numpy(ids).to(device), "lens": torch.from_numpy(lens).to(device),
           "table": table.to(device=device, dtype=torch.int32)}
    with torch.inference_mode():
        nxt, _, _ = paged_prefill(params, cfg, dev["ids"], dev["lens"], dev["table"], kp, vp)
        act = torch.ones(b, dtype=torch.bool, device=device)

        def step(kernel: str) -> torch.Tensor:  # rewrites the same K/V each time
            return paged_decode_step(params, cfg, nxt, dev["lens"], act, dev["table"], kp, vp,
                                     return_logits=True, attention_kernel=kernel)[0]

        logits = {"gather": step("gather"), "paged": step("paged")}
        pd.paged_flash_attention = ra.paged_attention_reference
        try:
            logits["paged_plain"] = step("paged")
        finally:
            pd.paged_flash_attention = ra.paged_flash_attention

    def err(a: str, b: str) -> float:
        return (logits[a] - logits[b]).abs().max().item()

    logit_err = {"paged_vs_plain": err("paged", "paged_plain"),
                 "paged_vs_gather": err("paged", "gather"),
                 "plain_vs_gather": err("paged_plain", "gather"),
                 "max_abs_logit": logits["gather"].abs().max().item()}
    del kp, vp, logits
    torch.cuda.empty_cache()
    report = {"prompts": b, "max_new_tokens": max_new,
              "tokens": {n: sum(len(t) for t, _ in r) for n, r in runs.items()},
              **streams, "depth2_equals_depth1": depth_equal, "first_step_max_logit_abs_err": logit_err,
              "logit_tol": LOGIT_TOL, "seconds": seconds}
    print("generate paths " + json.dumps(report), flush=True)
    check(not streams["rows_mismatched_before_a_tie"],
          f"paged and gather streams differ before a near-tie: {report}")
    check(depth_equal, f"depth 2 changed the paged streams: {report}")
    floor = logit_err["plain_vs_gather"] + LOGIT_TOL
    check(logit_err["paged_vs_plain"] <= floor and logit_err["paged_vs_gather"] <= floor,
          f"first decode step logits: K3 further from a yardstick than the yardsticks "
          f"are from each other: {report}")
    return report


def differing_elements(a: dict, b: dict) -> int:
    """Elements of ``a``'s outputs whose bytes differ from ``b``'s."""
    check(set(a) == set(b), f"output names differ: {sorted(a)} vs {sorted(b)}")
    n = 0
    for k in a:
        x, y = np.ascontiguousarray(a[k]), np.ascontiguousarray(b[k])
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"output {k}: {x.dtype} {x.shape} vs {y.dtype} {y.shape}")
        bx, by = x.view(np.uint8).reshape(x.size, -1), y.view(np.uint8).reshape(y.size, -1)
        n += int(np.count_nonzero((bx != by).any(axis=1)))
    return n


def key_inputs(runner: ModelRunner, key: tuple, rng: np.random.Generator) -> dict:
    """Random inputs of exactly one padded shape key of ``runner``: right-
    padded rows of random lengths; packed, every row holding its share of
    the key's examples in segments of random lengths."""
    shapes = dict(key)
    vocab = runner.cfg.vocab_size
    rows, seq = shapes["input_ids"]
    if not runner.packed:
        lengths = rng.integers(1, seq + 1, rows)
        mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
        return {"input_ids": rng.integers(4, vocab, (rows, seq)).astype(np.int32) * mask,
                "attention_mask": mask}
    examples = shapes["example_row"][0]
    per_row = np.full(rows, examples // rows)
    per_row[: examples % rows] += 1
    ids, seg, pos = (np.zeros((rows, seq), np.int32) for _ in range(3))
    ex_row, ex_pos = [], []
    for r, n in enumerate(per_row):
        start = 0
        for j in range(n):
            length = int(rng.integers(1, seq // n + 1))
            ids[r, start:start + length] = rng.integers(4, vocab, length)
            seg[r, start:start + length] = j + 1
            pos[r, start:start + length] = np.arange(length)
            ex_row.append(r)
            ex_pos.append(start)
            start += length
    return {"input_ids": ids, "segment_ids": seg, "position_ids": pos,
            "example_row": np.asarray(ex_row, np.int32),
            "example_pos": np.asarray(ex_pos, np.int32)}


def key_name(key: tuple) -> str:
    shapes = dict(key)
    name = "x".join(map(str, shapes["input_ids"]))
    return name + (f" e{shapes['example_row'][0]}" if "example_row" in shapes else "")


def graph_check_runner(path: str, runner: ModelRunner, memory: dict, seed: int) -> dict:
    """Every captured shape key of a stream's runner: its graph's replay
    against the eager twin on the same random inputs of that shape; 0
    differing elements required."""
    twin = eager_twin(runner)
    rng = np.random.default_rng(seed)
    keys = runner._compiled.keys()
    per_key = {}
    for key in keys:
        inputs = key_inputs(runner, key, rng)
        before = runner._compiled.replays[key]
        got = runner.infer_sync(inputs)
        check(runner._compiled.replays[key] == before + 1,
              f"{path}: the step did not replay the graph of {key_name(key)}")
        per_key[key_name(key)] = differing_elements(got, twin.infer_sync(inputs))
    report = {"captures": runner.captures, "keys_checked": len(keys),
              "differing_elements": sum(per_key.values()), "per_key": per_key,
              **{k: memory.get(k) for k in ("reserved_before_captures",
                                            "reserved_after_captures")}}
    print(f"graphs {path} " + json.dumps(report), flush=True)
    check(runner._compiled.graphed and len(keys) == runner.captures > 0,
          f"{path}: no graph captured: {report}")
    check(report["differing_elements"] == 0, f"{path}: graphed != eager: {report}")
    return report


def graph_check_server(server: GenerationServer, path: str = "generate",
                       kernels: tuple = ("paged", "gather")) -> dict:
    """Every step key of a generate path, with K3 (``paged``) and with the
    gather path: a graphed server on the stream server's weights and
    settings, every key captured by ``warmup``, against an eager twin on
    the same weights and the same KV pools (each step rewrites the K/V the
    other wrote, value for value), on the same inputs (a sampling server's
    steps on the same subkey): next tokens, top-2 logit gaps and top-k
    misses, 0 differing elements required. A speculative server's keys are
    verify, chunk and prefill; its verify step scores 1 to k tokens a slot."""
    graphed = server_twin(server, eager=False, record_margins=True, decode_kernel="paged")
    eager = server_twin(server, eager=True, record_margins=True, decode_kernel="paged")
    eager.k_pages, eager.v_pages = graphed.k_pages, graphed.v_pages
    memory = {"reserved_before_captures": reserved_bytes()}
    for kernel in kernels:
        graphed.decode_kernel = kernel
        graphed.warmup()
    memory["reserved_after_captures"] = reserved_bytes()
    s, p = graphed.slots, graphed.pages_per_slot
    table = (torch.randperm(graphed.num_pages - 1, generator=torch.Generator().manual_seed(8))
             + 1)[: s * p].reshape(s, p).numpy().astype(np.int32)
    rng = np.random.default_rng(9)
    lens = np.linspace(1, graphed.max_seq - 8, s).astype(np.int32)
    act = np.ones(s, bool)
    cur = rng.integers(3, graphed.cfg.vocab_size, s).astype(np.int32)
    sub = 0x5EED if graphed.sampling else None
    per_key = {}
    with torch.inference_mode():
        for key in graphed._compiled.keys():
            kind, size = key[0], key[1]
            kernel = key[-1] if kind != "prefill" else "paged"
            width = {"decode": 1, "verify": s * size}.get(kind, size)
            ids = rng.integers(3, graphed.cfg.vocab_size, (1, width)).astype(np.int32)
            clen = (np.arange(s) % size + 1).astype(np.int32) if kind == "verify" else None

            def step(srv):
                srv.decode_kernel = kernel
                if kind == "decode":
                    return srv._decode(cur, lens, act, table, key=sub).wait()
                if kind == "verify":
                    return srv._verify(ids.reshape(s, size), lens, clen, table).wait()
                if kind == "chunk":
                    off = max(0, min(256, srv.max_seq - size))
                    return srv._chunk(ids, off, size, table[:1], True, key=sub).wait()
                return srv._prefill(ids, size, table[:1], key=sub).wait()

            before = graphed._compiled.replays[key]
            (a_nxt, a_gap), (b_nxt, b_gap) = step(graphed), step(eager)
            check(graphed._compiled.replays[key] == before + 1,
                  f"{path}: the step did not replay the graph of {key}")
            per_key[" ".join(map(str, key))] = differing_elements(
                {"nxt": a_nxt, "margin": a_gap}, {"nxt": b_nxt, "margin": b_gap})
    report = {"captures": graphed.captures, "keys_checked": len(per_key),
              "differing_elements": sum(per_key.values()), "per_key": per_key,
              "top_k_misses": [graphed.top_k_misses, eager.top_k_misses], **memory}
    print(f"graphs {path} " + json.dumps(report), flush=True)
    check(len(per_key) == graphed.captures > 0, f"{path}: no graph captured: {report}")
    check(report["differing_elements"] == 0, f"{path}: graphed != eager: {report}")
    del graphed, eager
    release_memory()
    return report


def ab_numbers(report: dict) -> dict:
    """One stream run's numbers for the A/B line."""
    keys = (("traffic_tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "traffic_ms_per_decode_step")
            if "traffic_tokens_per_s" in report else ("traffic_rows_per_s",))
    return {**{k: report[k] for k in keys}, "duty_cycle": report["duty_cycle"],
            "captures": report["captures"], "traffic_seconds": report["traffic_seconds"]}


# -- the generation features: serving, sampling, batch ----------------------


def row_ids(rows: list[bytes]) -> list[list[int]]:
    """A generated column's rows as token ids."""
    return [[int(t) for t in g.split()] for g in rows]


def compare_to_first_tie(got: list[list[int]], ref: list[tuple[list[int], list[float]]],
                         margin: float = LABEL_MARGIN, limits: list | None = None) -> dict:
    """Every row of ``got`` against ``ref``'s (ids, top-2 gaps) up to the
    first step whose gap in ``ref`` is at or below ``margin`` (and, where
    ``limits`` gives one, up to that row's limit); all of it where there is
    none."""
    compared, tied, mismatched = 0, 0, []
    for i, (a, (b, gaps)) in enumerate(zip(got, ref)):
        tie = next((j for j, g in enumerate(gaps) if g <= margin), None)
        limit = None if limits is None else limits[i]
        stops = [x for x in (tie, limit) if x is not None]
        k = min(stops) if stops else len(b)
        tied += tie is not None
        compared += min(k, len(b))
        if a[:k] != b[:k] or (not stops and a != b):
            mismatched.append(i)
    return {"rows": len(ref), "tokens_compared": compared, "rows_with_a_tie": tied,
            "tie_margin": margin, "rows_mismatched_before_a_tie": mismatched}


def k3_verify_cases(gen) -> dict:
    """K3 in the forms speculative decoding and the prefix cache give it:
    the verify step (8 slots, C = 4 queries at offsets from 0 to past a
    split, 500 and the table's end), the same over tables whose rows share
    their first 6 pages (the cached 96-token instruction), and a 128-query
    chunk from a cached boundary over shared pages. Each held to its plain
    version and to ``emulate_paged_split``, timed, beside its bound and the
    gather + SDPA library call."""
    cases = {
        "verify": paged_case(gen, 8, 4, [0, 15, 16, 63, 64, 500, 256, 636], "verify C=4"),
        "verify_shared": paged_case(gen, 8, 4, [96, 101, 112, 160, 255, 500, 96, 400],
                                    "verify C=4, 6 shared pages", shared=6),
        "chunk_shared": paged_case(gen, 2, 128, [96, 96],
                                   "chunk from a cached boundary, 6 shared pages", shared=6),
    }
    line = {name: {k: c[k] for k in ("B", "C", "off", "shared_pages", "max_abs_err",
                                     "tile_err_ratio", "kernel_device_ms", "kernel_ms",
                                     "library_device_ms", "plain_device_ms", "bound_ms",
                                     "bound_by", "variant")}
            for name, c in cases.items()}
    print("K3 verify cases " + json.dumps(line), flush=True)
    return cases


def run_serving_features(cfg_raw: dict) -> dict:
    """``llama_serving_stream.json`` (8 slots, chunk 128, speculative 3,
    prefix cache 64 pages, ``SERVING_ROWS`` rows behind one 96-token
    instruction) graphed, its rows against a server with both features off
    (ids equal up to each row's first near-tie), its step keys' graphs
    against eager (the verify key included), then the stream eager."""
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    graphed = run_generate_slice(cfg_raw, label="serving")
    server, rep = graphed["server"], graphed["report"]
    check(rep["verify_steps"] > 0 and rep["decode_steps"] == 0,
          f"the speculative stream ran no verify step: {rep}")
    check(rep["prefix_hits"] > 0 and rep["prefix_pages_shared"] > 0,
          f"the stream never hit the prefix cache: {rep}")
    prompts = generate_prompts(cfg_raw, len(graphed["rows"]))
    plain = GenerationServer(
        server.params, server.cfg, slots=proc_cfg["slots"], page_size=proc_cfg["page_size"],
        max_seq=server.max_seq, eos_id=server.eos_id, prompt_buckets=server.prompt_buckets,
        prefill_chunk=proc_cfg["prefill_chunk"], decode_kernel="paged",
        kernel_parity_check=False, record_margins=True)
    t0 = time.perf_counter()
    ref = serve_prompts(plain, prompts, proc_cfg["max_new_tokens"])
    plain_s = time.perf_counter() - t0
    del plain
    release_memory()
    streams = {**compare_to_first_tie(row_ids(graphed["rows"]), ref),
               "features_off_seconds": plain_s,
               "features_off_tokens": sum(len(t) for t, _ in ref)}
    print("serving streams " + json.dumps(streams), flush=True)
    check(not streams["rows_mismatched_before_a_tie"],
          f"the features changed a row before its first near-tie: {streams}")
    graphs = graph_check_server(server, path="serving", kernels=("paged",))
    check(any(k.startswith("verify") for k in graphs["per_key"]),
          f"serving: no verify graph checked: {graphs}")
    del server, graphed["server"]
    release_memory()
    eager = run_generate_slice(cfg_raw, eager=True, label="serving")
    del eager["server"]
    release_memory()
    return {"report": rep, "eager": eager["report"], "streams": streams, "graphs": graphs}


def run_sampling(gen_raw: dict) -> dict:
    """The generate stream sampled (``temperature`` 0.8, ``top_k`` 50,
    dispatch depth 1) with the in-graph top-k check on; then on its first
    ``GEN_CHECK_PROMPTS`` prompts, all submitted at once: two graphed runs
    from one seed equal, an eager run equal to them, no top-k miss, and
    ``top_k`` 1 equal to the greedy stream up to its first exact tie (a
    top-2 gap of 0: ``top_k`` keeps every logit tied with the k-th, as in
    JAX, and the draw then picks among them)."""
    cfg = json.loads(json.dumps(gen_raw))
    cfg["streams"][0]["pipeline"]["processors"][0].update(
        temperature=0.8, top_k=50, dispatch_depth=1)
    cfg["streams"][0]["input"]["count"] = SERVING_ROWS
    run = run_generate_slice(cfg, label="sampling",
                             prepare=lambda srv: setattr(srv, "check_top_k", True))
    server = run["server"]
    prompts = generate_prompts(cfg, GEN_CHECK_PROMPTS)
    outs, misses = {}, {}
    for name, kw in (("graphed", {}), ("graphed_again", {}), ("eager", {"eager": True}),
                     ("top_k_1", {"top_k": 1}), ("greedy", {"temperature": 0.0, "top_k": 0})):
        twin = server_twin(server, eager=kw.pop("eager", False), record_margins=True,
                           check_top_k=True, seed=7, **kw)
        outs[name] = serve_prompts(twin, prompts, GEN_CHECK_NEW)
        misses[name] = twin.top_k_misses
        del twin
        release_memory()
    ids = {k: [t for t, _ in v] for k, v in outs.items()}
    top1 = compare_to_first_tie(ids["top_k_1"], outs["greedy"], margin=0.0)
    report = {"stream": {k: run["report"][k] for k in (
                  "traffic_tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tokens",
                  "decode_steps", "chunk_steps", "prefill_steps", "top_k_misses", "k3_launches")},
              "prompts": len(prompts), "max_new_tokens": GEN_CHECK_NEW,
              "same_seed_equal": ids["graphed"] == ids["graphed_again"],
              "graphed_equals_eager": ids["graphed"] == ids["eager"],
              "top_k_misses": misses, "top_k_1_vs_greedy": top1,
              "tokens": {k: sum(len(t) for t in v) for k, v in ids.items()}}
    print("sampling " + json.dumps(report), flush=True)
    check(report["same_seed_equal"], f"one seed gave two streams: {report}")
    check(report["graphed_equals_eager"], f"sampled graphs != eager: {report}")
    check(not any(misses.values()), f"a draw fell outside its top-k set: {report}")
    check(not top1["rows_mismatched_before_a_tie"],
          f"top_k 1 differs from greedy before an exact tie: {report}")
    del server, run["server"]
    release_memory()
    return report


def run_batch_generate(cfg_raw: dict) -> dict:
    """``llama_batch_stream.json`` (``serving`` absent: batch mode, buckets
    4/16, 256 + 64 positions) through ``Engine``: every row in order; every
    generation replayed on an ``eager=True`` generator from the same inputs
    and key, tokens and counts equal bit for bit; every row's ids equal to
    a continuous paged server's greedy stream on the same prompts up to the
    first near-tie (the contiguous plain attention against K3); no kernel
    launched by the batch path."""
    from arkflow_tpu_torch.tpu.batch_generate import BatchGenerator

    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]
    gen = proc.generator
    memory: dict = {}
    measure_warmup(gen, memory)
    calls = []
    inner = gen.generate

    def generate(ids, lengths, n, key):
        out = inner(ids, lengths, n, key)
        calls.append((ids.copy(), lengths.copy(), n, key, out))
        return out

    gen.generate = generate
    sink = stream.output = GeneratedSink(stream.output, proc_cfg["output_field"])
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": ra.launches.value, "k2": sa.launches.value,
                "k3": ra.paged_flash_attention.launches.value}
    rows = generated_rows(cfg_raw)
    traffic = stream.traffic_seconds
    tokens = sum(len(g.split()) for g in sink.generated)
    eager = BatchGenerator(gen.params, gen.cfg, max_new_tokens=gen.max_new_tokens,
                           eos_id=gen.eos_id, eager=True)
    differing = 0
    t1 = time.perf_counter()
    for ids, lengths, n, key, (tok, cnt, steps) in calls:
        e_tok, e_cnt, e_steps = eager.generate(ids, lengths, n, key)
        differing += int((e_tok != tok).sum()) + int((e_cnt != cnt).sum()) + (e_steps != steps)
    eager_s = time.perf_counter() - t1
    stream_steps, stream_generations = list(gen.steps), gen.generations
    # one generation again, graphed and eager in turns: wall ms per step
    ids, lengths, n, key, (_, _, steps) = calls[0]
    per_step = {}
    for name, run in (("graphed", inner), ("eager", eager.generate), ("graphed_again", inner)):
        t1 = time.perf_counter()
        run(ids, lengths, n, key)
        torch.cuda.synchronize()
        per_step[name] = (time.perf_counter() - t1) * 1e3 / (steps + 1)
    del eager
    release_memory()
    prompts = generate_prompts(cfg_raw, len(rows))
    server = GenerationServer(
        gen.params, gen.cfg, slots=16, page_size=16,
        max_seq=proc_cfg["max_input"] + proc_cfg["max_new_tokens"], eos_id=gen.eos_id,
        prefill_chunk=128, decode_kernel="paged", kernel_parity_check=False,
        record_margins=True)
    ref = serve_prompts(server, prompts, proc_cfg["max_new_tokens"])
    del server
    release_memory()
    # the reference's mask (``k < lengths`` with lengths advancing each
    # step, JAX ``decoder.decode_step``) lets a row shorter than its batch's
    # prompt width attend its first padding slot from token 2 on: such rows
    # are held to the server up to token 2, full-width rows up to a tie
    padded = [bool(lengths[r] < ids.shape[1]) for ids, lengths, n, _, _ in calls
              for r in range(n)]
    streams = compare_to_first_tie(row_ids(sink.generated), ref,
                                   limits=[2 if p else None for p in padded])
    streams["padded_rows"] = sum(padded)
    streams["padded_rows_equal_in_full"] = sum(
        1 for p, a, (b, _) in zip(padded, row_ids(sink.generated), ref) if p and a == b)
    report = {"rows_expected": len(rows), "rows_out": stream.rows_out,
              "errors": stream.errors, "in_order": sink.payloads == rows, "tokens": tokens,
              "seconds": wall, "traffic_seconds": traffic,
              "traffic_tokens_per_s": tokens / traffic,
              "generations": stream_generations, "decode_steps_per_generation": stream_steps,
              "batch_shapes": [list(c[0].shape) for c in calls],
              "captures": gen.captures, **memory,
              "replays": {" ".join(map(str, k)): v for k, v in gen.replay_counts().items()},
              "eager_replay_differing": differing, "eager_seconds": eager_s,
              "ms_per_step_of_one_generation": per_step,
              "launches": launches, "vs_continuous": streams}
    print("batch generate " + json.dumps(report), flush=True)
    check(stream.errors == 0 and stream.rows_out == len(rows) and report["in_order"],
          f"the batch stream lost or reordered rows: {report}")
    check(stream_generations == len(calls) > 0 and gen.captures > 0,
          f"the batch stream generated nothing through its graphs: {report}")
    check(all(s <= proc_cfg["max_new_tokens"] - 1 for s in stream_steps),
          f"a generation ran past max_new_tokens: {report}")
    check(differing == 0, f"batch graphs != eager: {report}")
    check(not any(launches.values()), f"the batch path launched a kernel: {report}")
    check(not streams["rows_mismatched_before_a_tie"],
          f"batch rows differ from the continuous server before a near-tie: {report}")
    gen.generate = inner
    del gen, calls
    # the warm processor, the rows, their tokens and the reference stay for
    # the Kafka CDC -> Llama-3-8B -> NATS stream
    return {"report": report, "proc": proc, "rows": rows, "generated": sink.generated,
            "ref": ref, "limits": [2 if p else None for p in padded]}


# -- MoE: the Switch decoder at Llama-3-8B widths ---------------------------


def held_everywhere(trace: dec.RoutingTrace, fn):
    """``fn()`` with every thread's MoE calls recording into or replaying
    from ``trace`` (``decoder.holding_routing`` holds one thread; a
    server's steps run on executor threads). Nothing else runs meanwhile."""
    saved = dec._routing
    dec._routing = types.SimpleNamespace(trace=trace)
    try:
        return fn()
    finally:
        dec._routing = saved


def compare_moe_paths(server: GenerationServer, prompts: list[list[int]], max_new: int) -> dict:
    """K3 against the gather path on the MoE model, with the routing held
    (``decoder.RoutingTrace``: top-1 routing is discontinuous, and a
    near-tied router choice that the two paths' rounding flips moves a
    token's logits far past any tie margin): the prompts through an eager
    gather server (routing recorded) and an eager paged server (the same
    routing replayed; same slots, pages and chunking, all submitted at
    once, so both run the same steps in the same order), streams equal up
    to each row's first step whose top-2 logit gap in the gather run is at
    or below the tie margin; the replayed decisions that K3's own routing
    would have flipped are reported. Then one decode step over the
    prompts' prefilled pools with the gather path (routing recorded), with
    K3 and with K3's plain version (replayed): K3's logits no further from
    either yardstick than the two lie from each other, plus 1/64."""
    trace = dec.RoutingTrace()
    runs, seconds = {}, {}
    for name, kernel in (("gather", "gather"), ("paged", "paged")):
        twin = server_twin(server, eager=True, record_margins=True, decode_kernel=kernel,
                           dispatch_depth=1)
        t0 = time.perf_counter()
        runs[name] = held_everywhere(trace, lambda: serve_prompts(twin, prompts, max_new))
        seconds[name] = time.perf_counter() - t0
        del twin
        if name == "gather":
            trace.replay()
    check(trace.at == len(trace.tops),
          f"held routing: {trace.at} calls replayed of {len(trace.tops)} recorded")
    streams = compare_to_first_tie([t for t, _ in runs["paged"]], runs["gather"])
    routing = {"moe_calls": len(trace.tops), "decisions": trace.replayed(),
               "flips": trace.flips()}
    del trace
    release_memory()

    params, cfg = server.params, server.cfg
    b, page = len(prompts), server.page_size
    p = server.pages_per_slot
    device = server.device
    kp, vp = init_page_pool(cfg, 1 + b * p, page, device)
    table = (torch.randperm(b * p, generator=torch.Generator().manual_seed(5)) + 1).reshape(b, p)
    lens = np.asarray([len(x) for x in prompts], np.int32)
    ids = np.zeros((b, int(lens.max())), np.int32)
    for i, x in enumerate(prompts):
        ids[i, : len(x)] = x
    dev = {"ids": torch.from_numpy(ids).to(device), "lens": torch.from_numpy(lens).to(device),
           "table": table.to(device=device, dtype=torch.int32)}
    step_trace = dec.RoutingTrace()
    with torch.inference_mode():
        nxt, _, _ = paged_prefill(params, cfg, dev["ids"], dev["lens"], dev["table"], kp, vp)
        act = torch.ones(b, dtype=torch.bool, device=device)

        def step(kernel: str) -> torch.Tensor:  # rewrites the same K/V each time
            return paged_decode_step(params, cfg, nxt, dev["lens"], act, dev["table"], kp, vp,
                                     return_logits=True, attention_kernel=kernel)[0]

        with dec.holding_routing(step_trace):
            logits = {"gather": step("gather")}
        with dec.holding_routing(step_trace.replay()):
            logits["paged"] = step("paged")
        pd.paged_flash_attention = ra.paged_attention_reference
        try:
            with dec.holding_routing(step_trace.replay()):
                logits["paged_plain"] = step("paged")
        finally:
            pd.paged_flash_attention = ra.paged_flash_attention

    def err(a: str, b: str) -> float:
        return (logits[a] - logits[b]).abs().max().item()

    logit_err = {"paged_vs_plain": err("paged", "paged_plain"),
                 "paged_vs_gather": err("paged", "gather"),
                 "plain_vs_gather": err("paged_plain", "gather"),
                 "max_abs_logit": logits["gather"].abs().max().item()}
    del kp, vp, logits
    release_memory()
    report = {"prompts": b, "max_new_tokens": max_new,
              "tokens": {n: sum(len(t) for t, _ in r) for n, r in runs.items()},
              **streams, "routing": routing, "first_step_flips": step_trace.flips(),
              "first_step_max_logit_abs_err": logit_err, "logit_tol": LOGIT_TOL,
              "seconds": seconds}
    print("moe paths " + json.dumps(report), flush=True)
    check(not streams["rows_mismatched_before_a_tie"],
          f"MoE: paged and gather streams differ before a near-tie: {report}")
    check(streams["tokens_compared"] >= b, f"MoE: the path comparison compared too little: "
          f"{report}")
    floor = logit_err["plain_vs_gather"] + LOGIT_TOL
    check(logit_err["paged_vs_plain"] <= floor and logit_err["paged_vs_gather"] <= floor,
          f"MoE first decode step logits: K3 further from a yardstick than the yardsticks "
          f"are from each other: {report}")
    return report


def moe_graphed_vs_eager(server: GenerationServer, prompts: list[list[int]],
                         max_new: int) -> dict:
    """The prompts, all submitted at once, through a graphed twin of the
    MoE server (each step key captured at its first step) and an eager
    twin, both on K3: every token and every step's top-2 gap equal bit for
    bit (the same steps in the same order, so the same expert capacities
    and drops)."""
    outs, seconds = {}, {}
    for name, eager in (("graphed", False), ("eager", True)):
        twin = server_twin(server, eager=eager, record_margins=True, dispatch_depth=1)
        t0 = time.perf_counter()
        outs[name] = serve_prompts(twin, prompts, max_new)
        seconds[name] = time.perf_counter() - t0
        del twin
        release_memory()
    tokens = {n: sum(len(t) for t, _ in o) for n, o in outs.items()}
    report = {"prompts": len(prompts), "max_new_tokens": max_new, "tokens": tokens,
              "tokens_equal": [t for t, _ in outs["graphed"]] == [t for t, _ in outs["eager"]],
              "gaps_equal": [g for _, g in outs["graphed"]] == [g for _, g in outs["eager"]],
              "seconds": seconds}
    print("moe graphed_vs_eager " + json.dumps(report), flush=True)
    check(report["tokens_equal"] and report["gaps_equal"],
          f"MoE: graphed tokens or gaps differ from eager: {report}")
    return report


def moe_padded_chunk_finite(server: GenerationServer) -> dict:
    """K3 on a chunk whose padded queries sit past its true length (JAX's
    rule, ``paged_decode.py:203-207``): every logit of every position
    finite, so a padded row cannot poison an expert's input."""
    cfg, chunk = server.cfg, server.prefill_chunk
    kp, vp = init_page_pool(cfg, 1 + chunk // server.page_size, server.page_size,
                            server.device)
    table = torch.arange(1, 1 + chunk // server.page_size, dtype=torch.int32,
                         device=server.device)[None]
    ids = torch.randint(3, cfg.vocab_size, (1, chunk), generator=torch.Generator().manual_seed(11),
                        dtype=torch.int32).to(server.device)
    off = torch.zeros(1, dtype=torch.int32, device=server.device)
    n = torch.full((1,), chunk // 3, dtype=torch.int32, device=server.device)
    with torch.inference_mode():
        logits, _, _ = pd.paged_prefill_chunk(server.params, cfg, ids, off, n, table, kp, vp,
                                              return_all=True, attention_kernel="paged")
        report = {"chunk": chunk, "true_len": chunk // 3,
                  "finite": bool(torch.isfinite(logits).all())}
    del kp, vp, logits
    print("moe padded chunk " + json.dumps(report), flush=True)
    check(report["finite"], f"MoE: K3 gave a non-finite padded chunk row: {report}")
    return report


def moe_batch(server: GenerationServer, prompts: list[list[int]]) -> dict:
    """``serving: batch`` on the MoE model: one bucket of
    ``MOE_BATCH_ROWS`` prompts (padded to the longest) through a graphed
    ``BatchGenerator`` and an eager one on the same weights, key 0:
    tokens, counts and steps equal bit for bit; no kernel launched (the
    contiguous cache's plain attention, as JAX's ``generate``)."""
    from arkflow_tpu_torch.tpu.batch_generate import BatchGenerator

    rows = prompts[:MOE_BATCH_ROWS]
    t = max(len(x) for x in rows)
    ids = np.zeros((len(rows), t), np.int32)
    for i, x in enumerate(rows):
        ids[i, : len(x)] = x
    lens = np.asarray([len(x) for x in rows], np.int32)
    out, seconds = {}, {}
    reset_counts()
    for name, eager in (("graphed", False), ("eager", True)):
        gen = BatchGenerator(server.params, server.cfg, max_new_tokens=MOE_BATCH_NEW,
                             eos_id=server.eos_id, eager=eager)
        gen.generate(ids, lens, len(rows), dec.make_key(0))  # captures (graphed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = gen.generate(ids, lens, len(rows), dec.make_key(0))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        del gen
    launches = {"k1": ra.launches.value, "k2": sa.launches.value,
                "k3": ra.paged_flash_attention.launches.value}
    (gt, gc_, gs), (et, ec, es) = out["graphed"], out["eager"]
    report = {"rows": len(rows), "prompt_width": t, "max_new_tokens": MOE_BATCH_NEW,
              "steps": [gs, es], "tokens": int(gc_.sum()),
              "equal": bool(np.array_equal(gt, et) and np.array_equal(gc_, ec) and gs == es),
              "ms_per_step": {n: seconds[n] * 1e3 / (out[n][2] + 1) for n in out},
              "launches": launches}
    print("moe batch " + json.dumps(report), flush=True)
    check(report["equal"], f"MoE batch mode: graphed != eager: {report}")
    check(report["tokens"] > 0 and not any(launches.values()),
          f"MoE batch mode generated nothing or launched a kernel: {report}")
    release_memory()
    return report


def moe_decode_bound_ms(cfg) -> float:
    """Least time of one MoE decode step at ``cfg``: every weight a decode
    step reads (the layers, whose ``bmm`` reads all E experts at any
    capacity, and the LM head; the embedding reads one row a slot), once,
    at the HBM rate."""
    dh = cfg.dim // cfg.heads
    attn = cfg.dim * (cfg.heads + 2 * cfg.kv_heads) * dh + cfg.heads * dh * cfg.dim
    experts = 3 * cfg.num_experts * cfg.dim * cfg.ffn
    nbytes = cfg.layers * 2 * (attn + experts) + cfg.layers * 4 * cfg.dim * cfg.num_experts \
        + 2 * cfg.dim * cfg.vocab_size
    return nbytes / HBM_BYTES_PER_S * 1e3


def run_moe(cfg_raw: dict) -> dict:
    """The MoE phase: ``llama_moe_stream.json`` (Switch top-1, 8 experts,
    Llama-3-8B widths, ``MOE_LAYERS`` layers) through ``Engine`` graphed (the stream
    checks of ``run_generate_slice``: rows in order, K3 = layers x (decode
    + chunk + verify steps), all ``mma``, the parity gate passed, no page
    leaked), its step times, ``graphs moe``, a padded chunk through K3,
    greedy streams graphed against eager, K3 against the gather path with
    the routing held, one ``serving: batch`` bucket graphed against eager;
    then the stream again on an eager twin (the A/B); and the ``moe`` line
    with the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graphed = run_generate_slice(cfg_raw, label="moe")
    server = graphed["server"]
    check(server.cfg.num_experts == 8 and "experts" in server.params["layers"],
          f"the MoE stream served no MoE model: {server.cfg}")
    params_bytes = tree_bytes(server.params)
    bound = moe_decode_bound_ms(server.cfg)
    steps = step_times(server, label="moe")
    graphs = graph_check_server(server, path="moe")
    finite = moe_padded_chunk_finite(server)
    prompts = generate_prompts(cfg_raw, MOE_CHECK_PROMPTS)
    exact = moe_graphed_vs_eager(server, prompts, MOE_CHECK_NEW)
    paths = compare_moe_paths(server, prompts, MOE_CHECK_NEW)
    batch = moe_batch(server, prompts)
    peak_graphed = torch.cuda.max_memory_reserved()
    del server, graphed["server"]
    release_memory()
    eager = run_generate_slice(cfg_raw, eager=True, label="moe eager")
    del eager["server"]
    release_memory()
    report = graphed["report"]
    moe = {"layers": report["layers"], "experts": 8, "params_gb": params_bytes / 1e9,
           "traffic_tokens_per_s": report["traffic_tokens_per_s"],
           "ttft_p50_ms": report["ttft_p50_ms"], "ttft_p99_ms": report["ttft_p99_ms"],
           "eager_traffic_tokens_per_s": eager["report"]["traffic_tokens_per_s"],
           "decode_step_ms": steps["graphed"]["decode_step_ms"],
           "decode_step_eager_ms": steps["eager"]["decode_step_ms"],
           "chunk_step_ms": steps["graphed"]["chunk_step_ms"],
           "decode_step_bound_ms": bound,
           "k3_launches": report["k3_launches"], "decode_steps": report["decode_steps"],
           "chunk_steps": report["chunk_steps"],
           "max_memory_reserved_gb": peak_graphed / 1e9,
           "max_memory_reserved_gb_with_eager": torch.cuda.max_memory_reserved() / 1e9,
           "graphed_vs_eager_tokens": exact["tokens"]["graphed"],
           "paths_tokens_compared": paths["tokens_compared"],
           "paths_routing": paths["routing"], "parity_gate": report["parity_gate"],
           "batch_equal": batch["equal"],
           "padded_chunk_finite": finite["finite"], "seconds": time.perf_counter() - t0}
    print("moe " + json.dumps(moe), flush=True)
    return {"report": report, "eager": eager["report"], "graphs": graphs, "moe": moe}


def run_batch_swap(cfg_raw: dict, layers: int = 4) -> dict:
    """A ``BatchGenerateUnit`` swap and rollback at full width and
    ``layers`` layers: a seed-1 checkpoint swapped in (the live addresses
    and captures kept), the column then equal to a processor built on that
    checkpoint; a ``swap_crash`` after the flip rolled back, the column the
    pre-crash one."""
    from arkflow_tpu_torch.components import Resource
    from arkflow_tpu_torch.components.registry import build_component

    proc_cfg = dict(cfg_raw["streams"][0]["pipeline"]["processors"][0])
    proc_cfg["model_config"] = {**proc_cfg["model_config"], "layers": layers}
    cfg = get_model("decoder_lm").make_config(**proc_cfg["model_config"])
    batch = MessageBatch.new_binary(generated_rows(cfg_raw)[:16])

    async def column(proc) -> list[bytes]:
        return (await proc.process(batch))[0].column(proc_cfg["output_field"]).to_pylist()

    os.makedirs(CHECKPOINT_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CHECKPOINT_ROOT) as d:
        ck = os.path.join(d, "seed1")
        save_ms = save_decoder_checkpoint(ck, cfg, 1)
        ref_proc = build_component("processor", {**proc_cfg, "checkpoint": ck}, Resource())

        async def reference():
            await ref_proc.connect()
            return await column(ref_proc)

        want = asyncio.run(reference())
        del ref_proc
        release_memory()
        proc = build_component("processor", {
            **proc_cfg, "swap": {"canary": {"min_agreement": 0.0}}}, Resource())
        ptrs = param_ptrs(proc.params)

        async def go():
            await proc.connect()
            before = await column(proc)
            captures = proc.generator.captures
            rep = await proc.swapper.swap(ck)
            after = await column(proc)
            proc.swapper.inject_swap_fault("swap_crash")
            crashed = None
            try:
                await proc.swapper.swap(ck)
            except Exception as e:  # the rollback raises SwapError
                crashed = type(e).__name__
            again = await column(proc)
            return before, after, again, rep, crashed, captures

        before, after, again, rep, crashed, captures = asyncio.run(go())
    report = {"layers": layers, "dim": cfg.dim, "vocab": cfg.vocab_size, "save_ms": save_ms,
              "version": rep.get("version"), "stage_ms": rep.get("stage_ms"),
              "swapped_equals_seed1": after == want, "changed": after != before,
              "rolled_back": crashed, "after_rollback_equal": again == after,
              "addresses_kept": param_ptrs(proc.params) == ptrs,
              "captures_kept": proc.generator.captures == captures}
    print("batch swap " + json.dumps(report), flush=True)
    check(report["version"] == 1 and report["swapped_equals_seed1"] and report["changed"],
          f"the batch swap did not serve the new weights: {report}")
    check(crashed == "SwapError" and report["after_rollback_equal"],
          f"the crashed batch swap did not roll back: {report}")
    check(report["addresses_kept"] and report["captures_kept"],
          f"the batch swap moved a live tensor or recaptured: {report}")
    del proc
    release_memory()
    return report


# -- the lifecycle phase ------------------------------------------------------


def lifecycle_config(ckpt_dir: str, *, faults: bool = True, count: int | None = None,
                     interval: str | None = None, **overrides) -> dict:
    """``bert_lifecycle_stream.json`` restoring the seed-0 checkpoint of
    ``ckpt_dir``: without its fault schedule when not ``faults``, with the
    generate input's ``count`` and ``interval`` and the processor's keys
    overridden; the health server on a free port."""
    with open(LIFECYCLE_CONFIG) as f:
        cfg = json.load(f)
    cfg["health_check"]["port"] = 0
    stream = cfg["streams"][0]
    fault = stream["pipeline"]["processors"][0]
    fault["inner"].update(checkpoint=os.path.join(ckpt_dir, "seed0"), **overrides)
    if not faults:
        fault["faults"] = []
    if count is not None:
        stream["input"]["inner"]["count"] = count
    if interval is not None:
        stream["input"]["inner"]["interval"] = interval
    return cfg


def save_checkpoints(ckpt_dir: str) -> dict:
    """The seed-0 and seed-1 BERT-base init trees as port checkpoints."""
    family = get_model("bert_classifier")
    cfg = family.make_config()
    out = {}
    for seed in (0, 1):
        t0 = time.perf_counter()
        checkpoint.save(os.path.join(ckpt_dir, f"seed{seed}"), init_host_params(family, cfg, seed))
        out[f"save_seed{seed}_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def outputs_of(batch: MessageBatch, names=("label", "score")) -> dict:
    return {k: np.asarray(batch.column(k)) for k in names}


def param_ptrs(params: dict) -> list[int]:
    return [t.data_ptr() for t in flatten(params).values()]


def fixed_batch(cfg_raw: dict, rows: int, offset: int = 7) -> MessageBatch:
    """``rows`` texts of the stream's payload mix, rotated from ``offset``
    so every length occurs."""
    payloads = cfg_raw["streams"][0]["input"]["inner"]["payloads"]
    return MessageBatch.new_binary([str(payloads[(offset + i) % len(payloads)]).encode()
                                    for i in range(rows)])


async def http(port: int, method: str, path: str, body=None) -> tuple[int, dict]:
    """One request to the engine's health server (HTTP/1.1, one connection)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


def wait_zombies(runner: ModelRunner, timeout_s: float = 30.0) -> None:
    """Wait until every step abandoned at its deadline has ended (it counts
    its launches and steps when it does)."""
    end = time.monotonic() + timeout_s
    while runner.core.zombies and time.monotonic() < end:
        time.sleep(0.05)
    check(runner.core.zombies == 0, "an abandoned step never ended")


def run_selfheal(cfg_raw: dict) -> dict:
    """The self-healing stream: the fault processor hangs the 5th step past
    its deadline and runs the 9th out of memory. Counts zeroed after the
    build (the golden reference's forward) and read once the stream and the
    abandoned step have ended."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]._inner
    runner, mon = proc.runner, proc.integrity
    sink = stream.output = OrderedSink(stream.output)
    count = cfg_raw["streams"][0]["input"]["inner"]["count"]
    grid_top = runner.bucket_cap
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    wait_zombies(runner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k1_variants = ra.launches.value, dict(ra.launches.variants)
    expected = generated_rows({"streams": [{"input": cfg_raw["streams"][0]["input"]["inner"]}]})
    report = {"rows_expected": count, "rows_out": stream.rows_out,
              "rows_dropped": sink.inner.dropped_rows, "in_order": sink.payloads == expected,
              "nacked": stream.errors, "redeliveries": stream.input.redeliveries,
              "seconds": wall, "device_steps": runner.device_steps, "layers": runner.cfg.layers,
              "k1_launches": k1, "k1_variants": k1_variants, "k2_launches": sa.launches.value,
              "bucket_cap_before": grid_top, **runner.health_report(),
              "integrity": {k: v for k, v in mon.report().items() if k != "members"}}
    print("lifecycle stream " + json.dumps(report), flush=True)
    check(stream.rows_out == count and sink.inner.dropped_rows == count and report["in_order"],
          f"the self-healing stream lost or reordered rows: {report}")
    check(stream.errors == 1 and stream.input.redeliveries == 1,
          f"not exactly one nacked and redelivered batch: {report}")
    check(report["deadline_misses"] == 1 and report["rebuilds"] == 1 and report["ooms"] == 1,
          f"not exactly one miss, one rebuild and one OOM: {report}")
    check(runner.bucket_cap < grid_top, f"the OOM did not cap the grid: {report}")
    check(report["state"] == "healthy", f"the runner did not end HEALTHY: {report}")
    # every probe that ended passed (a tick in flight at close is cancelled)
    results = mon.results
    check(results["ok"] >= 1
          and results["mismatch"] == results["error"] == results["digest_mismatch"] == 0,
          f"integrity probes missing or failing: {report}")
    check(k1 > 0 and k1 == runner.cfg.layers * runner.device_steps and report["k2_launches"] == 0,
          f"K1 launches != layers x device steps: {report}")
    check(k1_variants["mma"] == k1, f"a K1 launch missed the mma tile: {report}")
    return {"report": report, "proc": proc, "wall": wall}


def eager_processor(proc, ckpt: str, serving_dtype: str):
    """An ``eager=True`` processor like ``proc`` on the checkpoint's weights."""
    r = proc.runner
    eager = ModelRunner("bert_classifier", {}, buckets=r.buckets, device="cuda",
                        serving_dtype=serving_dtype, packed=r.packed, eager=True,
                        checkpoint=ckpt)
    return GpuInferenceProcessor(eager, text_field=proc.text_field, tokenizer=proc.tokenizer,
                                 max_seq=proc.max_seq, outputs=proc.outputs)


def swap_check(label: str, ckpt_dir: str, crash: bool, **overrides) -> dict:
    """A hot swap through the health server while a stream runs: POST a
    seed-1 checkpoint (200, version 1), then a fixed 256-row batch equals
    an eager runner on the seed-1 weights with 0 differing elements, the
    live tensors kept their addresses and no graph was captured again;
    with ``swap_corrupt`` (and ``crash``: ``swap_crash``) armed the answer
    is 409 and the outputs stay bit for bit. The canary's ``min_agreement``
    is 0: seed-1 weights are a behaviour-changing update."""
    serving_dtype = overrides.get("serving_dtype", "bfloat16")
    cfg_raw = lifecycle_config(ckpt_dir, faults=False, count=10 ** 7, interval="20ms",
                               swap={"canary": {"rows": 4, "min_agreement": 0.0}}, **overrides)
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]._inner
    runner, swapper = proc.runner, proc.swapper
    keys = len(runner.grid_shapes(runner.buckets))
    batch = fixed_batch(cfg_raw, 256)
    seed1 = os.path.join(ckpt_dir, "seed1")
    report: dict = {"path": label, "keys": keys}

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            end = time.monotonic() + 300
            while runner.captures < keys or not engine._ready or engine.health_port is None:
                check(time.monotonic() < end and not task.done(), f"{label}: warmup never ended")
                await asyncio.sleep(0.05)
            port = engine.health_port
            before = outputs_of((await proc.process(batch))[0])
            ptrs, captures = param_ptrs(runner.params), runner.captures
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            status, body = await http(port, "POST", "/admin/swap", {"checkpoint": seed1})
            report["swap_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            report["params_bytes"] = sum(t.numel() * t.element_size()
                                         for t in flatten(runner.params).values())
            report["status"], report["stage_ms"] = status, swapper.stage_ms
            rep = body.get("results", {}).get(stream.name, [{}])[0]
            check(status == 200 and rep.get("version") == 1, f"{label}: swap answered {body}")
            after = outputs_of((await proc.process(batch))[0])
            want = outputs_of((await eager_processor(proc, seed1, serving_dtype).process(batch))[0])
            report["differing_vs_eager_seed1"] = differing_elements(after, want)
            report["differing_vs_before"] = differing_elements(after, before)
            report["ptrs_kept"] = param_ptrs(runner.params) == ptrs
            report["captures_kept"] = runner.captures == captures
            # a corrupt tree is the canary's to reject: exact agreement
            swapper.cfg = dataclasses.replace(swapper.cfg, min_agreement=1.0)
            for kind in ("swap_corrupt",) + (("swap_crash",) if crash else ()):
                swapper.inject_swap_fault(kind)
                status, body = await http(port, "POST", "/admin/swap", {"checkpoint": seed1})
                again = outputs_of((await proc.process(batch))[0])
                report[kind] = {"status": status, "differing": differing_elements(again, after),
                                "ptrs_kept": param_ptrs(runner.params) == ptrs,
                                "error": swapper.report().get("last_error")}
            status, body = await http(port, "GET", "/health")
            report["health"] = {"status": status,
                                "runners": body["stream_health"][stream.name]["runners"]}
        finally:
            engine.shutdown()
            await asyncio.wait_for(task, 120)

    asyncio.run(go())
    print(f"lifecycle swap {label} " + json.dumps(report), flush=True)
    check(report["differing_vs_eager_seed1"] == 0,
          f"{label}: the swapped outputs differ from an eager runner on the new weights: {report}")
    check(report["differing_vs_before"] > 0, f"{label}: the swap changed no output: {report}")
    check(report["ptrs_kept"] and report["captures_kept"],
          f"{label}: the swap moved a live tensor or captured again: {report}")
    for kind in ("swap_corrupt",) + (("swap_crash",) if crash else ()):
        check(report[kind]["status"] == 409 and report[kind]["differing"] == 0
              and report[kind]["ptrs_kept"], f"{label}: {kind} did not roll back: {report}")
    check(report["health"]["status"] == 200, f"{label}: /health failed: {report}")
    return report


def integrity_check(proc, batch: MessageBatch) -> dict:
    """On the self-healing stream's runner: a bitflip, then an sdc fault,
    each caught by the monitor (digest drift, a failing golden probe
    through the graphed step), quarantined and repaired, the outputs back
    bit for bit; the digest pass and golden probe times."""
    runner, mon = proc.runner, proc.integrity
    mon.cfg = dataclasses.replace(mon.cfg, digest_every=1)
    member = mon.members[0]
    report: dict = {}

    async def go():
        before = outputs_of((await proc.process(batch))[0])
        await mon.probe_now()
        epoch, ptrs = mon.digest_epoch(), param_ptrs(runner.params)
        report["golden_probe_ms"] = statistics.median([await timed(member.golden_probe)
                                                       for _ in range(5)])
        for kind in ("bitflip", "sdc"):
            runner.inject_step_fault(kind)
            summary = await mon.probe_now()
            after = outputs_of((await proc.process(batch))[0])
            report[kind] = {**summary, "state": runner.health.state,
                            "epoch_kept": mon.digest_epoch() == epoch,
                            "ptrs_kept": param_ptrs(runner.params) == ptrs,
                            "differing": differing_elements(after, before)}
        report["results"] = dict(mon.results)

    async def timed(fn):
        t0 = time.perf_counter()
        ok = await fn()
        check(ok, "a golden probe failed on a healthy runner")
        return (time.perf_counter() - t0) * 1e3

    asyncio.run(go())
    runner.digest_params()
    digest_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner.digest_params()
        digest_times.append((time.perf_counter() - t0) * 1e3)
    report["digest_pass_ms"] = statistics.median(digest_times)
    print("lifecycle integrity " + json.dumps(report), flush=True)
    for kind in ("bitflip", "sdc"):
        r = report[kind]
        check(r["mismatches"] == 1 and r["repaired"] == 1 and r["state"] == "healthy"
              and r["differing"] == 0 and r["ptrs_kept"] and r["epoch_kept"],
              f"{kind} was not caught, quarantined and repaired: {report}")
    check(report["results"]["digest_mismatch"] >= 1, f"no digest drift was seen: {report}")
    return report


def oom_child() -> int:
    """Child process: a real allocator OOM. The top bucket's capture peak is
    measured on one runner; a second runner on the same weights is capped
    (``set_per_process_memory_fraction``) halfway between the reserved
    memory after its small bucket's capture and that peak, then handed a
    top-bucket batch: the capture that fails leaves no entry, the grid is
    capped, and the batch is split and delivered."""
    family = get_model("bert_classifier")
    host = init_host_params(family, family.make_config(), 0)
    buckets = BucketPolicy((16, 64), (256,))
    rng = np.random.default_rng(5)

    def inputs(rows):
        return {"input_ids": rng.integers(4, 30522, (rows, 256)).astype(np.int32),
                "attention_mask": np.ones((rows, 256), np.int32)}

    small, top = inputs(16), inputs(64)

    def runner():
        return ModelRunner("bert_classifier", {}, buckets=buckets, device="cuda",
                           serving_dtype="bfloat16", host_params=host)

    a = runner()
    a.infer_sync(small)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_top = torch.cuda.memory_reserved()
    a.infer_sync(top)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_reserved() - before_top
    want = a.infer_sync(top)
    del a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    b = runner()
    b.infer_sync(small)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    cap = held + growth // 2
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total)
    top_key = shape_key({n: (64, 256) for n in b.spec})
    got = b.infer_sync(top)
    top2 = np.sort(want["logits"], axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > LABEL_MARGIN
    report = {"top_capture_growth_bytes": growth, "held_reserved": held, "cap_bytes": cap,
              "ooms": b.ooms, "bucket_cap": b.bucket_cap,
              "top_key_captured": top_key in b._compiled, "rows": int(got["logits"].shape[0]),
              "max_abs_logit_diff": float(np.abs(got["logits"] - want["logits"]).max()),
              "labels_equal_tie_free": bool(np.array_equal(got["label"][tie_free],
                                                           want["label"][tie_free])),
              "state": b.health.state}
    print("lifecycle oom " + json.dumps(report), flush=True)
    check(b.ooms == 1 and b.bucket_cap == 16 and not report["top_key_captured"]
          and report["rows"] == 64, f"the real OOM did not cap and split: {report}")
    check(report["max_abs_logit_diff"] <= LOGIT_TOL and report["labels_equal_tie_free"],
          f"the split batch's outputs differ from the top bucket's: {report}")
    return 0


def run_oom_child() -> None:
    """The real OOM in a child process, so that an allocator it leaves
    broken cannot spoil later phases; the smoke fails unless it exits 0."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--oom-child"],
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith("lifecycle oom"):
            print(line, flush=True)
    check(proc.returncode == 0, f"the OOM child exited {proc.returncode}: {proc.stderr[-3000:]}")


def traffic_run(cfg_raw: dict, label: str, instrument=None) -> tuple[float, float]:
    """One stream of ``cfg_raw`` on the card: (traffic rows/s, traffic
    seconds); ``instrument(stream)`` runs after the build."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    if instrument is not None:
        instrument(stream)
    asyncio.run(engine.run())
    rows = cfg_raw["streams"][0]["input"].get("inner", cfg_raw["streams"][0]["input"])["count"]
    check(stream.errors == 0 and stream.rows_out == rows,
          f"{label}: {stream.errors} errors, {stream.rows_out} of {rows} rows")
    return stream.rows_out / stream.traffic_seconds, stream.traffic_seconds


def lifecycle_cost(ckpt_dir: str) -> dict:
    """The lifecycle keys' cost on the fault-free stream, reported and not
    gated: the plain padded stream (``bert_stream.json``), the lifecycle
    stream without faults, the plain stream again, ``COST_ROWS`` rows each,
    so that the lifecycle window holds several digest periods. Each digest
    pass (the host copy and hash of the live tree) and golden probe is
    timed where the monitor calls it."""
    with open(CONFIG) as f:
        plain = json.load(f)
    plain["streams"][0]["input"]["count"] = COST_ROWS
    timed: dict[str, list[float]] = {"digest": [], "probe": []}

    def instrument(stream) -> None:
        proc = stream.pipeline.processors[0]._inner
        runner, member = proc.runner, proc.integrity.members[0]

        def wrap(fn, into):
            def timed_fn(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    into.append(time.perf_counter() - t0)
            return timed_fn

        async def probe():
            t0 = time.perf_counter()
            try:
                return await golden()
            finally:
                timed["probe"].append(time.perf_counter() - t0)

        runner.digest_params = wrap(runner.digest_params, timed["digest"])
        golden, member.golden_probe = member.golden_probe, probe

    before, _ = traffic_run(plain, "plain stream")
    life, life_s = traffic_run(lifecycle_config(ckpt_dir, faults=False, count=COST_ROWS),
                               "lifecycle stream without faults", instrument)
    after, _ = traffic_run(plain, "plain stream again")
    report = {"cost_rows": COST_ROWS, "plain_traffic_rows_per_s": before,
              "lifecycle_traffic_rows_per_s": life, "plain_again_traffic_rows_per_s": after,
              "lifecycle_traffic_seconds": life_s, "digest_passes": len(timed["digest"]),
              "digest_share": sum(timed["digest"]) / life_s,
              "golden_probes": len(timed["probe"]),
              "golden_probe_share": sum(timed["probe"]) / life_s}
    print("lifecycle cost " + json.dumps(report), flush=True)
    check(report["digest_passes"] >= 3 and report["golden_probes"] >= 5,
          f"the lifecycle window held too few digest passes or probes: {report}")
    return report


def run_lifecycle() -> dict:
    """The lifecycle phase on BERT-base (see the module docstring)."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        timings = save_checkpoints(ckpt_dir)
        healed = run_selfheal(lifecycle_config(ckpt_dir))
        proc = healed["proc"]
        integrity = integrity_check(proc, fixed_batch(lifecycle_config(ckpt_dir), 256))
        swaps = {"padded": swap_check("padded", ckpt_dir, crash=True)}
        swaps["packed"] = swap_check(
            "packed", ckpt_dir, crash=False, packing=True, max_seq=256,
            batch_buckets=[8, 16, 32, 64], seq_buckets=[256])
        swaps["int8"] = swap_check(
            "int8", ckpt_dir, crash=False, serving_dtype="int8", max_seq=64,
            batch_buckets=[32, 256], seq_buckets=[64])
        run_oom_child()
        cost = lifecycle_cost(ckpt_dir)
        padded = swaps["padded"]
        line = {
            **timings, "swap_stage_ms": padded["stage_ms"],
            "swap_peak_bytes": padded["swap_peak_bytes"], "params_bytes": padded["params_bytes"],
            "digest_pass_ms": integrity["digest_pass_ms"],
            "golden_probe_ms": integrity["golden_probe_ms"],
            "rebuild_recapture_ms": healed["report"]["last_rebuild_ms"],
            "captures_after_rebuild": healed["report"]["captures"],
            **cost, "selfheal_seconds": healed["wall"],
        }
        print("lifecycle " + json.dumps(line), flush=True)
        return line


# -- the generate lifecycle phase ---------------------------------------------


def gen_lifecycle_config(*, faults: bool = True, idle: bool = False, **overrides) -> dict:
    """``llama_lifecycle_stream.json`` with the health server on a free port:
    without its fault schedule when not ``faults``; with ``idle`` the input
    waits an hour before its first batch (the stream carries no traffic of
    its own, the engine and its health server run); the processor's keys
    overridden."""
    with open(GEN_LIFECYCLE_CONFIG) as f:
        cfg = json.load(f)
    cfg["health_check"]["port"] = 0
    stream = cfg["streams"][0]
    fault = stream["pipeline"]["processors"][0]
    fault["inner"].update(overrides)
    if not faults:
        fault["faults"] = []
    if idle:
        stream["input"]["inner"].update(count=10 ** 7, interval="3600s")
    return cfg


def gen_rows(cfg_raw: dict) -> list[bytes]:
    """The rows of a lifecycle config's generate input, in order."""
    return generated_rows({"streams": [{"input": cfg_raw["streams"][0]["input"]["inner"]}]})


def gen_prompts(cfg_raw: dict, n: int) -> list[list[int]]:
    """The first ``n`` rows of a lifecycle config, tokenized as its
    processor tokenizes them."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]["inner"]
    tok = HashTokenizer(proc["model_config"]["vocab_size"])
    ids, mask = tok.encode_batch(gen_rows(cfg_raw)[:n], proc["max_input"])
    return [ids[i, : int(mask[i].sum())].tolist() for i in range(n)]


class StepsSink(GeneratedSink):
    """A ``GeneratedSink`` that also snapshots the server's device steps and
    its pools' address when it zeroes the counts."""

    def __init__(self, inner: Output, field: str, server: GenerationServer):
        super().__init__(inner, field)
        self.server = server
        self.steps0: dict = {}
        self.pool_ptr0 = 0

    async def connect(self) -> None:
        await super().connect()
        self.steps0 = dict(self.server.device_steps)
        self.pool_ptr0 = self.server.k_pages.data_ptr()


def release_memory() -> None:
    """Collect what a finished phase built (16 GB of weights on the card and
    a 16 GB host copy per server) before the next phase builds its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def gen_reference_run(cfg_raw: dict) -> dict:
    """The fault-free lifecycle stream: every row's generated ids (the
    yardstick of the faulted run) and its traffic tokens/s and TTFT."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]._inner
    server = proc.server
    sink = stream.output = GeneratedSink(stream.output, proc.output_field)
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    rows = gen_rows(cfg_raw)
    check(stream.errors == 0 and stream.rows_out == len(rows) and sink.payloads == rows,
          f"the fault-free lifecycle stream lost rows: {stream.errors} errors, "
          f"{stream.rows_out} of {len(rows)}")
    out = {"tokens": [[int(t) for t in g.split()] for g in sink.generated],
           "traffic_tokens_per_s": server.tokens / stream.traffic_seconds,
           "traffic_seconds": stream.traffic_seconds,
           "ttft_p50_ms": server.ttft_ms(0.5), "ttft_p99_ms": server.ttft_ms(0.99),
           "integrity_probes": proc.integrity.probes}
    return out


def run_gen_lifecycle_stream(cfg_raw: dict, reference: list[list[int]]) -> dict:
    """The faulted lifecycle stream: a step after the fault processor's 2nd
    call hangs 3 s past its 1 s deadline, a step after its 5th runs out of
    memory. Counts zeroed when the output connects (after the captures) and
    read once the stream and the abandoned step have ended. Every row's ids
    are held to the fault-free run's up to the first step whose top-2 gap
    (recorded in this run) is at or below the tie margin."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]._inner
    server, mon = proc.server, proc.integrity
    server.record_margins = True
    gaps: dict[tuple, list[float]] = {}
    generate = server.generate

    async def generate_with_gaps(prompt, max_new_tokens=64):
        ids, g = await generate(prompt, max_new_tokens, with_margins=True)
        gaps[tuple(prompt)] = g
        return ids

    server.generate = generate_with_gaps
    sink = stream.output = StepsSink(stream.output, proc.output_field, server)
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    wait_zombies(server)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k3_variants = ra.paged_flash_attention.launches.value, \
        dict(ra.paged_flash_attention.launches.variants)
    steps = {k: server.device_steps[k] - sink.steps0[k] for k in server.device_steps}
    rows = gen_rows(cfg_raw)
    prompts = gen_prompts(cfg_raw, len(rows))
    streams = compare_to_first_tie(
        row_ids(sink.generated),
        [(b, gaps.get(tuple(prompts[i]), [])) for i, b in enumerate(reference)])
    rep = server.health_report()
    report = {
        "rows_expected": len(rows), "rows_out": stream.rows_out,
        "rows_dropped": sink.inner.dropped_rows, "in_order": sink.payloads == rows,
        "nacked": stream.errors, "redeliveries": stream.input.redeliveries, "seconds": wall,
        "layers": server.cfg.layers, "dim": server.cfg.dim, "vocab": server.cfg.vocab_size,
        "k3_launches": k3, "k3_variants": k3_variants, "device_steps": steps,
        "traffic_steps": {"decode": server.decode_steps, "chunk": server.chunk_steps,
                          "prefill": server.prefill_steps},
        "pool_ptr_before": sink.pool_ptr0, "pool_ptr_after": server.k_pages.data_ptr(),
        "free_pages": len(server._free_pages), "num_pages": server.num_pages,
        **streams,
        "rebuild_recapture_ms": rep["last_rebuild_ms"],
        **{k: rep[k] for k in ("state", "deadline_misses", "rebuilds", "zombies", "ooms",
                               "pool_renewals", "captures", "tokens_per_sec")},
        "integrity": {k: v for k, v in mon.report().items() if k != "members"}}
    print("generate lifecycle stream " + json.dumps(report), flush=True)
    check(stream.rows_out == len(rows) and sink.inner.dropped_rows == len(rows)
          and report["in_order"], f"the generate lifecycle stream lost or reordered rows: {report}")
    check(stream.errors >= 1 and stream.input.redeliveries == stream.errors,
          f"the failed batches were not nacked and redelivered: {report}")
    check(report["deadline_misses"] == 1 and report["rebuilds"] == 1 and report["ooms"] == 1,
          f"not exactly one miss, one rebuild and one failed OOM step: {report}")
    check(report["state"] == "healthy" and report["zombies"] == 0,
          f"the server did not end HEALTHY with no zombie: {report}")
    check(report["free_pages"] == server.num_pages - 1, f"pages leaked: {report}")
    check(report["pool_renewals"] == 1 and report["pool_ptr_after"] != report["pool_ptr_before"],
          f"the rebuild did not serve from new pools: {report}")
    decode_chunk = steps["decode"] + steps["chunk"]
    check(k3 > 0 and k3 == server.cfg.layers * decode_chunk,
          f"K3 launches != layers x (decode + chunk steps): {report}")
    check(k3_variants.get("mma") == k3, f"a K3 launch missed the tensor-core body: {report}")
    check(not streams["rows_mismatched_before_a_tie"],
          f"a row's ids differ from the fault-free run before a near-tie: "
          f"{report}")
    results = mon.results
    check(results["mismatch"] == results["error"] == results["digest_mismatch"] == 0,
          f"an integrity probe failed on a healthy server: {report}")
    return report


async def gen_serve(server: GenerationServer, prompts: list[list[int]],
                    max_new: int) -> list[list[int]]:
    return list(await asyncio.gather(*[server.generate(p, max_new_tokens=max_new)
                                       for p in prompts]))


def save_decoder_checkpoint(path: str, cfg, seed: int) -> float:
    """The seed's decoder tree, drawn on the card as ``gpu_generate`` draws
    it, written as a port checkpoint; ms."""
    t0 = time.perf_counter()
    tree = get_model("decoder_lm").init(torch.Generator(device="cuda").manual_seed(seed), cfg)
    checkpoint.save(path, tree)
    del tree
    torch.cuda.empty_cache()
    return (time.perf_counter() - t0) * 1e3


def run_gen_swap_integrity(cfg_raw: dict, ckpt_dir: str) -> dict:
    """On an idle lifecycle stream (its engine and health server running):
    a hot swap to a seed-1 checkpoint through ``POST /admin/swap`` under
    in-flight requests, then the streams against an ``eager=True`` server on
    the seed-1 weights, bit for bit; a ``swap_corrupt`` swap rolled back;
    then a ``bitflip`` quarantined (``/readiness`` 503), repaired from the
    host copy, the streams back bit for bit. Prints the swap and the
    integrity lines."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    proc = stream.pipeline.processors[0]._inner
    server, swapper, mon = proc.server, proc.swapper, proc.integrity
    member = mon.members[0]
    seed1 = os.path.join(ckpt_dir, "seed1")
    save_ms = save_decoder_checkpoint(seed1, server.cfg, 1)
    prompts = gen_prompts(cfg_raw, GEN_CHECK_PROMPTS)
    swap_rep: dict = {"save_seed1_ms": save_ms, "prompts": len(prompts),
                      "max_new_tokens": GEN_CHECK_NEW}
    integ: dict = {"golden_seed": member.golden.seed, "golden_margin": member.golden.margin,
                   "golden_rows": int(member.golden.inputs["input_ids"].shape[0]),
                   "golden_seq": int(member.golden.inputs["input_ids"].shape[1])}
    flip_state: dict = {}
    swap_params = server.swap_params

    async def watched_swap_params(placed, drain_timeout_s=30.0, **kw):
        old = await swap_params(placed, drain_timeout_s, **kw)
        flip_state.setdefault("pools_zero", not (server.k_pages.any() or server.v_pages.any()))
        flip_state.setdefault("free_pages", len(server._free_pages))
        return old

    server.swap_params = watched_swap_params

    async def go():
        task = asyncio.create_task(engine.run())
        try:
            end = time.monotonic() + 600
            # the monitor starts once the processor's connect captured the graphs
            while not engine._ready or engine.health_port is None or mon._task is None:
                check(time.monotonic() < end and not task.done(), "generate warmup never ended")
                await asyncio.sleep(0.05)
            port = engine.health_port
            seed0 = await gen_serve(server, prompts, GEN_CHECK_NEW)
            ptrs, captures = param_ptrs(server.params), server.captures
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            stop = asyncio.Event()
            served, failed = [0], []

            async def client(i: int) -> None:
                # requests one after another until the swap answered: some
                # are in flight at the flip, some queue while it drains
                while not stop.is_set():
                    try:
                        await server.generate(prompts[i % len(prompts)],
                                              max_new_tokens=GEN_CHECK_NEW)
                        served[0] += 1
                    except Exception as e:  # a dropped request fails the check
                        failed.append(f"{type(e).__name__}: {e}")
                    i += 4

            clients = [asyncio.create_task(client(i)) for i in range(4)]
            await asyncio.sleep(0.5)
            status, body = await http(port, "POST", "/admin/swap", {"checkpoint": seed1})
            stop.set()
            await asyncio.gather(*clients)
            swap_rep["peak_bytes_over_live"] = torch.cuda.max_memory_allocated() - base
            swap_rep["peak_bytes"] = torch.cuda.max_memory_allocated()
            swap_rep["live_bytes"] = base
            swap_rep["params_bytes"] = sum(t.numel() * t.element_size()
                                           for t in flatten(server.params).values())
            swap_rep["status"], swap_rep["stage_ms"] = status, dict(swapper.stage_ms)
            rep = body.get("results", {}).get(stream.name, [{}])[0]
            check(status == 200 and rep.get("version") == 1, f"generate swap answered {body}")
            swap_rep["requests_during_swap"] = served[0]
            swap_rep["requests_dropped"] = failed
            after = await gen_serve(server, prompts, GEN_CHECK_NEW)
            swap_rep["ptrs_kept"] = param_ptrs(server.params) == ptrs
            swap_rep["captures_kept"] = server.captures == captures
            swap_rep.update(flip_state)
            swap_rep["num_pages"] = server.num_pages
            swap_rep["rows_changed_vs_seed0"] = sum(a != b for a, b in zip(after, seed0))
            tree = get_model("decoder_lm").init(
                torch.Generator(device="cuda").manual_seed(1), server.cfg)
            eager = server_twin(server, eager=True, params=tree)
            want = await gen_serve(eager, prompts, GEN_CHECK_NEW)
            await eager.close()
            del eager, tree
            torch.cuda.empty_cache()
            swap_rep["rows_differing_vs_eager_seed1"] = sum(a != b for a, b in zip(after, want))
            # a corrupt tree is the canary's to reject: exact agreement
            swapper.cfg = dataclasses.replace(swapper.cfg, min_agreement=1.0)
            swapper.inject_swap_fault("swap_corrupt")
            status, body = await http(port, "POST", "/admin/swap", {"checkpoint": seed1})
            again = await gen_serve(server, prompts, GEN_CHECK_NEW)
            swap_rep["swap_corrupt"] = {
                "status": status, "rows_differing": sum(a != b for a, b in zip(again, after)),
                "ptrs_kept": param_ptrs(server.params) == ptrs,
                "error": swapper.report().get("last_error")}
            swap_rep["version"] = swapper.version

            # integrity on the seed-1 weights: the baseline, then a bitflip
            # quarantined (no repair), readiness, and the repair
            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            digests = await loop.run_in_executor(None, tree_digests, server.params)
            integ["digest_pass_ms"] = (time.perf_counter() - t0) * 1e3
            # the card's digests (pinned slices) against the manifest save()
            # wrote from host tensors, for the same seed-1 tree
            with open(f"{seed1}.digests.json") as f:
                integ["digests_equal_manifest"] = digests == json.load(f)["digests"]
            probe_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                check(await member.golden_probe(), "a golden probe failed on a healthy server")
                probe_ms.append((time.perf_counter() - t0) * 1e3)
            integ["golden_probe_ms"] = statistics.median(probe_ms)
            mon.cfg = dataclasses.replace(mon.cfg, digest_every=1, repair=False)
            integ["baseline"] = await mon.probe_now()
            epoch = mon.digest_epoch()
            integ["bitflip_leaf"] = server.bitflip_leaf()
            server.inject_step_fault("bitflip")
            t0 = time.perf_counter()
            integ["quarantine"] = await mon.probe_now()
            integ["quarantine_ms"] = (time.perf_counter() - t0) * 1e3
            integ["state_quarantined"] = server.health.state
            status, body = await http(port, "GET", "/readiness")
            integ["readiness_quarantined"] = {"status": status, "body": body}
            mon.cfg = dataclasses.replace(mon.cfg, repair=True)
            t0 = time.perf_counter()
            integ["repair"] = await mon.probe_now()
            integ["repair_ms"] = (time.perf_counter() - t0) * 1e3
            integ["state_repaired"] = server.health.state
            integ["epoch_kept"] = mon.digest_epoch() == epoch
            integ["ptrs_kept"] = param_ptrs(server.params) == ptrs
            repaired = await gen_serve(server, prompts, GEN_CHECK_NEW)
            integ["rows_differing_vs_before_flip"] = sum(a != b for a, b in zip(repaired, after))
            status, _ = await http(port, "GET", "/readiness")
            integ["readiness_repaired"] = status
            integ["results"] = dict(mon.results)
        finally:
            engine.shutdown()
            await asyncio.wait_for(task, 300)

    asyncio.run(go())
    print("generate lifecycle swap " + json.dumps(swap_rep), flush=True)
    check(swap_rep["requests_during_swap"] > 0 and not swap_rep["requests_dropped"],
          f"the swap dropped a request: {swap_rep}")
    check(swap_rep["rows_differing_vs_eager_seed1"] == 0,
          f"the swapped streams differ from an eager server on the seed-1 weights: {swap_rep}")
    check(swap_rep["rows_changed_vs_seed0"] > 0, f"the swap changed no stream: {swap_rep}")
    check(swap_rep["ptrs_kept"] and swap_rep["captures_kept"],
          f"the swap moved a live tensor or captured again: {swap_rep}")
    check(swap_rep.get("pools_zero") and swap_rep.get("free_pages") == server.num_pages - 1,
          f"the swap left KV or pages behind: {swap_rep}")
    sc = swap_rep["swap_corrupt"]
    check(sc["status"] == 409 and sc["rows_differing"] == 0 and sc["ptrs_kept"]
          and swap_rep["version"] == 1, f"swap_corrupt did not roll back: {swap_rep}")
    print("generate lifecycle integrity " + json.dumps(integ), flush=True)
    q, r = integ["quarantine"], integ["repair"]
    check(q["mismatches"] == 1 and q["repaired"] == 0 and integ["state_quarantined"] == "corrupt",
          f"the bitflip was not caught and quarantined: {integ}")
    check(integ["readiness_quarantined"]["status"] == 503 and integ["readiness_repaired"] == 200,
          f"/readiness did not answer 503 while CORRUPT and 200 after: {integ}")
    check(r["repaired"] == 1 and integ["state_repaired"] == "healthy" and integ["epoch_kept"]
          and integ["ptrs_kept"] and integ["rows_differing_vs_before_flip"] == 0,
          f"the repair did not bring the weights and streams back: {integ}")
    check(integ["results"]["digest_mismatch"] >= 1, f"no digest drift was seen: {integ}")
    check(integ["digests_equal_manifest"],
          f"the card's digests of the seed-1 tree differ from its manifest: {integ}")
    return {"swap": swap_rep, "integrity": integ}


def run_gen_lifecycle(plain: dict) -> dict:
    """The generate lifecycle phase (see the module docstring): the
    fault-free lifecycle stream, the faulted one, the swap and integrity
    checks (at full width and ``GEN_SWAP_LAYERS`` layers), and the cost
    line beside ``plain`` (the graphed generate stream's report, same rows,
    this run)."""
    clean = gen_reference_run(gen_lifecycle_config(faults=False))
    release_memory()
    stream_rep = run_gen_lifecycle_stream(gen_lifecycle_config(), clean["tokens"])
    release_memory()
    os.makedirs(CHECKPOINT_ROOT, exist_ok=True)
    idle = gen_lifecycle_config(
        faults=False, idle=True,
        swap={"canary": {"rows": 4, "min_agreement": 0.0}, "drain_timeout": "120s"},
        integrity={"probe_interval": "3600s", "digest_every": 1,
                   "golden": {"rows": 1, "seq": 8}})
    inner = idle["streams"][0]["pipeline"]["processors"][0]["inner"]
    inner["model_config"] = {**inner["model_config"], "layers": GEN_SWAP_LAYERS}
    with tempfile.TemporaryDirectory(dir=CHECKPOINT_ROOT) as ckpt_dir:
        checks = run_gen_swap_integrity(idle, ckpt_dir)
    release_memory()
    cost = {"plain_traffic_tokens_per_s": plain["traffic_tokens_per_s"],
            "plain_ttft_p50_ms": plain["ttft_p50_ms"], "plain_ttft_p99_ms": plain["ttft_p99_ms"],
            "lifecycle_traffic_tokens_per_s": clean["traffic_tokens_per_s"],
            "lifecycle_ttft_p50_ms": clean["ttft_p50_ms"],
            "lifecycle_ttft_p99_ms": clean["ttft_p99_ms"],
            "lifecycle_traffic_seconds": clean["traffic_seconds"],
            "lifecycle_integrity_probes": clean["integrity_probes"],
            "rows": len(clean["tokens"])}
    print("generate lifecycle cost " + json.dumps(cost), flush=True)
    return {"stream": stream_rep, **checks, "cost": cost}


# -- model import, the tensor families and the tokenizer ----------------------

#: the Llama-3-8B-width tree of ``hf_import``: 8 of 32 layers, because the
#: float32 import of 32 layers (JAX's import makes a float32 tree) is 32 GB of
#: host memory beside a 16 GB bf16 state dict
#: depth of the Llama-3-8B-width import tree (8 until the tuner phase took
#: the time, 4 until the brokers phase did)
HF_LLAMA_LAYERS = 2
HF_PROMPTS = 8
HF_NEW = 32
VIT_IMAGES = 2048
LSTM_WINDOWS = 4096
#: rows of the ViT embeddings held to the CPU plain path
VIT_CPU_ROWS = 8
#: the bf16 floor of the ViT embeddings (a layer norm's output, of
#: magnitude up to ~3): the card's rows may lie no further from a float32
#: forward than the CPU plain path's bf16 rows do, plus this
VIT_EMB_TOL = 1.0 / 64
#: the LSTM's float32 floor (atol and rtol)
LSTM_TOL = 1e-5


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same float32 bits."""
    a, b = a.float(), b.float()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def hf_leaf(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """One leaf as a checkpoint holds it: bf16 on the host, a linear weight
    in torch's ``[out, in]``."""
    return (t.T if transpose else t).to(torch.bfloat16).contiguous().cpu()


def bert_to_hf(p: dict) -> dict:
    """A ``bert_classifier`` tree as a ``BertForSequenceClassification``
    state dict (the inverse of ``bert.from_hf_state_dict``, written here
    apart from it)."""
    e = "bert.embeddings"
    out = {f"{e}.word_embeddings.weight": hf_leaf(p["embed"]["word"]["table"]),
           f"{e}.position_embeddings.weight": hf_leaf(p["embed"]["position"]["table"]),
           f"{e}.token_type_embeddings.weight": hf_leaf(p["embed"]["token_type"]["table"]),
           f"{e}.LayerNorm.weight": hf_leaf(p["embed"]["ln"]["scale"]),
           f"{e}.LayerNorm.bias": hf_leaf(p["embed"]["ln"]["bias"]),
           "bert.pooler.dense.weight": hf_leaf(p["pooler"]["w"], True),
           "bert.pooler.dense.bias": hf_leaf(p["pooler"]["b"]),
           "classifier.weight": hf_leaf(p["classifier"]["w"], True),
           "classifier.bias": hf_leaf(p["classifier"]["b"])}
    lin = {"q": "attention.self.query", "k": "attention.self.key",
           "v": "attention.self.value", "attn_out": "attention.output.dense",
           "ffn_in": "intermediate.dense", "ffn_out": "output.dense"}
    lns = {"attn_ln": "attention.output.LayerNorm", "ffn_ln": "output.LayerNorm"}
    lay = p["layers"]
    for i in range(lay["q"]["w"].shape[0]):
        pre = f"bert.encoder.layer.{i}"
        for k, name in lin.items():
            out[f"{pre}.{name}.weight"] = hf_leaf(lay[k]["w"][i], True)
            out[f"{pre}.{name}.bias"] = hf_leaf(lay[k]["b"][i])
        for k, name in lns.items():
            out[f"{pre}.{name}.weight"] = hf_leaf(lay[k]["scale"][i])
            out[f"{pre}.{name}.bias"] = hf_leaf(lay[k]["bias"][i])
    return out


def llama_to_hf(p: dict) -> dict:
    """A dense ``decoder_lm`` tree as a ``LlamaForCausalLM`` state dict."""
    out = {"model.embed_tokens.weight": hf_leaf(p["embed"]["table"]),
           "model.norm.weight": hf_leaf(p["norm_out"]["scale"]),
           "lm_head.weight": hf_leaf(p["lm_head"]["w"], True)}
    lay = p["layers"]
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    for i in range(lay["wq"]["w"].shape[0]):
        pre = f"model.layers.{i}"
        out[f"{pre}.input_layernorm.weight"] = hf_leaf(lay["attn_norm"]["scale"][i])
        out[f"{pre}.post_attention_layernorm.weight"] = hf_leaf(lay["mlp_norm"]["scale"][i])
        for k, name in names.items():
            out[f"{pre}.{name}.weight"] = hf_leaf(lay[k]["w"][i], True)
    return out


def vit_to_hf(p: dict) -> dict:
    """A ``vit_embedder`` tree as a ``ViTForImageClassification`` state dict:
    the dense patch embedding back to the conv projection ``[D, C, P, P]``
    (row ``(i*P + j)*C + c`` of ``w`` is ``conv[:, c, i, j]``)."""
    w = p["patch_embed"]["w"]
    d = w.shape[1]
    c = 3
    pp = int(math.isqrt(w.shape[0] // c))
    conv = w.reshape(pp, pp, c, d).permute(3, 2, 0, 1)
    out = {"vit.embeddings.cls_token": hf_leaf(p["cls"]),
           "vit.embeddings.position_embeddings": hf_leaf(p["pos"]),
           "vit.embeddings.patch_embeddings.projection.weight": hf_leaf(conv),
           "vit.embeddings.patch_embeddings.projection.bias": hf_leaf(p["patch_embed"]["b"]),
           "vit.layernorm.weight": hf_leaf(p["ln_out"]["scale"]),
           "vit.layernorm.bias": hf_leaf(p["ln_out"]["bias"])}
    lin = {"q": "attention.attention.query", "k": "attention.attention.key",
           "v": "attention.attention.value", "attn_out": "attention.output.dense",
           "ffn_in": "intermediate.dense", "ffn_out": "output.dense"}
    lay = p["layers"]
    for i in range(lay["q"]["w"].shape[0]):
        pre = f"vit.encoder.layer.{i}"
        for k, name in lin.items():
            out[f"{pre}.{name}.weight"] = hf_leaf(lay[k]["w"][i], True)
            out[f"{pre}.{name}.bias"] = hf_leaf(lay[k]["b"][i])
        for k, name in (("ln1", "layernorm_before"), ("ln2", "layernorm_after")):
            out[f"{pre}.{name}.weight"] = hf_leaf(lay[k]["scale"][i])
            out[f"{pre}.{name}.bias"] = hf_leaf(lay[k]["bias"][i])
    return out


def trees_bitwise(imported: dict, original: dict) -> dict:
    """Every leaf of the imported float32 tree against the original's leaf
    as float32 (the same bf16 values): paths, shapes and bits."""
    a, b = flatten(imported), flatten(original)
    differing = [k for k in b if k not in a or not bits_equal(a[k].to(b[k].device), b[k])]
    return {"leaves": len(b), "paths_equal": sorted(a) == sorted(b),
            "dtypes": sorted({str(t.dtype) for t in a.values()}), "differing": differing}


def hf_import_bert(runner: ModelRunner, cfg_raw: dict) -> dict:
    """The padded stream's tree (bf16) exported into HF names and layouts,
    imported, checked against the tree, and served: logits of the imported
    tree's runner equal to the stream's runner's, bit for bit, on the same
    texts (K1 in every step)."""
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    fam = get_model("bert_classifier")
    t0 = time.perf_counter()
    state = bert_to_hf(runner.host_params)
    imported = fam.extras["from_hf_state_dict"](state, runner.cfg)
    import_s = time.perf_counter() - t0
    tree = trees_bitwise(imported, runner.host_params)
    twin = ModelRunner("bert_classifier", proc_cfg["model_config"], buckets=runner.buckets,
                       device="cuda", serving_dtype=proc_cfg["serving_dtype"],
                       host_params=imported)
    proc = GpuInferenceProcessor(runner, text_field="__value__",
                                 tokenizer=HashTokenizer(runner.cfg.vocab_size),
                                 max_seq=proc_cfg["max_seq"], outputs=None)
    batch = MessageBatch.new_binary(generated_rows(cfg_raw)[:256])
    inputs = proc._extract(batch)
    reset_counts()
    a, b = runner.infer_sync(inputs), twin.infer_sync(inputs)
    k1 = ra.launches.value
    report = {"state_dict_entries": len(state), "import_s": import_s, **tree,
              "rows": len(batch), "logits_equal": bool(np.array_equal(
                  a["logits"].view(np.int32), b["logits"].view(np.int32))),
              "k1_launches": k1}
    print("hf_import bert " + json.dumps(report), flush=True)
    check(tree["paths_equal"] and not tree["differing"] and tree["dtypes"] == ["torch.float32"],
          f"the imported BERT tree differs from the exported one: {report}")
    check(report["logits_equal"], f"the imported BERT tree served other logits: {report}")
    check(k1 > 0, "the imported BERT tree's runner launched no K1")
    del twin
    torch.cuda.empty_cache()
    return report


def hf_import_llama(gen_raw: dict) -> dict:
    """A Llama-3-8B-width tree at ``HF_LLAMA_LAYERS`` layers (bf16, drawn on
    the card from seed 0) exported into HF names and layouts, imported into
    a float32 tree (JAX's import), checked against the tree, put on the
    card as imported, and served: greedy streams of ``HF_PROMPTS``
    generate-stream prompts x ``HF_NEW`` new tokens from a server on each
    tree, equal bit for bit (K3 in every layer of every step). The import
    refuses an MoE config with JAX's ValueError."""
    proc_cfg = gen_raw["streams"][0]["pipeline"]["processors"][0]
    cfg = get_model("decoder_lm").make_config(**{**proc_cfg["model_config"],
                                                 "layers": HF_LLAMA_LAYERS})
    params = dec.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    t0 = time.perf_counter()
    state = llama_to_hf(params)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported_host = dec.from_hf_state_dict(state, cfg)
    import_s = time.perf_counter() - t0
    state_bytes, imported_bytes = tree_bytes(state), tree_bytes(imported_host)
    del state
    imported = tree_to_device(imported_host, "cuda")
    del imported_host
    gc.collect()
    tree = trees_bitwise(imported, params)
    prompts = generate_prompts(gen_raw, HF_PROMPTS)

    def serve(p) -> list[list[int]]:
        server = GenerationServer(
            p, cfg, slots=proc_cfg["slots"], page_size=proc_cfg["page_size"],
            max_seq=proc_cfg["max_input"] + proc_cfg["max_new_tokens"],
            eos_id=proc_cfg.get("eos_id", 2), prefill_chunk=proc_cfg["prefill_chunk"],
            dispatch_depth=1, record_margins=True)
        return [t for t, _ in serve_prompts(server, prompts, HF_NEW)]

    reset_counts()
    t0 = time.perf_counter()
    want = serve(params)
    got = serve(imported)
    serve_s = time.perf_counter() - t0
    k3 = ra.paged_flash_attention.launches.value
    moe_refused = None
    try:
        dec.from_hf_state_dict({}, dataclasses.replace(cfg, num_experts=8))
    except ValueError as e:
        moe_refused = str(e)
    report = {"layers": cfg.layers, "dim": cfg.dim, "vocab": cfg.vocab_size,
              "state_dict_gb": state_bytes / 1e9, "imported_float32_gb": imported_bytes / 1e9,
              "export_s": export_s, "import_s": import_s, "serve_s": serve_s, **tree,
              "prompts": len(prompts), "max_new_tokens": HF_NEW,
              "tokens": sum(len(t) for t in got), "streams_equal": got == want,
              "k3_launches": k3, "moe_refused": moe_refused}
    print("hf_import llama " + json.dumps(report), flush=True)
    check(tree["paths_equal"] and not tree["differing"] and tree["dtypes"] == ["torch.float32"],
          f"the imported Llama tree differs from the exported one: {report}")
    check(report["streams_equal"] and report["tokens"] > 0,
          f"the imported Llama tree generated other tokens: {report}")
    check(k3 > 0, "the imported Llama tree's servers launched no K3")
    check(moe_refused is not None and "MoE configs unsupported" in moe_refused,
          f"the decoder import did not refuse MoE: {report}")
    del params, imported
    release_memory()
    return report


def tree_to_device(tree: dict, device: str) -> dict:
    """A nested dict of tensors moved to ``device`` leaf by leaf, emptying
    ``tree`` as it goes (the float32 tree is never held twice on the host)."""
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = tree_to_device(v, device) if isinstance(v, dict) else v.to(device)
    return out


def run_tensor_stream(cfg_raw: dict, payloads: list[bytes], label: str, column: str,
                      eager: bool = False) -> dict:
    """A tensor example through ``Engine`` with its generate source's
    payloads set to ``payloads`` (bytes no JSON config holds; each batch
    takes its rows from the first, as the generate source does), its runner
    swapped for the eager twin when ``eager``: every row delivered with a
    finite ``column``, no attention kernel launched (neither family calls
    one), one graph key per batch bucket."""
    engine, stream, runner, memory = build_stream_runner(cfg_raw, eager)
    stream.input.payloads = payloads
    sink = stream.output = ColumnSink(stream.output, (column,))
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count = cfg_raw["streams"][0]["input"]["count"]
    out = np.concatenate(sink.columns[column])
    launches = {"k1": ra.launches.value, "k2": sa.launches.value,
                "k3": ra.paged_flash_attention.launches.value,
                "k4": flash_attention.launches.value}
    report = {"rows_expected": count, "rows_out": stream.rows_out, "errors": stream.errors,
              "seconds": wall, "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "output_shape": list(out.shape),
              "output_finite": bool(np.isfinite(out).all()), "launches": launches,
              "keys": sorted("x".join(map(str, shape)) for k in runner.dispatch_counts()
                             for shape in dict(k).values()),
              **mode_report(runner, memory)}
    print(f"{label} slice " + json.dumps(report), flush=True)
    check(stream.errors == 0 and stream.rows_out == count and sink.rows == count,
          f"the {label} stream lost rows: {report}")
    check(out.shape[0] == count and report["output_finite"],
          f"the {label} stream's {column} column is not finite: {report}")
    check(not any(launches.values()), f"the {label} stream launched a kernel: {report}")
    check(len(runner.dispatch_counts()) <= len(runner.buckets.batch_buckets),
          f"the {label} runner stepped more keys than batch buckets: {report}")
    return {"report": report, "runner": runner, "proc": stream.pipeline.processors[0]}


def through_processor(proc, payloads: list[bytes], rows: int, column: str) -> np.ndarray:
    """``payloads`` through the processor in batches of ``rows``, in turn;
    the ``column`` of every output, in order."""
    async def go():
        outs = []
        for i in range(0, len(payloads), rows):
            out = await proc.process(MessageBatch.new_binary(payloads[i: i + rows]))
            outs.append(np.asarray(out[0].column(column)))
        return np.concatenate(outs)

    return asyncio.run(go())


def bucket_step_times(runner: ModelRunner, name: str, bound) -> dict:
    """Each batch bucket's forward on random inputs: the device's time (a
    CUDA graph of 5 forwards replayed), one eager call's event time, and
    the bound of the same work."""
    out = {}
    trailing = runner.spec[name][1]
    with torch.inference_mode():
        for b in runner.buckets.batch_buckets:
            x = torch.rand(b, *trailing, device="cuda")
            fwd = functools.partial(runner._forward, **{name: x})
            dev = device_ms(fwd, calls=5, replays=3)
            eager = time_ms(fwd, iters=5, warmup=2)
            bound_ms, bound_by = bound(b)
            out[str(b)] = {"device_ms": dev, "eager_ms": eager, "bound_ms": bound_ms,
                           "bound_by": bound_by}
    return out


def tree_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(params).values())


def vit_flops(cfg, b: int) -> float:
    """Flops of one ViT forward over ``b`` images (2 a multiply-add), read
    from ``models/vit.py``'s shapes: the patch product, and in each layer
    the q/k/v/out and FFN products and both attention products."""
    n, d, f = cfg.num_patches, cfg.hidden, cfg.ffn
    s = n + 1
    per_layer = 2 * s * d * d * 4 + 2 * s * d * f * 2 + 2 * 2 * s * s * d
    return b * (2 * n * cfg.patch * cfg.patch * cfg.channels * d + cfg.layers * per_layer)


def lstm_flops(cfg, b: int) -> float:
    """Flops of one LSTM-AE forward over ``b`` windows, from
    ``models/lstm_ae.py``'s shapes: each step's [F+H, 4H] (encoder) or
    [2H, 4H] (decoder) gate product, the latent products and the head."""
    h = cfg.hidden
    steps = cfg.window * (2 * (cfg.features + h) * 4 * h + 2 * (2 * h) * 4 * h
                          + 2 * h * cfg.features)
    return b * (steps + 2 * h * cfg.latent * 2)


def bound_of(flops_fn, cfg, param_bytes: int, in_bytes_per_row: int, out_bytes_per_row: int,
             dtype: torch.dtype):
    """``b -> (bound_ms, bound_by)``: the larger of the bytes the forward
    must move (params as stored, inputs and outputs once) over HBM and its
    flops over the peak for ``dtype``."""
    def bound(b: int):
        by_bytes = (param_bytes + b * (in_bytes_per_row + out_bytes_per_row)) / HBM_BYTES_PER_S
        by_ops = flops_fn(cfg, b) / PEAK_FLOPS[dtype]
        return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"
    return bound


def hf_import_vit(runner: ModelRunner, images: np.ndarray) -> dict:
    """The ViT-B/16 stream's tree (float32), rounded to bf16 as a checkpoint
    holds it, exported into HF names and layouts (the conv projection
    ``[D, C, P, P]``), imported, checked against the rounded tree, and
    served: embeddings of a runner on each tree equal bit for bit."""
    fam = get_model("vit_embedder")
    rounded = tree_map(lambda t: t.to(torch.bfloat16).float(), runner.host_params)
    t0 = time.perf_counter()
    state = vit_to_hf(rounded)
    imported = fam.extras["from_hf_state_dict"](state, runner.cfg)
    import_s = time.perf_counter() - t0
    tree = trees_bitwise(imported, rounded)
    conv = state["vit.embeddings.patch_embeddings.projection.weight"]
    mc = dataclasses.asdict(runner.cfg)
    a_run = ModelRunner("vit_embedder", mc, buckets=runner.buckets, device="cuda",
                        host_params=rounded)
    b_run = ModelRunner("vit_embedder", mc, buckets=runner.buckets, device="cuda",
                        host_params=imported)
    x = images[:32].reshape(32, *runner.spec["images"][1]) / np.float32(255.0)
    a, b = a_run.infer_sync({"images": x}), b_run.infer_sync({"images": x})
    report = {"state_dict_entries": len(state), "conv_shape": list(conv.shape),
              "conv_dtype": str(conv.dtype), "import_s": import_s, **tree,
              "rows": 32, "embeddings_equal": bool(np.array_equal(
                  a["embedding"].view(np.int32), b["embedding"].view(np.int32)))}
    print("hf_import vit " + json.dumps(report), flush=True)
    check(tree["paths_equal"] and not tree["differing"] and tree["dtypes"] == ["torch.float32"],
          f"the imported ViT tree differs from the exported one: {report}")
    check(report["embeddings_equal"], f"the imported ViT tree served other embeddings: {report}")
    del a_run, b_run
    torch.cuda.empty_cache()
    return report


@contextlib.contextmanager
def float32_dense():
    """Every ``common.dense`` call that names no dtype in float32 instead of
    bf16: a model's float32 forward, the yardstick of its bf16 paths."""
    defaults = model_common.dense.__defaults__
    model_common.dense.__defaults__ = (torch.float32,)
    try:
        yield
    finally:
        model_common.dense.__defaults__ = defaults


def run_vit(cfg_raw: dict) -> dict:
    """``vit_stream.json`` at ViT-B/16 (224 x 224 x 3, batch buckets 8/32):
    ``VIT_IMAGES`` images of random bytes from a numpy seed as the generate
    source's payloads, the stream graphed, then eager; each bucket's step
    against its bound; then every image through the processor graphed and
    eager (equal bit for bit), a sample held to the CPU plain path (both
    bf16, rounding differently over 12 layers: the card's rows may lie no
    further from a float32 forward on the card than the CPU's do, plus the
    bf16 floor), and the ``hf_import vit`` check."""
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    fam = get_model("vit_embedder")
    cfg = fam.make_config(**proc_cfg["model_config"])
    size = cfg.image_size * cfg.image_size * cfg.channels
    images = np.random.default_rng(7).integers(0, 256, (VIT_IMAGES, size), dtype=np.uint8)
    payloads = [images[i].tobytes() for i in range(VIT_IMAGES)]
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    graphed = run_tensor_stream(cfg_raw, payloads, "vit", "embedding")
    eager = run_tensor_stream(cfg_raw, payloads, "vit", "embedding", eager=True)
    runner, proc = graphed["runner"], graphed["proc"]
    params_bytes = tree_bytes(runner.params)
    bound = bound_of(vit_flops, cfg, params_bytes, size * 4, cfg.hidden * 4, torch.bfloat16)
    steps = bucket_step_times(runner, "images", bound)
    rows = max(runner.buckets.batch_buckets)
    t0 = time.perf_counter()
    got = through_processor(proc, payloads, rows, "embedding")
    graphed_s = time.perf_counter() - t0
    proc.runner = eager["runner"]
    t0 = time.perf_counter()
    got_eager = through_processor(proc, payloads, rows, "embedding")
    eager_s = time.perf_counter() - t0
    proc.runner = runner
    cpu = tree_map(lambda t: t.cpu(), runner.host_params)
    x = torch.from_numpy(images[:VIT_CPU_ROWS].reshape(
        VIT_CPU_ROWS, *runner.spec["images"][1]) / np.float32(255.0))
    with torch.inference_mode():
        plain = fam.apply(cpu, cfg, images=x)["embedding"].numpy()
        with float32_dense():
            ref = fam.apply(runner.params, cfg, images=x.cuda())["embedding"].cpu().numpy()
    card = got[:VIT_CPU_ROWS]
    err = {"card_vs_cpu": float(np.abs(card - plain).max()),
           "card_vs_float32": float(np.abs(card - ref).max()),
           "cpu_vs_float32": float(np.abs(plain - ref).max())}
    report = {"images": VIT_IMAGES, "image_size": cfg.image_size, "hidden": cfg.hidden,
              "layers": cfg.layers, "params_mb": params_bytes / 1e6,
              "traffic_images_per_s": graphed["report"]["traffic_rows_per_s"],
              "eager_traffic_images_per_s": eager["report"]["traffic_rows_per_s"],
              "processor_images_per_s": {"graphed": VIT_IMAGES / graphed_s,
                                         "eager": VIT_IMAGES / eager_s},
              "step": steps, "flops_per_image": vit_flops(cfg, 1),
              "graphed_equals_eager": bool(np.array_equal(got.view(np.int32),
                                                          got_eager.view(np.int32))),
              "distinct_embeddings": int(len(np.unique(got.round(3), axis=0))),
              "cpu_rows": VIT_CPU_ROWS, "max_abs_err": err, "tol": VIT_EMB_TOL,
              "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
              "reserved_before_bytes": base}
    print("vit " + json.dumps(report), flush=True)
    check(got.shape == (VIT_IMAGES, cfg.hidden) and np.isfinite(got).all(),
          f"the ViT embeddings are not [{VIT_IMAGES}, {cfg.hidden}] and finite: {report}")
    check(report["graphed_equals_eager"], f"graphed ViT embeddings differ from eager: {report}")
    check(err["card_vs_float32"] <= err["cpu_vs_float32"] + VIT_EMB_TOL,
          f"the ViT embeddings lie further from float32 than the CPU plain path's: {report}")
    imported = hf_import_vit(runner, images)
    del graphed, eager, runner
    release_memory()
    # the graphed processor, the images and their embeddings stay for the
    # HTTP -> ViT -> Redis stream
    return {"report": report, "hf_import": imported, "proc": proc, "payloads": payloads,
            "embeddings": got}


def run_lstm(cfg_raw: dict) -> dict:
    """``lstm_stream.json`` at the config's widths (features 8, hidden 64,
    latent 16, window 32; float32, TF32 off): windows from a numpy seed
    as 256-byte payloads, one an outlier, the stream graphed, then eager;
    each bucket's step, graphed (one replay) and eager (launch-bound); then
    every window through the processor graphed and eager (equal bit for
    bit), every score held to a CPU float32 run at 1e-5, and the outlier
    scoring highest."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the float32 LSTM would leave its floor")
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    fam = get_model("lstm_ae")
    cfg = fam.make_config(**proc_cfg["model_config"])
    width = cfg.window * cfg.features
    rng = np.random.default_rng(8)
    windows = rng.integers(96, 160, (LSTM_WINDOWS, width), dtype=np.uint8)
    outlier = 1234
    windows[outlier] = np.where(np.arange(width) % 2 == 0, 255, 0)  # a saw-tooth at the rails
    payloads = [windows[i].tobytes() for i in range(LSTM_WINDOWS)]
    graphed = run_tensor_stream(cfg_raw, payloads, "lstm", "score")
    eager = run_tensor_stream(cfg_raw, payloads, "lstm", "score", eager=True)
    runner, proc = graphed["runner"], graphed["proc"]
    params_bytes = tree_bytes(runner.params)
    bound = bound_of(lstm_flops, cfg, params_bytes, width * 4, 4, torch.float32)
    steps = bucket_step_times(runner, "values", bound)
    rows = max(runner.buckets.batch_buckets)
    got = through_processor(proc, payloads, rows, "score")
    proc.runner = eager["runner"]
    got_eager = through_processor(proc, payloads, rows, "score")
    proc.runner = runner
    values = windows.reshape(LSTM_WINDOWS, cfg.window, cfg.features) / np.float32(255.0)
    with torch.inference_mode():
        want = fam.apply(tree_map(lambda t: t.cpu(), runner.host_params), cfg,
                         values=torch.from_numpy(values))["score"].numpy()
    err = np.abs(got - want)
    report = {"windows": LSTM_WINDOWS, **dataclasses.asdict(cfg),
              "traffic_windows_per_s": graphed["report"]["traffic_rows_per_s"],
              "eager_traffic_windows_per_s": eager["report"]["traffic_rows_per_s"],
              "step": steps, "flops_per_window": lstm_flops(cfg, 1),
              "graphed_equals_eager": bool(np.array_equal(got.view(np.int32),
                                                          got_eager.view(np.int32))),
              "cpu_max_abs_err": float(err.max()),
              "cpu_within_tol": bool(np.all(err <= LSTM_TOL + LSTM_TOL * np.abs(want))),
              "outlier": outlier, "argmax": int(np.argmax(got)),
              "outlier_score": float(got[outlier]), "median_score": float(np.median(got)),
              "tf32": torch.backends.cuda.matmul.allow_tf32}
    print("lstm " + json.dumps(report), flush=True)
    check(got.shape == (LSTM_WINDOWS,) and np.isfinite(got).all(), f"LSTM scores: {report}")
    check(report["graphed_equals_eager"], f"graphed LSTM scores differ from eager: {report}")
    check(report["cpu_within_tol"], f"LSTM scores are off the CPU float32 run: {report}")
    check(report["argmax"] == outlier, f"the outlier window did not score highest: {report}")
    # the graphed runner, the windows' float32 values and their scores stay
    # for the json phase's LSTM stream
    return {"report": report, "runner": runner, "values": values, "scores": got}


def local_wordpiece(path: str, texts: list[str]) -> str | None:
    """A WordPiece tokenizer over the words of ``texts``, saved into ``path``
    with ``tokenizers`` and ``transformers`` (nothing downloaded); None, with
    the reason printed, where this machine cannot build one."""
    try:
        from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors
        from transformers import PreTrainedTokenizerFast

        words = sorted({w for t in texts for w in re.findall(r"[a-z]+|[^\sa-z]", t.lower())})
        vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words)}
        tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
        tok.normalizer = normalizers.BertNormalizer(lowercase=True)
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
        tok.decoder = decoders.WordPiece()
        PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
                                cls_token="[CLS]", sep_token="[SEP]").save_pretrained(path)
        return path
    except Exception as e:  # noqa: BLE001 - reported, not a failure
        print(f"tokenizer local wordpiece unavailable: {type(e).__name__}: {e}", flush=True)
        return None


def run_tokenizer(cfg_raw: dict, runner: ModelRunner, plain_labels: np.ndarray) -> dict:
    """``build_tokenizer("bert-base-uncased")`` as this machine resolves it
    (local files only: without the files, or without ``transformers``, it
    is the hashing tokenizer), then the padded stream with and without
    ``tokenizer: bert-base-uncased`` on the stream's runner
    (``plain_labels``: the stream's run without it): with the hashing
    fallback the labels are the same. Where ``transformers`` and
    ``tokenizers`` import, the stream runs a third time on a WordPiece
    tokenizer built here from the payloads' words (``HFTokenizer`` on the
    card: every row delivered with a label)."""
    from arkflow_tpu_torch.tpu.tokenizer import build_tokenizer

    tok = build_tokenizer("bert-base-uncased", runner.cfg.vocab_size)
    try:
        import transformers
        have = transformers.__version__
    except ImportError:
        have = None
    tmp = tempfile.TemporaryDirectory()
    texts = [str(p) for p in cfg_raw["streams"][0]["input"]["payloads"]]
    local = local_wordpiece(tmp.name, texts) if have else None
    runs = [("with", {"tokenizer": "bert-base-uncased"})]
    if local:
        runs.append(("local", {"tokenizer": local}))
    labels, k1, classes = {"without": plain_labels}, {}, {}
    for name, extra in runs:
        raw = json.loads(json.dumps(cfg_raw))
        raw["streams"][0]["pipeline"]["processors"][0].update(extra)
        engine = Engine(EngineConfig.from_mapping(raw))
        stream = engine.build()[0]
        proc = stream.pipeline.processors[0]
        proc.runner = runner  # the padded stream's runner, its graphs captured
        sink = stream.output = ColumnSink(stream.output, ("label",))
        reset_counts()
        asyncio.run(engine.run())
        k1[name] = ra.launches.value
        check(stream.errors == 0 and sink.rows == raw["streams"][0]["input"]["count"],
              f"the padded stream {name} tokenizer lost rows")
        labels[name] = np.concatenate(sink.columns["label"])
        classes[name] = type(proc.tokenizer).__name__
    tmp.cleanup()
    report = {"build_tokenizer": type(tok).__name__, "stream_tokenizers": classes,
              "transformers": have, "rows": int(len(labels["with"])),
              "labels_equal": bool(np.array_equal(labels["with"], labels["without"])),
              "k1_launches": k1}
    if "local" in labels:
        report["local_labels_differ"] = int((labels["local"] != labels["without"]).sum())
    print("tokenizer " + json.dumps(report), flush=True)
    if report["build_tokenizer"] == "HashTokenizer":
        check(report["labels_equal"], f"the hashing fallback changed labels: {report}")
    check(classes.get("local", "HFTokenizer") == "HFTokenizer",
          f"the local WordPiece files did not load as HFTokenizer: {report}")
    return report


class Phases:
    """Command time of each phase of ``main``, for the smoke's budget."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds: dict[str, float] = {}
        self.carved = 0.0

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last - self.carved, 1)
        self.last, self.carved = now, 0.0

    def carve(self, name: str, fn, *args):
        """``fn(*args)``, its seconds added to ``name`` and taken out of the
        phase it runs inside (the broker streams run on runners that their
        phases keep warm)."""
        t0 = time.perf_counter()
        out = fn(*args)
        took = time.perf_counter() - t0
        self.seconds[name] = round(self.seconds.get(name, 0.0) + took, 1)
        self.carved += took
        return out

    def report(self) -> dict:
        return {**self.seconds, "total": round(time.perf_counter() - self.start, 1)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--oom-child" in sys.argv[1:]:
        return oom_child()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    phases = Phases()

    built = build_all(list(KERNEL_SOURCES), verbose=True)
    print("build " + json.dumps({k: round(v["seconds"], 3) for k, v in built.items()}), flush=True)
    for name, rep in built.items():
        print(f"ptxas {name} " + json.dumps(ptxas_summary(rep["output"])), flush=True)
    phases.mark("build")

    gen = torch.Generator(device="cuda").manual_seed(0)
    edge_cases(gen)
    # the bf16 cases at S 128 are also the tuner phase's pow2 neighbour
    pow2_cases: dict = {}
    for s in (128, 256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            case = kernel_case(gen, 64, 12, s, 64, dtype, causal=False)
            if s == 128 and dtype == torch.bfloat16:
                pow2_cases[s] = {"K1": case}
    kernel_case(gen, 64, 12, 256, 64, torch.bfloat16, causal=True)
    rng = np.random.default_rng(0)
    for s in (128, 256, 512):
        seg = segment_layouts(rng, 64, s)
        for dtype in (torch.bfloat16, torch.float32):
            case = segment_case(gen, seg, 12, 64, dtype, f"layouts S={s}")
            if s == 128 and dtype == torch.bfloat16:
                pow2_cases[s]["K2"] = case
    # head dim 128: the tensor-core tile in dynamic shared memory
    segment_case(gen, segment_layouts(rng, 32, 256), 8, 128, torch.bfloat16,
                 "layouts S=256, D=128")

    k4_path = run_dense_path(gen)
    k4_cases = [dense_case(gen, shape, causal, dtype) for shape, causal, dtype in K4_CASES]
    # K1 with every length S at K4's BERT shape: the same function
    kernel_case(gen, 64, 12, 256, 64, torch.bfloat16, causal=False,
                lengths=torch.full((64,), 256))
    phases.mark("kernel cases")

    with open(CONFIG) as f:
        cfg_raw = json.load(f)
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    batch = cfg_raw["streams"][0]["input"]["batch_size"]
    result = run_slice(cfg_raw)
    runner = result["runner"]
    # the A/B: each stream graphed (the default), then eager on the same rows
    ab = {"padded": {"graphed": ab_numbers(result["report"]),
                     "eager": ab_numbers(run_slice(cfg_raw, eager=True)["report"])}}
    graphs = {"padded": graph_check_runner("padded", runner, result["report"], seed=11)}
    main_len = slice_lengths(cfg_raw, batch)
    main_seq = runner.buckets.seq_bucket(int(main_len.max()))
    main_case = kernel_case(gen, batch, runner.cfg.heads, main_seq,
                            runner.cfg.hidden // runner.cfg.heads, torch.bfloat16,
                            causal=False, lengths=main_len)
    compare_paths(runner, proc_cfg, rows=256, seed=1)
    hf_bert = hf_import_bert(runner, cfg_raw)
    tokenizer = run_tokenizer(cfg_raw, runner, result["labels"])
    phases.mark("padded")

    with open(PACKED_CONFIG) as f:
        packed_raw = json.load(f)
    packed_proc = packed_raw["streams"][0]["pipeline"]["processors"][0]
    packed = run_packed_slice(packed_raw)
    prunner = packed["runner"]
    ab["packed"] = {"graphed": ab_numbers(packed["report"]),
                    "eager": ab_numbers(run_packed_slice(packed_raw, eager=True)["report"])}
    graphs["packed"] = graph_check_runner("packed", prunner, packed["report"], seed=12)
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
    phases.mark("packed")
    json_phase = run_json(runner, prunner, ab)
    phases.mark("json")
    run_sql()
    phases.mark("sql")
    brokers = {"kafka": phases.carve("brokers", run_kafka_bert, runner, ab)}
    # the obs part runs last on this runner: its profile capture leaves
    # CUPTI installed, which slows every later eager launch of the process
    obs_runner = runner
    brokers["nats"] = phases.carve("brokers", run_nats_bert, prunner, runner, ab)
    brokers["fanin"] = phases.carve("brokers", run_fanin_bert, runner, ab)
    brokers["modbus"] = phases.carve("brokers", run_modbus_influx)
    # the overload phase on the padded runner, before it is released and
    # before obs (whose capture slows later launches)
    overload = phases.carve("overload", run_overload, runner)
    del runner, prunner, result["runner"], packed["runner"]
    torch.cuda.empty_cache()
    with open(DELIVERY_CONFIG) as f:
        delivery = run_delivery(json.load(f))
    torch.cuda.empty_cache()
    phases.mark("delivery")
    with open(ADAPTIVE_CONFIG) as f:
        tuner = run_tuner(gen, json.load(f), pow2_cases)
    torch.cuda.empty_cache()
    phases.mark("tuner")

    with open(INT8_CONFIG) as f:
        int8_raw = json.load(f)
    int8_proc = int8_raw["streams"][0]["pipeline"]["processors"][0]
    bf16_raw = json.loads(json.dumps(int8_raw))
    bf16_raw["streams"][0]["pipeline"]["processors"][0]["serving_dtype"] = "bfloat16"
    int8_run, bf16_run = run_int8_slice(int8_raw), run_int8_slice(bf16_raw)
    ab["int8"] = {"graphed": ab_numbers(int8_run["report"]),
                  "eager": ab_numbers(run_int8_slice(int8_raw, eager=True)["report"])}
    graphs["int8"] = graph_check_runner("int8", int8_run["runner"], int8_run["report"], seed=13)
    print("int8 traffic rows/s " + json.dumps({
        "int8": int8_run["report"]["traffic_rows_per_s"],
        "bfloat16": bf16_run["report"]["traffic_rows_per_s"]}), flush=True)
    compare_int8(int8_run["runner"], bf16_run["runner"], int8_proc, rows=320, seed=3)
    product_times(gen)
    del int8_run["runner"], bf16_run["runner"]
    torch.cuda.empty_cache()
    phases.mark("int8")
    run_lifecycle()
    torch.cuda.empty_cache()
    phases.mark("lifecycle")

    # K3 at the generate stream's shapes: decode over 16 slots with contexts
    # ragged over 1..639, then 128-token chunks
    offs = [int(x) for x in torch.randint(0, 639, (16,), generator=torch.Generator().manual_seed(6))]
    offs[:3] = [0, 638, 15]
    paged_edge_cases(gen)
    k3_main = paged_case(gen, 16, 1, offs, "decode")
    paged_case(gen, 16, 1, offs, "decode, poisoned past the bound", poison=True)
    paged_case(gen, 16, 1, offs, "decode, f32 q", dtype=torch.float32)
    k3_chunks = {o: paged_case(gen, 1, 128, [o], f"chunk at {o}") for o in (0, 128, 256, 384)}
    paged_case(gen, 4, 128, [0, 128, 256, 384], "chunk, 4 rows")
    paged_case(gen, 4, 128, [0, 128, 256, 384], "chunk, 4 rows, poisoned past the bound",
               poison=True)
    k3_verify = k3_verify_cases(gen)
    phases.mark("K3 cases")

    with open(GENERATE_CONFIG) as f:
        gen_raw = json.load(f)
    gen_proc = gen_raw["streams"][0]["pipeline"]["processors"][0]
    generated = run_generate_slice(gen_raw)
    server = generated["server"]
    step_times(server)
    compare_generation_paths(server.params, server.cfg, gen_proc,
                             generate_prompts(gen_raw, gen_proc["slots"]), max_new=64)
    graphs["generate"] = graph_check_server(server)
    graphs["generate"]["stream"] = {k: generated["report"].get(k) for k in (
        "captures", "reserved_before_captures", "reserved_after_captures")}
    del server, generated["server"]
    torch.cuda.empty_cache()
    eager_raw = json.loads(json.dumps(gen_raw))
    eager_raw["streams"][0]["input"]["count"] = GENERATE_EAGER_ROWS
    generated_eager = run_generate_slice(eager_raw, eager=True)
    ab["generate"] = {"graphed": ab_numbers(generated["report"]),
                      "eager": ab_numbers(generated_eager["report"])}
    del generated_eager
    release_memory()
    phases.mark("generate")
    gen_life = run_gen_lifecycle(generated["report"])
    phases.mark("generate lifecycle")

    with open(SERVING_CONFIG) as f:
        serving_raw = json.load(f)
    serving_raw["streams"][0]["input"]["count"] = SERVING_ROWS
    serving = run_serving_features(serving_raw)
    ab["serving"] = {"graphed": ab_numbers(serving["report"]),
                     "eager": ab_numbers(serving["eager"])}
    graphs["serving"] = serving["graphs"]
    sampling = run_sampling(gen_raw)
    with open(BATCH_CONFIG) as f:
        batch_raw = json.load(f)
    batch_raw["streams"][0]["input"]["count"] = BATCH_ROWS
    batch_run = run_batch_generate(batch_raw)
    batch_gen = batch_run["report"]
    brokers["cdc"] = phases.carve(
        "brokers", run_cdc_nats, batch_run["proc"], batch_run["rows"], batch_run["generated"],
        batch_run["ref"], batch_run["limits"],
        batch_gen["rows_out"] / batch_gen["traffic_seconds"])
    del batch_run
    release_memory()
    batch_swap = run_batch_swap(batch_raw, layers=BATCH_SWAP_LAYERS)
    release_memory()
    phases.mark("generation features")
    with open(MOE_CONFIG) as f:
        moe_raw = json.load(f)
    moe_raw["streams"][0]["pipeline"]["processors"][0]["model_config"]["layers"] = MOE_LAYERS
    moe = run_moe(moe_raw)
    ab["moe"] = {"graphed": ab_numbers(moe["report"]), "eager": ab_numbers(moe["eager"])}
    graphs["moe"] = moe["graphs"]
    graphs["moe"]["stream"] = {k: moe["report"].get(k) for k in (
        "captures", "reserved_before_captures", "reserved_after_captures")}
    release_memory()
    phases.mark("moe")
    hf_llama = hf_import_llama(gen_raw)
    phases.mark("hf_import llama")
    with open(VIT_CONFIG) as f:
        vit = run_vit(json.load(f))
    brokers["http"] = phases.carve("brokers", run_http_vit, vit.pop("proc"),
                                   vit.pop("payloads"), vit.pop("embeddings"),
                                   vit["report"]["traffic_images_per_s"])
    release_memory()
    phases.mark("vit")
    with open(LSTM_CONFIG) as f:
        lstm_raw = json.load(f)
    lstm_run = run_lstm(lstm_raw)
    lstm = lstm_run["report"]
    phases.mark("lstm")
    json_phase["lstm"] = run_lstm_json(lstm_raw, lstm_run)
    brokers["mqtt"] = phases.carve("brokers", run_mqtt_lstm, lstm_run)
    brokers["redis"] = phases.carve("brokers", run_redis_lstm, lstm_run)
    del lstm_run
    release_memory()
    phases.mark("json lstm")
    phases.carve("obs", run_obs, obs_runner)
    del obs_runner
    release_memory()
    print("json " + json.dumps({
        "rows_per_s": {**json_phase["rows_per_s"],
                       "lstm_json": json_phase["lstm"]["traffic_windows_per_s"],
                       "lstm_raw": json_phase["lstm"]["raw_traffic_windows_per_s"]},
        "packed": {k: json_phase["packed"][k] for k in (
            "rows", "emissions", "k2_launches", "captures_on_path", "max_score_abs_err",
            "tie_free_rows")},
        "window": {k: json_phase["window"][k] for k in (
            "rows", "emissions", "emission_rows", "k1_launches", "captures_on_path",
            "max_score_abs_err", "tie_free_rows")},
        "lstm": {k: json_phase["lstm"][k] for k in ("windows", "max_abs_err_vs_raw")},
        "protobuf": "not driven: the card's machine has neither protoc nor google.protobuf"}),
        flush=True)
    print("hf_import " + json.dumps({
        "bert": {k: hf_bert[k] for k in ("leaves", "import_s", "logits_equal", "k1_launches")},
        "llama": {k: hf_llama[k] for k in ("layers", "leaves", "state_dict_gb",
                                           "imported_float32_gb", "export_s", "import_s",
                                           "streams_equal", "k3_launches")},
        "vit": {k: vit["hf_import"][k] for k in ("leaves", "import_s", "embeddings_equal")},
        "moe_refused": hf_llama["moe_refused"]}), flush=True)
    print("tensor families " + json.dumps({
        "vit": {k: vit["report"][k] for k in ("traffic_images_per_s",
                                               "eager_traffic_images_per_s", "step",
                                               "peak_reserved_bytes")},
        "lstm": {k: lstm[k] for k in ("traffic_windows_per_s", "eager_traffic_windows_per_s",
                                      "step")}}), flush=True)
    print("generation features " + json.dumps({
        "serving": {k: serving["report"][k] for k in (
            "traffic_tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "verify_steps",
            "decode_steps", "chunk_steps", "prefill_steps", "spec_drafted", "spec_accepted",
            "prefix_hits", "prefix_pages_shared", "prefix_evictions", "k3_launches")},
        "serving_eager_tokens_per_s": serving["eager"]["traffic_tokens_per_s"],
        "sampling_tokens_per_s": sampling["stream"]["traffic_tokens_per_s"],
        "batch_tokens_per_s": batch_gen["traffic_tokens_per_s"],
        "batch_decode_steps_per_generation": batch_gen["decode_steps_per_generation"],
        "batch_swap_ms": batch_swap["stage_ms"]}), flush=True)
    print("brokers " + json.dumps({
        "rows_per_s": {name: {"broker": brokers[name]["rows_per_s"],
                              "raw": brokers[name]["raw_rows_per_s"],
                              "share": brokers[name]["rows_per_s"]
                              / brokers[name]["raw_rows_per_s"]}
                       for name in ("kafka", "mqtt", "http", "cdc", "nats", "redis",
                                    "fanin")},
        "modbus_rows_per_s": brokers["modbus"]["rows_per_s"],
        "kafka_k1_launches": brokers["kafka"]["launches"]["k1"],
        "nats_k2_launches": brokers["nats"]["launches"]["k2"],
        "fanin_k1_launches": brokers["fanin"]["launches"]["k1"],
        "kafka_device_steps": brokers["kafka"]["device_steps"],
        "kafka_host_crc": brokers["kafka"]["host_crc"],
        "seconds": phases.seconds.get("brokers")}), flush=True)
    print("graphs " + json.dumps({path: {k: g[k] for k in ("captures", "keys_checked",
                                                         "differing_elements",
                                                         "reserved_before_captures",
                                                         "reserved_after_captures")}
                                  for path, g in graphs.items()}), flush=True)
    print("ab " + json.dumps(ab), flush=True)

    kernels = [{
        "name": "ragged_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "arkflow_tpu/ops/ragged_attention.py:95",
        "launches": (result["report"]["k1_launches"] + hf_bert["k1_launches"]
                     + sum(tokenizer["k1_launches"].values())
                     + json_phase["window"]["k1_launches"]
                     + brokers["kafka"]["launches"]["k1"]
                     + brokers["fanin"]["launches"]["k1"] + overload["k1_launches"]),
        "ok": True,
        **kernel_line(main_case), "redesigned": REDESIGN,
        "tuner_buckets": {s: c["K1"] for s, c in tuner["kernels"].items()},
    }, {
        "name": "segment_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/segment_attention.cu",
        "replaces": "arkflow_tpu/ops/segment_attention.py:52",
        "launches": (packed["report"]["k2_launches"] + tuner["k2_launches"]
                     + delivery["cost"]["k2_launches"] + json_phase["packed"]["k2_launches"]
                     + brokers["nats"]["launches"]["k2"]),
        "ok": True,
        **kernel_line(k2_main), "redesigned": REDESIGN,
        "tuner_buckets": {s: c["K2"] for s, c in tuner["kernels"].items()},
    }, {
        "name": "paged_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/paged_attention.cu",
        "replaces": "arkflow_tpu/ops/ragged_attention.py:193",
        "launches": (generated["report"]["k3_launches"] + gen_life["stream"]["k3_launches"]
                     + serving["report"]["k3_launches"]
                     + sampling["stream"]["k3_launches"] + moe["report"]["k3_launches"]
                     + hf_llama["k3_launches"] + overload["k3_launches"]),
        "ok": True,
        **kernel_line(k3_main), "redesigned": PAGED_REDESIGN,
        "chunks": {o: {k: k3_chunks[o][k] for k in ("kernel_device_ms", "library_device_ms",
                                                     "bound_ms", "tile_err_ratio")}
                   for o in (256, 384)},
        "verify": {name: {k: c[k] for k in ("kernel_device_ms", "library_device_ms",
                                            "plain_device_ms", "bound_ms", "max_abs_err",
                                            "tile_err_ratio")}
                   for name, c in k3_verify.items()},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "arkflow_tpu/ops/flash_attention.py:70",
        "launches": k4_path["k4_launches"], "ok": True,
        **kernel_line(k4_cases[0]), "redesigned": REDESIGN,
    }]
    print("phases " + json.dumps(phases.report()), flush=True)
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
