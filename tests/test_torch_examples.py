"""Which of the JAX package's examples the port accepts.

Each ``examples/*.yaml`` goes through the port's CLI, ``python -m
arkflow_tpu_torch -c F -v`` (validation only: nothing is built), with
``tpu_inference``, ``tpu_generate`` and ``tpu_train`` renamed to their
``gpu_*`` names. ``FIRST_REFUSAL`` holds each example's first refusal
(``None``: it validates), so a slice that ports a module moves its examples
to "validates" here, and one that breaks an example shows. A refusal is
compared without its ``(registered: ...)`` list, which grows with the port.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from arkflow_tpu_torch.runtime import cli

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*.yaml"))

_UNPORTED = "is not yet ported to arkflow_tpu_torch"

FIRST_REFUSAL = {
    "adaptive_shapes_example": None,
    "avro_file_example": "stream[0]: unknown input type 'file'",
    "cdc_llm_nats": None,
    "chaos_example": None,
    "cluster_example": "stream[0]: unknown processor type 'remote_tpu'",
    "continuous_generation_example": f"stream[0]: input 'http' key 'address' {_UNPORTED}",
    "disagg_example": "stream[0]: unknown processor type 'remote_tpu'",
    "elastic_fleet_example": "stream[0]: unknown processor type 'remote_tpu'",
    "enrichment_example": f"config error: stream.temporary {_UNPORTED}",
    "generate_example": None,
    "generate_tp_example": f"stream[0]: processor 'gpu_generate' key 'mesh' {_UNPORTED}",
    "hotswap_example": f"stream[0]: processor 'gpu_inference' key 'device_pool' {_UNPORTED}",
    "http_vit_redis": None,
    "int8_bert_example": None,
    "integrity_example": f"stream[0]: processor 'gpu_inference' key 'device_pool' {_UNPORTED}",
    "kafka_bert_kafka": None,
    "llm_serving_example": None,
    "modbus_example": f"stream[0]: output 'influxdb' key 'database' {_UNPORTED}",
    "mqtt_lstm_anomaly": None,
    "mqtt_qos2_example": None,
    "multitenant_example": None,
    "nats_jetstream_example": None,
    "online_training_example": "stream[0]: unknown processor type 'gpu_train'",
    "overload_example": None,
    "packed_inference_example": None,
    "partition_tolerant_example": f"stream[0]: fault processor kind 'net_corrupt' {_UNPORTED}",
    "postgres_sql_example": "stream[0]: unknown input type 'sql'",
    "pp_serving_example": f"stream[0]: processor 'gpu_inference' key 'mesh' {_UNPORTED}",
    "protobuf_example": None,
    "pulsar_example": "stream[0]: unknown input type 'pulsar'",
    "redis_cluster_example": None,
    "remote_scan_example": "stream[0]: unknown input type 'file'",
    "s3_scan_example": "stream[0]: unknown input type 'file'",
    "self_healing_example": f"stream[0]: processor 'gpu_inference' key 'device_pool' {_UNPORTED}",
    "session_window_example": None,
    "sharded_ingest_example": f"config error: pipeline.ingest_shards {_UNPORTED}",
    "tpu_bert_example": None,
    "tracing_example": None,
    "vrl_example": "stream[0]: unknown processor type 'vrl'",
    "websocket_example": None,
    "windowed_join_example": ("stream[0]: session_window.query (the windowed SQL join) "
                              f"{_UNPORTED}"),
}


def test_the_list_names_every_example():
    assert sorted(FIRST_REFUSAL) == [p.stem for p in EXAMPLES]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_validates_or_meets_its_first_refusal(path, tmp_path, capsys):
    src = re.sub(r"\btpu_(inference|generate|train)\b", r"gpu_\1", path.read_text())
    renamed = tmp_path / path.name
    renamed.write_text(src)
    rc = cli.main(["-c", str(renamed), "-v"])
    out = capsys.readouterr()
    first = (out.err.splitlines() or [""])[0]
    first = re.sub(r" \(registered: [^)]*\)", "", first)
    want = FIRST_REFUSAL[path.stem]
    if want is None:
        assert rc == 0 and "config OK" in out.out, first
    else:
        assert rc == 2 and first == want


def test_generate_reads_context_as_jax_does():
    """The reference's ``context`` names the payload where ``payload`` is
    absent; ``payload`` wins over it, as in JAX's builder."""
    import asyncio

    from arkflow_tpu.components import Resource as JaxResource
    from arkflow_tpu.components import build_component as jax_build
    from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
    from arkflow_tpu_torch.components import Resource, build_component, check_component
    from arkflow_tpu_torch.components import ensure_plugins_loaded

    jax_plugins()
    ensure_plugins_loaded()
    for cfg in ({"type": "generate", "context": '{"a": 1}', "count": 2, "batch_size": 2},
                {"type": "generate", "context": "c", "payload": "p", "count": 1}):
        check_component("input", cfg)
        j, p = jax_build("input", cfg, JaxResource()), build_component("input", cfg, Resource())

        async def first(inp):
            await inp.connect()
            batch, _ = await inp.read()
            return batch

        jb, pb = asyncio.run(first(j)), asyncio.run(first(p))
        assert pb.to_binary() == jb.column("__value__").to_pylist()
