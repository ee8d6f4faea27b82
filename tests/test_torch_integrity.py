"""The port's integrity plane, the batch-runner side (``tpu/integrity.py``)
on the CPU: ``parse_integrity_config`` against the JAX package's and the
engine's validation of the block; the golden reference picking the JAX
package's seed and signature on the same params; and the monitor over a
``gpu_inference`` runner, as ``tests/test_integrity.py`` drives it: a
bitflip caught by the digests, proven by the golden probe, quarantined,
repaired and re-admitted on the same digest epoch; an ``sdc`` fault
quarantined and repaired; ``repair: false`` leaving the runner CORRUPT; a
swap to new weights never quarantined."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from arkflow_tpu.errors import ConfigError as JaxConfigError
from arkflow_tpu.models import get_model as jax_get_model
from arkflow_tpu.tpu import integrity as jax_integrity
from arkflow_tpu_torch.components import Resource, ensure_plugins_loaded
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.convert import params_from_jax
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.runtime import cli
from arkflow_tpu_torch.tpu import checkpoint
from arkflow_tpu_torch.tpu.bucketing import bucket_cap_bus
from arkflow_tpu_torch.tpu.integrity import (MARGIN_FLOOR, find_golden_reference, flatten,
                                             parse_integrity_config)
from arkflow_tpu_torch.tpu.runner import init_host_params
from tests.test_tpu_layer import TINY_BERT

ensure_plugins_loaded()


@pytest.fixture(autouse=True)
def _reset_cap_bus():
    yield
    bucket_cap_bus().reset()


def _proc(**extra):
    """A gpu_inference processor with the monitor attached; the tests drive
    its ticks (999 s background interval)."""
    cfg = {"type": "gpu_inference", "model": "bert_classifier", "model_config": TINY_BERT,
           "device": "cpu", "max_seq": 16, "batch_buckets": [2], "seq_buckets": [16],
           "warmup": True, "integrity": {"probe_interval": "999s", "digest_every": 1}}
    cfg.update(extra)
    proc = build_component("processor", cfg, Resource())
    proc.runner.warmup()
    proc._warmed = True
    return proc


# -- config --------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    None, {}, {"probe_interval": "2s", "digest_every": 0, "repair": False},
    {"golden": {"rows": 4, "seq": 8, "seed": 42}}, [1], {"bogus": 1},
    {"probe_interval": "0s"}, {"digest_every": -1}, {"digest_every": True},
    {"golden": [1]}, {"golden": {"rows": 0}}, {"golden": {"seq": "8"}},
    {"golden": {"color": 1}}, {"repair": "yes"},
])
def test_parse_integrity_config_matches_jax(cfg):
    try:
        want = jax_integrity.parse_integrity_config(cfg, who="gpu_inference")
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            parse_integrity_config(cfg, who="gpu_inference")
        assert str(got.value) == str(e)
        return
    got = parse_integrity_config(cfg, who="gpu_inference")
    assert (got is None) == (want is None)
    if got is not None:
        assert vars(got) == vars(want)


@pytest.mark.parametrize("block,ok", [
    ({"probe_interval": "1s", "digest_every": 2}, True),
    ({"probe_interval": "-1s"}, False), ({"golden": {"rows": 0}}, False),
])
@pytest.mark.parametrize("wrapped", [False, True])
def test_engine_validates_the_integrity_block(tmp_path, block, ok, wrapped):
    proc = {"type": "gpu_inference", "model": "bert_classifier", "device": "cpu",
            "integrity": block}
    if wrapped:
        proc = {"type": "fault", "faults": [{"kind": "sdc", "at": 3}], "inner": proc}
    cfg = {"streams": [{"input": {"type": "generate", "payload": "x", "count": 1},
                        "pipeline": {"processors": [proc]}, "output": {"type": "drop"}}]}
    problems = EngineConfig.from_mapping(cfg).validate_components()
    assert (problems == []) is ok, problems
    path = tmp_path / "c.json"
    path.write_text(__import__("json").dumps(cfg))
    assert cli.main(["--config", str(path), "--validate"]) == (0 if ok else 2)


# -- the golden reference against the JAX package's ----------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0x90D, 7])
def test_golden_reference_matches_jax(packed, seed):
    jfam = jax_get_model("bert_classifier")
    jcfg = jfam.make_config(**TINY_BERT)
    host = jax.device_get(jfam.init(jax.random.PRNGKey(11), jcfg))
    want = jax_integrity.find_golden_reference(jfam, jcfg, host, rows=2, seq=16, seed=seed,
                                               serving_dtype=None, packed=packed)
    fam = get_model("bert_classifier")
    cfg = fam.make_config(**TINY_BERT)
    got = find_golden_reference(fam, cfg, params_from_jax(host), rows=2, seq=16, seed=seed,
                                serving_dtype=None, packed=packed)
    assert got.seed == want.seed and got.margin >= MARGIN_FLOOR[None]
    np.testing.assert_array_equal(got.signature, want.signature)
    assert got.inputs.keys() == want.inputs.keys()
    for k in got.inputs:
        np.testing.assert_array_equal(got.inputs[k], want.inputs[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_golden_margin_clears_the_dtype_floor_and_is_restart_stable(dtype):
    fam = get_model("bert_classifier")
    cfg = fam.make_config(**TINY_BERT)
    from arkflow_tpu_torch.tpu.runner import convert_for_serving

    host = convert_for_serving(init_host_params(fam, cfg, 0), dtype)
    a, b = (find_golden_reference(fam, cfg, host, rows=2, seq=16, seed=0x90D,
                                  serving_dtype=dtype) for _ in range(2))
    assert a.margin >= MARGIN_FLOOR[dtype] and a.signature.shape == (2,)
    assert a.seed == b.seed
    np.testing.assert_array_equal(a.signature, b.signature)


# -- the monitor -------------------------------------------------------------------


def test_monitor_detects_bitflip_quarantines_and_repairs():
    proc = _proc()
    mon, runner = proc.integrity, proc.runner
    ptrs = [t.data_ptr() for t in flatten(runner.params).values()]

    async def go():
        rep = await mon.probe_now()
        assert rep["checked"] == 1 and rep["ok"] == 1, rep
        epoch0 = mon.digest_epoch()
        assert epoch0 is not None
        fired = []
        mon.add_quarantine_hook(lambda: fired.append(1))
        runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 1, rep
        assert fired == [1] and mon.quarantines == 1 and mon.repairs == 1
        assert mon.results["digest_mismatch"] == 1 and mon.results["mismatch"] == 1
        assert mon.digest_epoch() == epoch0  # repaired to the same retained tree
        assert runner.health.state == "healthy"
        rep = await mon.probe_now()
        assert rep["ok"] == 1 and rep["mismatches"] == 0, rep

    asyncio.run(asyncio.wait_for(go(), 60))
    assert [t.data_ptr() for t in flatten(runner.params).values()] == ptrs


def test_monitor_quarantines_and_repairs_sdc():
    proc = _proc(integrity={"probe_interval": "999s", "digest_every": 0})
    mon, runner = proc.integrity, proc.runner

    async def go():
        await mon.probe_now()
        runner.inject_step_fault("sdc")
        assert runner.health_report()["sdc_armed"]
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 1, rep
        assert not runner.core.sdc_armed and runner.health.state == "healthy"

    asyncio.run(asyncio.wait_for(go(), 60))


def test_monitor_repair_false_leaves_runner_quarantined():
    proc = _proc(integrity={"probe_interval": "999s", "digest_every": 1, "repair": False})
    mon, runner = proc.integrity, proc.runner

    async def go():
        await mon.probe_now()
        runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 0, rep
        assert runner.health.state == "corrupt"
        rep = await mon.probe_now()
        assert rep["repaired"] == 0 and runner.health.state == "corrupt"
        assert mon.report()["members"][0]["state"] == "corrupt"
        with pytest.raises(Exception, match="CORRUPT"):
            await runner.infer({k: v.copy() for k, v in mon.members[0].golden.inputs.items()})

    asyncio.run(asyncio.wait_for(go(), 60))


def test_monitor_report_carries_state_and_probe_age():
    proc = _proc()
    mon = proc.integrity

    async def go():
        await mon.probe_now()
        rep = mon.report()
        assert rep["probes"] == 1 and rep["mismatches"] == 0 and "digest_epoch" in rep
        m0 = rep["members"][0]
        assert m0["state"] == "healthy" and m0["last_probe"] == "ok"
        assert m0["last_probe_age_s"] >= 0.0

    asyncio.run(asyncio.wait_for(go(), 60))


def test_swap_to_new_weights_never_false_quarantines(tmp_path):
    """A committed swap rebuilds the golden reference and the baselines; a
    later repair converges to the new weights, never back to the old."""
    proc = _proc(swap={"canary": {"min_agreement": 0.0}})
    mon, runner = proc.integrity, proc.runner
    assert proc.swapper.integrity is mon
    fam = get_model("bert_classifier")
    new_host = init_host_params(fam, fam.make_config(**TINY_BERT), 42)
    ck = str(tmp_path / "ck42")
    checkpoint.save(ck, new_host)

    async def go():
        await mon.probe_now()
        old_golden, old_epoch = mon.members[0].golden, mon.digest_epoch()
        rep = await proc.swapper.swap(ck)
        assert rep["version"] == 1 and not mon._suspended
        assert mon.members[0].golden is not old_golden
        rep = await mon.probe_now()
        assert rep["mismatches"] == 0 and rep["ok"] == 1, rep
        assert mon.digest_epoch() not in (None, old_epoch)
        runner.inject_step_fault("bitflip")
        rep = await mon.probe_now()
        assert rep["mismatches"] == 1 and rep["repaired"] == 1, rep
        live = flatten(runner.params)
        for k, v in flatten(new_host).items():
            assert torch.equal(live[k], v), k  # no silent rollback

    asyncio.run(asyncio.wait_for(go(), 60))
