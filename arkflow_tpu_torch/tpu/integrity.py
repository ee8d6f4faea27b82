"""Silent-data-corruption defense, the batch-runner side: digests, golden
probes, quarantine and repair.

Counterpart of ``arkflow_tpu/tpu/integrity.py``:

1. **Param digests** (``tree_digests``): one blake2b-128 per leaf over its
   dtype string, numpy's shape string and its bytes, keyed by the JAX
   package's ``keystr`` path. A port tree and the JAX tree it was converted
   from (``convert.params_from_jax``) give identical maps: a bf16 leaf is
   hashed from its raw 2-byte words under ``"bfloat16"`` (numpy has no
   bfloat16, and an upcast would change the bytes), and a column-major int8
   ``w_q`` in row-major order of its logical ``[in, out]`` shape.
2. **Golden probes**: a deterministic golden batch, tie-free by
   construction (``find_golden_reference`` searches seeds until the
   smallest top-1/top-2 logit gap clears the serving dtype's noise floor),
   whose reference signature is computed with the family's forward on the
   serving device (the kernels, on the card), runs through the runner's
   real step (heal gate, deadline, graph) on the probe cadence. A mismatch
   is proof of corruption: the runner is quarantined (``CORRUPT``) and
   repaired by re-adopting the retained host tree through
   ``CompiledStep.copy_params_``, then re-verified.
3. **Quarantine hooks**: whatever caches a corrupt runner's answers
   registers to be flushed.

The continuous generation server is one member (``ServerIntegrityMember``,
built by ``build_generate_integrity_monitor``): its golden probe is the
family's forward of the server's live tree on its device, off the event
loop (the serve loop picks tokens on the device, so its outputs carry no
signature to compare), its digests hash that tree, and its repair
re-places the retained host tree through ``swap_params``, which drains the
slot grid and zeroes the KV pools: KV written by corrupt weights must not
survive the repair.

Not here yet: the cluster dispatcher's shadow verification.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError, RunnerDead
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.tpu.compiled_step import tree_map
from arkflow_tpu_torch.tpu.health import CORRUPT, DEAD
from arkflow_tpu_torch.utils.duration import parse_duration

logger = logging.getLogger("arkflow_torch.integrity")

#: the results a probe counts under (``IntegrityMonitor.results``)
PROBE_RESULTS = ("ok", "mismatch", "digest_mismatch", "error")
#: leaves copied and hashed at once by ``leaf_digests``
_DIGEST_THREADS = 4
#: bytes of a card's leaf copied to the host at a time for its digest
_DIGEST_CHUNK = 64 << 20


# -- param digests ----------------------------------------------------------


def keystr(path: tuple) -> str:
    """The JAX package's ``keystr`` of a path of dict keys, e.g.
    ``['encoder']['layers']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)


def flatten(tree: Mapping, path: tuple = ()) -> dict[str, Any]:
    """A nested dict's leaves keyed by their ``keystr`` path."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, (*path, k)))
        else:
            out[keystr((*path, k))] = v
    return out


def _update_from_device(h, t: torch.Tensor) -> None:
    """Hash a card's leaf in row-major order without a host copy of it
    all: ``_DIGEST_CHUNK``-byte slices go to two pinned buffers in turn on
    a side stream (after the work already queued on the current one, and
    never holding back the serving steps queued behind it), each hashed
    while the next is copied. blake2b over the slices in order equals
    blake2b over the whole."""
    flat = t.contiguous().view(-1).view(torch.uint8)
    n = flat.numel()
    side = torch.cuda.Stream(t.device)
    side.wait_stream(torch.cuda.current_stream(t.device))
    bufs = [torch.empty(min(n, _DIGEST_CHUNK), dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def enqueue(lo: int, slot: int) -> None:
        hi = min(n, lo + _DIGEST_CHUNK)
        with torch.cuda.stream(side):
            bufs[slot][: hi - lo].copy_(flat[lo:hi], non_blocking=True)
            done[slot].record(side)

    enqueue(0, 0)
    for i, lo in enumerate(range(0, n, _DIGEST_CHUNK)):
        slot = i % 2
        if lo + _DIGEST_CHUNK < n:
            enqueue(lo + _DIGEST_CHUNK, 1 - slot)  # that buffer was hashed last turn
        done[slot].synchronize()
        h.update(bufs[slot][: min(n, lo + _DIGEST_CHUNK) - lo].numpy())


def _leaf_digest(leaf) -> str:
    h = hashlib.blake2b(digest_size=16)
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        t = leaf.detach()
        dtype = "bfloat16" if t.dtype == torch.bfloat16 else \
            str(torch.empty(0, dtype=t.dtype).numpy().dtype)
        h.update(dtype.encode())
        h.update(str(tuple(t.shape)).encode())
        if t.numel():
            _update_from_device(h, t)
        return h.hexdigest()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            dtype, data = "bfloat16", t.view(torch.int16).numpy()
        else:
            data = t.numpy()
            dtype = str(data.dtype)
        shape = str(tuple(t.shape))
    else:
        data = np.ascontiguousarray(np.asarray(leaf))
        dtype, shape = str(data.dtype), str(data.shape)
    h.update(dtype.encode())
    h.update(shape.encode())
    h.update(np.ascontiguousarray(data).reshape(-1).view(np.uint8))
    return h.hexdigest()


def leaf_digests(flat: Mapping[str, Any]) -> dict[str, str]:
    """Digests of a flat ``{keystr: leaf}`` map (a checkpoint's). The
    leaves are copied and hashed on a few threads at once (the copies and
    blake2b release the GIL): a Llama-3-8B tree is 16 GB."""
    paths = list(flat)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(_DIGEST_THREADS, max(1, len(paths)))) as ex:
        return dict(zip(paths, ex.map(_leaf_digest, (flat[p] for p in paths))))


def tree_digests(tree: Mapping) -> dict[str, str]:
    """Per-leaf blake2b-128 digests keyed by ``keystr`` path. Blocking: every
    leaf is copied to the host. The digest covers dtype, shape and bytes: a
    corrupt value, a silent re-cast and a re-shape all read as drift."""
    return leaf_digests(flatten(tree))


def combined_digest(digests: Mapping[str, str]) -> str:
    """One order-independent digest over a ``tree_digests`` map."""
    h = hashlib.blake2b(digest_size=16)
    for path in sorted(digests):
        h.update(path.encode())
        h.update(digests[path].encode())
    return h.hexdigest()


def diff_digests(baseline: Mapping[str, str], current: Mapping[str, str]) -> list[str]:
    """Leaf paths whose digests differ (missing and extra leaves included)."""
    return [p for p in sorted(set(baseline) | set(current))
            if baseline.get(p) != current.get(p)]


# -- tie-free golden reference ----------------------------------------------

#: minimum top-1/top-2 logit gap of a golden batch, per serving dtype: below
#: it, benign rounding between the reference and the serving step could flip
#: an argmax and read as corruption
MARGIN_FLOOR = {
    None: 1e-5,
    "float32": 1e-5,
    "bfloat16": 1.0 / 64,
    "float16": 1e-3,
    "int8": 1e-2,
}


@dataclass(frozen=True)
class GoldenReference:
    """A golden batch (in the runner's layout: packed when it packs), its
    reference argmax signature, the seed that made it tie-free and the
    margin it cleared."""

    inputs: dict[str, np.ndarray]
    signature: np.ndarray
    seed: int
    margin: float


def _packed_golden(spec_cfg, rows: int, seq: int, seed: int) -> dict[str, np.ndarray]:
    """Golden batch in the packed layout: equal-length full-seq examples,
    one per row, so the [E] outputs land in input example order."""
    from arkflow_tpu_torch.tpu.packing import pack_tokens

    rng = np.random.default_rng(seed)
    vocab = int(getattr(spec_cfg, "vocab_size", 256) or 256)
    ids = rng.integers(1, max(vocab, 2), size=(rows, seq)).astype(np.int32)
    pk = pack_tokens(ids, np.full(rows, seq, np.int64), seq)
    return {"input_ids": pk.input_ids, "segment_ids": pk.segment_ids,
            "position_ids": pk.position_ids, "example_row": pk.example_row,
            "example_pos": pk.example_pos}


def device_forward(apply_fn, params: dict, cfg, inputs: Mapping[str, np.ndarray],
                   device: torch.device) -> dict[str, np.ndarray]:
    """One eager forward of ``apply_fn`` on ``device`` (``params`` already
    there), its outputs as float32/int numpy arrays."""
    with torch.inference_mode():
        out = apply_fn(params, cfg, **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                                       for k, v in inputs.items()})
        return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in out.items()}


def find_golden_reference(family, cfg, host_params: dict, *, rows: int, seq: int, seed: int,
                          serving_dtype: Optional[str], packed: bool = False,
                          device: Any = "cpu") -> GoldenReference:
    """A tie-free golden batch and its reference signature: seeds ``seed``,
    ``seed + 1``, ... until the batch's ``signature_margin`` clears the
    serving dtype's ``MARGIN_FLOOR``. The forward runs on ``device`` on the
    converted tree, as the runner serves it."""
    from arkflow_tpu_torch.tpu.swap import argmax_signature, golden_inputs, signature_margin

    device = torch.device(device)
    floor = MARGIN_FLOOR.get(serving_dtype, 1e-2)
    apply_fn = family.extras["apply_packed"] if packed else family.apply
    params = tree_map(lambda t: t.to(device), host_params)
    best: Optional[tuple[float, int]] = None
    for k in range(64):
        s = seed + k
        golden = (_packed_golden(cfg, rows, seq, s) if packed
                  else golden_inputs(family.input_spec(cfg), cfg, rows, s, seq=seq))
        out = device_forward(apply_fn, params, cfg, golden, device)
        margin = signature_margin(out)
        if margin >= floor:
            return GoldenReference(inputs=golden, signature=argmax_signature(out),
                                   seed=s, margin=margin)
        if best is None or margin > best[0]:
            best = (margin, s)
    raise ConfigError(
        f"integrity: no tie-free golden batch for {family.name} in 64 seeds "
        f"(best margin {best[0]:.2e} at seed {best[1]}, need >= {floor:.2e} "
        f"for serving_dtype {serving_dtype or 'float32'}); raise golden.rows "
        "or pick another golden.seed")


# -- config -----------------------------------------------------------------


@dataclass(frozen=True)
class IntegrityConfig:
    """The ``integrity:`` block of ``gpu_inference`` (opt-in: no block, no
    monitor)."""

    #: golden-probe cadence
    probe_interval_s: float = 10.0
    #: every Nth probe tick also re-verifies the param digests (0 disables)
    digest_every: int = 3
    #: golden-batch rows
    golden_rows: int = 2
    #: golden-batch sequence length (clamped to the smallest seq bucket)
    golden_seq: int = 16
    #: base seed of the tie-free seed search
    golden_seed: int = 0x90D
    #: repair a quarantined runner (re-adopt the retained host tree,
    #: re-baseline, golden re-verify); False = quarantine only
    repair: bool = True


def parse_integrity_config(cfg: Any, who: str = "processor") -> Optional[IntegrityConfig]:
    """Parse an ``integrity:`` block (at ``--validate`` and at build). None
    in, None out."""
    if cfg is None:
        return None
    if not isinstance(cfg, Mapping):
        raise ConfigError(f"{who}.integrity must be a mapping, got {cfg!r}")
    unknown = set(cfg) - {"probe_interval", "digest_every", "golden", "repair"}
    if unknown:
        raise ConfigError(
            f"{who}.integrity: unknown keys {sorted(unknown)} "
            "(allowed: probe_interval, digest_every, golden, repair)")
    out: dict[str, Any] = {}
    if cfg.get("probe_interval") is not None:
        v = parse_duration(cfg["probe_interval"])
        if v <= 0:
            raise ConfigError(f"{who}.integrity.probe_interval must be positive")
        out["probe_interval_s"] = v
    de = cfg.get("digest_every")
    if de is not None:
        if isinstance(de, bool) or not isinstance(de, int) or de < 0:
            raise ConfigError(f"{who}.integrity.digest_every must be an int >= 0, got {de!r}")
        out["digest_every"] = de
    golden = cfg.get("golden")
    if golden is not None:
        if not isinstance(golden, Mapping):
            raise ConfigError(f"{who}.integrity.golden must be a mapping, got {golden!r}")
        bad = set(golden) - {"rows", "seq", "seed"}
        if bad:
            raise ConfigError(
                f"{who}.integrity.golden: unknown keys {sorted(bad)} (allowed: rows, seq, seed)")
        for key, lo in (("rows", 1), ("seq", 1), ("seed", None)):
            v = golden.get(key)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, int) or (lo is not None and v < lo):
                raise ConfigError(
                    f"{who}.integrity.golden.{key} must be an int"
                    f"{f' >= {lo}' if lo is not None else ''}, got {v!r}")
            out[f"golden_{key}"] = v
    repair = cfg.get("repair")
    if repair is not None:
        if not isinstance(repair, bool):
            raise ConfigError(f"{who}.integrity.repair must be a bool, got {repair!r}")
        out["repair"] = repair
    return IntegrityConfig(**out)


# -- the runner member -------------------------------------------------------


class RunnerIntegrityMember:
    """Integrity surface over one ``ModelRunner``: the golden probe is one
    real step through the runner's own path (heal gate, deadline, graph),
    digests ride ``verify_params_live``, and repair copies the retained host
    tree into the live tensors."""

    def __init__(self, runner, label: str, golden: GoldenReference):
        self.runner = runner
        self.label = label
        self.golden = golden
        self.last_probe_at: Optional[float] = None
        self.last_result = "never"

    @property
    def health(self):
        return self.runner.health

    def state(self) -> str:
        return self.runner.health.state

    async def verify_digests(self) -> list[str]:
        return await self.runner.verify_params_live()

    async def golden_probe(self) -> bool:
        from arkflow_tpu_torch.tpu.swap import argmax_signature

        out = await self.runner.infer({k: v.copy() for k, v in self.golden.inputs.items()},
                                      probe=True)
        return bool(np.array_equal(argmax_signature(out), self.golden.signature))

    def note_probe_failure(self, e: Exception) -> None:
        """A probe step that raised is an incident, not proof of corruption."""
        self.runner.core.note_external_failure(e)

    async def repair(self) -> None:
        """Copy the retained known-good host tree into the live tensors,
        clear an armed ``sdc`` fault (the replaced device), and take the
        digest baseline from the repaired tree."""
        loop = asyncio.get_running_loop()
        r = self.runner
        await loop.run_in_executor(None, lambda: r.adopt_params(r.host_params, retain=False))
        r.core.clear_sdc()
        await loop.run_in_executor(None, r.rebaseline_digests)

    def report(self) -> dict:
        rep = {"label": self.label, "state": self.state(), "last_probe": self.last_result}
        if self.last_probe_at is not None:
            rep["last_probe_age_s"] = round(time.monotonic() - self.last_probe_at, 3)
        return rep

    def baseline_digests(self) -> Optional[dict[str, str]]:
        return self.runner.param_digests

    def reset_baseline(self) -> None:
        self.runner.param_digests = None


class ServerIntegrityMember:
    """Integrity surface over a continuous ``GenerationServer``: the golden
    probe is the family's forward of the server's live tree on its device
    (off the event loop), digests hash that tree, and repair re-places the
    retained host tree through ``swap_params`` (drain, copy in place, KV
    pools zeroed), clears an armed ``sdc`` fault and takes a new digest
    baseline."""

    def __init__(self, server, label: str, golden: GoldenReference, *, family, cfg,
                 place_fn: Callable[[Any], Any], host_source: Callable[[], Any],
                 drain_timeout_s: float = 30.0, owner=None):
        self.server = server
        self.label = label
        self.golden = golden
        self.family = family
        self.cfg = cfg
        self._place_fn = place_fn
        self._host_source = host_source
        self._drain_timeout_s = drain_timeout_s
        self._owner = owner
        self._baseline: Optional[dict[str, str]] = None
        self.last_probe_at: Optional[float] = None
        self.last_result = "never"

    @property
    def health(self):
        return self.server.core.health

    def state(self) -> str:
        return self.server.core.health.state

    async def verify_digests(self) -> list[str]:
        digests = await asyncio.get_running_loop().run_in_executor(
            None, tree_digests, self.server.params)
        if self._baseline is None:
            self._baseline = digests
            return []
        return diff_digests(self._baseline, digests)

    async def golden_probe(self) -> bool:
        from arkflow_tpu_torch.tpu.swap import argmax_signature

        def forward() -> np.ndarray:
            return argmax_signature(device_forward(self.family.apply, self.server.params,
                                                   self.cfg, self.golden.inputs,
                                                   self.server.device))

        sig = await asyncio.get_running_loop().run_in_executor(None, forward)
        return bool(np.array_equal(sig, self.golden.signature))

    def note_probe_failure(self, e: Exception) -> None:
        """A probe that raised is an incident, not proof of corruption."""
        self.server.core.note_external_failure(e)

    async def repair(self) -> None:
        loop = asyncio.get_running_loop()
        host = await loop.run_in_executor(None, self._host_source)
        placed = await loop.run_in_executor(None, self._place_fn, host)
        await self.server.swap_params(placed, self._drain_timeout_s, retain=False)
        del placed
        if self._owner is not None:
            self._owner.params = self.server.params
        self.server.core.clear_sdc()
        self._baseline = await loop.run_in_executor(None, tree_digests, self.server.params)

    def report(self) -> dict:
        rep = {"label": self.label, "state": self.state(), "last_probe": self.last_result}
        if self.last_probe_at is not None:
            rep["last_probe_age_s"] = round(time.monotonic() - self.last_probe_at, 3)
        return rep

    def baseline_digests(self) -> Optional[dict[str, str]]:
        return self._baseline

    def reset_baseline(self) -> None:
        self._baseline = None


# -- the monitor -------------------------------------------------------------


class IntegrityMonitor:
    """Periodic verification, quarantine and repair over a list of members.

    Per tick, for every member: skip DEAD; repair CORRUPT (when enabled);
    otherwise run the golden probe, and on every ``digest_every``-th tick
    verify the digests first. A digest drift names the leaves, marks the
    member UNHEALTHY and leaves the decision to the golden probe; a probe
    mismatch is proof: the member goes CORRUPT, the quarantine hooks fire,
    and the repair re-adopts known-good params, re-baselines and re-verifies
    before ``mark_repaired`` re-admits it."""

    def __init__(self, *, name: str, cfg: IntegrityConfig, members: Sequence[Any]):
        if not members:
            raise ConfigError("IntegrityMonitor needs at least one member")
        self.name = name
        self.cfg = cfg
        self.members = list(members)
        self._task: Optional[asyncio.Task] = None
        self._tick = 0
        self._quarantine_hooks: list[Callable[[], None]] = []
        self._lock = asyncio.Lock()
        #: probing held off during a weights transition (a hot swap)
        self._suspended = False
        #: recomputes the golden reference for a committed swap's host tree
        self._golden_factory: Optional[Callable[[Any], GoldenReference]] = None
        #: members probed, golden mismatches, quarantines, repairs
        self.probes = self.mismatches = self.quarantines = self.repairs = 0
        #: probes by result
        self.results = dict.fromkeys(PROBE_RESULTS, 0)
        # the JAX monitor's metrics, fed beside the counters above
        reg = global_registry()
        labels = {"model": name}
        self.m_probe = {
            r: reg.counter("arkflow_integrity_probe_total",
                           "integrity probes by result (golden signature + digests)",
                           {**labels, "result": r})
            for r in PROBE_RESULTS}
        self.m_quarantine = reg.counter(
            "arkflow_integrity_quarantine_total",
            "members quarantined (CORRUPT) for proven integrity failures", labels)
        self.m_repair = reg.counter(
            "arkflow_integrity_repair_total",
            "quarantined members repaired, re-verified, and re-admitted", labels)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the probe loop (the processor's ``connect``)."""
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    def add_quarantine_hook(self, hook: Callable[[], None]) -> None:
        """Run whenever a member is quarantined: its past answers are no
        longer trusted."""
        self._quarantine_hooks.append(hook)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.probe_interval_s)
            try:
                await self.probe_now()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("[%s] integrity probe tick failed", self.name)

    # -- swap coexistence ----------------------------------------------------

    async def begin_quiesce(self) -> None:
        """Hold off probing for a weights transition: mid-swap the flipped
        runner legitimately diverges from the golden reference, and a probe
        would quarantine it (and its repair would roll the swap back).
        Waits for a tick in flight."""
        self._suspended = True
        async with self._lock:
            pass

    def end_quiesce(self) -> None:
        self._suspended = False

    def rebuild_reference(self, host_params) -> None:
        """Recompute the golden reference and reset the digest baselines
        for newly committed weights (blocking: device forwards)."""
        if self._golden_factory is None:
            raise ConfigError(f"IntegrityMonitor[{self.name}] has no golden factory; "
                              "cannot follow a weights swap")
        golden = self._golden_factory(host_params)
        for m in self.members:
            m.golden = golden
            m.reset_baseline()
        logger.info("[%s] integrity reference rebuilt for new weights (golden seed %d, "
                    "margin %.2e)", self.name, golden.seed, golden.margin)

    # -- probing -------------------------------------------------------------

    async def probe_now(self) -> dict:
        """One verification pass over every member; returns a summary."""
        if self._suspended:
            return {"tick": self._tick, "suspended": True, "checked": 0, "ok": 0,
                    "mismatches": 0, "repaired": 0}
        async with self._lock:
            self._tick += 1
            with_digests = bool(self.cfg.digest_every) and (
                self._tick % self.cfg.digest_every == 0)
            summary = {"tick": self._tick, "checked": 0, "ok": 0, "mismatches": 0,
                       "repaired": 0}
            for m in self.members:
                await self._probe_member(m, with_digests, summary)
            return summary

    def _count(self, m, result: str) -> None:
        self.results[result] += 1
        self.m_probe[result].inc()
        m.last_result = result

    async def _probe_member(self, m, with_digests: bool, summary: dict) -> None:
        state = m.state()
        if state == DEAD:
            return
        if state == CORRUPT:
            if self.cfg.repair:
                summary["repaired"] += await self._repair(m)
            return
        summary["checked"] += 1
        self.probes += 1
        if with_digests:
            try:
                drifted = await m.verify_digests()
            except RunnerDead:
                return
            except Exception as e:
                self._count(m, "error")
                m.note_probe_failure(e)
                return
            if drifted:
                self._count(m, "digest_mismatch")
                preview = drifted[:3] + (["..."] if len(drifted) > 3 else [])
                logger.error("[%s] %s: param digest drift on %d leaves: %s", self.name,
                             m.label, len(drifted), preview)
                m.health.mark_unhealthy(f"param digest drift: {preview}")
        try:
            ok = await m.golden_probe()
        except RunnerDead:
            return
        except Exception as e:
            self._count(m, "error")
            m.note_probe_failure(e)
            return
        m.last_probe_at = time.monotonic()
        if ok:
            self.results["ok"] += 1
            self.m_probe["ok"].inc()
            if m.last_result != "digest_mismatch":
                m.last_result = "ok"
            summary["ok"] += 1
            return
        self._count(m, "mismatch")
        self.mismatches += 1
        summary["mismatches"] += 1
        self.quarantine(m, "golden-probe signature mismatch")
        if self.cfg.repair:
            summary["repaired"] += await self._repair(m)

    # -- quarantine and repair -----------------------------------------------

    def quarantine(self, m, reason: str) -> None:
        """Mark a member CORRUPT and fire the quarantine hooks."""
        m.health.mark_corrupt(reason)
        self.quarantines += 1
        self.m_quarantine.inc()
        for hook in self._quarantine_hooks:
            try:
                hook()
            except Exception:
                logger.exception("[%s] quarantine hook failed", self.name)

    async def _repair(self, m) -> int:
        """Repair one CORRUPT member, then golden re-verify before it serves
        again. 1 on re-admission, 0 when it stays quarantined."""
        try:
            await m.repair()
        except Exception:
            logger.exception("[%s] %s: repair failed; member stays quarantined",
                             self.name, m.label)
            return 0
        # re-admit first (the heal gate rejects CORRUPT, so the verifying
        # probe could not run), then verify; a failure re-quarantines
        m.health.mark_repaired()
        try:
            ok = await m.golden_probe()
        except Exception as e:
            m.health.mark_corrupt(f"repair re-verify errored: {e}")
            return 0
        m.last_probe_at = time.monotonic()
        if not ok:
            m.health.mark_corrupt("repair failed golden re-verify")
            m.last_result = "mismatch"
            return 0
        m.last_result = "ok"
        self.repairs += 1
        self.m_repair.inc()
        logger.info("[%s] %s: repaired, re-verified, re-admitted", self.name, m.label)
        return 1

    # -- introspection -------------------------------------------------------

    def digest_epoch(self) -> Optional[str]:
        """One digest over every member's baseline; None until every member
        has one."""
        parts: dict[str, str] = {}
        for i, m in enumerate(self.members):
            base = m.baseline_digests()
            if base is None:
                return None
            parts[str(i)] = combined_digest(base)
        return combined_digest(parts)

    def report(self) -> dict:
        """JSON-able snapshot for the engine's ``/health``: the JAX keys, and
        the probes by result."""
        rep = {"probes": self.probes, "mismatches": self.mismatches,
               "quarantined": self.quarantines, "repaired": self.repairs,
               "results": dict(self.results),
               "members": [m.report() for m in self.members]}
        epoch = self.digest_epoch()
        if epoch is not None:
            rep["digest_epoch"] = epoch
        return rep


def build_integrity_monitor(runner, *, model: str,
                            cfg: Optional[IntegrityConfig]) -> Optional[IntegrityMonitor]:
    """A monitor over a ``ModelRunner`` (one member per swap unit); None when
    the ``integrity:`` block is absent. The reference is computed once, on
    the runner's device, from the retained host tree."""
    if cfg is None:
        return None
    units = runner.swap_units()
    first = units[0][1]
    seq = min(first.buckets.seq_buckets)

    def factory(host) -> GoldenReference:
        return find_golden_reference(
            first.family, first.cfg, host, rows=cfg.golden_rows,
            seq=min(cfg.golden_seq, seq), seed=cfg.golden_seed,
            serving_dtype=first.serving_dtype, packed=first.packed, device=first.device)

    golden = factory(first.host_params)
    mon = IntegrityMonitor(name=model, cfg=cfg,
                           members=[RunnerIntegrityMember(r, label, golden)
                                    for label, r in units])
    mon._golden_factory = factory
    return mon


def serving_dtype_of(params: Mapping) -> Optional[str]:
    """The dtype name of a tree's first float leaf in JAX's flatten order
    (keys sorted), as the JAX generate monitor picks its margin floor."""
    for k in sorted(params):
        v = params[k]
        if isinstance(v, Mapping):
            found = serving_dtype_of(v)
            if found is not None:
                return found
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            return str(v.dtype).removeprefix("torch.")
    return None


def build_generate_integrity_monitor(proc, *, model: str,
                                     cfg: Optional[IntegrityConfig]) -> Optional[IntegrityMonitor]:
    """A monitor over a ``gpu_generate`` processor's continuous server (one
    member); None when the ``integrity:`` block is absent. The margin floor
    is that of the tree's first float leaf's dtype, as in JAX. The golden
    reference of a tree is computed on the live tensors, which hold it bit
    for bit at build and after a committed swap: the 16 GB host tree of a
    Llama-3-8B model is not placed a second time. ``serving: batch`` holds
    no resident member to probe: the block raises there, with JAX's words."""
    if cfg is None:
        return None
    server = proc.server
    if server is None:
        raise ConfigError(
            "gpu_generate: integrity requires serving: continuous (batch "
            "mode holds no resident serving member to probe); drop the "
            "integrity block or switch serving modes")
    dtype = serving_dtype_of(server.params)

    def factory(host) -> GoldenReference:
        return find_golden_reference(
            proc.family, proc.cfg, server.params, rows=cfg.golden_rows, seq=cfg.golden_seq,
            seed=cfg.golden_seed, serving_dtype=dtype, device=server.device)

    golden = factory(proc.host_params)
    member = ServerIntegrityMember(
        server, "generate[continuous]", golden, family=proc.family, cfg=proc.cfg,
        place_fn=proc.place_params, host_source=lambda: proc.host_params, owner=proc)
    mon = IntegrityMonitor(name=model, cfg=cfg, members=[member])
    mon._golden_factory = factory
    return mon
