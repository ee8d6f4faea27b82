"""Hot swap of a runner's weights with canary and rollback, the batch side.

Counterpart of ``arkflow_tpu/tpu/swap.py``. ``ModelSwapManager`` changes the
weights a serving runner answers with, without a restart:

1. **Prepare off the serving path.** The candidate checkpoint is restored
   into a fresh host tree and converted for the serving dtype (int8:
   quantized) on an executor thread; a corrupt or mismatched checkpoint
   fails here (``ConfigError`` from ``tpu/checkpoint.py``) and the live
   weights serve throughout.
2. **Canary.** A deterministic golden batch runs through the family's
   forward on the device with the live weights and with the candidate
   staged in fresh tensors; the swap goes on only when their argmax
   signatures agree to ``min_agreement``.
3. **Flip.** The candidate is copied into the live tensors in place
   (``ModelRunner.adopt_params``): the runner's CUDA graphs read the
   addresses they were captured with, so no capture runs again, and every
   step enqueued before the copy reads the old weights. The prior tree comes
   back as a copy, the rollback token.
4. **Probe, then commit or roll back.** One real health-gated step runs
   through the runner. A probe failure, a canary disagreement, a restore
   error or a chaos crash copies the prior tree back and raises
   ``SwapError``; the old weights served throughout.

The continuous generation server is one unit (``GenerationServerUnit``):
its flip is ``GenerationServer.swap_params``, which drains the slot grid
first, zeroes the KV pools after the copy and flushes the prefix cache; its
probe is one real 2-token generation. ``serving: batch`` is
``BatchGenerateUnit``: its flip copies into the live tensors the batch
generator's graphs read, between two generations; its probe is one
generation at a fixed key. ``build_generate_swapper`` builds the manager
over a ``gpu_generate`` processor and picks the unit by its mode.

Chaos: ``inject_swap_fault("swap_corrupt")`` mangles the next swap's
restored tree (the canary rejects it); ``"swap_crash"`` raises after the
flip (the rollback path). Both are armed by the fault plugin's processor
wrapper. The helpers (``golden_inputs``, ``argmax_signature``,
``signature_margin``) use numpy only and equal the JAX package's bit for
bit.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError, SwapError
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.tpu.compiled_step import tree_map
from arkflow_tpu_torch.utils.duration import parse_duration

logger = logging.getLogger("arkflow_torch.swap")

#: chaos fault kinds the fault plugin may arm on a swapper
SWAP_FAULT_KINDS = ("swap_corrupt", "swap_crash")


@dataclass(frozen=True)
class SwapConfig:
    """The ``swap:`` block of ``gpu_inference``."""

    #: golden-batch rows of the canary (0 disables it)
    canary_rows: int = 4
    #: share of golden argmax positions on which the live model and the
    #: candidate must agree (1.0 = all)
    min_agreement: float = 1.0
    #: seed of the golden batch
    canary_seed: int = 0x5117
    #: continuous generation only: budget for the slot grid to run dry
    drain_timeout_s: float = 30.0


def parse_swap_config(cfg: Any, who: str = "processor") -> SwapConfig:
    """Parse a ``swap:`` block (at ``--validate`` and at build)."""
    if cfg is None:
        return SwapConfig()
    if not isinstance(cfg, Mapping):
        raise ConfigError(f"{who}.swap must be a mapping, got {cfg!r}")
    unknown = set(cfg) - {"canary", "drain_timeout"}
    if unknown:
        raise ConfigError(
            f"{who}.swap: unknown keys {sorted(unknown)} (allowed: canary, drain_timeout)")
    out: dict[str, Any] = {}
    canary = cfg.get("canary")
    if canary is not None:
        if not isinstance(canary, Mapping):
            raise ConfigError(f"{who}.swap.canary must be a mapping, got {canary!r}")
        bad = set(canary) - {"rows", "min_agreement", "seed"}
        if bad:
            raise ConfigError(
                f"{who}.swap.canary: unknown keys {sorted(bad)} "
                "(allowed: rows, min_agreement, seed)")
        rows = canary.get("rows", SwapConfig.canary_rows)
        if isinstance(rows, bool) or not isinstance(rows, int) or rows < 0:
            raise ConfigError(f"{who}.swap.canary.rows must be an int >= 0, got {rows!r}")
        out["canary_rows"] = rows
        agree = canary.get("min_agreement", SwapConfig.min_agreement)
        if isinstance(agree, bool) or not isinstance(agree, (int, float)) \
                or not (0.0 <= float(agree) <= 1.0):
            raise ConfigError(
                f"{who}.swap.canary.min_agreement must be in [0, 1], got {agree!r}")
        out["min_agreement"] = float(agree)
        seed = canary.get("seed", SwapConfig.canary_seed)
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise ConfigError(f"{who}.swap.canary.seed must be an int, got {seed!r}")
        out["canary_seed"] = seed
    drain = cfg.get("drain_timeout")
    if drain is not None:
        drain_s = parse_duration(drain)
        if drain_s <= 0:
            raise ConfigError(f"{who}.swap.drain_timeout must be positive, got {drain!r}")
        out["drain_timeout_s"] = drain_s
    return SwapConfig(**out)


# -- golden batch and canary signature ---------------------------------------


def golden_inputs(spec: Mapping[str, tuple], cfg, rows: int, seed: int,
                  seq: int = 16) -> dict[str, np.ndarray]:
    """Deterministic spec-shaped inputs: token ids below the vocab, masks
    all ones (right-padded by construction), float features standard
    normal. The same (spec, cfg, rows, seed) give the same bytes."""
    rng = np.random.default_rng(seed)
    vocab = int(getattr(cfg, "vocab_size", 256) or 256)
    out: dict[str, np.ndarray] = {}
    for name, (dtype, trailing) in spec.items():
        dims = tuple(seq if d == "seq" else int(d) for d in trailing)
        shape = (rows, *dims)
        if name == "attention_mask":
            out[name] = np.ones(shape, dtype)
        elif np.issubdtype(np.dtype(dtype), np.integer):
            out[name] = rng.integers(1, max(vocab, 2), size=shape).astype(dtype)
        else:
            out[name] = rng.standard_normal(shape).astype(dtype)
    return out


def _decision_output(outputs: Mapping[str, Any]):
    cand = outputs.get("logits")
    if cand is None:
        for v in outputs.values():
            arr = np.asarray(v)
            if arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating):
                return v
    return cand


def argmax_signature(outputs: Mapping[str, Any]) -> np.ndarray:
    """Decision signature of a forward: the argmax over the logits' last
    axis (the first output verbatim when none is floating)."""
    cand = _decision_output(outputs)
    if cand is None:
        return np.asarray(next(iter(outputs.values())))
    return np.asarray(np.argmax(np.asarray(cand, np.float32), axis=-1))


def signature_margin(outputs: Mapping[str, Any]) -> float:
    """Smallest top-1/top-2 logit gap over the signature's positions
    (+inf when there is no floating output to take an argmax of)."""
    cand = _decision_output(outputs)
    if cand is None:
        return float("inf")
    arr = np.asarray(cand, np.float32)
    if arr.shape[-1] < 2:
        return float("inf")
    top2 = np.partition(arr, -2, axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


# -- the swap unit -----------------------------------------------------------


class BatchRunnerUnit:
    """One ``ModelRunner``: place and flip are the runner's own swap
    surface; the probe is one real health-gated step."""

    def __init__(self, runner, label: str):
        self.runner = runner
        self.label = label

    def live(self):
        return self.runner.params

    def place(self, host_params):
        return self.runner.place_params(host_params)

    async def adopt(self, placed):
        return await asyncio.get_running_loop().run_in_executor(
            None, self.runner.adopt_params, placed)

    def note_committed_host(self, host) -> None:
        """The committed tree becomes the runner's known-good repair source."""
        self.runner.host_params = host

    def _probe_inputs(self) -> dict[str, np.ndarray]:
        r = self.runner
        seq = min(r.buckets.seq_buckets)
        rows = min(2, r.buckets.batch_buckets[0])
        if not r.packed:
            return golden_inputs(r.spec, r.cfg, rows, seed=0xB0B, seq=seq)
        from arkflow_tpu_torch.tpu.packing import pack_tokens

        rng = np.random.default_rng(0xB0B)
        vocab = int(getattr(r.cfg, "vocab_size", 256) or 256)
        ids = rng.integers(1, max(vocab, 2), size=(rows, seq)).astype(np.int32)
        pk = pack_tokens(ids, np.full(rows, seq, np.int64), seq)
        return {"input_ids": pk.input_ids, "segment_ids": pk.segment_ids,
                "position_ids": pk.position_ids, "example_row": pk.example_row,
                "example_pos": pk.example_pos}

    async def probe(self) -> None:
        """One real step through the runner's gate and deadline; a failure
        is marked as a dispatcher marks it."""
        try:
            await self.runner.infer(self._probe_inputs(), probe=True)
        except Exception as e:
            self.runner.core.note_external_failure(e)
            raise


class BatchGenerateUnit:
    """``gpu_generate`` in batch mode: the flip copies the tree into the
    live tensors of the processor's ``BatchGenerator`` (its prefill and
    decode graphs keep their addresses) between generations, and returns
    the prior tree; the probe is one generation at a fixed key (key 0), so
    it never advances the serving key."""

    label = "generate[batch]"

    def __init__(self, proc):
        self.proc = proc

    def live(self):
        return self.proc.params

    def place(self, host_params):
        return self.proc.place_params(host_params)

    async def adopt(self, placed):
        return await asyncio.get_running_loop().run_in_executor(
            None, self.proc.generator.adopt, placed)

    def note_committed_host(self, host) -> None:
        self.proc.host_params = host

    def _probe_blocking(self) -> None:
        from arkflow_tpu_torch.models.decoder import make_key

        p = self.proc
        # the smallest warmed shape (JAX probes [batch_bucket(1), min(8, seq_bucket(8))])
        seq = min(p.buckets.seq_bucket(8), p.max_input)
        rows = p.buckets.batch_bucket(1)
        p.generator.generate(np.ones((rows, seq), np.int32), np.ones(rows, np.int32), 1,
                             make_key(0))

    async def probe(self) -> None:
        await asyncio.get_running_loop().run_in_executor(None, self._probe_blocking)


class GenerationServerUnit:
    """The continuous ``GenerationServer``: the flip is its ``swap_params``
    (drain, copy in place, pools zeroed); the probe is one real generation
    through its heal gate and deadline. ``owner`` (the ``gpu_generate``
    processor) keeps its ``params`` alias and its known-good host tree in
    step with the server."""

    label = "generate[continuous]"

    def __init__(self, server, place_fn: Callable[[Any], Any], drain_timeout_s: float,
                 owner=None):
        self.server = server
        self._place_fn = place_fn
        self._drain_timeout_s = drain_timeout_s
        self._owner = owner

    def live(self):
        return self.server.params

    def place(self, host_params):
        return self._place_fn(host_params)

    async def adopt(self, placed):
        old = await self.server.swap_params(placed, self._drain_timeout_s)
        if self._owner is not None:
            self._owner.params = self.server.params
        return old

    def note_committed_host(self, host) -> None:
        if self._owner is not None:
            self._owner.host_params = host

    async def probe(self) -> None:
        vocab = int(getattr(self.server.cfg, "vocab_size", 256) or 256)
        await self.server.generate([t % max(vocab, 2) for t in (3, 5, 7)], max_new_tokens=2)


# -- the manager -------------------------------------------------------------


class ModelSwapManager:
    """One hot swap at a time over a list of units. ``prepare(path)`` is the
    blocking restore and convert; ``canary(params)`` the blocking golden
    forward giving an ``argmax_signature``. Commit hooks run after a
    committed swap, and after a rollback in which a unit had flipped."""

    def __init__(self, *, name: str, config: Optional[SwapConfig] = None,
                 prepare: Callable[[str], Any], canary: Callable[[Any], np.ndarray],
                 units: Sequence[Any], checkpoint: Optional[str] = None):
        if not units:
            raise ConfigError("ModelSwapManager needs at least one swap unit")
        self.name = name
        self.cfg = config or SwapConfig()
        self._prepare = prepare
        self._canary = canary
        self.units = list(units)
        #: model-version epoch: 0 = the weights the process booted with
        self.version = 0
        self.checkpoint = checkpoint
        self._lock = asyncio.Lock()
        self._state = "idle"
        self._last_error: Optional[str] = None
        self._chaos: deque[str] = deque()
        self._commit_hooks: list[Callable[[], None]] = []
        #: the integrity monitor (``tpu/integrity.py``), when both are on:
        #: probing quiesces across the flip, and a commit rebuilds its
        #: golden reference
        self.integrity = None
        self.started = self.completed = self.rolled_back = 0
        # the JAX manager's metrics, fed beside the counters above
        reg = global_registry()
        labels = {"model": name}
        self.m_version = reg.gauge(
            "arkflow_model_version",
            "model-version epoch (increments on each committed hot-swap)", labels)
        self.m_version.set(0)
        self.m_started = reg.counter(
            "arkflow_swap_started_total", "hot-swap attempts started", labels)
        self.m_completed = reg.counter(
            "arkflow_swap_completed_total", "hot-swaps committed", labels)
        self.m_rolled_back = reg.counter(
            "arkflow_swap_rolled_back_total",
            "hot-swaps rolled back (canary/restore/probe failure) with the "
            "prior version serving throughout", labels)
        #: milliseconds of the last swap's stages (prepare, canary, flip, probe)
        self.stage_ms: dict[str, float] = {}

    # -- chaos and hooks -----------------------------------------------------

    def inject_swap_fault(self, kind: str) -> None:
        """Arm a one-shot fault the next swap consumes."""
        if kind not in SWAP_FAULT_KINDS:
            raise ConfigError(f"unknown swap fault kind {kind!r} ({'/'.join(SWAP_FAULT_KINDS)})")
        self._chaos.append(kind)

    def _consume_chaos(self, kind: str) -> bool:
        if self._chaos and self._chaos[0] == kind:
            self._chaos.popleft()
            return True
        return False

    def add_commit_hook(self, hook: Callable[[], None]) -> None:
        self._commit_hooks.append(hook)

    def _run_flush_hooks(self) -> None:
        for hook in self._commit_hooks:
            try:
                hook()
            except Exception:
                logger.exception("[%s] swap flush hook failed", self.name)

    # -- introspection -------------------------------------------------------

    def report(self) -> dict:
        """JSON-able snapshot for the engine's ``/health``: the JAX keys, and
        the last swap's stage times."""
        rep = {"version": self.version, "checkpoint": self.checkpoint, "state": self._state,
               "units": len(self.units), "started": self.started,
               "completed": self.completed, "rolled_back": self.rolled_back,
               "stage_ms": dict(self.stage_ms)}
        if self._last_error:
            rep["last_error"] = self._last_error
        return rep

    # -- the swap ------------------------------------------------------------

    @staticmethod
    def _mangle(host_params: dict) -> dict:
        """swap_corrupt: every float leaf perturbed so no argmax survives."""
        return tree_map(lambda v: (v.float() * -1000.0 + 3.7).to(v.dtype)
                        if v.is_floating_point() else v, host_params)

    def _prepare_checked(self, checkpoint: str):
        host = self._prepare(checkpoint)
        if self._consume_chaos("swap_corrupt"):
            logger.warning("[%s] chaos: mangling the restored checkpoint tree", self.name)
            host = self._mangle(host)
        return host

    def _fail(self, stage: str, err: Exception) -> SwapError:
        self.rolled_back += 1
        self.m_rolled_back.inc()
        msg = f"swap rolled back at {stage}: {err}"
        self._last_error = msg
        logger.warning("[%s] %s (version %d still serving)", self.name, msg, self.version)
        return SwapError(f"[{self.name}] {msg}; version {self.version} still serving")

    async def swap(self, checkpoint: str) -> dict:
        """One hot swap to ``checkpoint``. Returns the committed report;
        raises ``SwapError`` on rejection or rollback."""
        if self._lock.locked():
            raise SwapError(f"[{self.name}] a swap is already in progress")
        async with self._lock:
            loop = asyncio.get_running_loop()
            self.started += 1
            self.m_started.inc()
            self.stage_ms = {}
            self._state = "restoring"
            if self.integrity is not None:
                await self.integrity.begin_quiesce()
            try:
                t0 = time.perf_counter()
                try:
                    host = await loop.run_in_executor(None, self._prepare_checked, checkpoint)
                except Exception as e:
                    raise self._fail("restore", e) from e
                t0 = self._stage("prepare", t0)

                self._state = "canary"
                placed0 = None
                if self.cfg.canary_rows > 0:
                    try:
                        placed0 = await loop.run_in_executor(None, self.units[0].place, host)
                        live_sig, cand_sig = await loop.run_in_executor(
                            None, self._canary_pair, placed0)
                    except Exception as e:
                        raise self._fail("canary", e) from e
                    agreement = float(np.mean(live_sig == cand_sig)) if live_sig.size else 1.0
                    if agreement < self.cfg.min_agreement:
                        raise self._fail("canary", SwapError(
                            f"golden-batch agreement {agreement:.3f} < "
                            f"min_agreement {self.cfg.min_agreement:.3f}"))
                t0 = self._stage("canary", t0)

                self._state = "rolling"
                flipped: list[tuple[Any, Any]] = []
                try:
                    for i, unit in enumerate(self.units):
                        placed = (placed0 if i == 0 and placed0 is not None
                                  else await loop.run_in_executor(None, unit.place, host))
                        old = await unit.adopt(placed)
                        del placed
                        placed0 = None
                        flipped.append((unit, old))
                        t0 = self._stage("flip", t0)
                        if self._consume_chaos("swap_crash"):
                            raise SwapError("chaos: injected crash mid-swap "
                                            f"({len(flipped)}/{len(self.units)} units flipped)")
                        await unit.probe()
                        t0 = self._stage("probe", t0)
                except Exception as e:
                    await self._rollback(flipped)
                    if flipped:
                        self._run_flush_hooks()
                    raise self._fail("rolling flip", e) from e
                del flipped

                for unit in self.units:
                    unit.note_committed_host(host)
                if self.integrity is not None:
                    await loop.run_in_executor(None, self.integrity.rebuild_reference, host)
                self.version += 1
                self.checkpoint = checkpoint
                self.completed += 1
                self.m_version.set(self.version)
                self.m_completed.inc()
                self._last_error = None
                self._run_flush_hooks()
                logger.info("[%s] hot swap committed: version %d <- %s", self.name,
                            self.version, checkpoint)
                self._state = "idle"
                return self.report()
            finally:
                self._state = "idle"
                if self.integrity is not None:
                    self.integrity.end_quiesce()

    def _stage(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + (now - t0) * 1e3
        return now

    def _canary_pair(self, placed_candidate) -> tuple[np.ndarray, np.ndarray]:
        """Blocking golden forwards: live first, then the candidate."""
        live = self._canary(self.units[0].live())
        cand = self._canary(placed_candidate)
        return np.asarray(live), np.asarray(cand)

    async def _rollback(self, flipped: list[tuple[Any, Any]]) -> None:
        """Copy the prior tree back into every flipped unit, newest first."""
        for unit, old in reversed(flipped):
            try:
                await unit.adopt(old)
            except Exception:
                logger.exception("[%s] rollback re-adopt failed on %s; unit left to its "
                                 "probe/backoff schedule", self.name, unit.label)


def build_batch_swapper(runner, *, model: str, serving_dtype: Optional[str],
                        swap_cfg: Optional[SwapConfig],
                        checkpoint: Optional[str] = None) -> ModelSwapManager:
    """A swapper over a ``ModelRunner``: ``prepare`` restores into the
    runner's ``checkpoint_layout`` and converts for the serving dtype; the
    canary is the family's forward on the runner's device."""
    from arkflow_tpu_torch.tpu.checkpoint import restore
    from arkflow_tpu_torch.tpu.integrity import device_forward
    from arkflow_tpu_torch.tpu.runner import convert_for_serving

    family, cfg = runner.family, runner.cfg
    swap_cfg = swap_cfg or SwapConfig()

    def prepare(path: str):
        return convert_for_serving(restore(path, runner.checkpoint_layout),
                                   serving_dtype, family.name)

    def canary(params) -> np.ndarray:
        golden = golden_inputs(family.input_spec(cfg), cfg, swap_cfg.canary_rows,
                               seed=swap_cfg.canary_seed)
        return argmax_signature(device_forward(family.apply, params, cfg, golden,
                                               torch.device(runner.device)))

    return ModelSwapManager(
        name=model, config=swap_cfg, prepare=prepare, canary=canary,
        units=[BatchRunnerUnit(member, label) for label, member in runner.swap_units()],
        checkpoint=checkpoint)


def build_generate_swapper(proc, *, model: str, swap_cfg: Optional[SwapConfig],
                           checkpoint: Optional[str] = None) -> ModelSwapManager:
    """A swapper over a ``gpu_generate`` processor: the continuous server's
    unit, or the batch generator's (``serving: batch``). ``prepare``
    restores into the layout of the live tree (the decoder's stacked
    layers, its dtypes); the canary is the family's forward on the
    processor's device."""
    from arkflow_tpu_torch.tpu.checkpoint import restore
    from arkflow_tpu_torch.tpu.integrity import device_forward

    family, cfg = proc.family, proc.cfg
    swap_cfg = swap_cfg or SwapConfig()
    if proc.server is not None:
        units: list[Any] = [GenerationServerUnit(proc.server, proc.place_params,
                                                 swap_cfg.drain_timeout_s, owner=proc)]
    else:
        units = [BatchGenerateUnit(proc)]

    def prepare(path: str):
        return restore(path, proc.params)

    def canary(params) -> np.ndarray:
        golden = golden_inputs(family.input_spec(cfg), cfg, swap_cfg.canary_rows,
                               seed=swap_cfg.canary_seed)
        return argmax_signature(device_forward(family.apply, params, cfg, golden,
                                               proc.device))

    return ModelSwapManager(name=model, config=swap_cfg, prepare=prepare, canary=canary,
                            units=units, checkpoint=checkpoint)
