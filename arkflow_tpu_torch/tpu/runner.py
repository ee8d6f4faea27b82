"""ModelRunner: the single-device execution provider for streaming inference.

Counterpart of the single-device path of ``arkflow_tpu/tpu/runner.py``:
batch -> pad to a (batch, seq) bucket -> model on the device -> unpad.

- The device is explicit: ``device=None`` means CUDA, and without a card the
  runner raises instead of carrying on quietly on the CPU. ``device="cpu"``
  runs the same code on the CPU (tests), where the model's attention takes
  the kernel's plain version.
- ``infer`` runs host prep and the step on executor threads, never on the
  event loop, and bounds steps in flight with a semaphore so several stream
  workers keep the device busy. ``torch.inference_mode`` is entered inside
  the executor thread (it is thread-local); outputs come back to the host.
- The ragged kernel needs right-padded masks. A mask that is not a
  contiguous prefix of ones raises when flash was forced in config, and
  otherwise switches the runner to the plain attention for good, counted in
  ``flash_fallbacks``.
- ``packed=True`` serves token-packed layouts (``tpu/packing.py``) through
  the family's ``apply_packed``: the row dim pads to a batch bucket, the
  example dim to an example bucket, and a layout over the grid raises
  (callers carve it first with ``carve_row_windows``).
- ``serving_dtype="int8"`` quantizes the host tree (``models/quantize.py``)
  before the transfer, padded or packed; every dense layer then runs an
  int8 product and the attention stays on the float path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.quantize import quantize_for_serving
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy, pad_batch_dim, pad_seq_dim

logger = logging.getLogger("arkflow_torch.runner")

_SERVING_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def _env_flash_floor(default: int = 0) -> int:
    """``ARKFLOW_FLASH_MIN_SEQ``, tolerantly: a malformed value logs a warning
    and gives the default (explicit config values raise). The default is 0
    on the H100 until a measurement there says the kernel loses at short seq."""
    raw = os.environ.get("ARKFLOW_FLASH_MIN_SEQ")
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ARKFLOW_FLASH_MIN_SEQ=%r is not an int; using %d", raw, default)
        return default


def resolve_device(device: Any = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for (or implied) and no
    card is present: the runner never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"device {str(dev)!r} unsupported (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def check_serving_dtype(serving_dtype: Optional[str]) -> None:
    if serving_dtype not in (None, "int8", *_SERVING_DTYPES):
        raise ConfigError(
            f"serving_dtype {serving_dtype!r} invalid (float32/bfloat16/float16/int8)")


def convert_for_serving(params, serving_dtype: Optional[str], family_name: str = ""):
    """Cast or quantize a host param tree for the serving dtype, before it
    goes to the device (as the JAX runner does):

    - ``int8``: W8A8 dynamic quantization (``models/quantize.py``): dense
      weights to per-channel int8, every other floating leaf to bf16;
    - ``bfloat16``/``float16``: every floating leaf cast;
    - ``float32``/None: unchanged."""
    check_serving_dtype(serving_dtype)
    if serving_dtype == "int8":
        params, n_q = quantize_for_serving(params)
        logger.info("[%s] int8 serving: %d dense layers quantized", family_name, n_q)
        return params
    if serving_dtype in (None, "float32"):
        return params
    target = _SERVING_DTYPES[serving_dtype]
    return _tree_map(lambda t: t.to(target) if t.is_floating_point() else t, params)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class ModelRunner:
    def __init__(
        self,
        model: str,
        model_config: Optional[dict] = None,
        *,
        buckets: Optional[BucketPolicy] = None,
        seed: int = 0,
        device: Any = None,
        serving_dtype: Optional[str] = None,
        max_in_flight: int = 2,
        host_params: Optional[dict] = None,
        packed: bool = False,
    ):
        self.device = resolve_device(device)
        self.family = get_model(model)
        self.cfg = self.family.make_config(**(model_config or {}))
        raw_flash = getattr(self.cfg, "use_flash_attention", False)
        self.cfg = self._resolve_auto_flags(self.cfg, self.device, packed)
        #: flash explicitly requested in config (never mutated): only then
        #: does an unservable mask raise; auto-chosen flash falls back
        self._flash_user_forced = raw_flash is True
        self._lock = threading.Lock()
        self.buckets = buckets or BucketPolicy()
        self.packed = packed
        if packed:
            if "apply_packed" not in self.family.extras:
                raise ConfigError(
                    f"model {model!r} has no packed execution (its family "
                    "publishes no apply_packed/packed_input_spec)")
            self._apply = self.family.extras["apply_packed"]
            self.spec = self.family.extras["packed_input_spec"](self.cfg)
        else:
            self._apply = self.family.apply
            self.spec = self.family.input_spec(self.cfg)
        if host_params is None:
            # init on the CPU from an explicit generator, then one transfer
            host_params = self.family.init(torch.Generator().manual_seed(seed), self.cfg)
        host_params = convert_for_serving(host_params, serving_dtype, model)
        self.params = _tree_map(lambda t: t.to(self.device), host_params)
        # 2: one step computes while the next one's host work overlaps it
        if max_in_flight < 1:
            raise ConfigError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_in_flight = max_in_flight
        self._inflight_sem: Optional[asyncio.Semaphore] = None
        self._sem_loop: Optional[asyncio.AbstractEventLoop] = None
        self._in_warmup = False
        #: model steps run on the device (warmup included)
        self.device_steps = 0
        #: of those, steps on packed layouts
        self.packed_steps = 0
        #: packed traffic steps (warmup excluded): true tokens, and the
        #: token slots (bucket rows x seq) they were padded to
        self.packed_tokens = 0
        self.packed_slots = 0
        #: true rows inferred (warmup excluded)
        self.rows = 0
        #: times the runner switched from the kernel to the plain attention
        #: because a mask was not right-padded
        self.flash_fallbacks = 0

    @staticmethod
    def _resolve_auto_flags(cfg, device: torch.device, packed: bool = False):
        """``use_flash_attention=None`` means auto: the ragged kernel on CUDA,
        the plain attention on the CPU. ``ARKFLOW_FLASH=0`` forces the plain
        attention even over an explicit ``use_flash_attention: true`` (and
        ``packed_flash: true``). An unset ``flash_min_seq`` takes
        ``ARKFLOW_FLASH_MIN_SEQ`` (default 0).

        Packed runners resolve ``packed_flash=None`` the same way: the
        segment kernel on CUDA (one device here), the pair-mask attention on
        the CPU, where an explicit ``packed_flash: true`` takes the kernel's
        plain version through its wrapper. The JAX package leaves its
        segment kernel off by default only because it had no A/B run on a
        TPU (``arkflow_tpu/ops/segment_attention.py``); ``chip_smoke.py``
        runs that A/B on the H100 (kernel against the pair mask and the
        unpacked ragged path, same texts), so on CUDA the kernel is the
        default."""
        if not hasattr(cfg, "use_flash_attention"):
            return cfg
        if packed and getattr(cfg, "packed_flash", False) is None:
            on = device.type == "cuda" and os.environ.get("ARKFLOW_FLASH", "1") != "0"
            cfg = dataclasses.replace(cfg, packed_flash=on)
        if os.environ.get("ARKFLOW_FLASH", "1") == "0":
            return dataclasses.replace(cfg, use_flash_attention=False,
                                       **({"packed_flash": False}
                                          if hasattr(cfg, "packed_flash") else {}))
        if cfg.use_flash_attention is not None:
            if (cfg.use_flash_attention and cfg.flash_min_seq is None
                    and os.environ.get("ARKFLOW_FLASH_MIN_SEQ")):
                return dataclasses.replace(cfg, flash_min_seq=_env_flash_floor())
            return cfg
        on_cuda = device.type == "cuda"
        extra = {}
        if on_cuda and cfg.flash_min_seq is None:
            extra["flash_min_seq"] = _env_flash_floor()
        return dataclasses.replace(cfg, use_flash_attention=on_cuda, **extra)

    def _disable_flash(self) -> None:
        """Auto fallback: serve with the plain attention from now on.
        Concurrent prep threads may call this together; it counts once."""
        with self._lock:
            if not self.cfg.use_flash_attention:
                return
            self.cfg = dataclasses.replace(self.cfg, use_flash_attention=False)
            self.flash_fallbacks += 1

    # -- shape plumbing ----------------------------------------------------

    def _pad_inputs_packed(self, inputs: dict[str, np.ndarray]) -> tuple[dict[str, np.ndarray], int]:
        """Pad a packed layout: the [P, S] row arrays pad P to a batch bucket
        (dead rows: segment 0), the [E] example arrays pad E to an example
        bucket (they point at row 0, position 0 and are sliced off by the
        true count). Returns (padded, E)."""
        p = inputs["input_ids"].shape[0]
        e = inputs["example_row"].shape[0]
        mb = self.buckets.max_batch()
        me = self.buckets.max_examples()
        if p > mb or e > me:
            raise ConfigError(
                f"packed batch ({p} rows / {e} examples) exceeds the grid (max {mb} "
                f"rows / {me} examples); carve row windows that fit before "
                "dispatch (tpu/packing.py carve_row_windows)")
        pb = self.buckets.batch_bucket(p)
        eb = self.buckets.example_bucket(e)
        out = {}
        for name, (dtype, trailing) in self.spec.items():
            arr = inputs.get(name)
            if arr is None:
                raise ConfigError(f"model {self.family.name!r} missing input {name!r}")
            arr = np.asarray(arr, dtype=dtype)
            if "seq" in trailing:
                arr = pad_seq_dim(arr, self.buckets.seq_bucket(arr.shape[1]), axis=1)
                arr = pad_batch_dim(arr, pb)
            else:
                arr = pad_batch_dim(arr, eb)
            out[name] = arr
        if not self._in_warmup:
            true_tokens = int(np.count_nonzero(np.asarray(inputs["segment_ids"]) > 0))
            with self._lock:
                self.packed_tokens += true_tokens
                self.packed_slots += out["input_ids"].size
        return out, e

    def _pad_inputs(self, inputs: dict[str, np.ndarray]) -> tuple[dict[str, np.ndarray], int]:
        """Pad every input to its bucket; returns (padded, true_batch). Rows
        longer than the top seq bucket are truncated to it."""
        if self.packed:
            return self._pad_inputs_packed(inputs)
        n = next(iter(inputs.values())).shape[0]
        bb = self.buckets.batch_bucket(n)
        out = {}
        for name, (dtype, trailing) in self.spec.items():
            arr = inputs.get(name)
            if arr is None:
                raise ConfigError(f"model {self.family.name!r} missing input {name!r}")
            arr = np.asarray(arr, dtype=dtype)
            if "seq" in trailing:
                arr = pad_seq_dim(arr, self.buckets.seq_bucket(arr.shape[1]), axis=1)
            out[name] = pad_batch_dim(arr, bb)
        return out, n

    def _prep(self, inputs: dict[str, np.ndarray]) -> tuple[dict[str, np.ndarray], int]:
        padded, n = self._pad_inputs(inputs)
        if getattr(self.cfg, "use_flash_attention", False) and "attention_mask" in padded:
            m = padded["attention_mask"]
            # buckets below the floor take the plain attention, which serves
            # any mask: no reason to fail or to give up the kernel for them
            if m.shape[1] < (self.cfg.flash_min_seq or 0):
                return padded, n
            # the kernel reads row sums as prefix lengths; a non-contiguous
            # mask (left padding) would silently mis-attend
            lengths = m.sum(axis=1)
            prefix = (np.arange(m.shape[1])[None, :] < lengths[:, None]).astype(m.dtype)
            if not np.array_equal(prefix, m):
                if self._flash_user_forced:
                    raise ConfigError(
                        "use_flash_attention requires right-padded attention "
                        "masks (contiguous prefix of ones)")
                logger.warning(
                    "[%s] non-right-padded attention mask: switching from the "
                    "ragged kernel to the plain attention", self.family.name)
                self._disable_flash()
        return padded, n

    # -- execution ---------------------------------------------------------

    def _step(self, padded: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One blocking model step: host -> device, forward, device -> host.
        Runs on an executor thread (or the caller's, for ``infer_sync``)."""
        with torch.inference_mode():
            inputs = {k: torch.from_numpy(v).to(self.device) for k, v in padded.items()}
            out = self._apply(self.params, self.cfg, **inputs)
            host = {k: v.cpu().numpy() for k, v in out.items()}
        with self._lock:
            self.device_steps += 1
            self.packed_steps += int(self.packed)
        return host

    def _finish(self, out: dict[str, np.ndarray], n: int) -> dict[str, np.ndarray]:
        if not self._in_warmup:
            with self._lock:
                self.rows += n
        return {k: v[:n] for k, v in out.items()}

    def infer_sync(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Blocking inference: pad -> device -> unpad. Batches larger than the
        biggest bucket are chunked and the outputs re-concatenated (packed
        layouts are never chunked: their row and example dims differ)."""
        n_total = next(iter(inputs.values())).shape[0]
        mb = self.buckets.max_batch()
        if n_total > mb and not self.packed:
            chunks = [self.infer_sync({k: v[i: i + mb] for k, v in inputs.items()})
                      for i in range(0, n_total, mb)]
            return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        padded, n = self._prep(inputs)
        return self._finish(self._step(padded), n)

    def _ensure_sem(self) -> asyncio.Semaphore:
        """(Re)bind the in-flight semaphore to the running loop: a runner may
        outlive one loop (tests, tools) and serve the next."""
        loop = asyncio.get_running_loop()
        if self._sem_loop is not loop:
            self._inflight_sem = asyncio.Semaphore(self.max_in_flight)
            self._sem_loop = loop
        return self._inflight_sem

    async def infer(self, inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Pipelined inference: host prep off the loop, at most
        ``max_in_flight`` steps on the device at once."""
        loop = asyncio.get_running_loop()
        n_total = next(iter(inputs.values())).shape[0]
        mb = self.buckets.max_batch()
        if n_total > mb and not self.packed:
            chunks = await asyncio.gather(*[
                self.infer({k: v[i: i + mb] for k, v in inputs.items()})
                for i in range(0, n_total, mb)])
            return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        padded, n = await loop.run_in_executor(None, self._prep, inputs)
        async with self._ensure_sem():
            out = await loop.run_in_executor(None, self._step, padded)
        return self._finish(out, n)

    def warmup(self) -> int:
        """One step per (batch, seq) bucket, so first-use costs (library
        loads, kernel builds, allocator growth) land before traffic does.
        Packed runners step every (row bucket, example bucket) pair with the
        row bucket at most the example bucket (a packed row holds at least
        one example). Returns the number of steps."""
        count = 0
        has_seq = any("seq" in t for _, t in self.spec.values())
        seqs = list(self.buckets.seq_buckets) if has_seq else [None]
        if self.packed:
            pairs = [(pb, eb) for eb in self.buckets.example_buckets()
                     for pb in self.buckets.batch_buckets if pb <= eb]
        else:
            pairs = [(bb, bb) for bb in self.buckets.batch_buckets]
        self._in_warmup = True
        try:
            for pb, eb in pairs:
                for sl in seqs:
                    fake = {}
                    for name, (dtype, trailing) in self.spec.items():
                        lead = eb if self.packed and "seq" not in trailing else pb
                        dims = tuple(sl if d == "seq" else d for d in trailing)
                        fake[name] = np.zeros((lead, *dims), dtype=dtype)
                    self.infer_sync(fake)
                    count += 1
        finally:
            self._in_warmup = False
        logger.info("[%s] warmed %d bucket shapes", self.family.name, count)
        return count
