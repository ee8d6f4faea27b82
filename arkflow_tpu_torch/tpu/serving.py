"""Continuous-batching generation server over the paged KV cache.

Counterpart of ``arkflow_tpu/tpu/serving.py::GenerationServer`` on one
device: a fixed grid of decode slots steps in lockstep under one
``paged_decode_step``; requests are admitted into free slots the moment
pages are available, finished sequences free their pages at once, and new
work rides along mid-flight (continuous batching, as in vLLM/Orca).

- device: the steps of ``models/paged_decode.py``, run on an executor
  thread (never on the event loop) under ``torch.inference_mode``. Every
  step is issued on the device's one current CUDA stream, in the order the
  serve loop issues them; the in-place pool writes rely on that order.
- host (this module): page allocation and refcounts, slot bookkeeping,
  EOS/max-token tracking, admission, one-shot or chunked prefill.

The steps are compiled (``tpu/compiled_step.py``): one CUDA graph per step
key, keyed as the JAX server's ``_seen_steps`` keys its jitted steps, with
the attention path beside it -- ``("decode", kernel)``, ``("prefill",
bucket)`` for every prompt bucket a one-shot prefill can take,
``("chunk", width, kernel)`` (the prefill chunk, or with the prefix cache
and no chunking each prompt bucket) and ``("verify", k, kernel)`` for
speculative decoding -- captured at ``warmup`` (the ``gpu_generate``
processor's connect) or at a key's first step, and replayed after. The
graphs' static inputs are the token ids, lengths, active mask, ``[slots,
pages_per_slot]`` page table, offset, chunk length and, when sampling, the
step's subkey; the params and the KV pools are captured in place, and the
pick (greedy, or the sampled draw of ``decoder.select_token``), the top-2
gap and the top-k check run inside the graph. ``eager=True`` (a keyword
only) runs every step op by op, for A/B comparisons; the init-time parity
gate always runs eagerly, before any capture.

An MoE model (``num_experts > 1``) serves through the same steps: each
step key's graph fixes its expert capacity from its own [B, S] (decode
``slots x 1``, verify ``slots x k``, a chunk or a prefill ``1 x width``),
as each JAX jit does, and padding and idle lanes take none of it.

The generation features of the JAX server:

- **Sampling** (``temperature > 0``, ``top_k``): the server's key
  (``decoder.make_key(seed)``) is split on the event loop where JAX splits
  its ``_key`` -- a one-shot prefill, a prompt's final chunk and a
  classic decode step -- and the subkey goes into the graph as an input,
  so a replay draws new numbers and the same numbers as the eager step.
  ``check_top_k`` (a keyword) adds an in-graph check that every picked
  token lies in its step's top-k set; misses are counted.
- **The prefix cache** (``prefix_cache_pages``): a finished request donates
  its prompt's FULL pages to an LRU keyed by the token prefix; a later
  request with that prefix aliases them (refcounted; decode only writes
  positions at or past the prompt, so they are read-only) and prefills the
  rest through the chunk step from the cached boundary. Every place that
  zeroes or renews the pools (a reset after an error or a deadline miss, a
  swap, a repair) flushes the cache with them.
- **Speculative decoding** (``speculative_tokens``, greedy): each active
  slot drafts up to k - 1 tokens by 2-gram lookup over its own history and
  scores them with its current token in one ``("verify", k, kernel)`` step
  (``paged_prefill_chunk(return_all=True)``, K3 with k queries at the
  slot's length); the argmax-consistent prefix is accepted.

Inputs go to the card from persistent pinned host buffers (one set per step
key, and per depth slot for decode) without a synchronisation, and each
step's next tokens come back through the set's pinned output buffers and
one event recorded right after the step: at ``dispatch_depth`` 2, fetching
step N waits for step N alone, not for step N+1 queued behind it, so step
N+1 is dispatched from N's device-resident tokens before N's host
bookkeeping runs. Those tokens are the decode graph's static output: the
copy into N+1's static token ids and N's copy to the host are both
enqueued before N+1's replay overwrites them. No other synchronisation sits
between two decode steps.

``decode_kernel``: ``auto`` (``paged`` on CUDA, ``gather`` on the CPU),
``gather`` (the plain path: each slot's context gathered from the pools)
or ``paged`` (the page-table kernel K3, ``ops/ragged_attention.py``; on CPU
tensors its plain version). Unlike the JAX server there is no fallback: on
CUDA ``paged`` launches the kernel or raises, and the init-time parity gate
(``kernel_parity_check``) raises on a mismatch instead of switching to
``gather``.

The lifecycle (the JAX server's self-healing, swap and integrity surfaces):

- **Composition.** The server composes a ``ServingRunnerCore``
  (``tpu/serving_core.py``) named ``<model>[generate]``. Every prefill,
  chunk and classic decode step passes its heal gate, runs ``apply_chaos``
  before the replay and, with ``step_deadline``, runs on a watchdog thread
  under ``deadline_for(first)``: a key is first while it has no graph (the
  JAX ``_seen_steps``). At ``dispatch_depth`` 2 the pipelined decode runs
  only on a HEALTHY server with a warm decode key, and its deadline and
  chaos watch the fetch, timed from the step's own dispatch; probe steps
  and cold keys take the depth-1 path, as in JAX.
- **Binding.** A step binds its ``CompiledStep``, host sets and KV pools
  on the event loop before it leaves it (``_Bound``), as the JAX server
  binds its donated pools: a step abandoned at its deadline (the zombie)
  that wakes later replays its old graph into the old pools, never into
  state a later step owns.
- **Incidents.** A failed or abandoned step fails every request in flight
  (their batches nack for redelivery) and resets the page ledger
  (``_reset_device_state``). After a deadline miss the zombie may still
  write the pools, so new pools are allocated and the probe's heal gate
  rebuilds (``_rebuild_after_incident``): a new ``CompiledStep`` with new
  host sets captures every warmed key again over them, under the
  first-step deadline; the old one, its sets and pools go with the zombie.
  A step that raised on its own thread (an OOM, an error) leaves no writer
  behind: the pools are zeroed in place and the graphs kept, so no
  allocation follows an allocation failure. Nothing falls back to eager
  steps or to ``gather``.
- **Weights.** ``swap_params`` pauses admission, waits until the slot grid
  is empty and the depth-2 pipeline applied, then copies the new tree into
  the live tensors (``CompiledStep.copy_params_``, whose addresses the
  graphs hold) and zeroes both pools in place, on the step stream under
  the step lock: KV written under the old weights must not survive. A
  chaos ``bitflip`` writes ``-1000 x + 3.7`` into the largest float leaf
  in place (the leaf JAX's ``_bitflip_params`` picks); ``sdc`` raises, as
  in JAX: the token is picked on the device.

Not ported yet: ``mesh`` (tensor-parallel pools; raises "not yet ported")
and the disaggregation entry points (``prefill_export``,
``generate_from_pages``). The plain counters (``decode_steps``,
``tokens``, ``ttft_samples``, ...) are kept beside the JAX server's
registry metrics (``arkflow_gen_*``, unlabelled as JAX's are, the TTFT
histogram, dispatch depth and paged-kernel flag by ``model``, and the
idle-gap histogram by ``model`` and ``path: generate``), which are fed at
the same sites.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from arkflow_tpu_torch.errors import (ArkError, ConfigError, StepDeadlineExceeded, SwapError,
                                     not_ported)
from arkflow_tpu_torch.models.decoder import (DecoderConfig, RoutingTrace, holding_routing,
                                             key_words, make_key, select_token, split_key)
from arkflow_tpu_torch.models.paged_decode import (
    init_page_pool,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
)
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.tpu.compiled_step import CompiledStep, DutyCycle, HostSet
from arkflow_tpu_torch.tpu.health import HEALTHY, HealthConfig
from arkflow_tpu_torch.tpu.serving_core import ServingRunnerCore, is_oom_error

logger = logging.getLogger("arkflow_torch.serving")

#: the tie margin of the parity rules: a top-2 logit gap at or below it
#: lets two correct attention paths pick different argmaxes
TIE_MARGIN = 0.05


class KernelParityError(ArkError):
    """The paged kernel disagreed with the gather path at init."""


@dataclass
class _Request:
    prompt: list[int]
    max_new_tokens: int
    future: asyncio.Future
    tokens: list[int] = field(default_factory=list)
    #: monotonic submit stamp for the TTFT samples
    submitted_at: float = 0.0
    ttft_stamped: bool = False
    #: top-2 logit gap of every step's logits (``record_margins``)
    margins: list[float] = field(default_factory=list)


@dataclass
class _Fetch:
    """One step's next tokens on their way to the host: the device tensor
    (fed straight into the next decode dispatch), and the host set whose
    output buffers receive them, the top-2 gaps (``record_margins``) and the
    top-k misses (``check_top_k``), with its event recorded right after the
    copies; ``misses`` receives the top-k misses."""

    nxt: torch.Tensor
    bufs: HostSet
    misses: Optional[Callable[[int], None]] = None

    def wait(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        out = self.bufs.outputs()
        if "topk_miss" in out and self.misses is not None:
            self.misses(int(out["topk_miss"].sum()))
        return out["nxt"], out.get("margin")


@dataclass
class _InFlightDecode:
    """One dispatched-but-unapplied decode step (``dispatch_depth`` 2).
    ``reqs`` snapshots per-slot request identity at dispatch: a slot whose
    request finished (or was replaced) between dispatch and apply drops its
    token instead of crediting it to the wrong request."""

    fetch: _Fetch
    act: np.ndarray
    reqs: list
    #: monotonic dispatch stamp: the fetch's deadline runs from it
    dispatched_at: float = 0.0


class _HostSets:
    """The persistent pinned host sets of one ``CompiledStep``, per (step
    key, depth slot), and whose turn the next decode step's slot is."""

    def __init__(self):
        self.by_key: dict[tuple, HostSet] = {}
        self.decode_turn = 0


@dataclass(frozen=True)
class _Bound:
    """What one step reads and writes, bound on the event loop before the
    step leaves it: the compiled step, its host sets and the KV pools. A
    rebuild or a reset replaces the server's, never a bound one's."""

    compiled: CompiledStep
    host: _HostSets
    k_pages: torch.Tensor
    v_pages: torch.Tensor


def _jax_leaf_order(tree: dict, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) of a param tree in the order JAX flattens a dict tree
    (keys sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _jax_leaf_order(v, (*path, k)) if isinstance(v, dict) else [((*path, k), v)]
    return out


class GenerationServer:
    """Continuous-batching decode over ``slots`` lockstep lanes: greedy, or
    sampled; with the prefix cache and speculative decoding on request."""

    def __init__(self, params: dict, cfg: DecoderConfig, *, slots: int = 8,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_seq: int = 512, eos_id: int = 2,
                 prompt_buckets: Optional[list[int]] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 prefill_chunk: int = 0, speculative_tokens: int = 0,
                 prefix_cache_pages: int = 0, mesh=None,
                 decode_kernel: str = "auto", kernel_parity_check: bool = True,
                 dispatch_depth: int = 1, step_deadline_s: Optional[float] = None,
                 step_deadline_first_s: Optional[float] = None,
                 health_config: Optional[HealthConfig] = None, name: str = "decoder_lm",
                 record_margins: bool = False, check_top_k: bool = False,
                 eager: bool = False):
        if mesh is not None:
            raise not_ported("GenerationServer mesh (tensor-parallel serving)")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_seq = int(max_seq)
        self.eos_id = int(eos_id)
        self.pages_per_slot = -(-self.max_seq // self.page_size)
        # page 0 is scratch; the default pool fits every slot at max_seq
        self.num_pages = num_pages or (1 + self.slots * self.pages_per_slot)
        if self.num_pages < 1 + self.pages_per_slot:
            raise ConfigError(
                f"num_pages={self.num_pages} cannot hold one sequence "
                f"({self.pages_per_slot} pages + scratch)")
        # always top out at max_seq so every admissible prompt has a bucket
        self.prompt_buckets = sorted(
            {b for b in (prompt_buckets or [32, 128]) if b <= self.max_seq} | {self.max_seq})
        self.k_pages, self.v_pages = init_page_pool(cfg, self.num_pages, self.page_size,
                                                    self.device)

        # chunked prefill: prompts longer than this admit in fixed-size chunks
        # interleaved with decode steps (0 = one-shot)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ConfigError("prefill_chunk must be >= 0")
        #: slot -> next absolute prefill offset (present while admitting)
        self._prefill_pos: dict[int, int] = {}
        self._turn_prefill = True  # alternate chunk/decode under contention

        # the prefix cache (0 = off; N = max cached pages): an LRU keyed by
        # the token prefix, of the FULL prompt pages finished requests donate
        self.prefix_cache_pages = int(prefix_cache_pages)
        if self.prefix_cache_pages < 0:
            raise ConfigError("prefix_cache_pages must be >= 0")
        self._prefix_cache: OrderedDict[tuple, list[int]] = OrderedDict()
        #: DISTINCT pages held by cache entries (page -> entry count): nested
        #: prefixes share pages, so capacity counts physical pages
        self._cache_pages: dict[int, int] = {}
        #: token lengths present in the cache (length -> entry count): a
        #: lookup probes only stored lengths
        self._prefix_lengths: dict[int, int] = {}

        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        #: the sampling key, split on the event loop per sampled step
        self._key = make_key(self.seed)
        self.check_top_k = bool(check_top_k)
        # speculative decoding: k - 1 drafts by 2-gram lookup, verified with
        # the current token in one chunk step; greedy only (acceptance
        # compares argmax)
        self.speculative_tokens = int(speculative_tokens)
        if self.speculative_tokens < 0:
            raise ConfigError("speculative_tokens must be >= 0")
        if self.speculative_tokens > 0 and self.temperature != 0.0:
            raise ConfigError(
                "speculative_tokens requires greedy decoding (temperature 0); "
                "sampled acceptance is not implemented")

        self._free_pages: list[int] = list(range(1, self.num_pages))
        self._page_refs: dict[int, int] = {}
        self._slot_req: list[Optional[_Request]] = [None] * self.slots
        self._slot_pages: list[list[int]] = [[] for _ in range(self.slots)]
        self._lengths = np.zeros(self.slots, np.int32)
        self._cur_tokens = np.zeros(self.slots, np.int32)
        self._pending: deque[_Request] = deque()
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False
        #: a hot swap is waiting for the slot grid to run dry: no admission
        self._draining = False

        self.decode_kernel = str(decode_kernel)
        if self.decode_kernel not in ("auto", "gather", "paged"):
            raise ConfigError(f"decode_kernel must be auto|gather|paged, got {decode_kernel!r}")
        if self.decode_kernel == "auto":
            self.decode_kernel = "paged" if self.device.type == "cuda" else "gather"

        # dispatch depth 2: step N+1 dispatches from step N's device-resident
        # tokens before N's are fetched. Greedy and dense only, as in the JAX
        # server: the host learns of an EOS one step late, so a finished lane
        # rides one more step and its token is dropped at apply (with MoE it
        # would take expert capacity from the other lanes).
        self.dispatch_depth = int(dispatch_depth)
        if self.dispatch_depth < 1:
            raise ConfigError("dispatch_depth must be >= 1")
        if self.dispatch_depth > 2:
            raise ConfigError(
                "dispatch_depth > 2 is not supported: lockstep decode can only lag "
                "host bookkeeping by one step")
        if self.dispatch_depth > 1:
            if self.temperature != 0.0:
                raise ConfigError(
                    "dispatch_depth > 1 requires greedy decoding "
                    "(temperature 0): a lane that finished at step N still "
                    "rides step N+1, which would consume sampling RNG")
            if self.speculative_tokens > 0:
                raise ConfigError(
                    "dispatch_depth > 1 and speculative_tokens are mutually "
                    "exclusive (both restructure the decode loop)")
            if cfg.num_experts > 0:
                raise ConfigError(
                    "dispatch_depth > 1 does not compose with MoE models: "
                    "a finished-but-still-riding lane consumes shared "
                    "expert capacity and changes other lanes' outputs")
        self._pipeline: Optional[_InFlightDecode] = None
        self.record_margins = bool(record_margins)
        #: one CUDA graph per step key (``eager``: none, for A/B runs)
        self._compiled = CompiledStep(self.device, eager=eager)
        #: persistent host buffers per (step key, depth slot)
        self._host = _HostSets()
        #: every step key captured so far: a rebuild captures them again
        self._warm_keys: list[tuple] = []
        self._retired_captures = 0
        self._register_metrics(name)
        self._duty = DutyCycle(idle_gap=self.m_idle_gap)

        #: the self-healing core: health, deadlines, chaos and rebuilds
        self.core = ServingRunnerCore(
            name=f"{name}[generate]", labels={"model": name, "path": "generate"},
            step_deadline_s=step_deadline_s,
            step_deadline_first_s=step_deadline_first_s, health_config=health_config,
            rebuild_fn=self._rebuild_after_incident)
        self.health = self.core.health

        #: counters (the JAX server's registry metrics)
        self.decode_steps = 0
        self.chunk_steps = 0
        self.prefill_steps = 0
        self.tokens = 0
        self.truncations = 0
        self.pipelined_dispatches = 0
        self.verify_steps = 0
        #: speculative drafts offered for verification, and accepted
        self.spec_drafted = 0
        self.spec_accepted = 0
        #: admissions that reused cached prefix pages, the pages they
        #: aliased, and cache entries evicted
        self.prefix_hits = 0
        self.prefix_pages_shared = 0
        self.prefix_evictions = 0
        #: picked tokens outside their step's top-k set (``check_top_k``)
        self.top_k_misses = 0
        #: steps dispatched to the device per kind (decode, chunk, prefill,
        #: verify): traffic, warmup and recapture steps, and abandoned steps
        #: that ran after all
        self.device_steps = dict.fromkeys(("decode", "chunk", "prefill", "verify"), 0)
        self._count_lock = threading.Lock()
        #: KV pools allocated anew after a deadline miss
        self.pool_renewals = 0
        #: steps that ran out of device memory
        self.ooms = 0
        #: ms of the last rebuild (new ``CompiledStep`` and recaptures)
        self.last_rebuild_ms: Optional[float] = None
        #: submit-to-first-token seconds, one per request
        self.ttft_samples: list[float] = []
        #: windowed generated tokens per second (the JAX ``m_tps`` gauge)
        self.tokens_per_sec = 0.0
        self._rate_window: Optional[tuple[float, int]] = None

        #: the parity gate's report (None when it did not run)
        self.parity_report: Optional[dict] = None
        if self.decode_kernel == "paged" and kernel_parity_check:
            self.parity_report = self.kernel_parity_check()

    def _register_metrics(self, name: str) -> None:
        """The JAX server's metric families, under its names and help."""
        reg = global_registry()
        self.m_steps = reg.counter("arkflow_gen_decode_steps_total", "lockstep decode steps")
        self.m_tokens = reg.counter("arkflow_gen_tokens_total", "tokens generated")
        self.m_spec_drafted = reg.counter(
            "arkflow_gen_spec_drafted_total", "draft tokens offered for verification")
        self.m_spec_accepted = reg.counter(
            "arkflow_gen_spec_accepted_total", "draft tokens accepted")
        self.m_active = reg.gauge("arkflow_gen_active_slots", "busy decode slots")
        self.m_waiting = reg.gauge("arkflow_gen_waiting_requests", "admission queue depth")
        self.m_truncated = reg.counter(
            "arkflow_gen_truncated_total",
            "requests cut short by page-pool exhaustion (pool undersized)")
        self.m_prefix_hits = reg.counter(
            "arkflow_gen_prefix_cache_hits_total", "admissions that reused cached prefix pages")
        self.m_prefix_pages = reg.counter(
            "arkflow_gen_prefix_pages_shared_total", "pages aliased from the prefix cache")
        self.m_slots_busy = reg.gauge(
            "arkflow_gen_slots_busy", "decode slots occupied (admitting + decoding)")
        self.m_pool_occupancy = reg.gauge(
            "arkflow_gen_page_pool_occupancy",
            "fraction of KV pages in use (scratch page excluded)")
        self.m_prefix_evictions = reg.counter(
            "arkflow_gen_prefix_cache_evictions_total",
            "prefix-cache entries evicted (LRU capacity or page pressure)")
        self.m_tps = reg.gauge(
            "arkflow_gen_tokens_per_sec",
            "windowed generation throughput (tokens/s over the serve loop)")
        self.m_idle_gap = reg.histogram(
            "arkflow_tpu_device_idle_gap_seconds",
            "gap between step N completing and step N+1 launching "
            "(device idle between consecutive steps)",
            {"model": name, "path": "generate"})
        self.m_depth = reg.gauge(
            "arkflow_gen_dispatch_depth",
            "configured decode dispatch depth (2 = pipelined)", {"model": name})
        self.m_depth.set(self.dispatch_depth)
        self.m_kernel_paged = reg.gauge(
            "arkflow_gen_decode_kernel_paged",
            "1 when the paged flash-attention kernel serves decode/chunk "
            "(0 = dense gather reference)", {"model": name})
        self.m_kernel_paged.set(1 if self.decode_kernel == "paged" else 0)
        self.m_ttft = reg.histogram(
            "arkflow_gen_ttft_seconds",
            "submit-to-first-decoded-token latency per request", {"model": name})

    def _update_gauges(self, busy: int) -> None:
        """The slot, queue and page-pool gauges, once a serve-loop pass."""
        self.m_active.set(busy)
        self.m_slots_busy.set(busy)
        self.m_waiting.set(len(self._pending))
        total = self.num_pages - 1
        if total:
            self.m_pool_occupancy.set((total - len(self._free_pages)) / total)

    # -- device plumbing ---------------------------------------------------

    def _on_device(self, arr) -> torch.Tensor:
        """A host array on the device, copied synchronously (the parity
        gate's inputs)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @property
    def captures(self) -> int:
        """Step keys captured, rebuilds' recaptures included: a CUDA graph
        each on CUDA; on the CPU or ``eager``, the key's static buffers."""
        return self._retired_captures + self._compiled.captures

    def replay_counts(self) -> dict:
        """Steps per step key after its capture (warmup included), on the
        current ``CompiledStep``."""
        return dict(self._compiled.replays)

    def duty_cycle(self) -> float:
        """The device queue's busy share since the first step, on the host
        clock: a step is busy from its dispatch until its tokens are
        fetched (or, for a chunk that is not its prompt's last, dispatched)."""
        return self._duty.share()

    @property
    def sampling(self) -> bool:
        return self.temperature > 0.0

    def _select(self, logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
        """The step's outputs, inside the graph: the pick (greedy, or drawn
        with the step's subkey ``key``), the top-2 logit gap with
        ``record_margins``, and with ``check_top_k`` the rows (``active``
        ones) whose pick lies outside the step's top-k set."""
        nxt = select_token(logits, key, self.temperature, self.top_k)
        out = {"nxt": nxt}
        if self.record_margins:
            top = logits.topk(2, dim=-1).values
            out["margin"] = top[:, 0] - top[:, 1]
        if self.check_top_k:
            picked = logits.gather(1, nxt.long()[:, None])[:, 0]
            if self.top_k > 0:
                kth = logits.topk(min(self.top_k, logits.shape[-1]), dim=-1).values[:, -1]
                miss = picked < kth
            else:  # no top-k filter: any finite logit may be drawn
                miss = ~torch.isfinite(picked)
            if active is not None:
                miss = miss & active
            out["topk_miss"] = miss.to(torch.int32).sum().reshape(1)
        return out

    def _note_top_k_misses(self, n: int) -> None:
        with self._count_lock:
            self.top_k_misses += n

    def _sample_input(self, key: Optional[int]) -> dict[str, np.ndarray]:
        """The step's subkey input (sampling servers only; zeros when the
        step draws nothing, as at a capture or a chunk that is not its
        prompt's last)."""
        if not self.sampling:
            return {}
        return {"key": key_words(0 if key is None else key)}

    def _split(self) -> Optional[int]:
        """A subkey of the server's key, split on the event loop (sampling
        servers only)."""
        if not self.sampling:
            return None
        self._key, sub = split_key(self._key)
        return sub

    def _bound(self) -> _Bound:
        return _Bound(self._compiled, self._host, self.k_pages, self.v_pages)

    def _dispatch(self, key: tuple, fn: Callable, arrays: dict[str, np.ndarray],
                  bound: _Bound, slot: int = 0, **on_device: torch.Tensor) -> _Fetch:
        """Enqueue one compiled step (no synchronisation): ``arrays`` into
        the key's persistent pinned set for ``slot``, once that set's last
        copies are done; ``on_device`` tensors stand in for the set's
        inputs of the same name."""
        bufs = bound.host.by_key.get((key, slot))
        if bufs is None:
            bufs = bound.host.by_key[(key, slot)] = HostSet(
                key, {n: (a.shape, a.dtype) for n, a in arrays.items()},
                pinned=self.device.type == "cuda")
        bufs.wait()
        for name, a in arrays.items():
            bufs.arrays[name][...] = a
        with self._count_lock:
            self.device_steps[key[0]] += 1
        step = bound.compiled.run(key, fn, {**bufs.inputs, **on_device},
                                  out=bufs.out, event=bufs.event)
        bufs.take(step)
        return _Fetch(step.result["nxt"], bufs, self._note_top_k_misses)

    async def _run_device_step(self, key: tuple, step: Callable[[_Bound], object],
                               track: bool = True):
        """One health-gated step (the JAX server's ``_run_device_step``):
        the core's heal gate (DEAD and CORRUPT raise; UNHEALTHY waits out
        the backoff, claims the probe and rebuilds first), the state bound
        here on the loop, then ``step(bound)`` on an executor thread under
        inference mode after the chaos hook, under ``deadline_for(first)``
        when deadlines are on; with ``track``, as one busy span of the duty
        cycle. A miss raises (the core marked the server UNHEALTHY and
        scheduled the rebuild); any other failure marks it UNHEALTHY."""
        core = self.core
        await core.heal_gate()
        bound = self._bound()
        deadline = core.deadline_for(key not in bound.compiled)

        def blocking():
            core.apply_chaos()
            with torch.inference_mode():
                return step(bound)

        if track:
            self._duty.dispatch(time.perf_counter())
        try:
            if deadline is None:
                out = await asyncio.get_running_loop().run_in_executor(None, blocking)
            else:
                out = await core.run_deadlined(blocking, deadline)
        except StepDeadlineExceeded:
            raise
        except Exception as e:
            self._note_failure(e)
            raise
        finally:
            # an abandoned step counts complete: the reset starts over
            if track:
                self._duty.complete(time.perf_counter())
        core.health.mark_success()
        return out

    def _note_failure(self, e: Exception) -> None:
        """A step that raised (not a deadline miss): counted when it ran out
        of device memory, and the server marked UNHEALTHY, as in JAX."""
        if is_oom_error(e):
            self.ooms += 1
        self.core.health.mark_unhealthy(f"generate step failed: {e}")

    def _decode_key(self, kernel: Optional[str] = None) -> tuple:
        return ("decode", kernel or self.decode_kernel)

    def _chunk_key(self, width: Optional[int] = None, kernel: Optional[str] = None) -> tuple:
        return ("chunk", width or self.prefill_chunk, kernel or self.decode_kernel)

    def _verify_key(self, kernel: Optional[str] = None) -> tuple:
        return ("verify", self.speculative_tokens + 1, kernel or self.decode_kernel)

    def _decode(self, cur, lens: np.ndarray, act: np.ndarray, table: np.ndarray,
                bound: Optional[_Bound] = None, kernel: Optional[str] = None,
                key: Optional[int] = None) -> _Fetch:
        """Dispatch one lockstep decode step (no synchronisation). ``cur``:
        the slots' tokens, on the host or on the device (a pipelined step's
        next tokens, copied into the graph's static input in stream order);
        the decode sets alternate over the depth's slots."""
        bound = bound or self._bound()
        step_key = self._decode_key(kernel)
        kp, vp = bound.k_pages, bound.v_pages

        def fn(token_ids, lengths, active, page_table, key=None):
            logits, _, _ = paged_decode_step(
                self.params, self.cfg, token_ids, lengths, active, page_table,
                kp, vp, return_logits=True, attention_kernel=step_key[1])
            return self._select(logits, key, active)

        sets = bound.host
        slot, sets.decode_turn = sets.decode_turn, (sets.decode_turn + 1) % self.dispatch_depth
        on_device = {"token_ids": cur} if isinstance(cur, torch.Tensor) else {}
        # a device ``cur`` stands in for the set's token ids, whose host
        # copy then carries the host state unused
        host_cur = self._cur_tokens if on_device else cur
        return self._dispatch(step_key, fn,
                              {"token_ids": host_cur, "lengths": lens, "active": act,
                               "page_table": table, **self._sample_input(key)},
                              bound, slot, **on_device)

    def _prefill(self, ids: np.ndarray, n: int, table: np.ndarray,
                 bound: Optional[_Bound] = None, key: Optional[int] = None) -> _Fetch:
        bound = bound or self._bound()
        kp, vp = bound.k_pages, bound.v_pages

        def fn(input_ids, lengths, page_table, key=None):
            logits, _, _ = paged_prefill(self.params, self.cfg, input_ids, lengths, page_table,
                                         kp, vp, return_logits=True)
            return self._select(logits, key)

        return self._dispatch(("prefill", ids.shape[1]), fn,
                              {"input_ids": ids, "lengths": np.asarray([n], np.int32),
                               "page_table": table, **self._sample_input(key)}, bound)

    def _chunk(self, ids: np.ndarray, off: int, clen: int, table: np.ndarray,
               final: bool, bound: Optional[_Bound] = None,
               kernel: Optional[str] = None, key: Optional[int] = None) -> Optional[_Fetch]:
        bound = bound or self._bound()
        step_key = self._chunk_key(ids.shape[1], kernel)
        kp, vp = bound.k_pages, bound.v_pages

        def fn(input_ids, chunk_off, chunk_len, page_table, key=None):
            logits, _, _ = paged_prefill_chunk(
                self.params, self.cfg, input_ids, chunk_off, chunk_len, page_table,
                kp, vp, attention_kernel=step_key[2])
            return self._select(logits, key)

        fetch = self._dispatch(step_key, fn,
                               {"input_ids": ids, "chunk_off": np.asarray([off], np.int32),
                                "chunk_len": np.asarray([clen], np.int32),
                                "page_table": table, **self._sample_input(key)}, bound)
        return fetch if final else None

    def _verify(self, ids: np.ndarray, lens: np.ndarray, clen: np.ndarray, table: np.ndarray,
                bound: Optional[_Bound] = None, kernel: Optional[str] = None) -> _Fetch:
        """Dispatch one speculative verify step over every slot: each slot's
        ``clen`` tokens (its current one, then its drafts) scored at its
        length in one chunk call; the argmax (and the top-2 gap) at every
        position, [slots, k]."""
        bound = bound or self._bound()
        step_key = self._verify_key(kernel)
        kp, vp = bound.k_pages, bound.v_pages

        def fn(input_ids, chunk_off, chunk_len, page_table):
            logits, _, _ = paged_prefill_chunk(
                self.params, self.cfg, input_ids, chunk_off, chunk_len, page_table,
                kp, vp, return_all=True, attention_kernel=step_key[2])
            s, k, v = logits.shape
            out = self._select(logits.reshape(s * k, v))
            return {name: t.reshape(s, k) for name, t in out.items() if name != "topk_miss"}

        return self._dispatch(step_key, fn, {"input_ids": ids, "chunk_off": lens,
                                             "chunk_len": clen, "page_table": table}, bound)

    def _one_shot_buckets(self) -> list[int]:
        """The prompt buckets a one-shot prefill can take: with chunking,
        only prompts of at most ``prefill_chunk`` tokens admit in one shot."""
        b = self.prompt_buckets
        return [x for i, x in enumerate(b)
                if not self.prefill_chunk or i == 0 or b[i - 1] < self.prefill_chunk]

    def _chunk_widths(self) -> list[int]:
        """The widths a chunk step can take: the prefill chunk; or, with the
        prefix cache and no chunking, a cached prompt's remainder in one
        bucketed span (every prompt bucket)."""
        if self.prefill_chunk:
            return [self.prefill_chunk]
        return list(self.prompt_buckets) if self.prefix_cache_pages else []

    def warmup(self) -> int:
        """Capture every step graph before traffic: decode (or, speculative,
        verify), every chunk width and every one-shot prefill bucket.
        Returns the number of keys captured (0 with ``eager``)."""
        if self._compiled.eager:
            return 0
        keys = [self._verify_key() if self.speculative_tokens else self._decode_key()]
        keys += [self._chunk_key(w) for w in self._chunk_widths()]
        keys += [("prefill", b) for b in self._one_shot_buckets()]
        self._capture_keys(keys, self._bound())
        logger.info("generation server: %d step keys captured", len(keys))
        return len(keys)

    def _capture_keys(self, keys: list[tuple], bound: _Bound) -> None:
        """One step at each key on ``bound`` (its first there: the capture),
        on inactive lanes and zero lengths, so every write lands in the
        scratch page 0; not traffic."""
        s = self.slots
        table = np.zeros((s, self.pages_per_slot), np.int32)
        zeros = np.zeros(s, np.int32)
        with torch.inference_mode():
            fetches = []
            for key in keys:
                if key[0] == "decode":
                    fetches.append(self._decode(zeros, zeros, np.zeros(s, bool), table, bound,
                                                kernel=key[1]))
                elif key[0] == "chunk":
                    fetches.append(self._chunk(np.zeros((1, key[1]), np.int32), 0, 0, table[:1],
                                               True, bound, kernel=key[2]))
                elif key[0] == "verify":
                    fetches.append(self._verify(np.zeros((s, key[1]), np.int32), zeros, zeros,
                                                table, bound, kernel=key[2]))
                else:
                    fetches.append(self._prefill(np.zeros((1, key[1]), np.int32), 0, table[:1],
                                                 bound))
            for fetch in fetches:
                fetch.wait()
        self._warm_keys += [k for k in keys if k not in self._warm_keys]

    def kernel_parity_check(self) -> dict:
        """Init-time parity gate of the paged kernel (a port of the JAX
        server's ``_paged_kernel_parity_ok``): one tiny golden batch --
        a prompt that crosses a page boundary and a one-token prompt, on
        non-contiguous page tables -- through prefill, then one decode step
        and one 2-token chunk with both attention paths. Every argmax must
        agree with the gather path's wherever its top-2 gap exceeds
        ``TIE_MARGIN`` (at a large vocabulary random weights give near-ties
        that two correct summation orders may break differently). An MoE
        model's paged steps replay the gather steps' expert routing
        (``decoder.RoutingTrace``): a near-tied router choice that the two
        paths' rounding flips would move the logits far past any margin;
        the decisions that would have flipped are reported
        (``routing_flips``). Raises ``KernelParityError`` on a mismatch;
        never falls back."""
        cfg, page = self.cfg, self.page_size
        n0 = min(page + 1, self.max_seq)
        pages_per = -(-(n0 + 3) // page)
        kp, vp = init_page_pool(cfg, 1 + 2 * pages_per, page, self.device)
        rng = np.random.RandomState(1234)
        ids = np.zeros((2, n0), np.int32)
        ids[0] = rng.randint(1, cfg.vocab_size, n0)
        ids[1, 0] = rng.randint(1, cfg.vocab_size)
        table = np.zeros((2, pages_per), np.int32)
        table[0] = np.arange(1, 2 * pages_per, 2)[::-1]
        table[1] = np.arange(2, 2 * pages_per + 1, 2)
        dev = self._on_device
        lens, tab = dev(np.asarray([n0, 1], np.int32)), dev(table)
        report = {"rows_checked": 0, "rows_tied": 0, "mismatches": 0, "max_logit_abs_diff": 0.0}

        def compare(ref: torch.Tensor, got: torch.Tensor) -> None:
            ref, got = ref.reshape(-1, ref.shape[-1]), got.reshape(-1, got.shape[-1])
            top = ref.topk(2, dim=-1).values
            clear = (top[:, 0] - top[:, 1]) > TIE_MARGIN
            agree = ref.argmax(-1) == got.argmax(-1)
            report["rows_checked"] += int(clear.sum())
            report["rows_tied"] += int((~clear).sum())
            report["mismatches"] += int((clear & ~agree).sum())
            report["max_logit_abs_diff"] = max(report["max_logit_abs_diff"],
                                               float((ref - got).abs().max()))
            if not bool(torch.isfinite(got).all()):
                report["mismatches"] += 1

        moe = cfg.num_experts > 1
        traces = []

        def both(step) -> tuple[torch.Tensor, torch.Tensor]:
            """``step`` on the gather path, then on the paged one with the
            gather run's routing held (MoE)."""
            trace = RoutingTrace() if moe else None
            with holding_routing(trace):
                ref = step("gather")
            with holding_routing(trace and trace.replay()):
                got = step("paged")
            traces.append(trace)
            return ref, got

        with torch.inference_mode():
            paged_prefill(self.params, cfg, dev(ids), lens, tab, kp, vp)
            tok, act = dev(ids[:, 0].copy()), dev(np.asarray([True, True]))
            compare(*both(lambda kernel: paged_decode_step(
                self.params, cfg, tok, lens, act, tab, kp, vp, return_logits=True,
                attention_kernel=kernel)[0]))
            cids = dev(rng.randint(1, cfg.vocab_size, (2, 2)).astype(np.int32))
            clen = dev(np.asarray([2, 2], np.int32))
            compare(*both(lambda kernel: paged_prefill_chunk(
                self.params, cfg, cids, lens, clen, tab, kp, vp, return_all=True,
                attention_kernel=kernel)[0]))
        if moe:
            report["routing_flips"] = sum(t.flips() for t in traces)
        if report["mismatches"]:
            raise KernelParityError(
                f"the paged attention kernel disagrees with the gather path at init: {report}")
        return report

    # -- incidents ---------------------------------------------------------

    def _rebuild_after_incident(self) -> None:
        """The core's rebuild (the probe's heal gate, after a deadline
        miss): graphs replayed across a hung step are not trusted. A new
        ``CompiledStep`` (fresh lock, side stream, static buffers and graph
        pool) and new host sets take the old ones' place, which are left to
        the zombie and dropped when it ends; every warmed key is captured
        again over the current pools (the ones the miss's reset allocated),
        under the first-step deadline. Runs on an executor thread; a
        failure leaves the server UNHEALTHY with the rebuild re-armed."""
        old = self._compiled
        self._compiled = CompiledStep(self.device, eager=old.eager)
        self._host = _HostSets()
        self._retired_captures += old.captures
        # a copy of the dict is atomic under the GIL: a zombie first step
        # may still be adding its key to it
        keys = self._warm_keys + [k for k in list(old._entries) if k not in self._warm_keys]
        del old
        t0 = time.perf_counter()
        bound = self._bound()
        deadline = self.core.deadline_for(True)
        if deadline is None:
            self._capture_keys(keys, bound)
        else:
            self.core.run_deadlined_sync(lambda: self._capture_keys(keys, bound),
                                         deadline * max(1, len(keys)))
        self.last_rebuild_ms = (time.perf_counter() - t0) * 1e3
        logger.warning("generation server rebuilt its compiled steps after a deadline miss: "
                       "%d keys captured again", len(keys))

    def _reset_device_state(self, zombie: bool) -> None:
        """The serve loop's reset after a failed or abandoned step (every
        request was failed first): a clean page ledger, the un-applied
        pipeline record dropped, and pools no step can still write. With a
        ``zombie`` (a deadline miss) new pools are allocated, the old ones
        left to it; the rebuild then captures over the new ones. Otherwise
        the pools are zeroed in place, after every step already enqueued."""
        self._pipeline = None
        self._clear_pages()
        if zombie:
            self.k_pages, self.v_pages = init_page_pool(self.cfg, self.num_pages,
                                                        self.page_size, self.device)
            self.pool_renewals += 1
        else:
            with torch.no_grad():
                self.k_pages.zero_()
                self.v_pages.zero_()

    # -- hot swap and chaos (tpu/swap.py, tpu/integrity.py) -----------------

    async def swap_params(self, placed: dict, drain_timeout_s: float = 30.0, *,
                          retain: bool = True) -> Optional[dict]:
        """Serve ``placed`` with no request dropped: admission pauses
        (queued requests wait), the slot grid and the depth-2 pipeline run
        dry, then the tree is copied into the live tensors and both pools
        are zeroed, in place on the step stream under the step lock (the
        graphs keep their addresses and no capture runs again), and the
        page ledger is reset. Returns the prior tree as a copy (the
        rollback token, ``retain``). Raises ``SwapError``, the old weights
        serving, when the grid does not drain within ``drain_timeout_s``."""
        self._draining = True
        try:
            end = time.monotonic() + drain_timeout_s
            while self._pipeline is not None or any(r is not None for r in self._slot_req):
                if time.monotonic() >= end:
                    busy = sum(1 for r in self._slot_req if r is not None)
                    raise SwapError(f"slot grid did not drain within {drain_timeout_s:.3g}s "
                                    f"({busy} slots still busy); old params still serving")
                await asyncio.sleep(0.01)
            compiled = self._compiled

            def flip() -> Optional[dict]:
                old = compiled.copy_params_(self.params, placed, retain=retain)
                compiled.zero_(self.k_pages, self.v_pages)
                return old

            old = await asyncio.get_running_loop().run_in_executor(None, flip)
            self._clear_pages()
            return old
        finally:
            self._draining = False

    def inject_step_fault(self, kind: str, duration_s: float = 0.0) -> None:
        """Arm a chaos fault (the fault plugin's processor wrapper): ``hang``
        and ``oom`` on the next step, in the core; ``bitflip`` corrupts the
        largest float leaf of the live tree in place. ``sdc`` raises: the
        token is picked on the device, so garbling host outputs would not
        model a corrupt device."""
        if kind == "sdc":
            raise ConfigError(
                "chaos: 'sdc' is not supported on the generation server — "
                "decode argmax/sampling happens on device, so host-side "
                "output corruption would be a lie; arm 'bitflip' instead")
        if kind == "bitflip":
            self._bitflip_params()
            return
        self.core.inject_step_fault(kind, duration_s)

    def bitflip_leaf(self) -> str:
        """The ``keystr`` path of the leaf a ``bitflip`` garbles: the first
        largest float leaf in JAX's flatten order, as JAX's
        ``_bitflip_params`` picks it."""
        from arkflow_tpu_torch.tpu.integrity import keystr

        best = None
        for path, leaf in _jax_leaf_order(self.params):
            if leaf.is_floating_point() and leaf.numel() and (
                    best is None or leaf.numel() > best[1].numel()):
                best = (path, leaf)
        if best is None:
            raise ConfigError("bitflip: model has no float param leaf to corrupt")
        return keystr(best[0])

    def _bitflip_params(self) -> None:
        """Write ``x * -1000 + 3.7`` (computed in float32) into the
        ``bitflip_leaf`` in place, on the step stream under the step lock.
        Nothing on the serving path notices by itself: only the integrity
        monitor's digests and golden probe can."""
        from arkflow_tpu_torch.tpu.integrity import flatten

        path = self.bitflip_leaf()
        leaf = flatten(self.params)[path]
        garbled = (leaf.float() * -1000.0 + 3.7).to(leaf.dtype)
        self._compiled.copy_params_({"leaf": leaf}, {"leaf": garbled})
        logger.warning("chaos: bitflip corrupted generation param leaf %s", path)

    def health_report(self) -> dict:
        """JSON-able snapshot for the engine's ``/health``: the core's report
        and the JAX server's serving keys, then the port's captures, rebuild,
        pool and OOM counters."""
        rep = self.core.health_report()
        total = self.num_pages - 1
        rep.update(
            serving="continuous", decode_kernel=self.decode_kernel,
            dispatch_depth=self.dispatch_depth, draining=self._draining, slots=self.slots,
            slots_busy=sum(1 for r in self._slot_req if r is not None),
            page_pool_occupancy=(round((total - len(self._free_pages)) / total, 4)
                                 if total else 0.0),
            prefix_cache={"entries": len(self._prefix_cache), "pages": self._cache_held,
                          "capacity_pages": self.prefix_cache_pages},
            tokens_per_sec=round(self.tokens_per_sec, 1))
        if self.ttft_samples:
            rep["ttft"] = {"count": len(self.ttft_samples),
                           "p50_ms": round(self.ttft_ms(0.5), 3),
                           "p99_ms": round(self.ttft_ms(0.99), 3)}
        rep.update(captures=self.captures, last_rebuild_ms=self.last_rebuild_ms,
                   pool_renewals=self.pool_renewals, ooms=self.ooms)
        return rep

    # -- public API --------------------------------------------------------

    async def generate(self, prompt_ids: list[int], max_new_tokens: int = 64, *,
                       with_margins: bool = False):
        """Submit one request; resolves with its generated ids (no EOS), or
        with (ids, top-2 logit gap of each step) when ``with_margins``
        (``record_margins`` servers only)."""
        if self._closed:
            raise ConfigError("generation server is closed")
        if with_margins and not self.record_margins:
            raise ConfigError("with_margins needs a server built with record_margins=True")
        if len(prompt_ids) == 0:
            return ([], []) if with_margins else []
        if len(prompt_ids) + max_new_tokens > self.max_seq:
            raise ConfigError(
                f"prompt({len(prompt_ids)}) + max_new({max_new_tokens}) exceeds "
                f"max_seq={self.max_seq}")
        req = _Request(list(prompt_ids), max_new_tokens,
                       asyncio.get_running_loop().create_future(),
                       submitted_at=time.monotonic())
        self._pending.append(req)
        self.m_waiting.set(len(self._pending))
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.create_task(self._serve_loop())
        tokens = await req.future
        return (tokens, list(req.margins)) if with_margins else tokens

    async def close(self) -> None:
        self._closed = True
        if self._loop_task is not None:
            await self._loop_task

    def release(self) -> None:
        """Free the server's device state for good: every graph with its
        pool and static buffers, the pinned host sets, the KV pools and the
        weights. The engine releases a crashed stream's server (after its
        close) before it builds the stream again, so a restart does not
        keep a second model and pool set on the card; the server serves
        nothing after."""
        self._closed = True
        self._compiled.clear()
        self._host = _HostSets()
        self._pipeline = None
        self._clear_pages()
        self.k_pages = self.v_pages = None
        self.params = {}

    def ttft_ms(self, q: float) -> Optional[float]:
        """The q-quantile (nearest rank) of the TTFT samples, in ms."""
        if not self.ttft_samples:
            return None
        ordered = sorted(self.ttft_samples)
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))] * 1e3

    # -- page accounting ---------------------------------------------------

    def _clear_pages(self) -> None:
        """Every page free (page 0 is scratch), no reference held, and the
        prefix cache flushed: its pages are zeroed or renewed with the
        pools, so a cached prefix would read as valid K/V that is not."""
        self._prefix_cache.clear()
        self._cache_pages.clear()
        self._prefix_lengths.clear()
        self._page_refs.clear()
        self._free_pages = list(range(1, self.num_pages))

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _alloc_page(self) -> Optional[int]:
        """One fresh page (ref 1); evicts LRU prefix entries under pressure."""
        while not self._free_pages:
            if not self._evict_one():
                return None
        p = self._free_pages.pop()
        self._page_refs[p] = 1
        return p

    def _ref_page(self, p: int) -> None:
        self._page_refs[p] += 1

    def _unref_page(self, p: int) -> None:
        self._page_refs[p] -= 1
        if self._page_refs[p] == 0:
            del self._page_refs[p]
            self._free_pages.append(p)

    @property
    def _cache_held(self) -> int:
        """Physical pages held by the prefix cache."""
        return len(self._cache_pages)

    def _evict_one(self) -> bool:
        """Drop the least recently used cache entry and its page refs."""
        if not self._prefix_cache:
            return False
        self.prefix_evictions += 1
        self.m_prefix_evictions.inc()
        key, pages = self._prefix_cache.popitem(last=False)
        self._prefix_lengths[len(key)] -= 1
        if self._prefix_lengths[len(key)] == 0:
            del self._prefix_lengths[len(key)]
        for p in pages:
            self._cache_pages[p] -= 1
            if self._cache_pages[p] == 0:
                del self._cache_pages[p]
            self._unref_page(p)
        return True

    def _lookup_prefix(self, prompt: list[int]) -> Optional[tuple]:
        """Key of the longest cached full-page prefix (no side effects). At
        least one prompt token is always left to prefill: the last
        position's logits seed generation."""
        if not self._prefix_cache:
            return None
        limit = ((len(prompt) - 1) // self.page_size) * self.page_size
        for length in sorted(self._prefix_lengths, reverse=True):
            if length > limit:
                continue
            key = tuple(prompt[:length])
            if key in self._prefix_cache:
                return key
        return None

    def _cache_prefix(self, req: _Request, pages: list[int]) -> None:
        """Donate the prompt's full pages to the cache (at finish, before
        the slot's refs drop)."""
        if not self.prefix_cache_pages:
            return
        count = min(len(req.prompt) // self.page_size, len(pages))
        if count == 0:
            return
        key = tuple(req.prompt[:count * self.page_size])
        if key in self._prefix_cache:
            self._prefix_cache.move_to_end(key)
            return
        held = pages[:count]
        for p in held:
            self._ref_page(p)
            self._cache_pages[p] = self._cache_pages.get(p, 0) + 1
        self._prefix_cache[key] = list(held)
        self._prefix_lengths[len(key)] = self._prefix_lengths.get(len(key), 0) + 1
        while self._cache_held > self.prefix_cache_pages:
            if not self._evict_one():
                break

    def _evictable_pages(self, keep: Optional[tuple]) -> int:
        """DISTINCT pages the cache could free by evicting every entry other
        than ``keep``: pages all of whose refs come from those entries."""
        keep_pages = set(self._prefix_cache.get(keep, ())) if keep is not None else set()
        counts: dict[int, int] = {}
        for key, pages in self._prefix_cache.items():
            if key == keep:
                continue
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        return sum(1 for p, c in counts.items()
                   if p not in keep_pages and self._page_refs.get(p) == c)

    def _reservable(self, req: _Request) -> Optional[tuple]:
        """(cache key or None, fresh pages needed) when every page the
        request's prompt and first decode write need can be had -- aliased
        prefix pages plus fresh ones, evicting other cache entries if need
        be -- else None. No side effects."""
        key = self._lookup_prefix(req.prompt)
        shared = len(self._prefix_cache[key]) if key is not None else 0
        fresh = self._pages_needed(len(req.prompt) + 1) - shared
        if len(self._free_pages) + self._evictable_pages(key) < fresh:
            return None
        return key, fresh

    def _try_reserve(self, req: _Request) -> Optional[tuple[list[int], int]]:
        """Reserve the request's pages: (pages, tokens of the shared prefix),
        or None without side effects (no eviction, no count) when the pool
        is short: a head-of-line stall must not wipe the cache."""
        plan = self._reservable(req)
        if plan is None:
            return None
        key, fresh = plan
        shared = list(self._prefix_cache[key]) if key is not None else []
        if key is not None:
            self._prefix_cache.move_to_end(key)
            for p in shared:
                self._ref_page(p)
        pages = list(shared)
        for _ in range(fresh):
            p = self._alloc_page()
            if p is None:  # not after the feasibility check
                for q in pages:
                    self._unref_page(q)
                return None
            pages.append(p)
        return pages, len(shared) * self.page_size

    # -- scheduler ---------------------------------------------------------

    def _table_array(self) -> np.ndarray:
        table = np.zeros((self.slots, self.pages_per_slot), np.int32)
        for s, pages in enumerate(self._slot_pages):
            table[s, :len(pages)] = pages
        return table

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    async def _admit_one(self, slot: int, req: _Request, pages: list[int],
                         shared_len: int) -> None:
        """Seed the slot with its reserved pages and start prefill: one shot,
        or in chunks from the cached prefix's boundary (``shared_len``) or
        from 0 when the prompt is longer than the prefill chunk."""
        # register FIRST: if anything below throws, the loop's crash handler
        # fails this future instead of leaving its caller hanging
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        n = len(req.prompt)
        if shared_len > 0:
            self.prefix_hits += 1
            self.prefix_pages_shared += shared_len // self.page_size
            self.m_prefix_hits.inc()
            self.m_prefix_pages.inc(shared_len // self.page_size)
        if shared_len > 0 or (self.prefill_chunk and n > self.prefill_chunk):
            # cooperative admission: the serve loop interleaves prefill
            # chunks with decode; the slot joins decode once fully prefilled
            self._prefill_pos[slot] = shared_len
            return
        ids = np.zeros((1, self._bucket(n)), np.int32)
        ids[0, :n] = req.prompt
        table = self._table_array()[slot:slot + 1]
        key = self._split()
        nxt, margin = await self._run_device_step(
            ("prefill", ids.shape[1]),
            lambda bound: self._prefill(ids, n, table, bound, key=key).wait())
        self.prefill_steps += 1
        self._lengths[slot] = n
        self._cur_tokens[slot] = nxt[0]
        self._handle_token(slot, int(nxt[0]), None if margin is None else float(margin[0]))

    def _stamp_ttft(self, req: _Request) -> None:
        if req.ttft_stamped:
            return
        req.ttft_stamped = True
        dt = time.monotonic() - req.submitted_at
        self.ttft_samples.append(dt)
        self.m_ttft.observe(dt)

    def _handle_token(self, slot: int, token: int, margin: Optional[float] = None) -> None:
        """Record one generated token; completes the request on EOS/limit."""
        req = self._slot_req[slot]
        if req is None:
            return
        self._stamp_ttft(req)
        if margin is not None:
            req.margins.append(margin)
        if token == self.eos_id:
            self._finish(slot)
            return
        req.tokens.append(token)
        self.tokens += 1
        self.m_tokens.inc()
        if len(req.tokens) >= req.max_new_tokens:
            self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        fully_prefilled = slot not in self._prefill_pos
        self._prefill_pos.pop(slot, None)
        if req is not None and fully_prefilled:
            # donate the prompt's full pages before the slot's refs drop
            self._cache_prefix(req, self._slot_pages[slot])
        for p in self._slot_pages[slot]:
            self._unref_page(p)
        self._slot_pages[slot] = []
        self._lengths[slot] = 0
        self._cur_tokens[slot] = 0
        if req is not None and not req.future.done():
            req.future.set_result(req.tokens)

    async def _prefill_one_chunk(self, slot: int) -> None:
        """One fixed-size prefill chunk for an admitting slot; seeds the slot
        for decode after the final chunk."""
        req = self._slot_req[slot]
        if req is None:
            self._prefill_pos.pop(slot, None)
            return
        off = self._prefill_pos[slot]
        n = len(req.prompt)
        # the prefill chunk, or (a cached prefix's remainder with chunking
        # off) one bucketed span covering the rest
        c = self.prefill_chunk if self.prefill_chunk else self._bucket(n - off)
        chunk = req.prompt[off:off + c]
        ids = np.zeros((1, c), np.int32)
        ids[0, :len(chunk)] = chunk
        table = self._table_array()[slot:slot + 1]
        new_off = off + len(chunk)
        final = new_off >= n
        # the final chunk samples the first generated token
        key = self._split() if final else None

        def step(bound: _Bound):
            fetch = self._chunk(ids, off, len(chunk), table, final, bound, key=key)
            return fetch.wait() if fetch is not None else None

        out = await self._run_device_step(self._chunk_key(c), step)
        self.chunk_steps += 1
        if not final:
            self._prefill_pos[slot] = new_off
            return
        del self._prefill_pos[slot]
        nxt, margin = out
        self._lengths[slot] = n
        self._cur_tokens[slot] = nxt[0]
        self._handle_token(slot, int(nxt[0]), None if margin is None else float(margin[0]))

    def _ensure_page_capacity(self, slot: int, total: Optional[int] = None) -> bool:
        """Grow the slot's page list to cover positions < ``total``
        (default: the next write position, lengths+1)."""
        if total is None:
            total = int(self._lengths[slot]) + 1
        need = self._pages_needed(total)
        while len(self._slot_pages[slot]) < need:
            p = self._alloc_page()
            if p is None:
                return False
            self._slot_pages[slot].append(p)
        return True

    def _reserve_or_truncate(self, s: int, act: np.ndarray) -> None:
        """Ensure slot ``s`` can write its next position; when the pool is
        dry, finish the longest active sequence (its tokens so far are its
        result) and retry, so the starved slot never scatters into the
        scratch page and corrupts its context."""
        while act[s] and not self._ensure_page_capacity(s):
            candidates = [i for i in range(self.slots)
                          if act[i] and self._slot_req[i] is not None]
            if not candidates:
                break
            longest = max(candidates, key=lambda i: int(self._lengths[i]))
            req = self._slot_req[longest]
            logger.warning(
                "page pool exhausted: truncating slot %d at %d tokens (%d/%d generated) "
                "-- size num_pages for the workload", longest, int(self._lengths[longest]),
                len(req.tokens) if req else 0, req.max_new_tokens if req else 0)
            self.truncations += 1
            self.m_truncated.inc()
            self._finish(longest)
            act[longest] = False

    async def _serve_loop(self) -> None:
        try:
            while not self._closed:
                admitted = await self._admit_pending()
                self._update_rate()
                prefilling = [s for s in range(self.slots)
                              if s in self._prefill_pos and self._slot_req[s]]
                active = [s for s in range(self.slots)
                          if self._slot_req[s] and s not in self._prefill_pos]
                self._update_gauges(len(active) + len(prefilling))
                if not active and not prefilling:
                    # a pipelined successor can outlive its lanes: apply it
                    # before idling or exiting
                    await self._drain_pipeline()
                    if not self._pending:
                        return  # drained; the next generate() restarts the loop
                    if not admitted:
                        await asyncio.sleep(0.01)  # waiting on pages
                    continue
                # interleave under contention: one prefill chunk, one decode step
                if prefilling and (not active or self._turn_prefill):
                    self._turn_prefill = False
                    await self._drain_pipeline()
                    await self._prefill_one_chunk(prefilling[0])
                    continue
                self._turn_prefill = True
                if self.speculative_tokens > 0:
                    await self._step_speculative(active)
                else:
                    await self._step(active)
            # closed with work in flight: fail it rather than hang awaiters
            self._fail_all(ConfigError("generation server closed"))
        except Exception as e:  # fail all in-flight requests, don't hang them
            logger.exception("generation serve loop failed")
            self._fail_all(e)
            self._reset_device_state(zombie=isinstance(e, StepDeadlineExceeded))

    def _update_rate(self) -> None:
        """The windowed tokens/s of ``health_report`` (the JAX ``m_tps``)."""
        now = time.monotonic()
        if self._rate_window is None:
            self._rate_window = (now, self.tokens)
            return
        t0, tok0 = self._rate_window
        if now - t0 >= 0.25:
            self.tokens_per_sec = (self.tokens - tok0) / (now - t0)
            self.m_tps.set(self.tokens_per_sec)
            self._rate_window = (now, self.tokens)

    def _fail_all(self, err: Exception) -> None:
        # the in-flight pipelined step dies with its requests: its tokens are
        # never applied
        if self._pipeline is not None:
            self._duty.complete(time.perf_counter())
        self._pipeline = None
        self._prefill_pos.clear()
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is not None and not req.future.done():
                req.future.set_exception(err)
            self._slot_req[s] = None
            # return the slot's pages: a crash must not shrink the pool
            for p in self._slot_pages[s]:
                self._unref_page(p)
            self._slot_pages[s] = []
            self._lengths[s] = 0
            self._cur_tokens[s] = 0
        while self._pending:
            req = self._pending.popleft()
            if not req.future.done():
                req.future.set_exception(err)

    async def _admit_pending(self) -> bool:
        """Admit queued requests into free slots, head of line first; none
        while a swap drains the grid. The pipeline is applied before a
        request leaves the queue, and its slot is registered before the
        next await, so a swap never sees a request in neither place."""
        admitted = False
        for slot in range(self.slots):
            if self._draining:
                break
            if self._slot_req[slot] is not None or not self._pending:
                continue
            if self._reservable(self._pending[0]) is None:
                break  # head-of-line waits for pages (FIFO fairness)
            # catch host state up before the admission prefill dispatches
            # (applying a step only frees pages and donates cached ones)
            await self._drain_pipeline()
            if self._draining:
                break
            reserved = self._try_reserve(self._pending[0])
            if reserved is None:
                break
            req = self._pending.popleft()
            await self._admit_one(slot, req, *reserved)
            admitted = True
        return admitted

    async def _step(self, active: list[int]) -> None:
        """One lockstep decode over all slots (inactive lanes masked); at
        ``dispatch_depth`` 2 the pipelined path runs instead, and this
        classic path only under page-pool pressure."""
        if self.dispatch_depth > 1 and await self._step_pipelined(active):
            return
        await self._drain_pipeline()
        # the drain may have finished requests in `active`: recompute from
        # host truth, or truncation would serve a ghost lane
        active = [s for s in active if self._slot_req[s] is not None]
        if not active:
            return
        act = np.zeros(self.slots, bool)
        act[active] = True
        for s in active:
            self._reserve_or_truncate(s, act)
        cur, lens, table = self._cur_tokens.copy(), self._lengths.copy(), self._table_array()
        key = self._split()
        nxt, margin = await self._run_device_step(
            self._decode_key(),
            lambda bound: self._decode(cur, lens, act, table, bound, key=key).wait())
        self.decode_steps += 1
        self.m_steps.inc()
        self._apply(nxt, margin, act, None)

    def _apply(self, nxt: np.ndarray, margin: Optional[np.ndarray], act: np.ndarray,
               reqs: Optional[list]) -> None:
        for s in range(self.slots):
            req = self._slot_req[s]
            if not act[s] or req is None or (reqs is not None and req is not reqs[s]):
                continue
            self._lengths[s] += 1
            self._cur_tokens[s] = nxt[s]
            self._handle_token(s, int(nxt[s]), None if margin is None else float(margin[s]))

    # -- pipelined dispatch (dispatch_depth 2) ---------------------------

    async def _step_pipelined(self, active: list[int]) -> bool:
        """Dispatch decode step N+1 from the in-flight step N's device
        tokens, THEN apply N. A lane whose pending token turns out to be EOS
        still rides N+1 and its token is dropped at apply; lanes whose
        budget the pending token exhausts are masked out up front. Returns
        False when the classic path should run: a cold decode key (its
        first step takes the first-step budget), a server that is not
        HEALTHY (probe steps take the gated path), or page-pool pressure
        (its truncation policy lives there)."""
        if self._decode_key() not in self._compiled or self.core.health.state != HEALTHY:
            await self._drain_pipeline()
            return False
        act = np.zeros(self.slots, bool)
        act[active] = True
        pend = self._pipeline
        eff_lens = self._lengths.copy()
        if pend is not None:
            eff_lens += pend.act.astype(np.int32)
            for s in active:
                req = self._slot_req[s]
                if req is None or (pend.act[s] and req is not pend.reqs[s]):
                    act[s] = False
                elif pend.act[s] and len(req.tokens) + 1 >= req.max_new_tokens:
                    act[s] = False
        if not act.any():
            # every lane finishes on the pending step: apply it and let the
            # loop re-evaluate (admission / drain / exit)
            await self._drain_pipeline()
            return True
        for s in np.flatnonzero(act):
            if not self._ensure_page_capacity(int(s), int(eff_lens[s]) + 1):
                await self._drain_pipeline()
                return False
        cur_host = self._cur_tokens.copy()
        table = self._table_array()
        bound = self._bound()

        def enqueue() -> _Fetch:
            cur = pend.fetch.nxt if pend is not None else cur_host
            with torch.inference_mode():
                return self._decode(cur, eff_lens, act, table, bound)

        # busy from this dispatch to its fetch in _apply_pipeline
        self._duty.dispatch(time.perf_counter())
        try:
            fetch = await asyncio.get_running_loop().run_in_executor(None, enqueue)
        except BaseException:
            self._duty.complete(time.perf_counter())
            raise
        self.pipelined_dispatches += 1
        # the new step is in flight before N is applied: a failure of N's
        # fetch drops both with their requests
        self._pipeline = _InFlightDecode(fetch=fetch, act=act, reqs=list(self._slot_req),
                                         dispatched_at=time.monotonic())
        if pend is not None:
            await self._apply_pipeline(pend)
        return True

    async def _drain_pipeline(self) -> None:
        """Fetch and apply the in-flight decode step, if any: every other
        event (admission, chunked prefill, a swap's drain, loop exit) runs
        against caught-up host state."""
        if self._pipeline is None:
            return
        pend, self._pipeline = self._pipeline, None
        await self._apply_pipeline(pend)

    async def _apply_pipeline(self, rec: _InFlightDecode) -> None:
        """Wait for one in-flight step's tokens (that step alone) after the
        chaos hook, under the warm deadline timed from the step's own
        dispatch, and apply them; a lane whose request finished or was
        replaced since dispatch drops its token."""
        core = self.core

        def blocking():
            core.apply_chaos()
            return rec.fetch.wait()

        deadline = core.deadline_for(False)
        try:
            if deadline is None:
                nxt, margin = await asyncio.get_running_loop().run_in_executor(None, blocking)
            else:
                nxt, margin = await core.run_deadlined(
                    blocking, core.deadline_remaining(deadline, rec.dispatched_at))
        except StepDeadlineExceeded:
            raise
        except Exception as e:
            self._note_failure(e)
            raise
        finally:
            self._duty.complete(time.perf_counter())
        core.health.mark_success()
        self.decode_steps += 1
        self.m_steps.inc()
        self._apply(nxt, margin, rec.act, rec.reqs)

    # -- speculative decode ------------------------------------------------

    @staticmethod
    def _draft(req: _Request, n: int) -> list[int]:
        """``n`` draft tokens by 2-gram lookup over the sequence's own
        history (prompt-lookup decoding): the tokens that followed the most
        recent earlier occurrence of the trailing bigram, padded with the
        last token. A wrong draft costs nothing: the slot's verify then
        degenerates to one decode."""
        hist = req.prompt + req.tokens
        out: list[int] = []
        if len(hist) >= 2 and n > 0:
            a, b = hist[-2], hist[-1]
            for i in range(len(hist) - 3, -1, -1):
                if hist[i] == a and hist[i + 1] == b:
                    out = hist[i + 2:i + 2 + n]
                    break
        while len(out) < n:
            out.append(hist[-1] if hist else 0)
        return out[:n]

    async def _step_speculative(self, active: list[int]) -> None:
        """One verify step: each active slot scores its current token and up
        to ``speculative_tokens`` drafts in one chunk call at its length;
        the argmax-consistent prefix all lands this step. Width-1 capacity
        comes first (the truncation policy of ``_step``); a slot widens only
        as far as free pages allow."""
        k = self.speculative_tokens + 1
        act = np.zeros(self.slots, bool)
        act[active] = True
        clen = np.zeros(self.slots, np.int32)
        ids = np.zeros((self.slots, k), np.int32)
        for s in active:
            self._reserve_or_truncate(s, act)
            if not act[s] or self._slot_req[s] is None:
                continue
            req = self._slot_req[s]
            remaining = req.max_new_tokens - len(req.tokens)
            room = self.max_seq - int(self._lengths[s])
            c = max(1, min(k, remaining, room))
            while c > 1 and not self._ensure_page_capacity(s, int(self._lengths[s]) + c):
                c -= 1
            clen[s] = c
            ids[s, 0] = self._cur_tokens[s]
            if c > 1:
                ids[s, 1:c] = self._draft(req, c - 1)
        lens, table = self._lengths.copy(), self._table_array()
        outs, margins = await self._run_device_step(
            self._verify_key(), lambda bound: self._verify(ids, lens, clen, table, bound).wait())
        self.verify_steps += 1
        self.m_steps.inc()
        for s in range(self.slots):
            if not act[s] or self._slot_req[s] is None or clen[s] == 0:
                continue
            c = int(clen[s])
            accepted = 0
            while accepted < c - 1 and ids[s, accepted + 1] == outs[s, accepted]:
                accepted += 1
            self.spec_drafted += c - 1
            self.spec_accepted += accepted
            self.m_spec_drafted.inc(c - 1)
            self.m_spec_accepted.inc(accepted)
            self._lengths[s] += accepted + 1
            self._cur_tokens[s] = int(outs[s, accepted])
            for j in range(accepted + 1):
                self._handle_token(s, int(outs[s, j]),
                                   None if margins is None else float(margins[s, j]))
                if self._slot_req[s] is None:
                    break
