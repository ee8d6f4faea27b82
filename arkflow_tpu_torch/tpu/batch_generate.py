"""Batched generation over the contiguous KV cache, as CUDA graphs.

The JAX package runs ``decoder.generate`` -- prefill, then a
``lax.while_loop`` of decode steps with an EOS early exit -- as one jit per
(batch bucket, seq bucket) (``arkflow_tpu/plugins/processor/
tpu_generate.py`` ``_generate_sync``). Here the same function is two
compiled steps per (batch bucket, seq bucket) on a ``CompiledStep``
(``tpu/compiled_step.py``) of its own:

- ``("prefill", batch, seq)``: zero the cache, prefill, pick the first
  token, reset the loop state and run loop step 0 (its emission). Its
  inputs: the token ids, the true lengths, ``n_real`` and the generation's
  subkeys (``decoder.generation_keys``: one per loop step, split on the
  host before the generation starts);
- ``("decode", batch, seq)``: one loop step after step 0 (decode at the
  top, pick with the step's subkey, emit). It takes no host input: the
  cursor, the lengths, ``done``, the counts, the token grid and the step
  live on the card in the key's workspace (``decoder.init_kv_cache`` and
  ``generation_state``), which both graphs read and write by address, so
  one graph serves every step of every generation of that shape.

The host loop replays the decode graph and learns ``all(done)`` through a
pinned, non-blocking copy of each step's flag. It reads the flag of the
step before the one in flight, so it never waits for the step it just
queued: a generation whose rows are all done after step s may run step
s + 1 as well, fully masked (every row done emits 0 into a zeroed column
and counts nothing), and never a step past ``max_new_tokens - 1``.
``steps`` lists the decode steps each generation ran.

Generations are serialised (one lock, held for the whole generation): the
workspaces are per shape, and a weight flip (``adopt``, the swap's
``BatchGenerateUnit``) copies into the live tensors between generations,
never inside one. ``eager=True`` runs every step op by op (A/B runs); on a
CPU device the same steps run on the same static buffers without capture.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from arkflow_tpu_torch.models import decoder as dec
from arkflow_tpu_torch.models.decoder import DecoderConfig
from arkflow_tpu_torch.tpu.compiled_step import CompiledStep


@dataclass
class _Workspace:
    """One (batch, seq) shape's device state, and the two pinned flag
    buffers (with their events) the host loop alternates over."""

    cache: dict
    state: dict
    keys: torch.Tensor
    flags: list


class BatchGenerator:
    """``decoder.generate`` per batch, one prefill and one decode graph per
    (batch bucket, seq bucket)."""

    def __init__(self, params: dict, cfg: DecoderConfig, *, max_new_tokens: int,
                 eos_id: int = 2, temperature: float = 0.0, top_k: int = 0,
                 eager: bool = False):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self._sample = dict(eos_id=self.eos_id, temperature=float(temperature),
                            top_k=int(top_k))
        self._compiled = CompiledStep(self.device, eager=eager)
        self._spaces: dict[tuple[int, int], _Workspace] = {}
        self._lock = threading.Lock()
        #: generations run, and the decode steps each ran (newest last)
        self.generations = 0
        self.steps: list[int] = []
        #: decode steps run in all (traffic, warmup and probes)
        self.decode_steps = 0

    @property
    def captures(self) -> int:
        """Graphs captured (on the CPU or eager: shape keys built)."""
        return self._compiled.captures

    def replay_counts(self) -> dict:
        return dict(self._compiled.replays)

    def _space(self, b: int, t: int) -> _Workspace:
        ws = self._spaces.get((b, t))
        if ws is None:
            cuda = self.device.type == "cuda"
            flags = [({"all_done": torch.zeros(1, dtype=torch.bool, pin_memory=cuda)},
                      torch.cuda.Event() if cuda else None) for _ in range(2)]
            ws = self._spaces[(b, t)] = _Workspace(
                cache=dec.init_kv_cache(self.cfg, b, t + self.max_new_tokens, self.device),
                state=dec.generation_state(b, self.max_new_tokens, self.device),
                keys=torch.zeros(self.max_new_tokens + 1, 2, dtype=torch.int64,
                                 device=self.device),
                flags=flags)
        return ws

    def _run(self, key: tuple, fn, inputs: dict, ws: _Workspace, turn: int):
        out, event = ws.flags[turn % 2]
        step = self._compiled.run(key, fn, inputs, out=out, event=event)
        return step.out, step.event

    def generate(self, input_ids: np.ndarray, lengths: np.ndarray, n_real: int,
                 key: int) -> tuple[np.ndarray, np.ndarray, int]:
        """One generation over a padded batch (``input_ids`` [B, T] int32,
        ``lengths`` [B]; rows at or past ``n_real`` are padding): the first
        ``n_real`` rows' tokens [n_real, max_new_tokens] (zero after EOS)
        and counts, and the decode steps it ran."""
        tokens, counts, steps = self._generate(input_ids, lengths, n_real, key,
                                               self.max_new_tokens - 1)
        self.generations += 1
        self.steps.append(steps)
        return tokens, counts, steps

    def _generate(self, input_ids: np.ndarray, lengths: np.ndarray, n_real: int, key: int,
                  max_steps: int) -> tuple[np.ndarray, np.ndarray, int]:
        b, t = input_ids.shape
        keys = torch.from_numpy(dec.generation_keys(key, self.max_new_tokens))
        inputs = {"input_ids": torch.from_numpy(np.ascontiguousarray(input_ids, np.int32)),
                  "lengths": torch.from_numpy(np.ascontiguousarray(lengths, np.int32)),
                  "n_real": torch.tensor([int(n_real)], dtype=torch.int32), "keys": keys}
        with self._lock, torch.inference_mode():
            ws = self._space(b, t)
            params, cfg, cache, state, sample = (self.params, self.cfg, ws.cache, ws.state,
                                                 self._sample)

            def start(input_ids, lengths, n_real, keys):
                ws.keys.copy_(keys)
                dec.start_generation(params, cfg, input_ids, lengths, n_real, ws.keys, cache,
                                     state, **sample)
                return {"all_done": state["done"].all().reshape(1)}

            def step():
                dec.continue_generation(params, cfg, ws.keys, cache, state, **sample)
                return {"all_done": state["done"].all().reshape(1)}

            pending = [self._run(("prefill", b, t), start, inputs, ws, 0)]
            steps = 0
            while steps < max_steps:
                if len(pending) == 2:
                    # the flag of the step before the one in flight
                    flag, event = pending.pop(0)
                    if event is not None:
                        event.synchronize()
                    if bool(flag["all_done"][0]):
                        break
                steps += 1
                pending.append(self._run(("decode", b, t), step, {}, ws, steps))
            tokens = state["out"][:n_real].cpu().numpy()
            counts = state["counts"][:n_real].cpu().numpy()
            self.decode_steps += steps
        return tokens, counts, steps

    def warmup(self, shapes: Iterable[tuple[int, int]]) -> int:
        """Capture the prefill and decode graphs of every (batch, seq) shape
        in ``shapes`` before traffic: a one-token prompt per row at key 0,
        prefill and one decode step (not counted as generations). Returns
        the number of shapes warmed (0 with ``eager``)."""
        if self._compiled.eager:
            return 0
        shapes = list(shapes)
        for b, t in shapes:
            self._generate(np.ones((b, t), np.int32), np.ones(b, np.int32), b,
                           dec.make_key(0), min(1, self.max_new_tokens - 1))
        return len(shapes)

    def release(self) -> None:
        """Free the generator's device state for good: every graph with its
        pool and static buffers, the KV caches and states of every shape,
        and the weights (a crashed stream's, before the engine builds the
        stream again). The generator serves nothing after."""
        with self._lock:
            self._compiled.clear()
            self._spaces.clear()
            self.params = {}

    def adopt(self, placed: dict, retain: bool = True) -> Optional[dict]:
        """Copy the tree ``placed`` into the live tensors the graphs read
        (``CompiledStep.copy_params_``), between generations; returns the
        prior tree (a copy) with ``retain``."""
        with self._lock:
            return self._compiled.copy_params_(self.params, placed, retain=retain)
