"""Continuous-batching inference server (counterpart of the core of
`mxnet_tpu/serving/server.py`).

The scheduling model is the standard continuous-batching loop (Orca /
vLLM):

- `submit()` enqueues a request (prompt, per-request sampling params,
  max_new_tokens), FIFO by submission.
- every `step()` (one decode tick):
    1. ADMIT: while a batch slot and enough KV blocks are free, pop the
       queue head, allocate its blocks, run the prefill (batch 1, padded
       to `max_prompt_len`), and seed the slot's logits and generator.
    2. ENSURE: allocate each running slot's next block when its write
       position crosses a block boundary. Pool exhausted -> preempt the
       youngest running request (free its blocks, re-queue it at the
       front; it regenerates identically, its generator re-seeded).
    3. DECODE: one decode tick for ALL slots (sample the previous
       logits, one paged-attention step, write the new KV rows).
    4. EVICT: finished rows (eos or max_new_tokens) free their blocks
       and slots in the same tick.

Robustness: per-request deadlines (status ``timed_out``), a preemption
retry cap (``preempted``), a watchdog raising :class:`ServerStalledError`
after `watchdog_ticks` ticks without progress, `cancel()`
(``cancelled``), and `drain()` / `shutdown()` (stragglers ``rejected``).

`kv_cache_dtype="int8"` keeps the pool as int8 codes with per-token fp32
scales (about half the bytes of a bf16 pool), read by the int8 paged
decode kernel.

Not ported yet: the prefix cache, chunked prefill, speculative decoding,
LoRA and tenants, the KV tier, per-request traces and every telemetry,
flight, goodput and fault hook.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..context import check_weights_on, resolve_device
from ..models.llama_infer import _params_tree
from . import executables
from .kv_cache import PagedKVCache

__all__ = ["Request", "InferenceServer", "ServerStalledError"]

_QUEUED, _RUNNING, _FINISHED = "queued", "running", "finished"
#: terminal statuses — set exactly once when a request leaves the system
_OK, _TIMED_OUT, _PREEMPTED, _REJECTED, _CANCELLED = \
    "ok", "timed_out", "preempted", "rejected", "cancelled"


class ServerStalledError(RuntimeError):
    """The decode loop made no progress for `watchdog_ticks` ticks while
    work was pending. Raised out of step()/run() so a supervisor can
    restart the server instead of spinning forever."""


class Request:
    """One generation request and its lifecycle record."""

    _next_id = 0

    def __init__(self, prompt, max_new_tokens, temperature, top_k, top_p,
                 eos_id, seed, deadline_s=None):
        self.id = Request._next_id
        Request._next_id += 1
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.seed = int(seed)
        self.state = _QUEUED
        self.output_tokens: List[int] = []
        #: high-water mark of tokens already counted into the server's
        #: throughput; survives preemption so regenerated tokens are not
        #: counted twice
        self.tokens_counted = 0
        self.finish_reason: Optional[str] = None
        #: "ok" | "timed_out" | "preempted" | "rejected" | "cancelled";
        #: None while the request is live
        self.status: Optional[str] = None
        self.t_submit = time.perf_counter()
        self.t_deadline = None if deadline_s is None \
            else self.t_submit + float(deadline_s)
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.preemptions = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def tokens(self) -> np.ndarray:
        """prompt + generated tokens, 1-D int32."""
        return np.concatenate(
            [self.prompt, np.asarray(self.output_tokens, np.int32)])

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state}, "
                f"prompt={len(self.prompt)}t, "
                f"out={len(self.output_tokens)}t)")


class InferenceServer:
    """Continuous-batching engine over the paged KV cache.

        server = InferenceServer(net, batch_slots=8, max_len=256)
        reqs = [server.submit(p, max_new_tokens=32) for p in prompts]
        server.run()
        for r in reqs: print(r.tokens())

    `max_len` (= max_blocks_per_seq * block_size) bounds prompt +
    generated tokens per sequence; `num_blocks` sizes the shared pool
    (default: every slot at full length, +1 scratch). `kv_cache_dtype`
    is "model" or "int8". `device` defaults to `cuda`; the net's weights
    must live there."""

    def __init__(self, net, *, batch_slots: int = 8, max_len: int = 256,
                 block_size: int = 16, max_prompt_len: Optional[int] = None,
                 kv_cache_dtype: str = "model",
                 num_blocks: Optional[int] = None,
                 max_preemptions: Optional[int] = 3,
                 watchdog_ticks: int = 256, device=None):
        if max_len % block_size:
            raise ValueError("max_len must be a multiple of block_size")
        executables.check_kv_cache_dtype(kv_cache_dtype)
        self.device = resolve_device(device)
        check_weights_on(net, self.device)
        cfg = net.model.cfg
        self.net = net
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.block_size = block_size
        self.kv_cache_dtype = kv_cache_dtype
        self.max_prompt_len = max_prompt_len or min(max_len, 64)
        if self.max_prompt_len > max_len:
            raise ValueError(f"max_prompt_len={self.max_prompt_len} exceeds "
                             f"max_len={max_len}")
        max_blocks = max_len // block_size
        if num_blocks is None:
            num_blocks = batch_slots * max_blocks + 1
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, num_blocks=num_blocks,
            block_size=block_size, batch_slots=batch_slots,
            max_blocks_per_seq=max_blocks, dtype=cfg.torch_dtype,
            quantized=kv_cache_dtype == "int8", device=self.device)
        self.programs = executables.paged_programs(
            cfg, batch_slots=batch_slots, block_size=block_size,
            kv_cache_dtype=kv_cache_dtype)
        self._params = _params_tree(net)

        B = batch_slots
        self._last_logits = torch.zeros(B, cfg.vocab_size,
                                        dtype=cfg.torch_dtype,
                                        device=self.device)
        self._gens: List[Optional[torch.Generator]] = [None] * B
        self._pos = np.zeros(B, np.int64)
        self._active = np.zeros(B, bool)
        self._temps = np.zeros(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._top_ps = np.zeros(B, np.float32)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._admit_seq = 0                 # admission order stamp
        self._slot_admit = np.zeros(B, np.int64)
        self.preemptions = 0
        self.queue: deque = deque()
        self.finished: List[Request] = []
        self.ticks = 0
        self.tokens_generated = 0
        # a request preempted more than max_preemptions times fails
        # terminally (None = unlimited); the watchdog raises after
        # watchdog_ticks consecutive ticks without progress
        self.max_preemptions = max_preemptions
        self.watchdog_ticks = int(watchdog_ticks)
        self._stall_ticks = 0
        self._draining = False
        self._shutdown = False

    # -- request intake -----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, eos_id: Optional[int] = None,
               seed: int = 0,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request. prompt_ids: 1-D (or (1, T)) ints.
        `deadline_s` bounds the request's whole wall-clock lifetime
        (queue wait included); past it the request finishes with status
        ``timed_out``."""
        if self._shutdown or self._draining:
            raise RuntimeError(
                "InferenceServer is "
                + ("shut down" if self._shutdown else "draining")
                + " — submit() rejected; start a new server (or submit "
                  "before calling drain()/shutdown())")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size > self.max_prompt_len:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds "
                             f"max_prompt_len={self.max_prompt_len}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new_tokens"
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must lie in "
                             f"[0, {self.cfg.vocab_size})")
        # a request whose lifetime footprint exceeds the whole pool can
        # never be admitted (or never finish): reject it up front
        need = self.cache.blocks_for(prompt.size + max_new_tokens)
        capacity = self.cache.num_blocks - 1    # block 0 is scratch
        if need > capacity:
            raise ValueError(
                f"request needs {need} KV blocks "
                f"(prompt {prompt.size} + {max_new_tokens} new tokens, "
                f"block_size={self.block_size}) but the pool only has "
                f"{capacity} — raise num_blocks or shrink the request")
        req = Request(prompt, max_new_tokens, temperature, top_k, top_p,
                      eos_id, seed, deadline_s=deadline_s)
        self.queue.append(req)
        return req

    # -- scheduler ----------------------------------------------------------

    def _free_slots(self):
        return [i for i in range(self.batch_slots) if not self._active[i]]

    def _seed_slot(self, slot: int, req: Request):
        """Decode activation: generator row + per-row sampling params."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(req.seed)
        self._gens[slot] = gen
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p

    def _admit_one(self, slot: int, req: Request):
        T = len(req.prompt)
        req.t_admit = time.perf_counter()
        self._slot_req[slot] = req
        self._slot_admit[slot] = self._admit_seq
        self._admit_seq += 1
        req.state = _RUNNING
        ids = np.zeros((1, self.max_prompt_len), np.int64)
        ids[0, :T] = req.prompt
        dev = self.device
        last = self.programs["prefill"](
            self._params, self.cache.pages,
            torch.from_numpy(self.cache.block_tables[slot]).to(dev),
            torch.from_numpy(ids).to(dev),
            torch.tensor([T], dtype=torch.int32, device=dev))
        self._last_logits[slot] = last[0].to(self._last_logits.dtype)
        self._pos[slot] = T
        self._seed_slot(slot, req)

    def _admit(self):
        admitted = 0
        free = self._free_slots()
        while self.queue and free:
            req = self.queue[0]
            # the prompt's blocks now; the first decode block comes
            # lazily through ensure()
            if not self.cache.can_alloc(len(req.prompt)):
                break
            self.queue.popleft()
            slot = free.pop(0)
            self.cache.alloc(slot, len(req.prompt))
            self._admit_one(slot, req)
            admitted += 1
        return admitted

    def _preempt_youngest(self, protect: int) -> bool:
        """Free the most recently admitted running request (except
        `protect`) back to the queue head. False if there is nothing to
        preempt."""
        running = [i for i in range(self.batch_slots)
                   if self._active[i] and i != protect]
        if not running:
            return False
        victim = max(running, key=lambda i: self._slot_admit[i])
        req = self._slot_req[victim]
        req.preemptions += 1
        self.preemptions += 1
        if self.max_preemptions is not None \
                and req.preemptions > self.max_preemptions:
            # retry budget exhausted: fail the request terminally
            # instead of thrashing the pool forever
            self._finish(victim, "preempted", status=_PREEMPTED)
            return True
        req.state = _QUEUED
        req.output_tokens = []          # greedy rerun is identical
        self._evict(victim)
        self.queue.appendleft(req)
        return True

    def _ensure_blocks(self):
        """Every running slot needs the block holding its next write
        position before the tick; oldest admissions are served first."""
        order = sorted((i for i in range(self.batch_slots)
                        if self._active[i]),
                       key=lambda i: self._slot_admit[i])
        for slot in order:
            if not self._active[slot]:
                # preempted by an older slot earlier in this pass —
                # ensure() on it would allocate a block to an empty slot
                # and poison its next admission
                continue
            while not self.cache.ensure(slot, int(self._pos[slot])):
                if not self._preempt_youngest(slot):
                    raise RuntimeError(
                        "KV pool too small for a single sequence — "
                        "raise num_blocks or lower max_len")

    def _evict(self, slot: int):
        self.cache.free_slot(slot)
        self._active[slot] = False
        self._pos[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 0.0
        self._gens[slot] = None
        self._slot_req[slot] = None

    def _finish(self, slot: int, reason: str, status: str = _OK):
        req = self._slot_req[slot]
        self._evict(slot)
        self._terminate(req, reason, status)

    def _terminate(self, req: Request, reason: str, status: str):
        """Terminal transition of a running (already evicted) or queued
        request."""
        req.state = _FINISHED
        req.finish_reason = reason
        req.status = status
        req.t_finish = time.perf_counter()
        self.finished.append(req)

    def _expire_deadlines(self):
        """Fail every request (queued or running) past its deadline with
        status ``timed_out``, before admission, so an expired request is
        never admitted."""
        now = time.perf_counter()
        for slot in range(self.batch_slots):
            req = self._slot_req[slot]
            if req is not None and req.t_deadline is not None \
                    and now > req.t_deadline:
                self._finish(slot, "timeout", status=_TIMED_OUT)
        if any(r.t_deadline is not None for r in self.queue):
            keep: deque = deque()
            for req in self.queue:
                if req.t_deadline is not None and now > req.t_deadline:
                    self._terminate(req, "timeout", _TIMED_OUT)
                else:
                    keep.append(req)
            self.queue = keep

    # -- the tick -----------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """Admit + one decode tick + evict. Returns tokens emitted."""
        done0 = len(self.finished)
        self._expire_deadlines()
        admitted = self._admit()
        if not self._active.any():
            self._note_progress(admitted, done0)
            return 0
        self._ensure_blocks()
        dev = self.device
        tok, self._last_logits = self.programs["decode"](
            self._params, self.cache.pages,
            torch.from_numpy(self.cache.block_tables).to(dev),
            torch.from_numpy(self._pos).to(dev), self._last_logits,
            self._gens, torch.from_numpy(self._temps).to(dev),
            torch.from_numpy(self._top_ks).to(dev),
            torch.from_numpy(self._top_ps).to(dev),
            torch.from_numpy(self._active).to(dev))
        tok = tok.cpu().numpy()                  # host sync: the tick's end
        now = time.perf_counter()
        emitted = net_new = 0
        for slot in range(self.batch_slots):
            if not self._active[slot]:
                continue
            req = self._slot_req[slot]
            t = int(tok[slot])
            self._pos[slot] += 1
            req.output_tokens.append(t)
            emitted += 1
            # tokens regenerated after a preemption were counted before
            if len(req.output_tokens) > req.tokens_counted:
                req.tokens_counted = len(req.output_tokens)
                net_new += 1
            req.t_last_token = now
            if req.t_first_token is None:
                req.t_first_token = now
            if req.eos_id >= 0 and t == req.eos_id:
                self._finish(slot, "eos")
            elif len(req.output_tokens) >= req.max_new_tokens:
                self._finish(slot, "length")
        self.ticks += 1
        self.tokens_generated += net_new
        self._note_progress(admitted + emitted, done0)
        return emitted

    def _note_progress(self, progress: int, done_before: int):
        """Watchdog: `progress` units this tick (tokens, admissions and
        finished requests). Zero progress with work pending for
        `watchdog_ticks` ticks in a row means the decode path is wedged."""
        progress += len(self.finished) - done_before
        if progress > 0 or not (self.queue or self._active.any()):
            self._stall_ticks = 0
            return
        self._stall_ticks += 1
        if self._stall_ticks >= self.watchdog_ticks:
            stalled, self._stall_ticks = self._stall_ticks, 0
            raise ServerStalledError(
                f"serving watchdog: {stalled} consecutive ticks without "
                f"progress ({len(self.queue)} queued, "
                f"{int(self._active.sum())} active) — restart the server")

    def run(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Step until queue and slots drain (or max_ticks). Returns the
        requests finished during this call."""
        done_before = len(self.finished)
        ticks = 0
        while self.queue or self._active.any():
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return self.finished[done_before:]

    def cancel(self, request_id: int) -> bool:
        """Cancel one queued or running request (status ``cancelled``,
        blocks freed). False for unknown or finished ids."""
        for slot in range(self.batch_slots):
            req = self._slot_req[slot]
            if req is not None and req.id == request_id:
                self._finish(slot, "cancel", status=_CANCELLED)
                return True
        for req in self.queue:
            if req.id == request_id:
                self.queue.remove(req)
                self._terminate(req, "cancel", _CANCELLED)
                return True
        return False

    # -- graceful teardown --------------------------------------------------

    def drain(self, max_ticks: Optional[int] = None,
              deadline_s: Optional[float] = None) -> List[Request]:
        """Stop admitting new submissions (submit() raises) and run the
        accepted work to completion, bounded by `max_ticks` and/or
        `deadline_s`. Returns the requests finished during the drain."""
        self._draining = True
        done_before = len(self.finished)
        t0 = time.perf_counter()
        ticks = 0
        while self.queue or self._active.any():
            if max_ticks is not None and ticks >= max_ticks:
                break
            if deadline_s is not None \
                    and time.perf_counter() - t0 > deadline_s:
                break
            self.step()
            ticks += 1
        return self.finished[done_before:]

    def shutdown(self, drain: bool = True, max_ticks: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        """Optionally drain, then cancel whatever remains with status
        ``rejected`` and refuse all further submissions. Idempotent."""
        if self._shutdown:
            return
        if drain:
            self.drain(max_ticks=max_ticks, deadline_s=deadline_s)
        for slot in range(self.batch_slots):
            if self._active[slot]:
                self._finish(slot, "shutdown", status=_REJECTED)
        while self.queue:
            self._terminate(self.queue.popleft(), "shutdown", _REJECTED)
        self._shutdown = True

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        by_status = {s: 0 for s in (_OK, _TIMED_OUT, _PREEMPTED,
                                    _REJECTED, _CANCELLED)}
        for r in self.finished:
            by_status[r.status] += 1
        return {"ticks": self.ticks,
                "tokens_generated": self.tokens_generated,
                "queued": len(self.queue),
                "active": int(self._active.sum()),
                "preemptions": self.preemptions,
                "finished": len(self.finished),
                "status_counts": by_status,
                "draining": self._draining,
                "shutdown": self._shutdown,
                "prefill_calls": self.programs["prefill"].calls,
                "decode_calls": self.programs["decode"].calls,
                **{f"kv_{k}": v for k, v in self.cache.stats().items()}}
