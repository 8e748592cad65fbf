"""Paged KV cache: a fixed pool of fixed-size blocks shared by every
in-flight sequence (counterpart of `mxnet_tpu/serving/kv_cache.py`
without its prefix cache or host tier).

The pool per layer is {"k", "v"} of (N, K, bs, d) in the model dtype or,
with `quantized=True`, int8 codes {"k", "v"} (N, K, bs, d) plus fp32
per-token scales {"ks", "vs"} (N, K, bs, 1) initialised to 1e-8/127 (the
scale of an all-zero row), on the serving device (`cuda` unless
`device="cpu"` is asked for); a
sequence holds ceil(len / bs) blocks, listed in its slot's row of
`block_tables` (physical ids in logical order). The
decode kernel reads through that table. The prefill and decode tick
write new rows into the pool in place (serving/executables.py).

Block 0 is a scratch sink: inactive batch slots and prompt padding write
there, so the tick never branches around its writes. It is never
allocated, and table entries past a sequence's length point at it.

This class owns the host-side allocator: a LIFO free list (hot blocks
are reused first), the block tables and per-slot lengths.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..context import resolve_device

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Block allocator + device page pool for `num_layers` layers."""

    def __init__(self, *, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int, batch_slots: int,
                 max_blocks_per_seq: int, dtype=torch.float32,
                 quantized: bool = False, device=None):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved scratch block)")
        device = resolve_device(device)
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.batch_slots = batch_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.dtype = dtype
        self.quantized = quantized
        shape = (num_blocks, num_kv_heads, block_size, head_dim)

        def pool():
            if not quantized:
                return {f: torch.zeros(shape, dtype=dtype, device=device)
                        for f in ("k", "v")}
            pg = {f: torch.zeros(shape, dtype=torch.int8, device=device)
                  for f in ("k", "v")}
            for f in ("ks", "vs"):
                pg[f] = torch.full(shape[:3] + (1,), 1e-8 / 127.0,
                                   dtype=torch.float32, device=device)
            return pg

        self.pages = [pool() for _ in range(num_layers)]

        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        #: (slots, max_blocks) physical ids in logical order; 0 =
        #: unallocated (reads there are masked by valid_len)
        self.block_tables = np.zeros((batch_slots, max_blocks_per_seq),
                                     np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in
                                              range(batch_slots)]
        self._slot_len = np.zeros(batch_slots, np.int64)
        self.alloc_count = 0
        self.free_count = 0

    # -- accounting ---------------------------------------------------------

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_used_blocks(self) -> int:
        # excludes the reserved scratch block
        return (self.num_blocks - 1) - len(self._free)

    def blocks_for(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens / self.block_size))

    def can_alloc(self, num_tokens: int) -> bool:
        return len(self._free) >= self.blocks_for(num_tokens)

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / free blocks): 0.0 for one
        solid run (or <= 1 free block), towards 1.0 as alloc/free churn
        shatters the pool into single-block holes."""
        n = len(self._free)
        if n <= 1:
            return 0.0
        ids = sorted(self._free)
        best = run = 1
        for prev, cur in zip(ids, ids[1:]):
            run = run + 1 if cur == prev + 1 else 1
            best = max(best, run)
        return 1.0 - best / n

    def stats(self) -> dict:
        cap = self.num_blocks - 1
        return {"num_blocks": cap, "block_size": self.block_size,
                "free_blocks": self.num_free_blocks,
                "used_blocks": self.num_used_blocks,
                "utilization": self.num_used_blocks / cap if cap else 0,
                "allocs": self.alloc_count, "frees": self.free_count,
                "fragmentation": self.fragmentation()}

    def slot_len(self, slot: int) -> int:
        return int(self._slot_len[slot])

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._slot_blocks[slot])

    # -- alloc / extend / free ----------------------------------------------

    def alloc(self, slot: int, num_tokens: int) -> bool:
        """Allocate blocks for a fresh sequence of `num_tokens` in `slot`.
        Returns False (and allocates nothing) if the pool cannot cover
        it; the slot must be empty."""
        if self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} already holds "
                             f"{len(self._slot_blocks[slot])} blocks")
        need = self.blocks_for(num_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence of {num_tokens} tokens needs {need} blocks "
                f"> max_blocks_per_seq={self.max_blocks_per_seq}")
        if len(self._free) < need:
            return False
        blocks = [self._free.pop() for _ in range(need)]
        self._slot_blocks[slot] = blocks
        self.block_tables[slot, :need] = blocks
        self._slot_len[slot] = num_tokens
        self.alloc_count += need
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Make sure the block holding token position `pos` is allocated
        for `slot` (before every decode tick, for the slot's next write
        position). Allocates at most one block; False when the pool is
        exhausted (the scheduler then preempts and retries)."""
        need = pos // self.block_size + 1
        held = len(self._slot_blocks[slot])
        if need <= held:
            self._slot_len[slot] = max(self._slot_len[slot], pos + 1)
            return True
        if need > self.max_blocks_per_seq:
            raise ValueError(f"position {pos} exceeds "
                             f"max_blocks_per_seq={self.max_blocks_per_seq}"
                             f" * block_size={self.block_size}")
        if not self._free:
            return False
        blk = self._free.pop()
        self._slot_blocks[slot].append(blk)
        self.block_tables[slot, held] = blk
        self._slot_len[slot] = pos + 1
        self.alloc_count += 1
        return True

    def free_slot(self, slot: int):
        """Return the slot's blocks to the pool (LIFO, so they are reused
        first) and clear its table row: an evicted slot reads scratch."""
        blocks = self._slot_blocks[slot]
        self.free_count += len(blocks)
        self._free.extend(reversed(blocks))
        self._slot_blocks[slot] = []
        self.block_tables[slot, :] = 0
        self._slot_len[slot] = 0

    def check(self):
        """Allocator invariants: the scratch block is never handed out,
        no block is owned twice or both owned and free, and every block
        but scratch is accounted for."""
        owned = [b for blks in self._slot_blocks for b in blks]
        if 0 in owned or 0 in self._free:
            raise AssertionError("scratch block allocated or freed")
        if len(set(owned)) != len(owned):
            raise AssertionError("block owned by two slots")
        if set(owned) & set(self._free):
            raise AssertionError("block both owned and free")
        if len(owned) + len(self._free) != self.num_blocks - 1:
            raise AssertionError("block leak")
        for slot, blks in enumerate(self._slot_blocks):
            if list(self.block_tables[slot, :len(blks)]) != blks or \
                    self.block_tables[slot, len(blks):].any():
                raise AssertionError(f"slot {slot}: table out of sync")
