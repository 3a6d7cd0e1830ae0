"""Block-paged KV-cache pool for the serving engine (port of
``repro/serving/kv_cache.py``: ``_RowPool`` and ``BlockPool``).

Attention K/V live in a global pool of fixed-size blocks on the device;
each request row owns a *block table* mapping its logical positions to
pool blocks.  Blocks are reserved at admission (so on-demand allocation
during decode can never fail), allocated at :meth:`BlockPool.write` and
:meth:`BlockPool.prepare_decode`, and returned at
:meth:`BlockPool.release`.  Block 0 is the trash block: zeroed table
entries point at it, its contents are never read, and writes from free
rows land there harmlessly.

:meth:`BlockPool.write` scatters into the pool IN PLACE with one
``index_put_`` per leaf and segment.  (The reference fuses its scatters
into one donated jitted program to dodge JAX's copy per ``.at[]``; eager
PyTorch writes in place to begin with.)

Prefix caching with copy-on-write, swap-out/swap-in for preemption,
free-list permutation and the slotted ``SlotPool`` come with the
serving-extras slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models import model as model_lib

PyTree = Any

_LATER = "comes with the serving-extras slice of the port"


class _RowPool:
    """Decode-row bookkeeping: a free list of rows and a per-row
    ``cache_pos`` — what decouples request lifetime from the decode
    step's batch shape."""

    def __init__(self, cfg, num_slots: int, slot_len: int, device):
        if num_slots < 1 or slot_len < 1:
            raise ValueError(f"num_slots={num_slots}, slot_len={slot_len}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.slot_len = slot_len
        self.device = torch.device(device)
        self.attn_len = model_lib.cache_len_for(cfg, slot_len)
        self.cache_pos = np.zeros((num_slots,), np.int32)
        self._free: List[int] = list(range(num_slots))

    @property
    def free_slots(self) -> List[int]:
        """Free slot ids, lowest first (deterministic allocation order)."""
        return sorted(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def take(self, slot: int) -> None:
        """Claim a specific free slot (scheduler-chosen assignment)."""
        if slot not in self._free:
            raise ValueError(
                f"{type(self).__name__}.take({slot}): slot is not free "
                f"(free: {self.free_slots})")
        self._free.remove(slot)

    def _require_live(self, slots: Sequence[int]) -> None:
        dead = [s for s in slots if s in self._free]
        if dead:
            raise ValueError(
                f"{type(self).__name__}.write: slots {dead} are free "
                f"(take them first)")

    def release(self, slot: int) -> None:
        """Return a claimed row to the free list."""
        if not 0 <= slot < self.num_slots or slot in self._free:
            raise ValueError(f"release({slot}): not a claimed slot")
        self.cache_pos[slot] = 0
        self._free.append(slot)

    def positions(self) -> torch.Tensor:
        """Per-slot decode positions as a device vector."""
        return torch.as_tensor(self.cache_pos, dtype=torch.int64,
                               device=self.device)

    def advance(self, slots: Sequence[int]) -> None:
        """One token decoded in each of ``slots``."""
        self.cache_pos[np.asarray(list(slots), np.int32)] += 1

    def slot_full(self, slot: int) -> bool:
        """No room left to write the next decode token (linear cache)."""
        if self.cfg.attention_window > 0:
            return False
        return int(self.cache_pos[slot]) >= self.attn_len


class BlockPool(_RowPool):
    """Block-paged KV-cache pool: global block pool + per-row block tables.

    ``num_slots`` decode rows share ``num_blocks`` usable blocks of
    ``block_size`` tokens (the device arrays hold one extra trash block at
    id 0).  Admission needs a free row AND the request's projected block
    count."""

    def __init__(self, cfg, num_slots: int, slot_len: int,
                 block_size: int = 16, num_blocks: int = None,
                 prefix_cache: bool = False, device="cuda"):
        if prefix_cache:
            raise NotImplementedError(f"prefix caching {_LATER}")
        if block_size < 1:
            raise ValueError(f"block_size={block_size}")
        super().__init__(cfg, num_slots, slot_len, device)
        self.block_size = block_size
        self.blocks_per_slot = -(-self.attn_len // block_size)
        if num_blocks is None:
            # full provisioning: every row can hold a max-length request
            num_blocks = num_slots * self.blocks_per_slot
        if num_blocks < self.blocks_per_slot:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold even one max-length "
                f"request ({self.blocks_per_slot} blocks)")
        self.num_blocks = num_blocks
        self.cache: PyTree = model_lib.init_paged_cache(
            cfg, num_slots, num_blocks, block_size, device=self.device)
        self.block_table = np.zeros((num_slots, self.blocks_per_slot),
                                    np.int32)
        self._free_blocks: List[int] = list(range(1, num_blocks + 1))
        self._reserved = np.zeros((num_slots,), np.int64)
        self._nalloc = np.zeros((num_slots,), np.int64)
        self.peak_blocks = 0

    def tables(self) -> torch.Tensor:
        """Per-row block tables as a device tensor for the decode step."""
        return torch.as_tensor(self.block_table, device=self.device)

    # ----------------------------------------------------- block bookkeeping
    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` logical positions (ring-capped)."""
        return -(-min(max(int(n_tokens), 1), self.attn_len)
                 // self.block_size)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free_blocks)

    @property
    def available_blocks(self) -> int:
        """Free blocks not spoken for by outstanding reservations."""
        debt = int((self._reserved - self._nalloc).sum())
        return len(self._free_blocks) - debt

    def reserved_for(self, slot: int) -> int:
        return int(self._reserved[slot])

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Book the request's lifetime block projection at admit time."""
        need = self.blocks_needed(n_tokens)
        if self._reserved[slot] or self._nalloc[slot]:
            raise ValueError(f"reserve({slot}): row already holds blocks")
        if need > self.available_blocks:
            raise ValueError(f"reserve({slot}, {n_tokens}): need {need} > "
                             f"available {self.available_blocks}")
        self._reserved[slot] = need

    def _alloc_block(self, slot: int) -> None:
        if self._nalloc[slot] >= self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: allocation would exceed its reservation "
                f"({self._reserved[slot]} blocks)")
        bid = self._free_blocks.pop(0)
        self.block_table[slot, self._nalloc[slot]] = bid
        self._nalloc[slot] += 1
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)

    def alloc_prompt(self, slot: int, prompt_len: int) -> None:
        while self._nalloc[slot] < self.blocks_needed(prompt_len):
            self._alloc_block(slot)

    def prepare_decode(self, slots: Sequence[int]) -> None:
        """Allocate, for each active row, the block its next decode write
        lands in (a no-op until the write crosses a block boundary)."""
        for s in slots:
            p = int(self.cache_pos[s])
            logical = (p % self.attn_len if self.cfg.attention_window > 0
                       else min(p, self.attn_len - 1))
            while self._nalloc[s] <= logical // self.block_size:
                self._alloc_block(s)

    def release(self, slot: int) -> None:
        """Evict a finished request: free its blocks and reservation."""
        for idx in range(int(self._nalloc[slot])):
            self._free_blocks.append(int(self.block_table[slot, idx]))
        self.block_table[slot, :] = 0
        self._reserved[slot] = 0
        self._nalloc[slot] = 0
        super().release(slot)

    def check_invariants(self) -> None:
        """Free-list integrity: used and free blocks partition the pool,
        the trash block is never handed out, no row outruns its
        reservation, table entries past a row's allocation are zero."""
        used = [int(self.block_table[s, j]) for s in range(self.num_slots)
                for j in range(int(self._nalloc[s]))]
        free = list(self._free_blocks)
        if 0 in used:
            raise AssertionError("trash block handed out")
        if len(set(used)) != len(used) or len(set(free)) != len(free):
            raise AssertionError("block referenced twice")
        if set(used) & set(free) or len(used) + len(free) != self.num_blocks:
            raise AssertionError("used and free blocks do not partition "
                                 "the pool")
        for s in range(self.num_slots):
            n = int(self._nalloc[s])
            if (self.block_table[s, n:] != 0).any():
                raise AssertionError(f"slot {s}: stale table entries")
            if n > self._reserved[s]:
                raise AssertionError(f"slot {s}: allocated past reservation")
        if self.available_blocks < 0:
            raise AssertionError("negative headroom")

    def swap_out(self, slot: int):
        raise NotImplementedError(f"preemption swap-out {_LATER}")

    def swap_in(self, slot: int, state) -> None:
        raise NotImplementedError(f"preemption swap-in {_LATER}")

    def permute_free(self, seed: int) -> None:
        raise NotImplementedError(f"free-list permutation {_LATER}")

    # ------------------------------------------------------------- cache I/O
    def write(self, slots: Sequence[int], piece: PyTree,
              lengths: Sequence[int]) -> None:
        """Install freshly prefilled caches into ``slots``, in place.

        ``piece``: the contiguous cache ``model.prefill`` returns, batch
        ``>= len(slots)`` on axis 1; its first ``min(len, attn_len)``
        columns go into each row's freshly allocated blocks.
        ``lengths``: per-slot prompt length (the first decode position)."""
        slots = [int(s) for s in slots]
        lengths = [int(n) for n in lengths]
        self._require_live(slots)
        for s, L in zip(slots, lengths):
            self.alloc_prompt(s, L)
        bs = self.block_size
        by_cols: Dict[int, List[int]] = {}
        for j, L in enumerate(lengths):
            by_cols.setdefault(min(L, self.attn_len), []).append(j)
        segs: List[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for nc, js in by_cols.items():
            cols = np.arange(nc)
            blks = np.stack([self.block_table[slots[j], cols // bs]
                             for j in js])                 # (rows, nc)
            offs = np.tile(cols % bs, (len(js), 1))
            segs.append((nc,
                         torch.as_tensor(np.asarray(js), device=self.device),
                         torch.as_tensor(blks, dtype=torch.int64,
                                         device=self.device),
                         torch.as_tensor(offs, dtype=torch.int64,
                                         device=self.device)))
        for pos_key, c in self.cache.items():
            for leaf, pool in c["attn"].items():
                src = piece[pos_key]["attn"][leaf]
                for nc, js, blks, offs in segs:
                    pool[:, blks, offs] = src[:, js, :nc].to(pool.dtype)
        self.cache_pos[np.asarray(slots)] = np.asarray(lengths, np.int32)
