"""KV-cache pools for the serving engine (port of
``repro/serving/kv_cache.py``: ``_RowPool``, ``SlotPool`` and
``BlockPool``).

:class:`SlotPool` is the slotted pool: one device cache of ``num_slots``
fixed-capacity rows (``model.init_cache``) plus a free list and a per-row
``cache_pos``; a short request pins as many K/V positions as a long one.
It is the reference's differential oracle for the paged pool.

Attention K/V live in a global pool of fixed-size blocks on the device;
each request row owns a *block table* mapping its logical positions to
pool blocks.  Blocks are reserved at admission (so on-demand allocation
during decode can never fail), allocated at :meth:`BlockPool.write` and
:meth:`BlockPool.prepare_decode`, and returned at
:meth:`BlockPool.release`.  Block 0 is the trash block: zeroed table
entries point at it, its contents are never read, and writes from free
rows land there harmlessly.

Prefix caching (``prefix_cache=True``, linear caches only): every prompt
block is content-addressed by a chained SHA-1 digest of the token ids it
holds (salted by the writer's expert budget, so equal prompts served at
different k never alias), blocks carry reference counts, and a new
request attaches the longest cached chain matching its prompt instead of
writing duplicate K/V.  A shared attach is charged against the attaching
row's reservation as *shared*, not owned, so the copy-on-write in
:meth:`BlockPool.prepare_decode` (taken when a row's next decode write
lands in a block other rows reference) can never fail for want of a free
block.  Freed blocks keep their index entry and are revived on an exact
match; a generic allocation that repurposes one evicts its entry.  The
digests are computed on host numpy token ids exactly as the reference
computes them, so both packages produce the same keys, hits and stats.

Preemption: :meth:`BlockPool.swap_out` copies a row's live blocks to host
memory and releases the row (blocks and reservation), and
:meth:`BlockPool.swap_in` restores them bit for bit into a freshly
reserved row.

Mamba (SSM) positions keep O(1) state per request, so both pools hold it
per row (``{"ssm": {"conv", "ssm"}}``, fp32, leading n_periods axis):
:meth:`SlotPool.write` and :meth:`BlockPool.write` install a prefilled
row (the reference's ``put_rows``), swaps carry it, and byte counts add
it beside the attention K/V.

Device writes are in place: :meth:`BlockPool.write` scatters with one
``index_put_`` per leaf and segment, a copy-on-write is one ``copy_`` per
leaf, all on the current stream, whose order puts them before the decode
step that reads them.  (The reference fuses its scatters into one donated
jitted program to dodge JAX's copy per ``.at[]``; eager PyTorch writes in
place to begin with.)
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import model as model_lib
from ..obs import trace as obs_trace

PyTree = Any


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

    def allocate(self) -> int:
        """Claim the lowest-id free row and return it."""
        if not self._free:
            raise RuntimeError(f"{type(self).__name__}: no free rows")
        self._free.sort()
        return self._free.pop(0)

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

    def truncate_to(self, slot: int, n_tokens: int) -> None:
        """Roll a live row back to ``n_tokens`` written positions (the
        speculative-decode rollback): positions ``>= n_tokens`` become dead
        and the next write lands at ``n_tokens``.  Never grows a row, and
        needs an unwrapped cache."""
        if slot in self._free:
            raise ValueError(
                f"{type(self).__name__}.truncate_to({slot}): slot is free")
        held = int(self.cache_pos[slot])
        if self.cfg.attention_window > 0 and held > self.attn_len:
            raise ValueError(
                f"{type(self).__name__}.truncate_to({slot}): ring cache "
                f"has wrapped ({held} > {self.attn_len} positions); "
                f"rollback is ill-defined")
        if not 0 <= n_tokens <= held:
            raise ValueError(
                f"{type(self).__name__}.truncate_to({slot}, {n_tokens}): "
                f"row holds only {held} positions")
        self.cache_pos[slot] = n_tokens

    def slot_full(self, slot: int) -> bool:
        """No room left to write the next decode token (linear cache)."""
        if self.cfg.attention_window > 0:
            return False
        return int(self.cache_pos[slot]) >= self.attn_len

    def kv_bytes(self) -> int:
        """Device bytes held by the pool's cache tree (attention K/V and
        Mamba state rows)."""
        return sum(leaf.numel() * leaf.element_size()
                   for c in self.cache.values() for part in c.values()
                   for leaf in part.values())

    def row_bytes(self) -> int:
        """Device bytes of the Mamba state rows (every slot's, always
        resident)."""
        return sum(leaf.numel() * leaf.element_size()
                   for c in self.cache.values() if "ssm" in c
                   for leaf in c["ssm"].values())

    def _put_rows(self, idx: torch.Tensor, piece: PyTree, n: int) -> None:
        """Install the first ``n`` rows of ``piece``'s Mamba state into
        rows ``idx``, cast to the pool's dtype (the reference's
        ``put_rows``)."""
        for pos_key, c in self.cache.items():
            if "ssm" in c:
                for leaf, rows in c["ssm"].items():
                    rows[:, idx] = piece[pos_key]["ssm"][leaf][:, :n].to(
                        rows.dtype)

    def publish(self, reg) -> None:
        """Set pool gauges on ``reg`` (a MetricsRegistry); the engine
        registers this as a snapshot-time source."""
        reg.gauge("serving.kv.num_slots").set(self.num_slots)
        reg.gauge("serving.kv.slots_free").set(self.num_free)
        reg.gauge("serving.kv.kv_bytes").set(self.kv_bytes())


class SlotPool(_RowPool):
    """Fixed-capacity slotted KV-cache pool with take/release."""

    def __init__(self, cfg, num_slots: int, slot_len: int, device="cuda"):
        super().__init__(cfg, num_slots, slot_len, device)
        self.cache: PyTree = model_lib.init_cache(cfg, num_slots, slot_len,
                                                  device=self.device)

    def write(self, slots: Sequence[int], piece: PyTree,
              lengths: Sequence[int],
              tokens: Optional[Sequence[np.ndarray]] = None,
              salt: bytes = b"", starts: Optional[Sequence[int]] = None
              ) -> None:
        """Install freshly prefilled caches into ``slots``, in place.

        ``piece``: a contiguous cache tree (what ``model.prefill``
        returns), batch ``>= len(slots)`` on axis 1; its columns land at
        the row's start and the rest of the row is zeroed.  ``lengths``:
        per-slot prompt length (the first decode position).  ``tokens``
        and ``salt`` are accepted for :meth:`BlockPool.write`'s signature
        and ignored (the slotted layout shares nothing); ``starts`` (a
        prefix attach) has no meaning here."""
        del tokens, salt
        if starts is not None:
            raise ValueError("SlotPool.write: the slotted pool attaches no "
                             "prefix (starts must be None)")
        slots = [int(s) for s in slots]
        self._require_live(slots)
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        self._put_rows(idx, piece, len(slots))
        for pos_key, c in self.cache.items():
            for leaf, rows in c.get("attn", {}).items():
                src = piece[pos_key]["attn"][leaf][:, :len(slots)]
                n = min(src.shape[2], self.attn_len)
                block = rows.new_zeros((rows.shape[0], len(slots))
                                       + rows.shape[2:])
                block[:, :, :n] = src[:, :, :n]
                rows[:, idx] = block
        self.cache_pos[np.asarray(slots)] = np.asarray(list(lengths),
                                                       np.int32)


class BlockPool(_RowPool):
    """Block-paged KV-cache pool: global block pool + per-row block tables.

    ``num_slots`` decode rows share ``num_blocks`` usable blocks of
    ``block_size`` tokens (the device arrays hold one extra trash block at
    id 0).  Admission needs a free row AND the request's projected block
    count.  ``prefix_cache=True`` turns on content-addressed block sharing
    for prompts (refcounts + copy-on-write; see the module docstring) and
    needs a linear cache: a wrapped ring rewrites logical positions in
    place under shared readers."""

    def __init__(self, cfg, num_slots: int, slot_len: int,
                 block_size: int = 16, num_blocks: int = None,
                 prefix_cache: bool = False, device="cuda"):
        if block_size < 1:
            raise ValueError(f"block_size={block_size}")
        if prefix_cache and cfg.attention_window > 0:
            raise ValueError(
                "prefix_cache requires a linear cache "
                "(cfg.attention_window == 0): a wrapped ring rewrites "
                "logical positions in place under shared readers")
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
        self._attn_layers = sum(next(iter(c["attn"].values())).shape[0]
                                for c in self.cache.values() if "attn" in c)
        self._free_blocks: List[int] = list(range(1, num_blocks + 1))
        self._reserved = np.zeros((num_slots,), np.int64)
        self._nalloc = np.zeros((num_slots,), np.int64)
        self.peak_blocks = 0

        self.prefix_cache = bool(prefix_cache)
        # per-block reference count (index 0 = trash block, always 0) and
        # per-slot count of table entries attached via live sharing: those
        # are not owned, the slot's reservation keeps covering a private
        # replacement, so copy-on-write can never fail
        self._ref = np.zeros((num_blocks + 1,), np.int32)
        self._nshared = np.zeros((num_slots,), np.int64)
        self._shared_mark = np.zeros((num_slots, self.blocks_per_slot), bool)
        # content-addressed prefix index: chained digest <-> block id
        self._cache_map: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        # blocks indexed by attach_prefix whose K/V the row's write has not
        # scattered yet: a same-pass match on them must recompute their
        # content instead of reading it (attach_prefix's ``ready``)
        self._pending_blocks: set = set()
        self._pending_by_slot: Dict[int, List[int]] = {}
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.prefix_cow_copies = 0
        self.prefix_evictions = 0
        self.swap_outs = 0
        self.swap_ins = 0

    def tables(self) -> torch.Tensor:
        """Per-row block tables as a device tensor for the decode step.
        The run's tracer counts, from host integers, the K/V rows the
        step's paged gather copies (every row's ``attn_len`` page span in
        each attention layer: ``kv.rows_gathered``) against the live ones
        (each taken row's positions up to the one it decodes:
        ``kv.rows_live``)."""
        tr = obs_trace.current()
        if tr.enabled:
            taken = np.ones(self.num_slots, bool)
            taken[self._free] = False
            live = np.minimum(self.cache_pos[taken].astype(np.int64) + 1,
                              self.attn_len).sum()
            tr.add("kv.rows_gathered",
                   self.num_slots * self.attn_len * self._attn_layers)
            tr.add("kv.rows_live", int(live) * self._attn_layers)
        return torch.as_tensor(self.block_table, device=self.device)

    # ----------------------------------------------------- block bookkeeping
    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` logical positions (ring-capped)."""
        return -(-min(max(int(n_tokens), 1), self.attn_len)
                 // self.block_size)

    @property
    def blocks_in_use(self) -> int:
        """Distinct blocks referenced by at least one row (a block shared
        by N rows counts once)."""
        return self.num_blocks - len(self._free_blocks)

    @property
    def available_blocks(self) -> int:
        """Free blocks not spoken for by outstanding reservations.  Debt
        counts owned allocations only: a shared attach leaves its slot's
        reservation booked for a private copy-on-write replacement."""
        owned = self._nalloc - self._nshared
        debt = int((self._reserved - owned).sum())
        return len(self._free_blocks) - debt

    def can_admit(self, n_tokens: int) -> bool:
        """Whether a request projecting ``n_tokens`` positions fits."""
        return self.blocks_needed(n_tokens) <= self.available_blocks

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

    def _evict_entry(self, bid: int) -> None:
        """Drop ``bid``'s prefix-index entry (its content is about to be
        overwritten)."""
        key = self._block_key.pop(bid, None)
        if key is not None:
            del self._cache_map[key]
            self.prefix_evictions += 1

    def _alloc_block(self, slot: int) -> None:
        if self._nalloc[slot] >= self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: allocation would exceed its reservation "
                f"({self._reserved[slot]} blocks)")
        # the list head, not the lowest id: keeps a permute_free order in
        # force (physical placement must be invisible to results)
        bid = self._free_blocks.pop(0)
        self._evict_entry(bid)
        self._ref[bid] = 1
        self.block_table[slot, self._nalloc[slot]] = bid
        self._nalloc[slot] += 1
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)

    def _attach_block(self, slot: int, bid: int) -> None:
        """Append a cached block to ``slot``'s table.  A refcount-zero
        block is revived out of the free list (an owned allocation); a
        live one is attached as shared."""
        if self._nalloc[slot] >= self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: prefix attach would exceed its reservation")
        idx = int(self._nalloc[slot])
        if self._ref[bid] == 0:
            self._free_blocks.remove(bid)
        else:
            self._nshared[slot] += 1
            self._shared_mark[slot, idx] = True
        self._ref[bid] += 1
        self.block_table[slot, idx] = bid
        self._nalloc[slot] += 1
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)

    def _detach_block(self, slot: int, idx: int) -> None:
        """Drop table entry ``idx`` of ``slot``: decrement the block's
        refcount, freeing it at zero (its index entry survives for
        revival)."""
        bid = int(self.block_table[slot, idx])
        self._ref[bid] -= 1
        if self._ref[bid] < 0:
            raise AssertionError(f"block {bid}: negative refcount")
        if self._ref[bid] == 0:
            self._free_blocks.append(bid)
        if self._shared_mark[slot, idx]:
            self._shared_mark[slot, idx] = False
            self._nshared[slot] -= 1
        self.block_table[slot, idx] = 0

    def alloc_prompt(self, slot: int, prompt_len: int) -> None:
        """Allocate the blocks the prompt's K/V go into (on top of any
        prefix attaches already in the table)."""
        while self._nalloc[slot] < self.blocks_needed(prompt_len):
            self._alloc_block(slot)

    def _copy_block(self, src: int, dst: int) -> None:
        """One block's K/V copied in place on the device, per leaf."""
        for c in self.cache.values():
            for leaf in c.get("attn", {}).values():
                leaf[:, dst].copy_(leaf[:, src])

    def _cow(self, slot: int, idx: int) -> None:
        """Copy-on-write: give ``slot`` a private copy of its shared table
        entry ``idx`` before it appends into that block; the fresh block
        comes out of the slot's own reservation."""
        old = int(self.block_table[slot, idx])
        new = self._free_blocks.pop(0)
        self._evict_entry(new)
        self._copy_block(old, new)
        self._ref[new] = 1
        self._ref[old] -= 1
        if self._ref[old] < 1:
            raise AssertionError(f"block {old}: CoW from sole referent")
        self._shared_mark[slot, idx] = False
        self._nshared[slot] -= 1
        self.block_table[slot, idx] = new
        self.prefix_cow_copies += 1
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)

    def prepare_decode(self, slots: Sequence[int]) -> None:
        """Allocate, for each active row, the block its next decode write
        lands in (a no-op until the write crosses a block boundary).  A
        row about to append into a block it only shares first gets a
        private copy, or adopts the block in place when every other
        referent has released it.  Owners never copy: borrowers only read
        positions below the shared span."""
        for s in slots:
            p = int(self.cache_pos[s])
            logical = (p % self.attn_len if self.cfg.attention_window > 0
                       else min(p, self.attn_len - 1))
            bi = logical // self.block_size
            while self._nalloc[s] <= bi:
                self._alloc_block(s)
            if self._shared_mark[s, bi]:
                if self._ref[int(self.block_table[s, bi])] > 1:
                    self._cow(s, bi)
                else:
                    # sole referent now: adopt in place; the booked
                    # replacement returns to the headroom
                    self._shared_mark[s, bi] = False
                    self._nshared[s] -= 1

    def truncate_to(self, slot: int, n_tokens: int) -> None:
        """Rollback: drop the row's positions ``>= n_tokens`` and release
        the tail blocks past the kept span (refcount-aware).  The
        reservation stays booked."""
        super().truncate_to(slot, n_tokens)
        keep = -(-min(n_tokens, self.attn_len) // self.block_size)
        n = int(self._nalloc[slot])
        for idx in range(keep, n):
            self._detach_block(slot, idx)
        if keep < n:
            self._nalloc[slot] = keep

    def release(self, slot: int) -> None:
        """Evict a finished request: drop every table entry (refcount-
        aware), clear the reservation, and free the row."""
        for bid in self._pending_by_slot.pop(slot, []):
            if bid in self._pending_blocks:
                # indexed but never written: the entry must not survive
                self._pending_blocks.discard(bid)
                self._evict_entry(bid)
        for idx in range(int(self._nalloc[slot])):
            self._detach_block(slot, idx)
        self.block_table[slot, :] = 0
        self._shared_mark[slot, :] = False
        self._reserved[slot] = 0
        self._nalloc[slot] = 0
        self._nshared[slot] = 0
        super().release(slot)

    def permute_free(self, seed: int) -> None:
        """Shuffle free-block allocation order (physical placement is
        invisible to results)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self._free_blocks))
        self._free_blocks = [self._free_blocks[i] for i in order]

    def check_invariants(self) -> None:
        """Free-list/refcount integrity: each block's refcount equals the
        table entries pointing at it, no block is both referenced and
        free, distinct used + free == total, the shared marks agree with
        the per-row counts, no row outruns its reservation, and the prefix
        index and its pending set are consistent."""
        def require(cond: bool, msg: str) -> None:
            if not cond:
                raise AssertionError(msg)

        counted: Dict[int, int] = {}
        for s in range(self.num_slots):
            for j in range(int(self._nalloc[s])):
                b = int(self.block_table[s, j])
                counted[b] = counted.get(b, 0) + 1
        used_ids = sorted(counted)
        free_ids = list(self._free_blocks)
        require(0 not in used_ids, "trash block handed out")
        for b in range(1, self.num_blocks + 1):
            require(int(self._ref[b]) == counted.get(b, 0),
                    f"block {b}: refcount {int(self._ref[b])} != "
                    f"{counted.get(b, 0)} table references")
        require(len(set(free_ids)) == len(free_ids), "double-freed block")
        require(not set(used_ids) & set(free_ids),
                "block simultaneously used and free")
        require(len(used_ids) + len(free_ids) == self.num_blocks,
                f"leak: used {len(used_ids)} + free {len(free_ids)} != "
                f"{self.num_blocks}")
        require(all(1 <= b <= self.num_blocks for b in used_ids + free_ids),
                "block id out of range")
        for s in range(self.num_slots):
            n = int(self._nalloc[s])
            require(not (self.block_table[s, n:] != 0).any(),
                    f"slot {s}: stale table entries past nalloc")
            require(not self._shared_mark[s, n:].any(),
                    f"slot {s}: stale shared marks past nalloc")
            require(int(self._shared_mark[s, :n].sum())
                    == int(self._nshared[s]), f"slot {s}: nshared mismatch")
            require(self._nalloc[s] <= self._reserved[s],
                    f"slot {s}: allocated past its reservation")
        for key, bid in self._cache_map.items():
            require(self._block_key.get(bid) == key,
                    f"prefix index: block {bid} map/reverse-map mismatch")
            require(1 <= bid <= self.num_blocks, f"indexed block {bid}")
        require(len(self._cache_map) == len(self._block_key),
                "prefix index: map and reverse map differ in size")
        listed = {b for bl in self._pending_by_slot.values() for b in bl}
        for bid in self._pending_blocks:
            require(bid in self._block_key,
                    f"pending block {bid} lost its index entry")
            require(int(self._ref[bid]) >= 1,
                    f"pending block {bid} is not allocated")
            require(bid in listed, f"pending block {bid} owned by no slot")
        require(self.available_blocks >= 0, "negative headroom")

    # --------------------------------------------------------- prefix cache
    def _prefix_keys(self, toks: np.ndarray, salt: bytes = b""
                     ) -> Tuple[List[bytes], Optional[bytes]]:
        """Chained content digests for a prompt: one per full block (each
        covering the whole prefix up to that block), plus a distinct one
        for a partial tail block.  ``salt`` seeds the chain (the engine
        salts with the tier k)."""
        toks = np.ascontiguousarray(np.asarray(toks, np.int32))
        bs = self.block_size
        keys: List[bytes] = []
        h = b"prefix:" + salt
        for i in range(len(toks) // bs):
            h = hashlib.sha1(h + toks[i * bs:(i + 1) * bs].tobytes()).digest()
            keys.append(h)
        tail = None
        if len(toks) % bs:
            tail = hashlib.sha1(
                h + b"partial:" + toks[(len(toks) // bs) * bs:].tobytes()
            ).digest()
        return keys, tail

    def _match_prefix(self, toks: np.ndarray, salt: bytes = b""
                      ) -> Tuple[List[int], int]:
        """Longest cached chain matching the prompt: the block ids to
        attach and the tokens they cover.  The partial tail block shares
        only when the entire prompt matches."""
        keys, tail = self._prefix_keys(toks, salt)
        bids: List[int] = []
        for key in keys:
            bid = self._cache_map.get(key)
            if bid is None:
                break
            bids.append(bid)
        covered = len(bids) * self.block_size
        if tail is not None and len(bids) == len(keys):
            bid = self._cache_map.get(tail)
            if bid is not None:
                bids.append(bid)
                covered = len(toks)
        return bids, covered

    def _register_prefix(self, slot: int, toks: np.ndarray,
                         salt: bytes = b"") -> List[int]:
        """Index ``slot``'s freshly allocated prompt blocks; blocks already
        keyed (the attached prefix) are left as they are.  Returns the
        newly indexed block ids."""
        keys, tail = self._prefix_keys(toks, salt)
        if tail is not None:
            keys = keys + [tail]
        fresh: List[int] = []
        for i, key in enumerate(keys):
            bid = int(self.block_table[slot, i])
            if key in self._cache_map or bid in self._block_key:
                continue
            self._cache_map[key] = bid
            self._block_key[bid] = key
            fresh.append(bid)
        return fresh

    def attach_prefix(self, slot: int, toks: Optional[np.ndarray],
                      prompt_len: int, salt: bytes = b"") -> Tuple[int, int]:
        """Match ``slot``'s prompt against the prefix index, attach the
        matched chain, allocate the remaining prompt blocks and index the
        fresh ones: everything :meth:`write` does per slot but the
        scatter.  Returns ``(covered, ready)``: the tokens the attached
        chain holds, and the leading part of them whose pages are already
        written (a suffix prefill may read below ``ready``; pages in
        ``[ready, covered)`` were indexed by a row of this admission pass
        that has not written yet)."""
        self._require_live([slot])
        covered = ready = 0
        if self.prefix_cache and toks is not None:
            toks = np.asarray(toks, np.int32)[:prompt_len]
            bids, covered = self._match_prefix(toks, salt)
            n_ready = 0
            for bid in bids:
                if bid in self._pending_blocks:
                    break
                n_ready += 1
            ready = (covered if n_ready == len(bids)
                     else n_ready * self.block_size)
            for bid in bids:
                self._attach_block(slot, bid)
            self.prefix_hit_blocks += len(bids)
            self.prefix_hit_tokens += covered
        self.alloc_prompt(slot, prompt_len)
        if self.prefix_cache and toks is not None:
            fresh = self._register_prefix(slot, toks, salt)
            if fresh:
                self._pending_blocks.update(fresh)
                self._pending_by_slot.setdefault(slot, []).extend(fresh)
        return covered, ready

    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache counters (cumulative)."""
        return {
            "hit_blocks": self.prefix_hit_blocks,
            "hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.prefix_cow_copies,
            "evictions": self.prefix_evictions,
            "cached_blocks": len(self._cache_map),
        }

    def publish(self, reg) -> None:
        """Paged-pool gauges: occupancy, headroom, swap and prefix-cache
        counters, sampled at snapshot time."""
        super().publish(reg)
        reg.gauge("serving.kv.num_blocks").set(self.num_blocks)
        reg.gauge("serving.kv.blocks_used").set(self.blocks_in_use)
        reg.gauge("serving.kv.blocks_free").set(
            self.num_blocks - self.blocks_in_use)
        reg.gauge("serving.kv.blocks_available").set(self.available_blocks)
        reg.gauge("serving.kv.blocks_peak").set(self.peak_blocks)
        reg.gauge("serving.kv.swap_outs").set(self.swap_outs)
        reg.gauge("serving.kv.swap_ins").set(self.swap_ins)
        if self.prefix_cache:
            for name, v in self.prefix_stats().items():
                reg.gauge(f"serving.kv.prefix.{name}").set(v)

    # ----------------------------------------------------------- preemption
    def swap_out(self, slot: int) -> Dict[str, Any]:
        """Preempt a live row: copy its allocated blocks' K/V and its Mamba
        state rows to host memory, then release the row, blocks and
        reservation and all.
        The copy is stream-ordered after every queued write to those
        blocks and waits for them.  Each block's prefix key rides along,
        so :meth:`swap_in` re-registers the row's prompt blocks."""
        if slot in self._free:
            raise ValueError(
                f"{type(self).__name__}.swap_out({slot}): slot is free")
        n = int(self._nalloc[slot])
        bids = self.block_table[slot, :n].astype(np.int64)
        keys = [self._block_key.get(int(b)) for b in bids]
        idx = torch.as_tensor(bids, device=self.device)
        blocks = {pos: {name: leaf[:, idx].cpu()
                        for name, leaf in c["attn"].items()}
                  for pos, c in self.cache.items() if "attn" in c}
        # a copy even on a CPU pool, where .cpu() of a view is the view
        rows = {pos: {name: leaf[:, slot].to("cpu", copy=True)
                      for name, leaf in c["ssm"].items()}
                for pos, c in self.cache.items() if "ssm" in c}
        state = {"cache_pos": int(self.cache_pos[slot]), "n_blocks": n,
                 "attn": blocks, "ssm": rows, "keys": keys}
        self.swap_outs += 1
        self.release(slot)
        return state

    def swap_in(self, slot: int, state: Dict[str, Any]) -> None:
        """Resume a swapped-out request into a freshly taken and reserved
        row: allocate as many blocks as it held, copy the saved contents
        back and restore its ``cache_pos``; then re-register its prompt
        blocks under their saved keys where no live row has claimed them
        (a key surviving only on a free block is re-pointed here)."""
        self._require_live([slot])
        if self._nalloc[slot]:
            raise ValueError(f"swap_in({slot}): target row already holds "
                             "blocks")
        n = int(state["n_blocks"])
        for _ in range(n):
            self._alloc_block(slot)
        idx = torch.as_tensor(self.block_table[slot, :n].astype(np.int64),
                              device=self.device)
        for pos, c in self.cache.items():
            for name, leaf in c.get("attn", {}).items():
                leaf[:, idx] = state["attn"][pos][name].to(leaf.device,
                                                           leaf.dtype)
            for name, leaf in c.get("ssm", {}).items():
                leaf[:, slot] = state["ssm"][pos][name].to(leaf.device,
                                                           leaf.dtype)
        self.cache_pos[slot] = state["cache_pos"]
        if self.prefix_cache:
            for i, key in enumerate(state.get("keys") or []):
                bid = int(self.block_table[slot, i])
                if key is None or bid in self._block_key:
                    continue
                old = self._cache_map.get(key)
                if old is not None:
                    if self._ref[old] > 0:
                        continue
                    del self._block_key[old]
                self._cache_map[key] = bid
                self._block_key[bid] = key
        self.swap_ins += 1

    # ------------------------------------------------------------- cache I/O
    def write(self, slots: Sequence[int], piece: PyTree,
              lengths: Sequence[int],
              tokens: Optional[Sequence[np.ndarray]] = None,
              starts: Optional[Sequence[int]] = None,
              piece_col0: Optional[Sequence[int]] = None,
              salt: bytes = b"") -> None:
        """Install freshly prefilled caches into ``slots``, in place.

        ``piece``: a contiguous cache tree (what ``model.prefill``
        returns), batch ``>= len(slots)`` on axis 1 (extra rows are
        ignored); Mamba state rows install per row.  ``lengths``: per-slot
        prompt length (the first decode position).  ``tokens`` (per-slot
        prompt ids, for prefix caching): each prompt is matched against
        the block index first, matched blocks are attached instead of
        written, and the fresh ones are indexed — the reference pool's
        one-call form, kept for op-for-op parity with it (the engine
        attaches through :meth:`attach_prefix` and passes ``starts``; the
        parity tests drive this form).  ``starts``/
        ``piece_col0`` (the suffix-prefill path): :meth:`attach_prefix`
        already ran; ``piece`` column 0 is prompt position
        ``piece_col0[j]`` and the scatter begins at ``starts[j]``."""
        slots = [int(s) for s in slots]
        lengths = [int(n) for n in lengths]
        self._require_live(slots)
        if starts is None:
            starts = []
            for j, (s, L) in enumerate(zip(slots, lengths)):
                toks = None if tokens is None else tokens[j]
                covered, _ready = self.attach_prefix(s, toks, L, salt)
                starts.append(covered)
            piece_col0 = [0] * len(slots)
        else:
            starts = [int(v) for v in starts]
            piece_col0 = ([0] * len(slots) if piece_col0 is None
                          else [int(v) for v in piece_col0])

        bs = self.block_size
        n_cols = [min(L, self.attn_len) for L in lengths]
        # one scatter per (start, n_cols, piece offset) segment and leaf;
        # ``start`` skips the columns an attached prefix already holds
        by_seg: Dict[Tuple[int, int, int], List[int]] = {}
        for j, (st, nc, c0) in enumerate(zip(starts, n_cols, piece_col0)):
            if st < nc:
                by_seg.setdefault((st, nc, c0), []).append(j)
        segs = []
        for (st, nc, c0), js in by_seg.items():
            cols = np.arange(st, nc)
            blks = np.stack([self.block_table[slots[j], cols // bs]
                             for j in js])                  # (rows, cols)
            offs = np.tile(cols % bs, (len(js), 1))
            segs.append((st - c0, nc - c0,
                         torch.as_tensor(np.asarray(js), device=self.device),
                         torch.as_tensor(blks, dtype=torch.int64,
                                         device=self.device),
                         torch.as_tensor(offs, dtype=torch.int64,
                                         device=self.device)))
        for pos_key, c in self.cache.items():
            for leaf, pool in c.get("attn", {}).items():
                src = piece[pos_key]["attn"][leaf]
                for a, b, js, blks, offs in segs:
                    pool[:, blks, offs] = src[:, js, a:b].to(pool.dtype)
        self._put_rows(torch.as_tensor(slots, dtype=torch.int64,
                                       device=self.device), piece, len(slots))
        self.cache_pos[np.asarray(slots)] = np.asarray(lengths, np.int32)
        # the scatter materialised every registration these rows left
        # pending: later passes may read those pages
        for s in slots:
            for bid in self._pending_by_slot.pop(s, []):
                self._pending_blocks.discard(bid)

    # ------------------------------------------------------------ reporting
    def block_bytes(self) -> int:
        """Device bytes of one block across all attention leaves."""
        return sum(leaf[:, 0].numel() * leaf.element_size()
                   for c in self.cache.values() if "attn" in c
                   for leaf in c["attn"].values())

    def peak_kv_bytes(self) -> int:
        """High-watermark of device bytes holding live pages, plus the
        Mamba state rows (always resident); a block shared by N rows
        counts once."""
        return self.peak_blocks * self.block_bytes() + self.row_bytes()
