"""Paged slot KV: a ref-counted block pool with cross-slot prefix sharing.

The counterpart of ``distributed_llm_pipeline_tpu/runtime/paged.py``. It owns
the host side of the paged KV layout (the device side is
``models.llama.PagedKVCache`` and ``LlamaModel.forward_paged*``):

- :class:`BlockAllocator`, pure numpy and host-only: a ref-counted physical
  block allocator with a hash index of full prompt blocks. A new prompt that
  shares at least one full block with any resident slot attaches those
  physical blocks instead of prefilling them again. A write into a block
  with more than one reference first copies it to a private block
  (copy-on-write), so tenants never corrupt each other.
- :class:`PagedSlotBackend`, the :class:`SlotScheduler`'s backend over the
  shared pool: admission consults the prefix index before prefilling, and
  decode chunks and mixed steps run the batched paged forward.

Physical block 0 is the sentinel: unmapped table entries point at it so
gathers stay in bounds, and parked rows' junk writes land in it.

The pools are written in place; the reference donates its buffers to XLA
for the same effect, which is why it needs an ``uncache`` and this port does
not. Host tables reach the device from a fresh pinned copy (``upload``):
the allocator mutates its numpy tables right after an upload, and a copy
still in flight must not see that. The reference backend's slot
save/restore (``gather``, ``adopt_row``, ``row_cache``) and the wrappers its
handoff, restore and quarantine paths call (``register_prefix``,
``release_row``) come with those paths.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import PagedKVCache
from .engine import _bucket


class PoolExhausted(RuntimeError):
    """The block pool has no free block for a required write/allocation."""


def _chain_hash(prev: int, ids: tuple) -> int:
    """Chain hash of one full token block given the previous block's chain
    hash: position-sensitive, so equal blocks at different depths never
    collide into one entry."""
    return hash((prev, ids))


def pick_block_size(max_seq: int) -> int:
    """Default block size (the prefix-sharing granule): a divisor of
    ``max_seq``, preferring 64."""
    for cand in (64, 32, 16, 8):
        if max_seq % cand == 0:
            return cand
    return 16


def pool_sublane(dtype: torch.dtype, kv_quant: str | None) -> int:
    """The smallest block size the pool dtype takes: 8 for f32, 16 for
    bf16, 32 for int8 codes. These are the TPU's tiling floors; the port
    keeps them so the default geometry is the reference's (block 64 at
    ``max_seq`` 2048)."""
    if kv_quant is not None:
        return 32
    return 16 if dtype == torch.bfloat16 else 8


def kv_token_bytes(cfg, kv_quant: str | None, kv_mode: str = "dense",
                   latent_rank: int | None = None) -> int:
    """Device bytes one cached token costs across all layers (K + V; codes
    plus per-vector f32 scales on an int8 pool), for bf16 or int8 pools.
    ``kv_mode="latent"`` counts one rank-``latent_rank`` latent per side:
    at the default rank K·Hd/4, a quarter of the dense bf16 figure."""
    per_elem = 2 if kv_quant is None else 1
    if kv_mode == "latent":
        if not latent_rank:
            raise ValueError("kv_token_bytes(kv_mode='latent') needs latent_rank")
        n_vec, width = 1, int(latent_rank)
    else:
        n_vec, width = cfg.n_kv_heads, cfg.head_dim
    n = 2 * cfg.n_layers * n_vec * width * per_elem
    if kv_quant is not None:
        n += 2 * cfg.n_layers * n_vec * 4
    return n


def pool_geometry(max_seq: int, n_slots: int, block_size: int | None = None,
                  n_blocks: int | None = None, min_block: int = 8,
                  ) -> tuple[int, int, int]:
    """(block_size, n_tables, n_blocks). Defaults: a ``max_seq``-divisor
    block size raised to the pool dtype's floor, tables covering the whole
    window, and a pool holding every slot's full window plus the sentinel
    block and copy-on-write slack (``DLP_KV_BLOCK`` / ``DLP_KV_POOL_BLOCKS``
    override). An explicit block size below the floor is refused."""
    env = os.environ.get("DLP_KV_BLOCK")
    if block_size is None and env:
        block_size = int(env)
    bs = block_size if block_size is not None \
        else max(min_block, pick_block_size(max_seq))
    if bs % min_block:
        raise ValueError(
            f"kv block size {bs} must be a multiple of {min_block} for "
            "this pool dtype (floor: 8 f32, 16 bf16, 32 int8)")
    nt = -(-max_seq // bs)
    if n_blocks is None:
        env = os.environ.get("DLP_KV_POOL_BLOCKS")
        n_blocks = int(env) if env else n_slots * nt + 3
    return bs, nt, n_blocks


class BlockAllocator:
    """Host-side ref-counted block allocator + prefix hash index.

    Invariants:
    - ``ref[b] >= 1`` while any slot's table maps b (plus the pin on the
      sentinel block 0); a block reaching ref 0 is deregistered and freed.
    - a registered block's contents never change: any write first copies
      it (ref > 1) or deregisters it (ref == 1, solely owned).
    - ``rows[r]`` is the slot's logical → physical map; entries beyond a
      tenant's valid length may be intact blocks of a previous tenant,
      still correct under their registered hashes, reclaimed on release.
    """

    def __init__(self, n_blocks: int, block_size: int, n_slots: int,
                 n_tables: int):
        if n_blocks < n_slots + 2:
            raise ValueError(f"pool of {n_blocks} blocks cannot serve "
                             f"{n_slots} slots (junk block + 1 per slot "
                             "minimum)")
        self.n_blocks = n_blocks
        self.bs = block_size
        self.n_slots = n_slots
        self.n_tables = n_tables
        self.reset()

    def reset(self) -> None:
        self.ref = np.zeros(self.n_blocks, np.int64)
        self.ref[0] = 1                       # sentinel block pinned
        self.free = list(range(self.n_blocks - 1, 0, -1))  # pop() -> 1, 2, …
        self.index: dict[int, int] = {}       # chain hash -> block id
        self.hash_of: dict[int, int] = {}     # registered block -> its hash
        # registered block -> (predecessor physical block, its exact token
        # tuple): the hash index is only a fast path; a match must verify
        # content and chain linkage, or a hash collision would attach
        # another tenant's KV
        self.meta: dict[int, tuple[int | None, tuple[int, ...]]] = {}
        self.rows: list[list[int]] = [[] for _ in range(self.n_slots)]
        self.tables = np.zeros((self.n_slots, self.n_tables), np.int32)
        self.dirty = True                     # device tables need re-upload
        self.cow_copies = 0

    # -- primitive ops ------------------------------------------------------

    def _alloc(self) -> int:
        if not self.free:
            raise PoolExhausted(
                f"KV block pool exhausted ({self.n_blocks} blocks of "
                f"{self.bs}); raise DLP_KV_POOL_BLOCKS or lower n_slots")
        b = self.free.pop()
        self.ref[b] = 1
        return b

    def _decref(self, b: int) -> None:
        self.ref[b] -= 1
        if self.ref[b] == 0:
            self._deregister(b)
            self.free.append(b)

    def _deregister(self, b: int) -> None:
        h = self.hash_of.pop(b, None)
        self.meta.pop(b, None)
        if h is not None and self.index.get(h) == b:
            del self.index[h]

    # -- row lifecycle ------------------------------------------------------

    def release_row(self, r: int) -> None:
        for b in self.rows[r]:
            self._decref(b)
        self.rows[r] = []
        self.tables[r, :] = 0
        self.dirty = True

    def match_prefix(self, ids: list[int]) -> list[int]:
        """Longest run of resident full blocks matching ``ids``' prefix: the
        physical block ids, in logical order. Every candidate is verified
        against its registered token tuple and its predecessor's physical
        identity, so a hash collision can never attach foreign KV."""
        h = 0
        prev: int | None = None
        out: list[int] = []
        for j in range(len(ids) // self.bs):
            tok = tuple(ids[j * self.bs: (j + 1) * self.bs])
            h = _chain_hash(h, tok)
            b = self.index.get(h)
            if b is None or self.meta.get(b) != (prev, tok):
                break
            out.append(b)
            prev = b
        return out

    def attach_shared(self, r: int, blocks: list[int]) -> None:
        """Point row ``r``'s table at shared physical blocks, releasing its
        previous holdings. Increments before the release: the matched
        blocks may be solely owned by row ``r`` itself, and releasing first
        would free the very blocks being attached."""
        for b in blocks:
            self.ref[b] += 1
        self.release_row(r)
        for j, b in enumerate(blocks):
            self.tables[r, j] = b
        self.rows[r] = list(blocks)
        self.dirty = True

    def ensure_writable(self, r: int, start: int, end: int,
                        ) -> list[tuple[int, int]]:
        """Make positions [start, end) of row ``r`` writable: allocate
        missing blocks, copy-on-write shared ones, deregister solely-owned
        registered ones. Returns the (src, dst) block pairs whose contents
        the caller must copy on the device before writing. Atomic: capacity
        is checked first, so a PoolExhausted leaves no mutation."""
        row = self.rows[r]
        jb0, jb1 = start // self.bs, -(-end // self.bs)
        jb1 = min(jb1, self.n_tables)
        assert jb0 <= len(row), (r, start, len(row))
        cow = [j for j in range(jb0, min(jb1, len(row)))
               if self.ref[row[j]] > 1]
        n_new = max(0, jb1 - len(row))
        if len(self.free) < len(cow) + n_new:
            raise PoolExhausted(
                f"KV block pool exhausted ({len(self.free)} free of "
                f"{self.n_blocks}; need {len(cow)} CoW + {n_new} new); "
                "raise DLP_KV_POOL_BLOCKS or lower n_slots")
        pairs: list[tuple[int, int]] = []
        for j in cow:
            old = row[j]
            new = self._alloc()
            pairs.append((old, new))
            row[j] = new
            self.tables[r, j] = new
            self._decref(old)
        for j in range(len(row), jb1):
            b = self._alloc()
            row.append(b)
            self.tables[r, j] = b
        # what is left in the write range is now solely owned; deregister
        # blocks whose contents are about to change
        for j in range(jb0, jb1):
            self._deregister(row[j])
        if pairs or n_new:
            self.dirty = True
        self.cow_copies += len(pairs)
        return pairs

    def register_row(self, r: int, ids: list[int]) -> None:
        """Register row ``r``'s full prompt blocks in the prefix index. The
        first block registered under a chain hash stays canonical."""
        h = 0
        row = self.rows[r]
        for j in range(len(ids) // self.bs):
            tok = tuple(ids[j * self.bs: (j + 1) * self.bs])
            h = _chain_hash(h, tok)
            if j >= len(row):
                break
            b = row[j]
            if b in self.hash_of:
                continue                       # already registered (shared)
            if h in self.index:
                continue                       # another block is canonical
            self.index[h] = b
            self.hash_of[b] = h
            self.meta[b] = (row[j - 1] if j else None, tok)

    @property
    def used(self) -> int:
        return self.n_blocks - 1 - len(self.free)

    @property
    def shared(self) -> int:
        """Blocks mapped by more than one slot."""
        return int(np.sum(self.ref[1:] > 1))


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array that the caller may mutate right away:
    on CUDA the array is copied into fresh pinned memory first and sent
    without blocking the host (a blocking copy would wait for the step in
    flight); on the CPU the copy is the tensor itself."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class PagedSlotBackend:
    """Slot KV over the shared block pool for the single-device
    :class:`Engine`: the batch KV is ``{k, v, ks, vs, tables}`` with pools
    [L, N, bs, K, Hd] (``[L, N, bs, 1, r]`` latents on a latent engine,
    int8 codes and scales under ``kv_quant``); the decode step is one
    batched ``forward_paged`` (per-row lengths and tables), and prefill
    runs ``forward_paged_last`` over the suffix only: shared prefix tokens
    are read by attention, never recomputed. ``fused`` is the engine's
    answer for this pool's geometry: decode steps then run the fused
    decode-step kernel; mixed steps and prefill stay unfused."""

    def __init__(self, eng, n_slots: int, max_seq: int,
                 block_size: int | None = None, n_blocks: int | None = None):
        self.eng = eng
        self.B = n_slots
        self.S = max_seq
        self.cfg = eng.cfg
        self.kv_quant = eng.kv_quant
        self.kv_mode = eng.kv_mode
        self.latent_rank = eng.kv_latent_rank
        self.bs, self.NT, self.n_blocks = pool_geometry(
            max_seq, n_slots, block_size, n_blocks,
            min_block=pool_sublane(eng.dtype, self.kv_quant))
        self.allocator = BlockAllocator(self.n_blocks, self.bs, n_slots, self.NT)
        self.fused = eng.resolve_fused_decode(self.bs, n_slots)

    @property
    def block_bytes(self) -> int:
        """Device bytes of one pool block across all layers."""
        return self.bs * kv_token_bytes(self.cfg, self.kv_quant, self.kv_mode,
                                        self.latent_rank)

    # -- layout -------------------------------------------------------------

    def alloc(self) -> dict:
        self.allocator.reset()
        c = self.eng.make_paged_cache(self.B, block_size=self.bs,
                                      n_blocks=self.n_blocks, n_tables=self.NT)
        return {"k": c.k, "v": c.v, "ks": c.k_scale, "vs": c.v_scale,
                "tables": c.tables}

    @staticmethod
    def cache(bufs: dict, lengths: torch.Tensor) -> PagedKVCache:
        return PagedKVCache(bufs["k"], bufs["v"], bufs["tables"], lengths,
                            bufs.get("ks"), bufs.get("vs"))

    def vstep(self, tok: torch.Tensor, cache: PagedKVCache) -> torch.Tensor:
        """tok [B] → logits [B, V]: one batched paged forward, fused when
        the engine resolved it so."""
        return self.eng.model.forward_paged(tok[:, None], cache,
                                            fused=self.fused)[:, -1]

    def mstep(self, block: torch.Tensor, n_tok: torch.Tensor,
              cache: PagedKVCache) -> torch.Tensor:
        """Mixed prefill + decode step: per-row ``n_tok`` routes each row's
        padding lanes into the sentinel block, so a decode row sharing the
        step with a wide prefill chunk needs writable blocks for its one
        real token only."""
        return self.eng.model.forward_paged_mixed(block, cache, n_tok)

    # -- admission / prefill ------------------------------------------------

    def begin_prefill(self, sched, r: int, ids: list[int], reuse_k: int) -> int:
        """Admission's host-side half, shared by one-shot ``prefill_row``
        and chunked admission: consult the prefix index, attach shared
        blocks (or keep the slot's retained ones or the already-fed chunk
        prefix, whichever is longer), or release the row's stale holdings.
        Returns the resident-prefix length the forward may skip."""
        eng = sched.engine
        al = self.allocator
        shared = al.match_prefix(ids)
        shared_k = min(len(shared) * self.bs, len(ids) - 1)
        # the suffix bucket must fit behind the reused prefix, else drop
        # whole blocks (the _pick_slot headroom rule)
        while shared_k > 0 and shared_k + _bucket(
                len(ids) - shared_k, eng.max_prompt,
                quantum=eng._prompt_quantum) > self.S:
            shared = shared[:-1]
            shared_k = min(len(shared) * self.bs, len(ids) - 1)
        if shared_k > reuse_k:
            al.attach_shared(r, shared)  # increfs before releasing r's own
            sched.counters["paged_prefix_hits_total"] += 1
            # only the tokens the index newly served beyond what the row
            # already held: the finishing sub-chunk re-runs this with the
            # chunk-fed fill as reuse_k
            sched.counters["paged_prefix_tokens_total"] += shared_k - reuse_k
            reuse_k = shared_k
        elif not reuse_k:
            al.release_row(r)
        return reuse_k

    def prefill_row(self, sched, r: int, ids: list[int], reuse_k: int,
                    ) -> tuple[torch.Tensor, int]:
        """Admit ``ids`` into row ``r``: consult the prefix index, copy-on-
        write anything the suffix bucket will write, then run the paged
        prefill over the suffix only. Returns (logits [1, V], tokens
        reused). Chunked prefill's finishing sub-chunk calls this with the
        fed tokens as ``reuse_k``."""
        eng = sched.engine
        al = self.allocator
        reuse_k = self.begin_prefill(sched, r, ids, reuse_k)
        suffix = ids[reuse_k:]
        b = _bucket(len(suffix), eng.max_prompt, quantum=eng._prompt_quantum)
        try:
            pairs = al.ensure_writable(r, reuse_k, reuse_k + b)
        except PoolExhausted:
            # idle slots' retained prefixes are a cache, not a reservation;
            # a second failure is a real capacity error for this request
            self._evict_idle(sched, exclude=r)
            pairs = al.ensure_writable(r, reuse_k, reuse_k + b)
        self._run_copies(sched, pairs)
        padded = np.zeros((1, b), np.int64)
        padded[0, :len(suffix)] = suffix
        dev = eng.device
        cache = PagedKVCache(
            sched._bufs["k"], sched._bufs["v"], upload(al.tables[r:r + 1], dev),
            torch.full((1,), reuse_k, dtype=torch.int32, device=dev),
            sched._bufs.get("ks"), sched._bufs.get("vs"))
        logits = eng.model.forward_paged_last(upload(padded, dev), cache,
                                              len(suffix) - 1)
        sched.forwards += 1
        sched.counters["prefill_tokens_total"] += b
        al.register_row(r, ids)
        return logits, reuse_k

    # -- decode-step preparation --------------------------------------------

    def prepare_chunk(self, sched, running: list[tuple[int, int]],
                      n: int | dict[int, int]) -> list[tuple[int, int]]:
        """Before a step launches: make every running row's next write
        range writable (allocate / copy-on-write), upload the tables if they
        changed, and return the rows the exhausted pool cannot extend (the
        scheduler finishes them gracefully). ``n`` is the chunk depth, an
        int (decode chunk: every row advances n) or a per-row width map (the
        mixed step: 1 for decode rows, the prompt chunk for prefill rows,
        0 for no writes)."""
        al = self.allocator
        stop: list[tuple[int, int]] = []
        pairs: list[tuple[int, int]] = []
        for r, serial in running:
            w = n if isinstance(n, int) else n.get(r, 0)
            if not w:
                continue
            pos = int(sched._pos[r])
            try:
                pairs += al.ensure_writable(r, pos, min(pos + w, self.S))
            except PoolExhausted:
                try:  # reclaim idle retained prefixes before giving up
                    self._evict_idle(sched)
                    pairs += al.ensure_writable(r, pos, min(pos + w, self.S))
                except PoolExhausted:
                    stop.append((r, serial))
        self._run_copies(sched, pairs)
        self._sync_tables(sched._bufs)
        return stop

    def _sync_tables(self, bufs: dict) -> None:
        """Upload the host tables when they changed, from a fresh copy."""
        if self.allocator.dirty:
            bufs["tables"] = upload(self.allocator.tables, self.eng.device)
            self.allocator.dirty = False

    # -- internals ----------------------------------------------------------

    def _evict_idle(self, sched, exclude: int | None = None) -> None:
        """Release every idle slot's retained blocks; their prefix-cache
        entries go with them. Busy slots are never touched."""
        for i in range(self.B):
            if i == exclude or sched._slots[i] is not None:
                continue
            if self.allocator.rows[i]:
                self.allocator.release_row(i)
                sched._row_ids[i] = []

    def _run_copies(self, sched, pairs: list[tuple[int, int]]) -> None:
        """Copy-on-write block copies on every pool array (codes and scales
        on an int8 pool). They are queued on the stream ahead of the step
        that writes the copies."""
        if not pairs:
            return
        dev = self.eng.device
        src = upload(np.asarray([p[0] for p in pairs], np.int64), dev)
        dst = upload(np.asarray([p[1] for p in pairs], np.int64), dev)
        for name in ("k", "v", "ks", "vs"):
            a = sched._bufs.get(name)
            if a is not None:
                a[:, dst] = a[:, src]
        sched.counters["kv_cow_copies_total"] += len(pairs)
