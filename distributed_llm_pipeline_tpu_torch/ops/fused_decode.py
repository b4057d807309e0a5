"""The fused decode step of one layer's attention half: the hand-written CUDA
kernel, its plain PyTorch version, the support gate and the dispatch by
device.

For a T = 1 paged decode step the kernel (``csrc/fused_decode.cu``) runs
RMSNorm → Q/K/V matvecs → RoPE → attention over the pool through the block
tables, plus the new token's own diagonal term → O-projection + residual in
one launch per layer, keeping every intermediate on chip. It replaces the
TPU kernel ``fused_decode_attn`` of ``distributed_llm_pipeline_tpu/ops/
fused_decode.py`` and computes the same function: weights dense or q8_0
packs, pools in the activation dtype or int8 with f32 scales, both rope
styles, window and softcap. It returns ``y [B, D]`` and the new token's K/V
``[B, K, Hd]`` (post-rope, pre-quant), which the caller scatters into the
pool with the same write as the unfused step.

``fused_decode_plain`` is the unfused composition (``Block.qkv``, the pool
write, ``paged_attention_plain``, ``Block.attn_out``), as the reference's
``fused_decode_ref`` is. ``fused_supported`` gives the reason a config
cannot take the kernel (None when it can); the engine logs it once and
decodes unfused.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .paged_attention import check_aligned
from .quant_matmul import QuantPack

QBLOCK = 32   # q8_0 block length along the contraction axis

# the kernel's shared-memory limit for one block (227 KB on Hopper) and its
# largest head dim; fused_supported's "vmem:" and "head-dim:" reasons
SMEM_LIMIT_BYTES = 232448
MAX_HEAD_DIM = 256

# csrc/fused_decode.cu's cut: CTAs a kv head (the cluster: the H100 holds 15
# clusters of 8 at once but 7 of 16, so 8 kv heads take one wave only
# at 8), pool columns a key tile, the ring's stage bytes it aims at (a tile
# costs a fixed wait, so fewer, larger tiles), and the kernel's limits
FUSED_CLUSTER = 8
KEY_TILE = 32
STAGE_BYTES = 64 << 10
MAX_STAGES = 16
MAX_KV_ROUND = 8
H100_SMS = 132

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# served path ran the kernel); only the CUDA wrapper below increments it.
# One launch per layer: the cross-head sum is a last-CTA reduction a slice.
launches = 0

_fn = None
_counters: dict[torch.device, torch.Tensor] = {}


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _chunks(n: int) -> int:
    """Units of 256 columns a row of n columns takes (a warp's lanes, 8
    columns each)."""
    return -(-n // 256)


class FusedPlan(NamedTuple):
    """How one launch of the fused kernel is cut, from shapes only: a
    cluster of ``cluster`` CTAs a kv head (``ctas`` = K · cluster in all);
    CTA c takes the head's Q/K/V rows ``[c · qkv_rows, (c + 1) · qkv_rows)``
    of its R·Hd + 2·Hd (the last ones fewer) and the rows ``[c · out_rows,
    (c + 1) · out_rows)`` of wo, the same columns of y; a ring of
    ``stages`` stages of ``stage_bytes`` bytes, each holding ``qkv_tile``
    Q/K/V rows; ``kv_round`` key tiles of ``KEY_TILE`` columns a round,
    ``kv_buffers`` rounds in flight; with ``late_keys`` the key tiles'
    arrays overlay the ring and their first copies wait for its last tile
    (a cut that fits no other way: f32 activations at a large B); ``smem``
    bytes of shared memory a CTA (``fused_layout``)."""
    cluster: int
    ctas: int
    qkv_rows: int
    out_rows: int
    qkv_tile: int
    stages: int
    stage_bytes: int
    kv_round: int
    kv_buffers: int
    late_keys: int
    smem: int


def fused_layout(batch: int, dim: int, n_rep: int, head_dim: int, act_bytes: int,
                 w_q8: bool, kv_int8: bool, plan) -> dict[str, int]:
    """The byte offsets of one CTA's shared memory (csrc/fused_decode.cu
    ``make_layout``): the key runs; h [B, D + 8], whose place the roped q
    and the diagonal K/V take once the Q/K/V tiles are done; the raw Q/K/V
    products; after the diagonal K/V, over what h and the products leave
    once RoPE has read them, the attention output [B, R·Hd + 8] and the
    (m, l, acc) partials; two tiles' units' sums; the key tiles' items,
    pool rows and slots (an int8 round's dequantized once more into the
    activation dtype); the ring (a stage's rows D·w + 16 bytes apart, then
    a q8_0 tile's run of scales), in the key tiles' place with
    ``late_keys``; an mbarrier a stage, a flag and the 16 warps' RMSNorm
    sums; ``total`` the sum. ``plan`` needs the FusedPlan fields from
    ``qkv_rows`` to ``late_keys``."""
    B, D, Hd = batch, dim, head_dim
    rhd = n_rep * Hd
    nq = rhd + 2 * Hd
    wb = 1 if w_q8 else act_bytes
    kb = 1 if kv_int8 else act_bytes
    slot_v = _a16(KEY_TILE * Hd * kb)
    out = {"qkv_sc": _a16(plan.qkv_tile * (D * wb + 16)), "slot_v": slot_v,
           "slot_s": 2 * slot_v, "slot": 2 * slot_v + (2 * KEY_TILE * 4 if kv_int8 else 0),
           "cslot": 2 * _a16(KEY_TILE * Hd * act_bytes) if kv_int8 else 0,
           "red_stage": _a16(plan.qkv_tile * max(16, _chunks(D)) * B * 4)}
    out["qkv_need"] = out["qkv_sc"] + (
        _a16(plan.qkv_tile * D // 16) + (16 if D % 256 else 0) if w_q8 else 0)
    o = out["runs"] = 0
    o += _a16(2 * B * 4)
    # f32 rows need no padding: only the bf16 fragments' loads meet banks
    pad = 8 if act_bytes == 2 else 0
    out["h"] = u = o
    for name, n in (("qr", _a16(B * rhd * act_bytes)), ("kd", _a16(B * Hd * 4)),
                    ("vd", _a16(B * Hd * 4))):
        out[name] = u
        u += n
    out["prod"] = o + max(_a16(B * (D + pad) * act_bytes), u - o)
    keys = (("items", _a16(plan.kv_buffers * plan.kv_round * 3 * 4)),
            ("vecs", plan.kv_buffers * plan.kv_round * KEY_TILE * 4),
            ("kv", plan.kv_buffers * plan.kv_round * out["slot"]),
            ("kvc", plan.kv_round * out["cslot"]))
    attn = (("at", _a16(B * (rhd + pad) * act_bytes)), ("pm", _a16(B * n_rep * 4)),
            ("pl", _a16(B * n_rep * 4)), ("pacc", _a16(B * n_rep * Hd * 4)))
    for name, n in attn + (keys if plan.late_keys else ()):
        out[name] = u
        u += n
    # the tiles' sums and the ring after the products (and, while the key
    # tiles are in flight under the Q/K/V tiles, after the partials too)
    o = out["red"] = out["prod"] + _a16(B * nq * 4)
    if not plan.late_keys:
        o = out["red"] = max(o, u)
    o += 2 * out["red_stage"]
    for name, n in () if plan.late_keys else keys:
        out[name] = o
        o += n
    out["ring"] = o
    o = max(o + plan.stages * plan.stage_bytes, u)
    for name, n in (("bars", _a16(8 * plan.stages)), ("flag", 16 + 4 * 16)):
        out[name] = o
        o += n
    out["total"] = o
    return out


def qkv_tiles(first: int, end: int, rhd: int, head_dim: int, tile: int) -> list[tuple[int, int]]:
    """(first row, rows) of each ring tile of a CTA's Q/K/V rows [first,
    end) of the head's R·Hd + 2·Hd: cut at the wq | wk | wv edges (one
    projection a tile), at most ``tile`` rows each (the kernel's
    ``qkv_tile``)."""
    edges = (0, rhd, rhd + head_dim, rhd + 2 * head_dim)
    out = []
    for lo, hi in zip(edges, edges[1:]):
        a, e = max(first, lo), min(end, hi)
        out += [(r, min(tile, e - r)) for r in range(a, e, tile)]
    return out


def key_run(lo: int, end: int, rank: int, cluster: int) -> tuple[int, int]:
    """The visible keys [lo, end) of one row that CTA ``rank`` of the
    cluster attends (the kernel's runs): the n = end - lo keys cut into
    ``cluster`` contiguous runs, run c = [lo + n·c // C, lo + n·(c+1) // C)."""
    n = max(0, end - lo)
    return lo + n * rank // cluster, lo + n * (rank + 1) // cluster


def visible(length: int, window: int, max_pos: int) -> tuple[int, int]:
    """A row's visible pool positions [lo, end): the last ``window`` - 1
    before its new token (all of them without a window), within the pool's
    ``max_pos`` positions."""
    return (max(0, length - window + 1) if window > 0 else 0), min(length, max_pos)


def key_tiles(runs: list[tuple[int, int]], kv_round: int) -> list[list[tuple[int, int, int]]]:
    """The rounds of (row, first key, keys) tiles of ``KEY_TILE`` columns a
    CTA walks over its runs (one a row): tile-major over the rows, so a
    round holds the same tile of as many rows as it can."""
    counts = [-(-(e - a) // KEY_TILE) for a, e in runs]
    items = [(b, runs[b][0] + t * KEY_TILE, min(KEY_TILE, runs[b][1] - runs[b][0] - t * KEY_TILE))
             for t in range(max(counts, default=0)) for b in range(len(runs)) if t < counts[b]]
    return [items[i:i + kv_round] for i in range(0, len(items), kv_round)]


def _cluster_size(n_kv_heads: int) -> int:
    """The plan's CTAs a kv head: the largest power of two up to
    ``FUSED_CLUSTER`` with K of them on the H100's SMs, at least 1."""
    c = min(FUSED_CLUSTER, max(1, H100_SMS // n_kv_heads))
    return 1 << (c.bit_length() - 1)


# the cuts fused_plan tries, in order: (ring tile rows, or 0 for the
# STAGE_BYTES tile; key tiles a round, or 0 for min(B, MAX_KV_ROUND);
# rounds in flight; least stages; late keys)
_CUTS = ((0, 0, 2, 2, 0), (0, 0, 1, 1, 0), (0, 1, 1, 1, 0), (2, 1, 1, 1, 0),
         (0, 0, 2, 1, 1), (0, 1, 1, 1, 1), (2, 1, 1, 1, 1), (1, 1, 1, 1, 1))


@functools.lru_cache(maxsize=256)
def fused_plan(batch: int, dim: int, n_heads: int, n_kv_heads: int, head_dim: int,
               act_bytes: int = 2, w_q8: bool = False, kv_int8: bool = False) -> FusedPlan:
    """The fused kernel's cut, from shapes only (no value is read from the
    card). The rows of a head split evenly over its cluster; a ring tile is
    the largest power of two of rows within ``STAGE_BYTES`` (at least 2, at
    most the CTA's rows, rounded up to even); ``min(B, MAX_KV_ROUND)`` key
    tiles a round, two rounds in flight, and as many stages as the CTA has
    tiles and shared memory allows (up to ``MAX_STAGES``, at least 2).
    Where that does not fit, one round in flight, then one tile a round,
    then tiles of two rows, down to one stage; then the same with the key
    tiles in the ring's place (``late_keys``). Raises ``ValueError`` when
    even that does not fit (``fused_supported``'s ``vmem:`` reason)."""
    B, D, Hd = batch, dim, head_dim
    R = n_heads // n_kv_heads
    rhd = R * Hd
    nq = rhd + 2 * Hd
    C = _cluster_size(n_kv_heads)
    qkv_rows, out_rows = -(-nq // C), -(-D // C)
    row_bytes = D * (1 if w_q8 else act_bytes) + (D // 16 if w_q8 else 0)   # and its scales

    def plan(qt: int, kv_round: int, kv_buffers: int, least: int, late: int) -> FusedPlan | None:
        tiles = max(len(qkv_tiles(min(nq, c * qkv_rows), min(nq, (c + 1) * qkv_rows), rhd,
                                  Hd, qt)) for c in range(C))
        base = FusedPlan(C, n_kv_heads * C, qkv_rows, out_rows, qt, 1, 0, kv_round,
                         kv_buffers, late, 0)
        lay = fused_layout(B, D, R, Hd, act_bytes, w_q8, kv_int8, base)
        stage = -(-lay["qkv_need"] // 128) * 128
        top = min(MAX_STAGES, max(1, tiles))
        for stages in range(top, min(least, top) - 1, -1):
            p = base._replace(stages=stages, stage_bytes=stage)
            total = fused_layout(B, D, R, Hd, act_bytes, w_q8, kv_int8, p)["total"]
            if total <= SMEM_LIMIT_BYTES:
                return p._replace(smem=total)
        return None

    qt = min(1 << max(1, (STAGE_BYTES // row_bytes).bit_length() - 1), qkv_rows + qkv_rows % 2)
    for tile, kv_round, kv_buffers, least, late in _CUTS:
        p = plan(tile or qt, kv_round or min(B, MAX_KV_ROUND), kv_buffers, least, late)
        if p is not None:
            return p
    least = _least_smem(B, D, n_heads, n_kv_heads, Hd, act_bytes, w_q8, kv_int8)
    raise ValueError(f"fused_plan: no cut fits {SMEM_LIMIT_BYTES} bytes of shared memory "
                     f"(the smallest takes {least})")


def _least_smem(batch: int, dim: int, n_heads: int, n_kv_heads: int, head_dim: int,
                act_bytes: int, w_q8: bool, kv_int8: bool) -> int:
    """The smallest cut's shared memory (tiles of one row, one stage, one
    key tile, late): what ``vmem:`` reports when even it does not fit."""
    rhd = n_heads // n_kv_heads * head_dim
    C = _cluster_size(n_kv_heads)
    p = FusedPlan(C, n_kv_heads * C, -(-(rhd + 2 * head_dim) // C), -(-dim // C), 1, 1, 0, 1,
                  1, 1, 0)
    lay = fused_layout(batch, dim, n_heads // n_kv_heads, head_dim, act_bytes, w_q8, kv_int8, p)
    return fused_layout(batch, dim, n_heads // n_kv_heads, head_dim, act_bytes, w_q8, kv_int8,
                        p._replace(stage_bytes=-(-lay["qkv_need"] // 128) * 128))["total"]


def fused_smem_bytes(batch: int, dim: int, head_dim: int, n_rep: int,
                     act_bytes: int = 2, *, n_kv_heads: int = 8, w_q8: bool = False,
                     kv_int8: bool = False) -> int:
    """Shared memory one fused call takes (``fused_plan(...).smem``, the sum
    of ``fused_layout``): h [B, D], the Q/K/V products, the partials, the
    key tiles and the weight ring. Where no cut fits, the smallest cut's
    bytes (more than ``SMEM_LIMIT_BYTES``)."""
    H = n_rep * n_kv_heads
    try:
        return fused_plan(batch, dim, H, n_kv_heads, head_dim, act_bytes, w_q8, kv_int8).smem
    except ValueError:
        return _least_smem(batch, dim, H, n_kv_heads, head_dim, act_bytes, w_q8, kv_int8)


def fused_supported(cfg, *, weight_kind: str | None = None, batch: int = 1,
                    act_bytes: int = 2, kv_int8: bool = False) -> str | None:
    """None when the fused kernel can serve this config's decode step, else
    the reason the engine logs before decoding unfused. ``weight_kind`` is
    the attention projections' pack kind (None = dense); ``kv_int8`` says
    the pools hold int8 codes (else the activation dtype).

    The structural reasons are the reference's. Two are the CUDA kernel's
    own: ``head-dim:<n>`` also for head dims above ``MAX_HEAD_DIM``, and
    ``vmem:<n>KiB`` when no cut of ``fused_plan`` fits ``SMEM_LIMIT_BYTES``
    of shared memory (mostly B·D of h), where the reference budgets the
    TPU's 16 MiB of VMEM for its weight tiles instead."""
    if cfg.norm_type != "rms":
        return "norm-type:layer"
    if not cfg.pre_norms:
        return "no-pre-norms"
    if cfg.norm_offset:
        return "norm-offset"
    if cfg.qk_norm:
        return "qk-norm"
    if cfg.attn_bias or cfg.attn_out_bias:
        return "attn-bias"
    if cfg.post_norms:
        return "sandwich-norms"
    if cfg.rope_style not in ("interleaved", "half"):
        return f"rope-style:{cfg.rope_style}"
    if cfg.head_dim % 8 or cfg.head_dim < 8 or cfg.head_dim > MAX_HEAD_DIM:
        return f"head-dim:{cfg.head_dim}"
    if cfg.n_heads % cfg.n_kv_heads:
        return "gqa-ragged"
    if weight_kind not in (None, "q8_0"):
        return f"weight-pack:{weight_kind}"
    # a head group's slice of wo starts at g·R·Hd: whole q8_0 blocks only
    if weight_kind == "q8_0" and (
            cfg.dim % QBLOCK
            or (cfg.n_heads // cfg.n_kv_heads * cfg.head_dim) % QBLOCK):
        return "q8_0-align"
    est = fused_smem_bytes(batch, cfg.dim, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
                           act_bytes, n_kv_heads=cfg.n_kv_heads, w_q8=weight_kind == "q8_0",
                           kv_int8=kv_int8)
    if est > SMEM_LIMIT_BYTES:
        return f"vmem:{est >> 10}KiB"
    return None


# the wrapper's per-call check, cached: configs are frozen dataclasses
_supported = functools.lru_cache(maxsize=64)(fused_supported)


def decode_hbm_bytes(cfg, kv_len: int, batch: int = 1, fused: bool = True,
                     w_bytes: float = 2.0, kv_bytes: float = 2.0,
                     act_bytes: int = 2) -> int:
    """Bytes one decode step moves through a layer's attention half. Both
    paths stream the projection weights once and read ``kv_len`` cached
    tokens; the unfused path also writes and reads back every intermediate
    (normed x, q, k, v, attention output), the fused one only x in, y out and
    the new token's K/V."""
    d, hd, h, k = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    weights = (d * h * hd + 2 * d * k * hd + h * hd * d) * w_bytes
    kv = 2 * kv_len * k * hd * kv_bytes * batch
    new_kv = 2 * k * hd * kv_bytes * batch
    xy = 2 * batch * d * act_bytes
    if fused:
        return int(weights + kv + new_kv + xy)
    inter = (d + h * hd + 2 * k * hd + h * hd) * batch * act_bytes
    return int(weights + kv + new_kv + xy + 2 * inter)


def _library():
    from .cuda_build import load_library

    return load_library("fused_decode")


_PLAN_ARGS = ("cluster", "qkv_rows", "out_rows", "qkv_tile", "stages", "stage_bytes",
              "kv_round", "kv_buffers", "late_keys", "smem")


def _kernel():
    """The C entry point, built from ``csrc/fused_decode.cu`` at first use."""
    global _fn
    if _fn is None:
        fn = _library().dlp_fused_decode
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 23 + [i] * 11 + [f] * 3 + [i] * (1 + len(_PLAN_ARGS)) + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _plan_args(plan: FusedPlan) -> tuple[int, ...]:
    """The plan's ints in the C entries' order."""
    return tuple(getattr(plan, k) for k in _PLAN_ARGS)


@functools.lru_cache(maxsize=256)
def _launch_plan(*shape) -> tuple[FusedPlan, tuple[int, ...]]:
    """``fused_plan`` of these shapes and its C arguments, one lookup a call."""
    plan = fused_plan(*shape)
    return plan, _plan_args(plan)


def max_active_clusters(plan: FusedPlan, batch: int, dim: int, n_heads: int,
                        n_kv_heads: int, head_dim: int, act_bytes: int = 2,
                        w_q8: bool = False, kv_int8: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the instantiation and plan a
    launch of these shapes takes: how many of its clusters the card holds
    at once (at least K of them for one wave)."""
    fn = _library().dlp_fused_decode_max_clusters
    fn.argtypes = [ctypes.c_int] * (8 + len(_PLAN_ARGS)) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(batch, dim, n_heads, n_kv_heads, head_dim, int(act_bytes == 2), int(w_q8),
            int(kv_int8), *_plan_args(plan), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"max_active_clusters: cudaError {rc}")
    return out.value


def _weight(block, name: str, dtype: torch.dtype, dev) -> tuple[int, int | None]:
    """(codes or weight pointer, scale pointer or None) of one projection:
    a dense [F, D] tensor in the activation dtype, or a q8_0 pack (its
    fields checked once a placement, ``QuantPack.kernel_ptrs``)."""
    w = block._modules[name] if name in block._modules else block._parameters[name]
    if isinstance(w, QuantPack):
        if w.kind != "q8_0":
            raise ValueError(f"fused_decode_attn: {name} is a {w.kind} pack "
                             "(dense or q8_0 only)")
        qs, sc = w.kernel_ptrs(dev)
        return qs, sc
    if w.dtype != dtype or w.device != dev or not w.is_contiguous():
        raise ValueError(f"fused_decode_attn: {name} must be contiguous {dtype} "
                         f"on {dev}, got {w.dtype} on {w.device}")
    ptr = w.data_ptr()
    if ptr % 16:
        check_aligned(f"fused_decode_attn: {name}", w)
    return ptr, None


def fused_decode_attn(x: torch.Tensor, block, cos: torch.Tensor,
                      sin: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, *,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None,
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel over ``block``'s weights (``models.llama.Block``:
    ``attn_norm``, ``wq``/``wk``/``wv``/``wo`` dense in x's dtype or q8_0
    packs with bf16 x). ``x`` [B, D]; ``cos``/``sin`` [B, Hd/2] f32 at each
    row's position ``lengths[b]``; the pools hold positions [0, lengths[b]).
    Returns ``(y [B, D], k_new, v_new [B, K, Hd])``. Raises on any input the
    kernel does not take (a view off a 16-byte boundary included: the
    kernel's bulk and 16-byte copies would fault), and when the launch
    fails."""
    global launches
    cfg = block.cfg
    B, D = x.shape
    N, bs, K, Hd = k_pool.shape
    H = cfg.n_heads
    NT = tables.shape[-1]
    dev = x.device
    wq = block._modules.get("wq")
    quant = k_scale is not None
    reason = _supported(cfg, weight_kind=wq.kind if wq is not None else None,
                        batch=B, act_bytes=x.element_size(), kv_int8=quant)
    if reason is not None:
        raise ValueError(f"fused_decode_attn: config not supported ({reason})")
    if not (x.is_cuda and all(t.device == dev for t in
                              (cos, sin, k_pool, v_pool, tables, lengths))):
        raise ValueError("fused_decode_attn: x, rope tables, pools, tables and "
                         "lengths must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"fused_decode_attn: x must be contiguous float32 or "
                         f"bfloat16, got {x.dtype}")
    if D != cfg.dim or D % 8 or K != cfg.n_kv_heads or Hd != cfg.head_dim \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"fused_decode_attn: x {tuple(x.shape)} and pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not "
                         f"fit the config (D {cfg.dim}, K {cfg.n_kv_heads}, "
                         f"Hd {cfg.head_dim}; D a multiple of 8)")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (B, Hd // 2) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"fused_decode_attn: {name} must be contiguous "
                             f"float32 [{B}, {Hd // 2}]")
    if tables.shape != (B, NT) or tables.dtype != torch.int32 \
            or not tables.is_contiguous():
        raise ValueError("fused_decode_attn: tables must be contiguous int32 "
                         f"[{B}, NT], got {tables.dtype} {tuple(tables.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("fused_decode_attn: lengths must be contiguous int32 "
                         f"[{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    if (v_scale is not None) != quant:
        raise ValueError("fused_decode_attn: k_scale and v_scale go together")
    if quant:
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or s.shape != (N, bs, K, 1)
                    or s.device != dev or not s.is_contiguous()):
                raise ValueError("fused_decode_attn: scales must be contiguous "
                                 f"float32 [N, bs, K, 1] on {dev}")
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError("fused_decode_attn: scales need int8 pools")
    elif k_pool.dtype != x.dtype or v_pool.dtype != x.dtype:
        raise ValueError(f"fused_decode_attn: pool dtype {k_pool.dtype} must "
                         f"match x's {x.dtype} (or be int8 with scales)")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("fused_decode_attn: the pools must be contiguous")
    norm = block._parameters["attn_norm"]
    if norm.dtype != x.dtype or norm.device != dev or not norm.is_contiguous():
        raise ValueError(f"fused_decode_attn: attn_norm must be contiguous "
                         f"{x.dtype} on {dev}")
    args = (x, norm, cos, sin, k_pool, v_pool, tables, lengths)
    if quant:
        args += (k_scale, v_scale)
    addr = [t.data_ptr() for t in args]
    if any(a % 16 for a in addr):
        check_aligned("fused_decode_attn", *args)
    ptrs = [_weight(block, n, x.dtype, dev) for n in ("wq", "wk", "wv", "wo")]
    w_q8 = ptrs[0][1] is not None
    if any((s is not None) != w_q8 for _, s in ptrs):
        raise ValueError("fused_decode_attn: wq, wk, wv and wo must all be dense "
                         "or all q8_0 packs")
    if w_q8 and x.dtype != torch.bfloat16:
        raise ValueError("fused_decode_attn: q8_0 weights serve bf16 x")
    plan, plan_args = _launch_plan(B, D, H, K, Hd, x.element_size(), w_q8, quant)
    counter = _counters.get(dev)
    if counter is None:
        counter = _counters[dev] = torch.zeros(FUSED_CLUSTER, dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    k_new = torch.empty(B, K, Hd, dtype=x.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    ws = torch.empty(K, B, D, dtype=torch.float32, device=dev)
    window = block.window
    with torch.cuda.device(dev):
        rc = _kernel()(
            *addr[:4], *(p for pair in ptrs for p in pair), addr[4], addr[5],
            addr[8] if quant else None, addr[9] if quant else None,
            addr[6], addr[7], y.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), ws.data_ptr(),
            counter.data_ptr(), B, D, H, K, Hd, NT, bs,
            0 if x.dtype == torch.float32 else 1, int(w_q8), int(quant),
            int(cfg.rope_style == "half"), float(cfg.norm_eps),
            float(cfg.attn_scale or Hd ** -0.5), float(cfg.attn_softcap or 0.0),
            int(window), *plan_args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode_attn: kernel launch failed (cudaError {rc}; "
                           f"plan {plan})")
    launches += 1
    return y, k_new, v_new


def fused_decode_plain(x: torch.Tensor, block, cos: torch.Tensor,
                       sin: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function as the unfused step computes it, on any device
    (the reference's ``fused_decode_ref``): ``Block.qkv``, the new token's
    K/V written into the pools (in place, at ``paged_write_index``'s
    places, quantized on an int8 pool), ``paged_attention_plain``, then
    ``Block.attn_out``. Returns ``(y, k_new, v_new)`` as the kernel does;
    the caller's scatter of k_new / v_new rewrites the same values."""
    from ..models.llama import _paged_kv_write, paged_write_index
    from .paged_attention import paged_attention_plain

    cfg = block.cfg
    xb = x[:, None]
    q, k, v = block.qkv(xb, cos[:, None], sin[:, None])
    where = paged_write_index(tables, lengths, 1, k_pool.shape[1])
    _paged_kv_write(k_pool, v_pool, k_scale, v_scale, k, v, *where)
    attn = paged_attention_plain(q, k_pool, v_pool, tables, lengths,
                                 cfg.n_heads // cfg.n_kv_heads,
                                 scale=cfg.attn_scale, softcap=cfg.attn_softcap,
                                 window=block.window, k_scale=k_scale,
                                 v_scale=v_scale)
    return block.attn_out(xb, attn)[:, 0], k[:, 0], v[:, 0]


def fused_decode_any(x: torch.Tensor, block, cos: torch.Tensor,
                     sin: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, *,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None):
    """The fused step by x's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    args = (x, block, cos, sin, k_pool, v_pool, tables, lengths)
    if x.is_cuda:
        return fused_decode_attn(*args, k_scale=k_scale, v_scale=v_scale)
    if x.device.type == "cpu":
        return fused_decode_plain(*args, k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"fused_decode_any: no fused step for device {x.device}")
