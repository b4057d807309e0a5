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

import torch

QBLOCK = 32   # q8_0 block length along the contraction axis

# the kernel's shared-memory limit for one block (227 KB on Hopper) and its
# largest head dim; fused_supported's "vmem:" and "head-dim:" reasons
SMEM_LIMIT_BYTES = 232448
MAX_HEAD_DIM = 256
_WARPS, _ROWS_PER_TASK = 16, 4   # csrc/fused_decode.cu kWarps, kRT

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# served path ran the kernel); only the CUDA wrapper below increments it.
# One launch per layer: the cross-head sum is a last-block reduction.
launches = 0

_fn = None
_counters: dict[torch.device, torch.Tensor] = {}


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def fused_smem_bytes(batch: int, dim: int, head_dim: int, n_rep: int,
                     act_bytes: int = 2) -> int:
    """Shared memory one fused call needs (csrc/fused_decode.cu ``Smem``):
    the normalized x [B, D] and the attention output [B, R·Hd] in the
    activation dtype; the rounded q [B, R·Hd], the diagonal K/V [B, Hd] and
    the attention partials of 16 warps × 4 heads in f32."""
    rhd = n_rep * head_dim
    return (_a16(batch * dim * act_bytes) + _a16(batch * rhd * 4)
            + 2 * _a16(batch * head_dim * 4) + _a16(batch * rhd * act_bytes)
            + 2 * _a16(_WARPS * _ROWS_PER_TASK * 4)
            + _a16(_WARPS * _ROWS_PER_TASK * head_dim * 4) + 16)


def fused_supported(cfg, *, weight_kind: str | None = None, batch: int = 1,
                    act_bytes: int = 2) -> str | None:
    """None when the fused kernel can serve this config's decode step, else
    the reason the engine logs before decoding unfused. ``weight_kind`` is
    the attention projections' pack kind (None = dense).

    The structural reasons are the reference's. Two are the CUDA kernel's
    own: ``head-dim:<n>`` also for head dims above ``MAX_HEAD_DIM``, and
    ``vmem:<n>KiB`` when the shared-memory working set (``fused_smem_bytes``,
    mostly B·D) passes ``SMEM_LIMIT_BYTES``, where the reference budgets
    the TPU's 16 MiB of VMEM for its weight tiles instead."""
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
    est = fused_smem_bytes(batch, cfg.dim, cfg.head_dim,
                           cfg.n_heads // cfg.n_kv_heads, act_bytes)
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


def _kernel():
    """The C entry point, built from ``csrc/fused_decode.cu`` at first use."""
    global _fn
    if _fn is None:
        from .cuda_build import load_library

        fn = load_library("fused_decode").dlp_fused_decode
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 23 + [i] * 11 + [f] * 3 + [i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _weight(block, name: str, dtype: torch.dtype, dev) -> tuple[int, int | None]:
    """(codes or weight pointer, scale pointer or None) of one projection:
    a dense [F, D] tensor in the activation dtype, or a q8_0 pack."""
    from .quant_matmul import QuantPack

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
    return w.data_ptr(), None


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
    kernel does not take, and when the launch fails."""
    global launches
    cfg = block.cfg
    B, D = x.shape
    N, bs, K, Hd = k_pool.shape
    H = cfg.n_heads
    NT = tables.shape[-1]
    dev = x.device
    wq = block._modules.get("wq")
    reason = _supported(cfg, weight_kind=wq.kind if wq is not None else None,
                        batch=B, act_bytes=x.element_size())
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
    quant = k_scale is not None
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
    ptrs = [_weight(block, n, x.dtype, dev) for n in ("wq", "wk", "wv", "wo")]
    w_q8 = ptrs[0][1] is not None
    if any((s is not None) != w_q8 for _, s in ptrs):
        raise ValueError("fused_decode_attn: wq, wk, wv and wo must all be dense "
                         "or all q8_0 packs")
    if w_q8 and x.dtype != torch.bfloat16:
        raise ValueError("fused_decode_attn: q8_0 weights serve bf16 x")
    counter = _counters.get(dev)
    if counter is None:
        counter = _counters[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    k_new = torch.empty(B, K, Hd, dtype=x.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    ws = torch.empty(K, B, D, dtype=torch.float32, device=dev)
    window = block.window
    with torch.cuda.device(dev):
        rc = _kernel()(
            x.data_ptr(), norm.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            *(p for pair in ptrs for p in pair),
            k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), y.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), ws.data_ptr(),
            counter.data_ptr(), B, D, H, K, Hd, NT, bs,
            0 if x.dtype == torch.float32 else 1, int(w_q8), int(quant),
            int(cfg.rope_style == "half"), float(cfg.norm_eps),
            float(cfg.attn_scale or Hd ** -0.5), float(cfg.attn_softcap or 0.0),
            int(window), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode_attn: kernel launch failed (cudaError {rc})")
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
