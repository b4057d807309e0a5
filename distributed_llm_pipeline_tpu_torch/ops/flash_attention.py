"""Causal-over-cache attention: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatch between them by device.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention`` of ``distributed_llm_pipeline_tpu/ops/flash_attention.py``
and computes the same function: q ``[B, T, H, Hd]`` against k, v
``[B, S, K, Hd]`` (``H = K * n_rep``), where key column c attends query t iff
``c <= cache_len[b] + t`` and, on a windowed layer, ``cache_len[b] + t - c <
window``. Scores are scaled (``scale`` 0 means ``Hd ** -0.5``), soft-capped
before the mask, and soft-maxed in f32; the output has q's dtype. An int8 KV
cache passes its codes with f32 scales ``[B, S, K, 1]``; each K/V value is
dequantized as ``code * scale`` and rounded to q's dtype before the dot.

The kernel is ``csrc/paged_tile.cuh``'s split-KV kernel with its dense
addressing policy: the cache is cut into virtual pages of ``DENSE_PAGE``
columns, and ``paged_attention.split_plan`` cuts the launch from shapes alone
(``cache_len`` is never read on the host), with a workspace for the runs'
partials (``paged_attention.workspace_numel``) when it splits.

Dispatch: ``attention_any`` sends a CUDA tensor to the kernel and a CPU
tensor to the plain version, which is the reference's einsum path. There is
no fallback: a kernel that cannot take its inputs, or cannot build or
launch, raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

NEG_INF = -1e30   # the masked-score fill of the reference and the kernel
# head widths the kernel takes; 512 serves the single-stream latent path at
# head dim r (the paged kernel stays at PAGED_HEAD_DIMS)
HEAD_DIMS = (64, 128, 256, 512)
PAGED_HEAD_DIMS = (64, 128, 256)
# columns of a virtual page of the dense cache: the unit the split plan cuts
# the walk into (NT = ceil(S / DENSE_PAGE) pages)
DENSE_PAGE = 64

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# served path ran the kernel); only the CUDA wrapper below increments it.
# ``row_launches`` counts the launches whose cache_len was a [B] tensor of
# per-row lengths (batch generation's decode steps)
launches = 0
row_launches = 0

_fn = None


def _kernel():
    """The C entry point, built from ``csrc/flash_attention.cu`` at first use."""
    global _fn
    if _fn is None:
        from .cuda_build import load_library

        fn = load_library("flash_attention").dlp_flash_attention
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 6 + [i, p, p] + [i] * 8 + [f, f] + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _scale(scale: float, head_dim: int) -> float:
    return float(scale) if scale else head_dim ** -0.5


def dense_plan(B: int, T: int, H: int, K: int, S: int, geometry, sm_count: int):
    """The split plan of a launch over a dense cache of S columns: the paged
    kernel's plan (``paged_attention.split_plan``) over ``ceil(S /
    DENSE_PAGE)`` virtual pages of ``DENSE_PAGE`` columns, from shapes and
    the kernel's tiling only. Run s walks columns ``[s · pps · DENSE_PAGE,
    min(S, (s + 1) · pps · DENSE_PAGE))``."""
    # paged_attention imports this module: its plan is imported at call time
    from .paged_attention import split_plan

    return split_plan(B, T, H, K, -(-S // DENSE_PAGE), DENSE_PAGE, geometry, sm_count)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache_len, n_rep: int, *, scale: float = 0.0,
                    softcap: float = 0.0, window: int | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel. ``cache_len`` is an int, or an int tensor of shape
    ``[]`` or ``[B]`` on q's device (an int goes to the kernel as a scalar
    argument, never through a copy to the card). Raises on any input the
    kernel does not take, and when the launch fails."""
    # imported here for the reason dense_plan gives
    from .paged_attention import check_aligned, sm_count, tile_geometry, workspace_numel

    global launches, row_launches
    B, T, H, Hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must be on one CUDA device")
    if k.shape != (B, S, K, Hd) or v.shape != k.shape or H != K * n_rep:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, n_rep {n_rep}")
    if Hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: q dtype {q.dtype} (float32 or bfloat16)")
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("flash_attention: k_scale and v_scale go together")
    if quant:
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or s.shape != (B, S, K, 1)
                    or s.device != q.device or not s.is_contiguous()):
                raise ValueError("flash_attention: scales must be contiguous "
                                 f"float32 [B, S, K, 1] on {q.device}")
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError("flash_attention: scales need int8 k and v")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: k/v dtype {k.dtype}/{v.dtype} "
                         f"must match q's {q.dtype} (or be int8 with scales)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    check_aligned("flash_attention", q, k, v)
    window = 0 if window is None else int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    lens, lens_scalar = None, 0
    if isinstance(cache_len, torch.Tensor):
        if cache_len.numel() not in (1, B) or cache_len.device != q.device:
            raise ValueError("flash_attention: cache_len tensor must hold 1 "
                             f"or {B} values on {q.device}")
        lens = cache_len.reshape(-1).to(torch.int32).expand(B).contiguous()
    else:
        lens_scalar = int(cache_len)
    out = torch.empty_like(q)
    plan = dense_plan(B, T, H, K, S, tile_geometry("flash_attention", Hd),
                      sm_count(q.device.index))
    n = workspace_numel(plan, B, T, H, Hd)
    ws = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    # the device's context only where it is not current (entering one costs
    # host time on every launch of a host-bound decode step)
    here = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            lens.data_ptr() if lens is not None else None, lens_scalar,
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            B, T, S, H, K, Hd, 0 if q.dtype == torch.float32 else 1, int(quant),
            _scale(scale, Hd), float(softcap), window, DENSE_PAGE,
            plan.rows_per_block, plan.pages_per_split, plan.splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (cudaError {rc}, {plan})")
    launches += 1
    if lens is not None and cache_len.dim() == 1:
        row_launches += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, n_rep: int, scale: float = 0.0,
              softcap: float = 0.0) -> torch.Tensor:
    """The reference einsum attention: q [B, T, H, Hd]; k, v [B, S, K, Hd];
    mask [B, T, S] bool (True = attend). Softmax in f32."""
    B, T, H, Hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, T, K, n_rep, Hd).float()
    scores = torch.einsum("btkrh,bskh->bkrts", qg, k.float()) * _scale(scale, Hd)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrts,bskh->btkrh", probs, v.float())
    return out.reshape(B, T, H, Hd).to(q.dtype)


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache_len, n_rep: int, *, scale: float = 0.0,
                          softcap: float = 0.0, window: int | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the mask is
    built from ``cache_len`` and ``window`` and the einsum attention runs
    over the whole window."""
    if k_scale is not None:
        k = kv_dequantize(k, k_scale, q.dtype)
        v = kv_dequantize(v, v_scale, q.dtype)
    B, T = q.shape[:2]
    S = k.shape[1]
    kpos = torch.arange(S, device=q.device, dtype=torch.int32)
    cl = torch.as_tensor(cache_len, device=q.device).to(torch.int32).reshape(-1, 1, 1)
    qpos = cl + torch.arange(T, device=q.device, dtype=torch.int32)[None, :, None]
    mask = kpos[None, None, :] <= qpos
    if window:
        mask &= qpos - kpos[None, None, :] < int(window)
    return attention(q, k, v, mask.expand(B, T, S), n_rep, scale=scale,
                     softcap=softcap)


def attention_any(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache_len, n_rep: int, scale: float = 0.0,
                  softcap: float = 0.0, window: int | None = None,
                  k_scale: torch.Tensor | None = None,
                  v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over the causal-over-cache window, by q's device: the CUDA
    kernel for a CUDA tensor (prefill and decode alike), the plain version
    for a CPU tensor."""
    kw = dict(scale=scale, softcap=softcap, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return flash_attention(q, k, v, cache_len, n_rep, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, cache_len, n_rep, **kw)
    raise ValueError(f"attention_any: no attention for device {q.device}")
