"""Attention over the paged KV pool: the hand-written CUDA kernel, its plain
PyTorch version, and the dispatch between them by device.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_flash_attention`` of ``distributed_llm_pipeline_tpu/ops/
paged_attention.py`` and computes the same function: q ``[B, T, H, Hd]``
against pools ``[N, bs, K, Hd]`` through int32 ``tables [B, NT]`` and int32
``lengths [B]``. Row b's query t sits at absolute position ``lengths[b] + t``;
logical column c lives at physical block ``tables[b, c // bs]``, offset
``c % bs``, and attends iff ``c <= lengths[b] + t`` and, on a windowed layer,
``lengths[b] + t - c < window``. Scores, softcap, scale and int8 pools
(f32 scales ``[N, bs, K, 1]``) follow ``ops/flash_attention.py``.

Dispatch: ``paged_attention_any`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version (gather the logical window, then the dense
plain attention). There is no fallback: a kernel that cannot take its
inputs, or cannot build or launch, raises.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_attention import PAGED_HEAD_DIMS, _scale, flash_attention_plain

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# served path ran the kernel); only the CUDA wrapper below increments it
launches = 0

_fn = None


def _kernel():
    """The C entry point, built from ``csrc/paged_attention.cu`` at first use."""
    global _fn
    if _fn is None:
        from .cuda_build import load_library

        fn = load_library("paged_attention").dlp_paged_attention
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f,
                       i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_flash_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor, n_rep: int, *,
                          scale: float = 0.0, softcap: float = 0.0,
                          window: int | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel. Raises on any input the kernel does not take, and
    when the launch fails."""
    global launches
    B, T, H, Hd = q.shape
    N, bs, K = k_pool.shape[:3]
    NT = tables.shape[-1]
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in
                              (k_pool, v_pool, tables, lengths))):
        raise ValueError("paged_flash_attention: q, pools, tables and lengths "
                         "must be on one CUDA device")
    if (k_pool.shape != (N, bs, K, Hd) or v_pool.shape != k_pool.shape
            or H != K * n_rep):
        raise ValueError(f"paged_flash_attention: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"n_rep {n_rep}")
    if tables.shape != (B, NT) or tables.dtype != torch.int32 \
            or not tables.is_contiguous():
        raise ValueError("paged_flash_attention: tables must be contiguous "
                         f"int32 [{B}, NT], got {tables.dtype} {tuple(tables.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("paged_flash_attention: lengths must be contiguous "
                         f"int32 [{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    if Hd not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged_flash_attention: head_dim {Hd} not in "
                         f"{PAGED_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_flash_attention: q dtype {q.dtype} "
                         "(float32 or bfloat16)")
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("paged_flash_attention: k_scale and v_scale go together")
    if quant:
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or s.shape != (N, bs, K, 1)
                    or s.device != dev or not s.is_contiguous()):
                raise ValueError("paged_flash_attention: scales must be "
                                 f"contiguous float32 [N, bs, K, 1] on {dev}")
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError("paged_flash_attention: scales need int8 pools")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_flash_attention: pool dtype {k_pool.dtype}/"
                         f"{v_pool.dtype} must match q's {q.dtype} (or be int8 "
                         "with scales)")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError("paged_flash_attention: q and the pools must be contiguous")
    window = 0 if window is None else int(window)
    if window < 0:
        raise ValueError(f"paged_flash_attention: window {window} < 0")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, T, NT, bs, H, K, Hd, 0 if q.dtype == torch.float32 else 1,
            int(quant), _scale(scale, Hd), float(softcap), window,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_attention: kernel launch failed "
                           f"(cudaError {rc})")
    launches += 1
    return out


def gather_paged_kv(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The logical KV window: pool ``[N, bs, ...]`` gathered by tables
    ``[B, NT]`` → ``[B, NT * bs, ...]``."""
    g = pool[tables.long()]                       # [B, NT, bs, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor, n_rep: int, *,
                          scale: float = 0.0, softcap: float = 0.0,
                          window: int | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: gather each
    row's logical window, then the dense plain attention with per-row
    lengths (the reference's ``paged_attention_ref``)."""
    ks = vs = None
    if k_scale is not None:
        ks, vs = gather_paged_kv(k_scale, tables), gather_paged_kv(v_scale, tables)
    return flash_attention_plain(
        q, gather_paged_kv(k_pool, tables), gather_paged_kv(v_pool, tables),
        lengths, n_rep, scale=scale, softcap=softcap, window=window,
        k_scale=ks, v_scale=vs)


def paged_attention_any(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor, n_rep: int, scale: float = 0.0,
                        softcap: float = 0.0, window: int | None = None,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged attention by q's device: the CUDA kernel for a CUDA tensor
    (prefill, mixed and decode steps alike), the plain version for a CPU
    tensor."""
    kw = dict(scale=scale, softcap=softcap, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return paged_flash_attention(q, k_pool, v_pool, tables, lengths, n_rep,
                                     **kw)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, lengths, n_rep,
                                     **kw)
    raise ValueError(f"paged_attention_any: no attention for device {q.device}")
