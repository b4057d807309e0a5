"""Latent-KV attention: absorbed MLA attention over rank-r latent pools, the
hand-written CUDA kernel, its plain PyTorch version and the dispatch by
device.

With ``kv_mode="latent"`` a layer caches, per token, one rank-r latent per
side instead of per-head K/V: ``c_k = k_rot @ w_lk`` (the post-rope K,
flattened across heads, through the layer's orthonormal truncated-SVD basis,
``models.convert.latent_factorize``) and ``c_v = v @ w_lv``. Because
``w_lk`` is orthonormal the score absorbs into the query,
``q_h · (V_r V_rᵀ k) = (q_h @ w_lk[h]) · c_k``, so attention runs against
the latents directly, accumulates in latent space, and up-projects once per
step through ``w_lvᵀ``. The pools stream ``2·r`` elements a token instead
of ``2·K·Hd``.

The kernel (``csrc/latent_attention.cu``) replaces the TPU kernel
``latent_flash_attention`` of ``distributed_llm_pipeline_tpu/ops/
latent_attention.py``: absorbed queries ``qa [B, T, H, r]``, all H heads
folded into query rows (row = t·H + h), against one latent stream per batch
row in pools ``[N, bs, 1, r]`` (bf16 or f32 like qa, or int8 codes with f32
scales ``[N, bs, 1, 1]``) through int32 ``tables [B, NT]`` and ``lengths
[B]``; causal per token, window and softcap; the caller's head-dim scale
(never ``r ** -0.5``); output ``[B, T, H, r]`` in qa's dtype. It serves
prefill, mixed and decode steps (T >= 1). Both pools of a latent engine have
one rank, so the kernel requires ``rk == rv``. The launch is cut as the
paged kernel's (``paged_attention.split_plan`` at one kv head of width r).

Dispatch: ``latent_attention_any`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version, which is ``paged_attention_plain`` over a
``[1, r]`` "kv head" (the reference's ``latent_attention_ref``). There is no
fallback: a kernel that cannot take its inputs, or cannot build or launch,
raises.
"""

from __future__ import annotations

import torch

from .paged_attention import (c_entry, check_aligned, paged_attention_plain,
                              plan_launch, tile_geometry)

# latent ranks the kernel takes: the attention tile's head widths plus 512
# (full rank at Llama-3.2-1B, the default rank at gemma2-9b geometry)
LATENT_RANKS = (64, 128, 256, 512)

# kernel launches since the last reset (chip_smoke.py reads it to prove the
# served path ran the kernel); only the CUDA wrapper below increments it
launches = 0

_fn = None


def latent_project(kv: torch.Tensor, w_l: torch.Tensor) -> torch.Tensor:
    """Per-head K or V [B, T, K, Hd] through ``w_l`` [K·Hd, r] → the
    per-token latent [B, T, 1, r], accumulated and returned in f32 (the
    pool write casts or quantizes)."""
    B, T = kv.shape[:2]
    c = kv.reshape(B, T, -1).float() @ w_l.float()
    return c[:, :, None, :]


def absorb_queries(q: torch.Tensor, w_lk: torch.Tensor, n_kv: int) -> torch.Tensor:
    """Weight absorption: post-rope q [B, T, H, Hd] → ``q̃`` [B, T, H, r]
    with ``q̃_h = q_h @ w_lk[kv(h)]`` (the n_rep heads of a kv head share
    its slice), in f32, returned in q's dtype."""
    B, T, H, Hd = q.shape
    w = w_lk.reshape(n_kv, Hd, -1).float()
    qg = q.reshape(B, T, n_kv, H // n_kv, Hd).float()
    qa = torch.einsum("btkrh,khz->btkrz", qg, w)
    return qa.reshape(B, T, H, -1).to(q.dtype)


def unproject_values(acc: torch.Tensor, w_lv: torch.Tensor, n_kv: int,
                     head_dim: int) -> torch.Tensor:
    """The latent-space attention output [B, T, H, r] through ``w_lvᵀ`` →
    per-head values [B, T, H, Hd] in f32, once per step."""
    B, T, H = acc.shape[:3]
    w = w_lv.reshape(n_kv, head_dim, -1).float()
    ag = acc.reshape(B, T, n_kv, H // n_kv, -1).float()
    out = torch.einsum("btkrz,khz->btkrh", ag, w)
    return out.reshape(B, T, H, head_dim)


def latent_decode_hbm_bytes(cfg, rank: int, kv_len: int, batch: int = 1,
                            kv_bytes: float = 2.0, w_bytes: float = 2.0) -> int:
    """Bytes one decode step's attention read moves through a layer on the
    latent path: ``kv_len`` cached latents on both sides plus the two
    projection bases, against ``dense_decode_kv_bytes``' dense read."""
    latents = 2 * kv_len * rank * kv_bytes * batch
    proj = 2 * cfg.n_kv_heads * cfg.head_dim * rank * w_bytes
    return int(latents + proj)


def dense_decode_kv_bytes(cfg, kv_len: int, batch: int = 1,
                          kv_bytes: float = 2.0) -> int:
    """The dense-pool KV read the latent path replaces."""
    return int(2 * kv_len * cfg.n_kv_heads * cfg.head_dim * kv_bytes * batch)


def _kernel():
    """The C entry point, built from ``csrc/latent_attention.cu`` at first use."""
    global _fn
    if _fn is None:
        _fn = c_entry("latent_attention", "dlp_latent_attention", 6)
    return _fn


def latent_flash_attention(qa: torch.Tensor, ck_pool: torch.Tensor,
                           cv_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, n_rep: int, *, scale: float,
                           softcap: float = 0.0, window: int | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel (``n_rep = H``: every query head attends the row's one
    latent stream). Raises on any input the kernel does not take, and when
    the launch fails."""
    global launches
    B, T, H, r = qa.shape
    N, bs = ck_pool.shape[:2]
    NT = tables.shape[-1]
    dev = qa.device
    if not scale:
        raise ValueError("latent_flash_attention needs the original head_dim scale")
    if not (qa.is_cuda and all(t.device == dev for t in
                               (ck_pool, cv_pool, tables, lengths))):
        raise ValueError("latent_flash_attention: qa, pools, tables and lengths "
                         "must be on one CUDA device")
    if H != n_rep or ck_pool.shape != (N, bs, 1, r) or cv_pool.shape != ck_pool.shape:
        raise ValueError(f"latent_flash_attention: shapes qa {tuple(qa.shape)}, "
                         f"pools {tuple(ck_pool.shape)}/{tuple(cv_pool.shape)} "
                         f"(rk == rv), n_rep {n_rep}")
    if r not in LATENT_RANKS:
        raise ValueError(f"latent_flash_attention: rank {r} not in {LATENT_RANKS}")
    if tables.shape != (B, NT) or tables.dtype != torch.int32 \
            or not tables.is_contiguous():
        raise ValueError("latent_flash_attention: tables must be contiguous "
                         f"int32 [{B}, NT], got {tables.dtype} {tuple(tables.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError("latent_flash_attention: lengths must be contiguous "
                         f"int32 [{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    if qa.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"latent_flash_attention: qa dtype {qa.dtype} "
                         "(float32 or bfloat16)")
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("latent_flash_attention: k_scale and v_scale go together")
    if quant:
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or s.shape != (N, bs, 1, 1)
                    or s.device != dev or not s.is_contiguous()):
                raise ValueError("latent_flash_attention: scales must be "
                                 f"contiguous float32 [N, bs, 1, 1] on {dev}")
        if ck_pool.dtype != torch.int8 or cv_pool.dtype != torch.int8:
            raise ValueError("latent_flash_attention: scales need int8 pools")
    elif ck_pool.dtype != qa.dtype or cv_pool.dtype != qa.dtype:
        raise ValueError(f"latent_flash_attention: pool dtype {ck_pool.dtype}/"
                         f"{cv_pool.dtype} must match qa's {qa.dtype} (or be "
                         "int8 with scales)")
    if not (qa.is_contiguous() and ck_pool.is_contiguous()
            and cv_pool.is_contiguous()):
        raise ValueError("latent_flash_attention: qa and the pools must be "
                         "contiguous")
    check_aligned("latent_flash_attention", qa, ck_pool, cv_pool)
    window = 0 if window is None else int(window)
    if window < 0:
        raise ValueError(f"latent_flash_attention: window {window} < 0")
    out = torch.empty_like(qa)
    plan, ws = plan_launch(qa, tables, bs, 1, tile_geometry("latent_attention", r))
    with torch.cuda.device(dev):
        rc = _kernel()(
            qa.data_ptr(), ck_pool.data_ptr(), cv_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            B, T, NT, bs, H, r, 0 if qa.dtype == torch.float32 else 1,
            int(quant), float(scale), float(softcap), window,
            plan.rows_per_block, plan.pages_per_split, plan.splits,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"latent_flash_attention: kernel launch failed "
                           f"(cudaError {rc}, {plan})")
    launches += 1
    return out


def latent_attention_plain(qa: torch.Tensor, ck_pool: torch.Tensor,
                           cv_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, n_rep: int, *, scale: float,
                           softcap: float = 0.0, window: int | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the latent
    pools are a ``[1, r]`` kv head, so the paged plain attention is the
    latent one (the reference's ``latent_attention_ref``)."""
    if not scale:
        raise ValueError("latent attention needs the original head_dim scale")
    return paged_attention_plain(qa, ck_pool, cv_pool, tables, lengths, n_rep,
                                 scale=scale, softcap=softcap, window=window,
                                 k_scale=k_scale, v_scale=v_scale)


def latent_attention_any(qa: torch.Tensor, ck_pool: torch.Tensor,
                         cv_pool: torch.Tensor, tables: torch.Tensor,
                         lengths: torch.Tensor, n_rep: int, *, scale: float,
                         softcap: float = 0.0, window: int | None = None,
                         k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Latent attention by qa's device: the CUDA kernel for a CUDA tensor
    (prefill, mixed and decode steps alike), the plain version for a CPU
    tensor."""
    kw = dict(scale=scale, softcap=softcap, window=window, k_scale=k_scale,
              v_scale=v_scale)
    if qa.is_cuda:
        return latent_flash_attention(qa, ck_pool, cv_pool, tables, lengths,
                                      n_rep, **kw)
    if qa.device.type == "cpu":
        return latent_attention_plain(qa, ck_pool, cv_pool, tables, lengths,
                                      n_rep, **kw)
    raise ValueError(f"latent_attention_any: no attention for device {qa.device}")
