"""Llama-family transformer forward over a dense KV cache or a paged KV
pool, in PyTorch.

The counterpart of ``distributed_llm_pipeline_tpu/models/llama.py``, function
for function, for the dense families: Llama-2/3, Qwen2/3, Gemma-1/2, OLMo2,
StarCoder2 and Phi-3 wiring. A block's optional parts follow the leaves its
checkpoint has, as in the reference: QKV and output biases, QK-norms (per
head or full width), pre- or post-only norms, Gemma-2 sandwich norms,
LayerNorm, the ungated MLP, attention and final logit softcap, and the
per-layer sliding window.

Differences of idiom, not of arithmetic:

- Projection matrices keep the GGUF's own (out, in) layout and contract
  with ``F.linear``; the reference keeps (in, out).
- The layer loop is a Python loop over an ``nn.ModuleList``; the reference
  scans stacked layer weights.
- The KV cache and the paged pools are written in place. The reference
  returns new buffers and donates the old ones, which lets XLA update them in
  place too.

Weights live in the engine dtype (bf16 by default), or stay quantized as a
pack (``ops/quant_matmul.py``) where ``quantize_params`` or the native GGUF
loader put one; every weight matmul goes through ``proj``. Norms, rope,
softmax and the logits run in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import attention_any
from ..ops.fused_decode import fused_decode_any
from ..ops.latent_attention import (absorb_queries, latent_attention_any,
                                    latent_project, unproject_values)
from ..ops.paged_attention import paged_attention_any
from ..ops.quant_matmul import INV127, QuantPack, pack_q8_0, proj
from .config import ModelConfig

# flat parameter state: "embed", "out_norm", optional "out_norm_b" and
# "lm_head", and "layers.{i}.{leaf}" for each block's leaves; a projection
# leaf or the head may be a quantized pack
Params = dict[str, "torch.Tensor | QuantPack"]


@dataclass
class KVCache:
    """Per-layer KV buffers [n_layers, batch, max_seq, *kv_entry_shape] and
    the number of valid positions: per-head K/V ``[n_kv_heads, head_dim]``,
    or one rank-r latent per side ``[1, r]`` for a latent model. With an
    int8 cache ``k``/``v`` hold codes and ``k_scale``/``v_scale`` one f32
    scale per cached vector ([..., 1])."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, max_seq: int | None = None,
              dtype: torch.dtype = torch.bfloat16, device="cpu",
              kv_quant: str | None = None, kv_mode: str = "dense",
              latent_rank: int | None = None) -> "KVCache":
        shape = (cfg.n_layers, batch, max_seq or cfg.max_seq_len,
                 *kv_entry_shape(cfg, kv_mode, latent_rank))
        if kv_quant is None:
            return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
        check_kv_quant(kv_quant)
        sshape = shape[:-1] + (1,)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device), 0,
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device))


@dataclass
class PagedKVCache:
    """Paged slot KV: one physical block pool per layer plus per-row block
    tables.

    - ``k``/``v``: [n_layers, n_blocks, block_size, *kv_entry_shape], the
      shared pool (per-head K/V, or ``[1, r]`` latents); int8 codes with
      ``k_scale``/``v_scale`` [..., 1] f32 per-vector scales on an int8
      pool.
    - ``tables``: int32 [B, n_tables]; logical block j of row b lives in
      physical block ``tables[b, j]``.
    - ``length``: int32 [B], the valid positions of each row.

    Physical block 0 is the sentinel: unmapped table entries point at it,
    so every gather and scatter stays in bounds without a mask."""

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    length: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @staticmethod
    def zeros(cfg: ModelConfig, n_blocks: int, block_size: int, batch: int,
              n_tables: int, dtype: torch.dtype = torch.bfloat16, device="cpu",
              kv_quant: str | None = None, kv_mode: str = "dense",
              latent_rank: int | None = None) -> "PagedKVCache":
        shape = (cfg.n_layers, n_blocks, block_size,
                 *kv_entry_shape(cfg, kv_mode, latent_rank))
        tables = torch.zeros((batch, n_tables), dtype=torch.int32, device=device)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        if kv_quant is None:
            return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                                torch.zeros(shape, dtype=dtype, device=device),
                                tables, length)
        check_kv_quant(kv_quant)
        sshape = shape[:-1] + (1,)
        return PagedKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device), tables, length,
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device))


def check_kv_quant(kv_quant: str | None) -> None:
    """The supported KV-cache quant formats."""
    if kv_quant is not None and kv_quant != "q8_0":
        raise ValueError(f"unsupported kv cache quant {kv_quant!r} "
                         f"(supported: q8_0)")


KV_MODES = ("dense", "latent")


def check_kv_mode(kv_mode: str) -> None:
    """The supported KV-cache representations: "dense" (per-head K/V) or
    "latent" (one low-rank latent per token per side; composes with
    ``kv_quant``)."""
    if kv_mode not in KV_MODES:
        raise ValueError(f"unsupported kv mode {kv_mode!r} "
                         f"(one of {', '.join(KV_MODES)})")


def kv_entry_shape(cfg: ModelConfig, kv_mode: str = "dense",
                   latent_rank: int | None = None) -> tuple[int, int]:
    """The trailing shape of one cached position, shared by the dense cache
    and the pools: [n_kv_heads, head_dim] dense, [1, rank] latent (the
    singleton axis keeps every write and gather shape-agnostic)."""
    check_kv_mode(kv_mode)
    if kv_mode == "latent":
        if not latent_rank:
            raise ValueError("kv_mode='latent' needs latent_rank")
        return (1, int(latent_rank))
    return (cfg.n_kv_heads, cfg.head_dim)


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: [..., Hd] → (codes, f32 scale [..., 1]).
    The scale is ``amax · f32(1/127)``, as the reference computes it under
    ``jit``; codes round half to even."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) * INV127).clamp_min(1e-12)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              eps: float) -> torch.Tensor:
    """Mean-subtracting LayerNorm with optional bias (StarCoder2)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            offset: float = 0.0) -> torch.Tensor:
    """RMS norm; ``offset`` is the Gemma (offset + w) convention."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * (w.float() + offset)).to(x.dtype)


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions``: [..., head_dim // 2], f32, with the
    Phi-3 longrope factors and magnitude when the config carries them."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    if cfg.rope_factors:
        freqs = freqs / torch.tensor(cfg.rope_factors, dtype=torch.float32,
                                     device=positions.device)
    angles = positions[..., None].float() * freqs
    m = cfg.rope_attn_factor or 1.0
    return torch.cos(angles) * m, torch.sin(angles) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str) -> torch.Tensor:
    """x [B, T, H, Hd]; cos/sin [B, T, Hd/2] broadcast over heads."""
    xf = x.float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    if style == "interleaved":  # ggml NORM: pairs (2i, 2i+1)
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)
    elif style == "half":       # HF rotate_half: pairs (i, i + Hd/2)
        half = x.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    return out.to(x.dtype)


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    xf = x.float()
    y = F.gelu(xf, approximate="tanh") if act == "gelu" else F.silu(xf)
    return y.to(x.dtype)


def sliding_window_per_layer(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = global): Gemma-2 attends locally on
    even layers and globally on odd ones."""
    return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]


class Block(nn.Module):
    """One transformer block. Its parameters are the leaves its checkpoint
    has; which optional parts run follows from which leaves are present."""

    def __init__(self, cfg: ModelConfig, leaves: Params, window: int = 0):
        super().__init__()
        self.cfg = cfg
        self.window = int(window)
        for name, t in leaves.items():
            if isinstance(t, QuantPack):
                self.add_module(name, t)
            else:
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def has(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        cfg = self.cfg
        if cfg.norm_type == "layer":
            return layernorm(x, self._parameters[name],
                             self._parameters.get(name + "_b"), cfg.norm_eps)
        return rmsnorm(x, self._parameters[name], cfg.norm_eps, cfg.norm_offset)

    def _proj(self, x: torch.Tensor, w: str, b: str | None = None,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
        weight = self._modules[w] if w in self._modules else self._parameters[w]
        y = proj(x, weight, out_dtype)
        return y + self._parameters[b] if b and self.has(b) else y

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """Projections, QK-norm variants and rope: the block's (q, k, v)."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, K, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        h = self.norm(x, "attn_norm") if self.has("attn_norm") else x
        q, k, v = self._proj(h, "wq", "bq"), self._proj(h, "wk", "bk"), self._proj(h, "wv", "bv")
        full_qk = self.has("q_norm") and self.q_norm.shape[-1] == H * Hd
        if full_qk:    # OLMo2: QK-norm over the full projection width
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        q, k, v = q.reshape(B, T, H, Hd), k.reshape(B, T, K, Hd), v.reshape(B, T, K, Hd)
        if self.has("q_norm") and not full_qk:   # Qwen3: per head, pre-rope
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        return (apply_rope(q, cos, sin, cfg.rope_style),
                apply_rope(k, cos, sin, cfg.rope_style), v)

    def attn_out(self, x: torch.Tensor, attn: torch.Tensor,
                 reduce=None) -> torch.Tensor:
        """Output projection, optional post-norm, residual. ``reduce`` (a
        tensor-parallel rank's all-reduce) sums the row-parallel partial
        products, kept in f32, before the bias and the norm."""
        B, T = x.shape[:2]
        if reduce is None:
            out = self._proj(attn.reshape(B, T, -1), "wo")
        else:
            out = reduce(self._proj(attn.reshape(B, T, -1), "wo",
                                    out_dtype=torch.float32)).to(x.dtype)
        if self.has("bo"):
            out = out + self.bo
        if self.has("post_attn_norm"):   # Gemma-2 sandwich norm
            out = rmsnorm(out, self.post_attn_norm, self.cfg.norm_eps,
                          self.cfg.norm_offset)
        return x + out

    def ffn(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        """The FFN half: norm, gated (or StarCoder2's ungated) MLP, residual;
        ``reduce`` as in ``attn_out``, before the down-projection bias."""
        cfg = self.cfg
        h = self.norm(x, "ffn_norm") if self.has("ffn_norm") else x
        od = None if reduce is None else torch.float32
        if self.has("w_gate"):
            g = _act(self._proj(h, "w_gate"), cfg.act).to(x.dtype)
            f = self._proj(g * self._proj(h, "w_up"), "w_down", out_dtype=od)
        else:
            f = self._proj(_act(self._proj(h, "w_up", "b_up"), cfg.act), "w_down",
                           out_dtype=od)
        if reduce is not None:
            f = reduce(f).to(x.dtype)
        if self.has("b_down"):
            f = f + self.b_down
        if self.has("post_ffn_norm"):
            f = rmsnorm(f, self.post_ffn_norm, cfg.norm_eps, cfg.norm_offset)
        return x + f

    @property
    def latent(self) -> bool:
        """A latent-KV block (``models.convert.latent_factorize`` gave it
        ``w_lk``/``w_lv``): its cache holds rank-r latents, not K/V."""
        return "w_lk" in self._parameters

    def _latent_kv(self, q, k, v):
        """Project K/V to their latents [B, T, 1, r] (f32) and absorb the K
        basis into the queries [B, T, H, r]."""
        return (absorb_queries(q, self.w_lk, self.cfg.n_kv_heads),
                latent_project(k, self.w_lk), latent_project(v, self.w_lv))

    def _latent_out(self, acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The latent-space attention output through ``w_lvᵀ``."""
        cfg = self.cfg
        return unproject_values(acc, self.w_lv, cfg.n_kv_heads,
                                cfg.head_dim).to(dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: KVCache, layer: int) -> torch.Tensor:
        """One block over the dense cache: the new tokens' K/V are written
        at [cache.length, cache.length + T) (quantized per vector on an int8
        cache), then attention reads the layer's whole buffer. A latent
        block writes the latents instead and attends them with the absorbed
        queries, n_rep = H over its one [.., 1, r] "kv head" (the same
        kernel at head dim r), then up-projects the output."""
        cfg = self.cfg
        q, k, v = self.qkv(x, cos, sin)
        if self.latent:
            q, k, v = self._latent_kv(q, k, v)
        at = slice(cache.length, cache.length + x.shape[1])
        ks = vs = None
        if cache.k_scale is not None:
            (kq, k_s), (vq, v_s) = kv_quantize(k), kv_quantize(v)
            cache.k[layer, :, at] = kq
            cache.v[layer, :, at] = vq
            cache.k_scale[layer, :, at] = k_s
            cache.v_scale[layer, :, at] = v_s
            ks, vs = cache.k_scale[layer], cache.v_scale[layer]
        else:
            cache.k[layer, :, at] = k
            cache.v[layer, :, at] = v
        # the absorbed score is the dense q·k: the head dim's scale, not r's
        n_rep, scale = ((cfg.n_heads, cfg.attn_scale or cfg.head_dim ** -0.5)
                        if self.latent else
                        (cfg.n_heads // cfg.n_kv_heads, cfg.attn_scale))
        attn = attention_any(q, cache.k[layer], cache.v[layer], cache.length,
                             n_rep, scale=scale, softcap=cfg.attn_softcap,
                             window=self.window, k_scale=ks, v_scale=vs)
        if self.latent:
            attn = self._latent_out(attn, x.dtype)
        return self.ffn(self.attn_out(x, attn))

    def forward_paged(self, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cache: PagedKVCache, layer: int,
                      where: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """One block over the paged pool: the new tokens' K/V scatter into
        the layer's pools at ``where`` (``paged_write_index``), then
        attention reads them back through the block tables. A latent block
        runs ``forward_latent``."""
        if self.latent:
            return self.forward_latent(x, cos, sin, cache, layer, where)
        cfg = self.cfg
        q, k, v = self.qkv(x, cos, sin)
        ks = vs = None
        if cache.k_scale is not None:
            ks, vs = cache.k_scale[layer], cache.v_scale[layer]
        _paged_kv_write(cache.k[layer], cache.v[layer], ks, vs, k, v, *where)
        attn = paged_attention_any(q, cache.k[layer], cache.v[layer],
                                   cache.tables, cache.length,
                                   cfg.n_heads // cfg.n_kv_heads,
                                   scale=cfg.attn_scale,
                                   softcap=cfg.attn_softcap, window=self.window,
                                   k_scale=ks, v_scale=vs)
        return self.ffn(self.attn_out(x, attn))

    def forward_latent(self, x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, cache: PagedKVCache, layer: int,
                       where: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """One latent block over the paged latent pools ([N, bs, 1, r]) on a
        prefill, mixed or decode step: K/V through the shared ``qkv``, their
        latents scattered by the same ``_paged_kv_write``, attention of the
        absorbed queries against the latents (``latent_attention_any``), the
        output up-projected once."""
        cfg = self.cfg
        qa, ck, cv = self._latent_kv(*self.qkv(x, cos, sin))
        ks = vs = None
        if cache.k_scale is not None:
            ks, vs = cache.k_scale[layer], cache.v_scale[layer]
        _paged_kv_write(cache.k[layer], cache.v[layer], ks, vs, ck, cv, *where)
        acc = latent_attention_any(qa, cache.k[layer], cache.v[layer],
                                   cache.tables, cache.length, cfg.n_heads,
                                   scale=cfg.attn_scale or cfg.head_dim ** -0.5,
                                   softcap=cfg.attn_softcap, window=self.window,
                                   k_scale=ks, v_scale=vs)
        return self.ffn(self.attn_out(x, self._latent_out(acc, x.dtype)))

    def forward_fused(self, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cache: PagedKVCache, layer: int,
                      where: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """A T = 1 decode step with the attention half fused
        (``ops/fused_decode.py``: one kernel launch on the card): it returns
        ``y`` and the new token's K/V, which scatter through the same
        ``_paged_kv_write`` as the unfused step; then the FFN half. The
        caller gates on ``fused_supported``."""
        ks = vs = None
        if cache.k_scale is not None:
            ks, vs = cache.k_scale[layer], cache.v_scale[layer]
        y, k_new, v_new = fused_decode_any(
            x[:, 0], self, cos[:, 0], sin[:, 0], cache.k[layer], cache.v[layer],
            cache.tables, cache.length, k_scale=ks, v_scale=vs)
        _paged_kv_write(cache.k[layer], cache.v[layer], ks, vs, k_new[:, None],
                        v_new[:, None], *where)
        return self.ffn(y[:, None])


def paged_write_index(tables: torch.Tensor, lengths: torch.Tensor, T: int,
                      bs: int, n_tok: torch.Tensor | None = None,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where T new tokens of each row go in the pools: (physical block,
    offset), each [B, T]. Write positions clamp to the last logical
    position ``NT * bs - 1`` (a parked row, at ``max_seq``, corrupts at most
    that slot-private position); with ``n_tok`` ([B]), lanes at or past a
    row's count go to sentinel block 0 (the mixed-step contract). Every
    layer shares one table, so a forward computes this once."""
    NT = tables.shape[1]
    lane = torch.arange(T, device=tables.device)
    pos = (lengths.long()[:, None] + lane[None, :]).clamp_max(NT * bs - 1)
    blk = torch.gather(tables.long(), 1, pos // bs)
    off = pos % bs
    if n_tok is not None:
        valid = lane[None, :] < n_tok.long()[:, None]
        blk = torch.where(valid, blk, 0)   # junk lanes land in the junk block
        off = torch.where(valid, off, 0)
    return blk, off


def _paged_kv_write(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    pool_ks: torch.Tensor | None, pool_vs: torch.Tensor | None,
                    k: torch.Tensor, v: torch.Tensor, blk: torch.Tensor,
                    off: torch.Tensor) -> None:
    """Scatter new tokens' K/V ([B, T, K, Hd]) into one layer's pools
    ([N, bs, K, Hd], in place) at ``paged_write_index``'s places,
    quantized per head vector on an int8 pool."""
    if pool_ks is not None:
        (kq, k_s), (vq, v_s) = kv_quantize(k), kv_quantize(v)
        pool_k[blk, off] = kq
        pool_v[blk, off] = vq
        pool_ks[blk, off] = k_s
        pool_vs[blk, off] = v_s
    else:
        pool_k[blk, off] = k.to(pool_k.dtype)
        pool_v[blk, off] = v.to(pool_v.dtype)


class LlamaModel(nn.Module):
    """Embedding, blocks and the vocab head over a dense KV cache."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError("MoE models are not ported yet")
        self.cfg = cfg
        self.fused_forwards = 0   # backbone_paged forwards that took the fused route
        for name in ("embed", "out_norm", "out_norm_b", "lm_head"):
            if isinstance(params.get(name), QuantPack):
                self.add_module(name, params[name])
            elif name in params:
                self.register_parameter(
                    name, nn.Parameter(params[name], requires_grad=False))
        windows = sliding_window_per_layer(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, {k[len(f"layers.{i}."):]: t for k, t in params.items()
                        if k.startswith(f"layers.{i}.")}, windows[i])
            for i in range(cfg.n_layers))

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.embed_scale != 1.0:   # Gemma: sqrt(dim)
            x = (x.float() * self.cfg.embed_scale).to(x.dtype)
        return x

    def backbone(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """tokens [B, T] → pre-norm hidden states [B, T, D]; advances
        ``cache.length`` by T."""
        B, T = tokens.shape
        x = self.embed_tokens(tokens)
        pos = cache.length + torch.arange(T, device=tokens.device)
        cos, sin = rope_freqs(self.cfg, pos[None, :].expand(B, T))
        for i, block in enumerate(self.layers):
            x = block(x, cos, sin, cache, i)
        cache.length += T
        return x

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and vocab projection: [B, T, D] → [B, T, V] f32,
        accumulated in f32; tied embeddings contract against the embedding
        table unless ``quantize_params`` packed its transpose as the head."""
        cfg = self.cfg
        if cfg.norm_type == "layer":
            x = layernorm(x, self.out_norm, self._parameters.get("out_norm_b"),
                          cfg.norm_eps)
        else:
            x = rmsnorm(x, self.out_norm, cfg.norm_eps, cfg.norm_offset)
        head = getattr(self, "lm_head", None)
        out = proj(x, self.embed if head is None else head, out_dtype=torch.float32)
        if cfg.final_softcap:   # Gemma-2
            out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
        return out

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """tokens [B, T] → logits [B, T, V] f32; the T tokens occupy
        positions [cache.length, cache.length + T)."""
        return self.lm_logits(self.backbone(tokens, cache))

    @torch.inference_mode()
    def forward_last(self, tokens: torch.Tensor, cache: KVCache,
                     last_index: int) -> torch.Tensor:
        """Logits of position ``last_index`` only ([B, V] f32): prefill of a
        padded bucket never builds the [B, T, V] tensor."""
        x = self.backbone(tokens, cache)
        return self.lm_logits(x[:, last_index:last_index + 1])[:, 0]

    def backbone_paged(self, tokens: torch.Tensor, cache: PagedKVCache,
                       n_tok: torch.Tensor | None = None,
                       fused: bool = False) -> torch.Tensor:
        """tokens [B, T] over the paged pool, row b at positions
        [length[b], length[b] + T) → pre-norm hidden states [B, T, D].
        ``n_tok`` ([B], optional) marks each row's real lanes (the mixed
        step): padding lanes write into the sentinel block, and the lengths
        advance by ``n_tok`` instead of T. ``fused`` runs each layer's
        attention half as the fused decode step, on T = 1 decode steps of a
        dense-KV model only (mixed steps, prefill and latent blocks stay
        unfused, as in the reference)."""
        T = tokens.shape[1]
        x = self.embed_tokens(tokens)
        pos = cache.length.long()[:, None] + torch.arange(T, device=tokens.device)
        cos, sin = rope_freqs(self.cfg, pos)
        where = paged_write_index(cache.tables, cache.length, T,
                                  cache.block_size, n_tok)
        fused = fused and T == 1 and n_tok is None and not self.layers[0].latent
        self.fused_forwards += fused
        for i, block in enumerate(self.layers):
            if fused:
                x = block.forward_fused(x, cos, sin, cache, i, where)
            else:
                x = block.forward_paged(x, cos, sin, cache, i, where)
        cache.length = cache.length + (T if n_tok is None else n_tok.to(torch.int32))
        return x

    @torch.inference_mode()
    def forward_paged(self, tokens: torch.Tensor, cache: PagedKVCache,
                      fused: bool = False) -> torch.Tensor:
        """Batched forward over the paged pool: tokens [B, T] → logits
        [B, T, V] f32; ``fused`` as in ``backbone_paged``."""
        return self.lm_logits(self.backbone_paged(tokens, cache, fused=fused))

    @torch.inference_mode()
    def forward_paged_last(self, tokens: torch.Tensor, cache: PagedKVCache,
                           last_index: int) -> torch.Tensor:
        """Prefill over the paged pool: logits of position ``last_index``
        only ([B, V] f32). The shared prefix's KV is already in the pool and
        is only read by attention, never recomputed."""
        x = self.backbone_paged(tokens, cache)
        return self.lm_logits(x[:, last_index:last_index + 1])[:, 0]

    @torch.inference_mode()
    def forward_paged_mixed(self, tokens: torch.Tensor, cache: PagedKVCache,
                            n_tok: torch.Tensor) -> torch.Tensor:
        """Mixed prefill + decode step: tokens [B, T] of which row b's first
        ``n_tok[b]`` lanes are real → logits [B, V] f32 at each row's own
        last real lane; lengths advance by ``n_tok``."""
        x = self.backbone_paged(tokens, cache, n_tok)
        idx = (n_tok.long() - 1).clamp_min(0)
        xl = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return self.lm_logits(xl)[:, 0]


# --------------------------------------------------------------------------
# serving-side weight quantization

QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# the reference server's --quant choices, every one served by this package
QUANT_MODES = ("int8", "q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k", "native")


def check_quant(quant: str | None) -> None:
    """Raise ``ValueError`` on a quant mode that is not one of
    ``QUANT_MODES``."""
    if quant is not None and quant not in QUANT_MODES:
        raise ValueError(f"unsupported quant mode {quant!r} "
                         f"(supported: {', '.join(QUANT_MODES)})")


def quantize_params(params: Params, cfg: ModelConfig, mode: str, *,
                    byte_codes: bool = False) -> Params:
    """Re-pack the projection weights and the head so they stay quantized on
    the device (the reference's ``quantize_params``). Packing runs on the
    host; each pack lands on the device of the weight it replaces. Norms and
    the embedding table stay dense.

    ``byte_codes`` (tp > 1 meshes, whose row shards split every field along
    D): q4_k, q5_k and q6_k take the byte-code packs ``q4_k8``, ``q5_k`` and
    ``q6_k8`` instead of the sub-byte ones, and q2_k and q3_k, whose bit
    planes have no byte form, take ``q8_0``, as the reference falls back.

    - ``int8``: int8 codes per 256-row group, or the largest power-of-two
      group of 128, 64, 32 that divides D; Q8_0 where none does.
    - ``q8_0``: per-32 blocks. ``q2_k``, ``q3_k``, ``q4_k``, ``q5_k`` and
      ``q6_k`` (the ``q2_ks``, ``q3_ks``, ``q4_k``, ``q5_ks`` and ``q6_k``
      packs): 256-row super-blocks; a weight whose contraction dim is not a
      multiple of 256 falls back to ``q8_0``.
    - An untied head is packed; a tied head gets a packed copy of the
      embedding table (already [V, D], out-features-major) while the dense
      table keeps serving lookups."""
    from ..ops import kquant_matmul as kq
    from ..ops.quant_matmul import _pow2_group, pack_int8

    packers = ({"q8_0": pack_q8_0, "q2_k": pack_q8_0, "q3_k": pack_q8_0,
                "q4_k": kq.pack_q4_k8, "q5_k": kq.pack_q5_k, "q6_k": kq.pack_q6_k8}
               if byte_codes else
               {"q8_0": pack_q8_0, "q2_k": kq.pack_q2_ks, "q3_k": kq.pack_q3_ks,
                "q4_k": kq.pack_q4_k, "q5_k": kq.pack_q5_ks, "q6_k": kq.pack_q6_k})
    if mode != "int8" and mode not in packers:
        raise ValueError(f"quantize_params: mode {mode!r} "
                         f"(int8, {', '.join(packers)})")

    def pack_dense(w: torch.Tensor) -> QuantPack:
        D = w.shape[1]
        if mode == "int8":
            packer = pack_int8 if D % 256 == 0 or _pow2_group(D) else pack_q8_0
        else:
            packer = pack_q8_0 if D % 256 else packers[mode]
        return packer(w).to(w.device)

    out = dict(params)
    for key, w in params.items():
        if (key.startswith("layers.") and key.rsplit(".", 1)[1] in QUANTIZABLE
                and not isinstance(w, QuantPack)):
            out[key] = pack_dense(w)
    head = params.get("lm_head")
    if head is not None and not isinstance(head, QuantPack):
        out["lm_head"] = pack_dense(head)
    elif head is None and "embed" in params and params["embed"].shape[1] % 32 == 0:
        out["lm_head"] = pack_dense(params["embed"])
    return out


def quantized_bytes(params: Params) -> tuple[int, int]:
    """(bytes as stored, bytes were every pack a dense bf16 weight), for the
    engine's load log."""
    stored = dense = 0
    for t in params.values():
        if isinstance(t, QuantPack):
            stored += t.nbytes()
            dense += 2 * t.shape[0] * t.shape[1]
        else:
            stored += t.numel() * t.element_size()
            dense += t.numel() * t.element_size()
    return stored, dense
