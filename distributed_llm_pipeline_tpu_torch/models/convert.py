"""GGUF tensors → the port's flat parameter state, dequantized at load or,
with ``native_quant_layers``, kept in their stored Q8_0 / Q2_K / Q3_K / Q4_K /
Q5_K / Q6_K blocks.

Name mapping follows llama.cpp's GGUF tensor names, as
``distributed_llm_pipeline_tpu/models/convert.py`` does. The port keeps each
matrix in the GGUF's own (out, in) layout, so loading transposes nothing;
fused Phi-3 QKV and gate/up tensors are split by rows. ``params_from_jax``
maps the JAX package's parameter pytree (stacked layers, (in, out)
matrices, quantized packs as dicts of stacked fields) onto the same state,
so tests feed both packages one set of weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf import GGMLType, GGUFReader
from ..ops.kquant_matmul import (Q2KSPack, Q3KSPack, Q4KPack, Q5KSPack, Q6KPack,
                                 pack_q2_ks_from_gguf, pack_q3_ks_from_gguf,
                                 pack_q4_k_from_gguf, pack_q5_ks_from_gguf,
                                 pack_q6_k_from_gguf)
from ..ops.quant_matmul import Int8Pack, Q8_0Pack, QuantPack, pack_q8_0_from_gguf
from .config import ModelConfig
from .llama import QUANTIZABLE, Params

# JAX leaves stored (in, out) there and (out, in) here
_MATRICES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# a JAX pack is identified by its field names; its fields are [..., rows, F]
_PACKS = {frozenset(cls.fields): cls for cls in (Q8_0Pack, Int8Pack, Q6KPack, Q4KPack,
                                                  Q5KSPack, Q2KSPack, Q3KSPack)}


def _pack_from_jax(fields: dict, device) -> QuantPack:
    """One JAX pack (a dict of numpy fields, [rows, F]) as a port pack: the
    same values, each field transposed to out-features-major."""
    cls = _PACKS.get(frozenset(fields))
    if cls is None:
        raise NotImplementedError(
            f"pack with fields {sorted(fields)} is not ported to the "
            "PyTorch/CUDA package yet (ROADMAP.md §2)")
    return cls(**{f: _torch(np.asarray(a).T) for f, a in fields.items()}).to(device)


def params_from_jax(np_params: dict, dtype: torch.dtype | None = None,
                    device="cpu") -> Params:
    """The JAX pytree, as numpy arrays, as this package's state. The per-layer
    window leaf ``swa`` is dropped: the port derives it from the config.
    Quantized packs keep their own dtypes; ``dtype`` casts dense leaves."""
    def put(a) -> torch.Tensor:
        t = _torch(np.asarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    out: Params = {k: put(np_params[k]) for k in ("embed", "out_norm", "out_norm_b")
                   if k in np_params}
    head = np_params.get("lm_head")
    if isinstance(head, dict):
        out["lm_head"] = _pack_from_jax(head, device)
    elif head is not None:
        out["lm_head"] = put(np.asarray(head).T)
    for name, stack in np_params["layers"].items():
        if name == "swa":
            continue
        if isinstance(stack, dict):   # a pack stacked over layers
            n = len(next(iter(stack.values())))
            for i in range(n):
                out[f"layers.{i}.{name}"] = _pack_from_jax(
                    {f: a[i] for f, a in stack.items()}, device)
            continue
        for i, a in enumerate(np.asarray(stack)):
            out[f"layers.{i}.{name}"] = put(a.T if name in _MATRICES else a)
    return out


def select_rope_factors(reader: GGUFReader, cfg: ModelConfig,
                        max_seq: int) -> ModelConfig:
    """Resolve Phi-3 longrope factor tensors into the config: serving
    contexts beyond the original training context use the long factors,
    shorter ones the short factors, with the attention magnitude factor
    sqrt(1 + ln(M/O)/ln(O))."""
    have = reader.tensors.keys()
    if "rope_factors_long.weight" not in have \
            and "rope_factors_short.weight" not in have:
        return cfg
    orig = cfg.rope_orig_ctx or cfg.max_seq_len
    name = ("rope_factors_long.weight" if max_seq > orig
            else "rope_factors_short.weight")
    if name not in have:  # checkpoint carries only one set
        name = ("rope_factors_short.weight"
                if "rope_factors_short.weight" in have
                else "rope_factors_long.weight")
    factors = np.asarray(reader.tensor_f32(name), np.float32).reshape(-1)
    if factors.size != cfg.head_dim // 2:
        raise ValueError(f"longrope factor tensor {name} has {factors.size} "
                         f"entries, expected head_dim/2 = {cfg.head_dim // 2}")
    if cfg.rope_attn_factor:  # stored explicitly; an explicit 1.0 means none
        attn = cfg.rope_attn_factor
    else:
        M, O = cfg.max_seq_len, orig
        attn = float(np.sqrt(1.0 + np.log(M / O) / np.log(O))) if M > O else 1.0
    return cfg.replace(rope_factors=tuple(float(f) for f in factors),
                       rope_attn_factor=attn)


def load_params(reader: GGUFReader, cfg: ModelConfig,
                dtype: torch.dtype = torch.bfloat16, device="cpu",
                skip: frozenset[str] = frozenset()) -> Params:
    """Every tensor of a dense checkpoint, dequantized to ``dtype`` on
    ``device``, except the per-layer leaves named in ``skip`` (the stacks
    ``native_quant_layers`` serves packed: never dequantized). BF16 tensors
    loaded as bf16 copy their bytes as they are."""
    have = reader.tensors.keys()
    if cfg.is_moe:
        raise NotImplementedError("MoE checkpoints are not ported yet")
    if ("rope_factors_long.weight" in have
            or "rope_factors_short.weight" in have) and not cfg.rope_factors:
        raise ValueError(
            "longrope checkpoint: resolve the factor tensors first "
            "(models.convert.select_rope_factors) so the forward uses the "
            "right per-dim frequencies")

    def get(name: str) -> torch.Tensor:
        ti = reader.tensors[name]
        if ti.ggml_type == GGMLType.BF16 and dtype == torch.bfloat16:
            raw = bytearray(reader.tensor_data(name))
            t = torch.frombuffer(raw, dtype=torch.bfloat16).reshape(ti.shape)
        else:
            t = torch.from_numpy(reader.tensor_f32(name))
        return t.to(device=device, dtype=dtype)

    H, K, Hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim
    names = {"wo": "attn_output.weight"}
    if cfg.pre_norms:
        names.update(attn_norm="attn_norm.weight", ffn_norm="ffn_norm.weight")
        if cfg.norm_type == "layer":
            names.update(attn_norm_b="attn_norm.bias", ffn_norm_b="ffn_norm.bias")
    fused_qkv = "blk.0.attn_qkv.weight" in have
    if not fused_qkv:
        names.update(wq="attn_q.weight", wk="attn_k.weight", wv="attn_v.weight")
    if cfg.qk_norm:
        names.update(q_norm="attn_q_norm.weight", k_norm="attn_k_norm.weight")
    if cfg.post_norms:
        names.update(post_attn_norm="post_attention_norm.weight",
                     post_ffn_norm="post_ffw_norm.weight")
    # optional biases: the reference fills absent QKV/output biases with zeros
    zero_biases = {}
    if cfg.attn_out_bias:
        zero_biases["bo"] = ("attn_output.bias", cfg.dim)
    if cfg.attn_bias:
        zero_biases.update(bq=("attn_q.bias", H * Hd), bk=("attn_k.bias", K * Hd),
                           bv=("attn_v.bias", K * Hd))
    fused_gate_up = (cfg.mlp_gated and "blk.0.ffn_gate.weight" not in have
                     and "blk.0.ffn_up.weight" in have)
    if not cfg.mlp_gated:   # StarCoder2 c_fc / c_proj, biases when stored
        for leaf, n in (("w_up", "ffn_up.weight"), ("w_down", "ffn_down.weight"),
                        ("b_up", "ffn_up.bias"), ("b_down", "ffn_down.bias")):
            if f"blk.0.{n}" in have:
                names[leaf] = n
    elif fused_gate_up:
        names["w_down"] = "ffn_down.weight"
    else:
        names.update(w_gate="ffn_gate.weight", w_up="ffn_up.weight",
                     w_down="ffn_down.weight")

    params: Params = {"embed": get("token_embd.weight"),
                      "out_norm": get("output_norm.weight")}
    if "output_norm.bias" in have:
        params["out_norm_b"] = get("output_norm.bias")
    if "output.weight" in have:
        params["lm_head"] = get("output.weight")
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for leaf, n in names.items():
            if leaf not in skip:
                params[pre + leaf] = get(f"blk.{i}.{n}")
        for leaf, (n, width) in zero_biases.items():
            params[pre + leaf] = (get(f"blk.{i}.{n}") if f"blk.{i}.{n}" in have
                                  else torch.zeros(width, dtype=dtype, device=device))
        if fused_qkv:   # Phi-3: [(H + 2K) Hd, D], q rows first
            qkv = get(f"blk.{i}.attn_qkv.weight")
            if qkv.shape[0] != (H + 2 * K) * Hd:
                raise ValueError(f"fused attn_qkv width {qkv.shape[0]} != "
                                 f"(H + 2K) * Hd = {(H + 2 * K) * Hd}")
            params[pre + "wq"], params[pre + "wk"], params[pre + "wv"] = (
                t.contiguous() for t in qkv.split([H * Hd, K * Hd, K * Hd]))
        if fused_gate_up:   # Phi-3: [2F, D], gate rows first
            gu = get(f"blk.{i}.ffn_up.weight")
            if gu.shape[0] != 2 * F:
                raise ValueError(f"fused ffn_up width {gu.shape[0]} != "
                                 f"2 * hidden_dim = {2 * F}")
            params[pre + "w_gate"], params[pre + "w_up"] = (
                t.contiguous() for t in gu.split([F, F]))
    return params


# the GGUF tensor of each projection leaf
_PROJ_TENSORS = {"wq": "attn_q.weight", "wk": "attn_k.weight",
                 "wv": "attn_v.weight", "wo": "attn_output.weight",
                 "w_gate": "ffn_gate.weight", "w_up": "ffn_up.weight",
                 "w_down": "ffn_down.weight"}
# K-quant stacks: packed only when D % 256 == 0, else served dense
_KQUANTS = (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K)


def native_quant_layers(reader: GGUFReader, cfg: ModelConfig) -> dict[str, QuantPack]:
    """Packs for the projection stacks whose stored type is Q8_0, Q2_K, Q3_K,
    Q4_K, Q5_K or Q6_K (the sub-byte ``q2_ks``, ``q3_ks`` and ``q5_ks`` packs
    for Q2_K, Q3_K and Q5_K), built from the raw block bytes with no
    dequantize → requantize round trip (the reference's
    ``native_quant_layers`` on one device). Returns
    ``{"layers.{i}.{leaf}": pack}`` on the host; the caller loads the rest
    dense with ``load_params(..., skip=...)``.

    A stack qualifies when every layer stores one type (mixed stacks load
    dense, as in the reference; so do fused Phi-3 tensors, which are split
    at load, and K-quant stacks whose contraction dim is not a multiple of
    256)."""
    if cfg.is_moe or "blk.0.attn_qkv.weight" in reader.tensors:
        return {}
    packers = {GGMLType.Q8_0: pack_q8_0_from_gguf, GGMLType.Q2_K: pack_q2_ks_from_gguf,
               GGMLType.Q3_K: pack_q3_ks_from_gguf, GGMLType.Q4_K: pack_q4_k_from_gguf,
               GGMLType.Q5_K: pack_q5_ks_from_gguf, GGMLType.Q6_K: pack_q6_k_from_gguf}
    out: dict[str, QuantPack] = {}
    for leaf in QUANTIZABLE:
        tis = [reader.tensors.get(f"blk.{i}.{_PROJ_TENSORS[leaf]}")
               for i in range(cfg.n_layers)]
        if any(ti is None for ti in tis) or len({ti.ggml_type for ti in tis}) != 1:
            continue
        t = tis[0].ggml_type
        F, D = tis[0].shape                  # disk layout (out F, in D)
        if t in _KQUANTS and D % 256:
            continue                         # the reference serves it dense too
        packer = packers.get(t)
        if packer is None:
            continue
        for i, ti in enumerate(tis):
            out[f"layers.{i}.{leaf}"] = packer(
                np.frombuffer(reader.tensor_data(ti.name), np.uint8), (D, F))
    return out


# ---------------------------------------------------------------------------
# latent-KV factorization (kv_mode="latent"): per-layer low-rank K/V bases
# from the checkpoint's wk / wv by truncated SVD, in numpy float64 as the
# reference computes them, so one input gives the same basis bit for bit


def latent_default_rank(cfg: ModelConfig) -> int:
    """The default latent rank per side: a quarter of the dense per-token K
    width, at least 8, so latent pools take 1/4 of dense bf16 bytes."""
    return max(8, (cfg.n_kv_heads * cfg.head_dim) // 4)


def latent_max_rank(cfg: ModelConfig) -> int:
    """Full rank, K·Hd: the basis is complete and the latent path reproduces
    dense attention to fp rounding."""
    return cfg.n_kv_heads * cfg.head_dim


def _svd_projection(w: np.ndarray, rank: int) -> np.ndarray:
    """The top-``rank`` right-singular vectors of ``w`` [D, K·Hd] as a
    [K·Hd, rank] orthonormal projection (full matrices only when D < K·Hd,
    so full rank stays reachable)."""
    w = np.asarray(w, np.float64)
    _, _, vt = np.linalg.svd(w, full_matrices=w.shape[0] < w.shape[1])
    return np.ascontiguousarray(vt[:rank].T)


def latent_factorize(params: Params, cfg: ModelConfig,
                     rank: int | None = None) -> Params:
    """Add each layer's latent bases ``w_lk`` / ``w_lv`` [K·Hd, r] (the
    reference's layout) beside its dense ``wk`` / ``wv``, which the write
    path still uses to compute full K/V before projecting them down. One
    orthonormal matrix per side serves both directions: the cache holds
    ``k_rot @ w_lk`` and the absorbed query is ``q_h @ w_lk[h]``. Runs
    before weight quantization: packed ``wk`` / ``wv`` cannot be
    factorized."""
    r = int(rank) if rank is not None else latent_default_rank(cfg)
    khd = cfg.n_kv_heads * cfg.head_dim
    if not 1 <= r <= khd:
        raise ValueError(f"latent rank {r} out of range [1, {khd}] "
                         f"(K*Hd = {khd} is full rank)")
    out = dict(params)
    for i in range(cfg.n_layers):
        for src, dst in (("wk", "w_lk"), ("wv", "w_lv")):
            w = params.get(f"layers.{i}.{src}")
            if w is None or isinstance(w, QuantPack):
                raise ValueError(
                    f"latent KV factorization needs the dense {src} stack "
                    "(factorize before --quant packing; --quant native serves "
                    "packed blocks and cannot combine with kv_mode=latent)")
            if w.shape[0] != khd:
                raise ValueError(f"{src} shape {tuple(w.shape)} is not [K*Hd, D]")
            # the reference's [D, K*Hd] layout, C-contiguous, as float64
            wt = np.ascontiguousarray(w.detach().to("cpu", torch.float32).numpy().T)
            basis = _svd_projection(wt, r).astype(np.float32)
            out[f"layers.{i}.{dst}"] = torch.from_numpy(basis).to(
                device=w.device, dtype=w.dtype)
    return out
