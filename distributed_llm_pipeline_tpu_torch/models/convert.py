"""GGUF tensors → the port's flat parameter state, dequantized at load.

Name mapping follows llama.cpp's GGUF tensor names, as
``distributed_llm_pipeline_tpu/models/convert.py`` does. The port keeps each
matrix in the GGUF's own (out, in) layout, so loading transposes nothing;
fused Phi-3 QKV and gate/up tensors are split by rows. ``params_from_jax``
maps the JAX package's parameter pytree (stacked layers, (in, out)
matrices) onto the same state, so tests feed both packages one set of
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf import GGMLType, GGUFReader
from .config import ModelConfig
from .llama import Params

# JAX leaves stored (in, out) there and (out, in) here
_MATRICES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: dict, dtype: torch.dtype | None = None,
                    device="cpu") -> Params:
    """The JAX pytree, as numpy arrays, as this package's state. The per-layer
    window leaf ``swa`` is dropped: the port derives it from the config."""
    def put(a) -> torch.Tensor:
        t = _torch(np.asarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    out: Params = {k: put(np_params[k]) for k in ("embed", "out_norm", "out_norm_b")
                   if k in np_params}
    if "lm_head" in np_params:
        out["lm_head"] = put(np.asarray(np_params["lm_head"]).T)
    for name, stack in np_params["layers"].items():
        if name == "swa":
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
                dtype: torch.dtype = torch.bfloat16, device="cpu") -> Params:
    """Every tensor of a dense checkpoint, dequantized to ``dtype`` on
    ``device``. BF16 tensors loaded as bf16 copy their bytes as they are."""
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
