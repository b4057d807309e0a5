"""The port's llama-family forward against the JAX package's ``forward``.

Both packages get the same weights: the JAX ``random_params`` pytree, as
numpy, goes through ``params_from_jax``. A 12-token prefill and 4 greedy
decode steps run through both at f32: logits agree within atol 1e-4 (f32
summation order through a few layers) and the argmax is identical at every
step. A GGUF written by the JAX package's exporter loads into the same
state through the port's ``load_params``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import KVCache as JaxKVCache
from distributed_llm_pipeline_tpu.models import PRESETS as JAX_PRESETS
from distributed_llm_pipeline_tpu.models import forward as jax_forward
from distributed_llm_pipeline_tpu.models import random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models.config import ModelConfig as JaxConfig
from distributed_llm_pipeline_tpu_torch.gguf import GGUFReader
from distributed_llm_pipeline_tpu_torch.models import (KVCache, LlamaModel,
                                                       ModelConfig, load_params,
                                                       params_from_jax)

_NARROW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
               head_dim=16, hidden_dim=128, max_seq_len=64)

CONFIGS = {
    "tiny": JAX_PRESETS["tiny"],
    "llama3_tied": JAX_PRESETS["llama3.2-1b"].replace(**_NARROW),
    "qwen3_qk_norm": JAX_PRESETS["qwen3-8b"].replace(**_NARROW),
    # window 8 < the 16 positions run, so layer 0's window masks
    "gemma2": JAX_PRESETS["gemma2-9b"].replace(
        **_NARROW, embed_scale=64 ** 0.5, sliding_window=8,
        attn_scale=16 ** -0.5),
    "qwen2_biases": JaxConfig(arch="qwen2", rope_style="half", attn_bias=True,
                              rope_theta=1e6, **_NARROW),
    "olmo2_post_norms": JaxConfig(arch="olmo2", rope_style="half", qk_norm=True,
                                  qk_norm_full=True, pre_norms=False,
                                  post_norms=True, **_NARROW),
    "starcoder2_layernorm": JaxConfig(arch="starcoder2", rope_style="half",
                                      norm_type="layer", mlp_gated=False,
                                      attn_out_bias=True, attn_bias=True,
                                      act="gelu", **_NARROW),
}


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _jax_params(cfg, seed=0):
    params = random_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if cfg.norm_type == "layer" or not cfg.pre_norms:
        # non-trivial norm weights/biases, so a swapped leaf cannot pass
        rng = np.random.default_rng(seed + 1)
        layers = dict(params["layers"])
        for name in ("attn_norm_b", "ffn_norm_b", "post_attn_norm", "post_ffn_norm"):
            if name in layers:
                layers[name] = layers[name] + jnp.asarray(
                    0.1 * rng.standard_normal(layers[name].shape), jnp.float32)
        params = {**params, "layers": layers}
    return params


def _run_both(cfg, params, kv_quant=None, n_prompt=12, n_steps=4):
    tcfg = _port_cfg(cfg)
    model = LlamaModel(tcfg, params_from_jax(jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, n_prompt))
    jcache = JaxKVCache.zeros(cfg, 1, 32, dtype=jnp.float32, kv_quant=kv_quant)
    tcache = KVCache.zeros(tcfg, 1, 32, dtype=torch.float32, kv_quant=kv_quant)
    fwd = jax.jit(jax_forward, static_argnums=1)   # two traces: prefill, decode
    out = []
    for step in range(n_steps + 1):
        jl, jcache = fwd(params, cfg, jnp.asarray(toks, jnp.int32), jcache)
        tl = model(torch.from_numpy(toks).long(), tcache)
        out.append((np.asarray(jl), tl.numpy()))
        assert tcache.length == int(jcache.length)
        toks = np.asarray(jl)[:, -1:].argmax(-1)
    return out


# qwen2's QKV biases are covered by starcoder2, which carries them too
@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "qwen2_biases"])
def test_forward_matches_jax(name):
    cfg = CONFIGS[name]
    for jl, tl in _run_both(cfg, _jax_params(cfg)):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        assert (tl[:, -1].argmax(-1) == jl[:, -1].argmax(-1)).all()


def test_forward_matches_jax_int8_kv_cache():
    cfg = CONFIGS["llama3_tied"]
    for jl, tl in _run_both(cfg, _jax_params(cfg), kv_quant="q8_0"):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        assert (tl[:, -1].argmax(-1) == jl[:, -1].argmax(-1)).all()


@pytest.mark.parametrize("name", ["tiny", "qwen2_biases", "starcoder2_layernorm",
                                  "phi3_fused"])
def test_load_params_matches_params_from_jax(name, tmp_path):
    cfg = CONFIGS.get(name) or JaxConfig(arch="phi3", rope_style="half", **_NARROW)
    params = _jax_params(cfg)
    np_params = jax.tree.map(np.asarray, params)
    path = write_model_gguf(tmp_path / "m.gguf", cfg, np_params)
    with GGUFReader(path) as r:
        loaded = load_params(r, ModelConfig.from_gguf_metadata(r.metadata),
                             dtype=torch.float32)
    expect = params_from_jax(np_params)
    assert sorted(loaded) == sorted(expect)
    for k in expect:
        torch.testing.assert_close(loaded[k], expect[k], rtol=0, atol=0, msg=k)


def test_bf16_weights_load_as_their_bytes(tmp_path):
    from distributed_llm_pipeline_tpu.gguf import GGMLType

    cfg = CONFIGS["tiny"]
    np_params = jax.tree.map(np.asarray, _jax_params(cfg))
    path = write_model_gguf(tmp_path / "m.gguf", cfg, np_params,
                            quant=GGMLType.BF16)
    with GGUFReader(path) as r:
        loaded = load_params(r, _port_cfg(cfg), dtype=torch.bfloat16)
    want = params_from_jax(np_params, dtype=torch.bfloat16)
    for k in want:
        torch.testing.assert_close(loaded[k], want[k], rtol=0, atol=0, msg=k)


def test_params_from_jax_takes_bf16_arrays():
    cfg = CONFIGS["tiny"]
    bf16 = jax.tree.map(np.asarray, random_params(cfg, jax.random.PRNGKey(0),
                                                  dtype=jnp.bfloat16))
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), bf16)
    got, want = params_from_jax(bf16), params_from_jax(f32, dtype=torch.bfloat16)
    for k in want:
        assert got[k].dtype == torch.bfloat16
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
