"""The port's quantized model forwards against the JAX package's.

- Model: narrowed Llama-3 widths with D = 256 (so Q6_K applies), 2 layers,
  f32, quantized by the JAX ``quantize_params`` and carried across by
  ``params_from_jax``: the port's forwards against the JAX forwards under the
  Pallas impl (interpret mode). A 12-token prefill and 4 decode steps, then
  the paged forwards with a mixed step of B·T > 32. Logits within atol 2e-4
  (f32 summation order through quantized layers) and the same argmax. The
  inputs are ones where no activation lands on a rounding tie of the int8
  quantizer: there a last-bit difference upstream flips one code (at these
  widths about one input in two has such a tie somewhere; each case names
  the seed of its tokens).
- ``quantize_params`` in the port packs exactly what the JAX one packs.

The engine and the server over quantized weights are in
``test_torch_quant_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import KVCache as JaxKVCache
from distributed_llm_pipeline_tpu.models import PRESETS as JAX_PRESETS
from distributed_llm_pipeline_tpu.models import PagedKVCache as JaxPagedKVCache
from distributed_llm_pipeline_tpu.models import forward as jax_forward
from distributed_llm_pipeline_tpu.models import forward_paged as jax_forward_paged
from distributed_llm_pipeline_tpu.models import forward_paged_last as jax_forward_paged_last
from distributed_llm_pipeline_tpu.models import forward_paged_mixed as jax_forward_paged_mixed
from distributed_llm_pipeline_tpu.models import random_params
from distributed_llm_pipeline_tpu.models.llama import quantize_params as jax_quantize_params
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.models import (KVCache, LlamaModel, ModelConfig,
                                                       PagedKVCache, params_from_jax)
from distributed_llm_pipeline_tpu_torch.models.llama import quantize_params
from distributed_llm_pipeline_tpu_torch.ops.quant_matmul import QuantPack

CFG = JAX_PRESETS["llama3.2-1b"].replace(
    vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
    hidden_dim=512, max_seq_len=64)
UNTIED = CFG.replace(tie_embeddings=False)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's quantized matmuls through their Pallas kernels (in
    interpret mode on the CPU), restored to "auto" after the module: setting
    the impl clears JAX's caches, so it is set once."""
    jqm.set_quant_matmul_impl("pallas")
    try:
        yield
    finally:
        jqm.set_quant_matmul_impl("auto")


def _models(cfg, mode):
    """The same quantized weights in both packages: (JAX params, port model)."""
    params = jax_quantize_params(jax.tree.map(np.asarray, random_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32)), cfg, mode)
    model = LlamaModel(ModelConfig(**dataclasses.asdict(cfg)), params_from_jax(params))
    return jax.tree.map(jnp.asarray, params), model


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(t.numpy().argmax(-1), j.argmax(-1))


# (config, mode, seed of the tokens)
CASES = {"q8_0_tied": (CFG, "q8_0", 3), "q6_k_tied": (CFG, "q6_k", 3),
         "q8_0_untied_head": (UNTIED, "q8_0", 3), "q4_k_tied": (CFG, "q4_k", 5),
         "q5_k_tied": (CFG, "q5_k", 3), "int8_tied": (CFG, "int8", 3),
         "int8_untied_head": (UNTIED, "int8", 3), "q2_k_tied": (CFG, "q2_k", 3),
         "q3_k_tied": (CFG, "q3_k", 3)}
# the pack kind each mode gives a weight whose D is a multiple of 256
KIND = {"q8_0": "q8_0", "q4_k": "q4_k", "q5_k": "q5_ks", "q6_k": "q6_k",
        "int8": "int8", "q2_k": "q2_ks", "q3_k": "q3_ks"}


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_forward_matches_jax(case, pallas):
    cfg, mode, seed = CASES[case]
    params, model = _models(cfg, mode)
    assert isinstance(model.lm_head, QuantPack) and model.lm_head.kind == KIND[mode]
    assert all(isinstance(getattr(blk, n), QuantPack) for blk in model.layers
               for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 12))
    jc = JaxKVCache.zeros(cfg, 1, 32, dtype=jnp.float32)
    tc = KVCache.zeros(model.cfg, 1, 32, dtype=torch.float32)
    fwd = jax.jit(jax_forward, static_argnums=1)
    for _ in range(5):    # the prefill, then 4 greedy decode steps
        jl, jc = fwd(params, cfg, jnp.asarray(toks, jnp.int32), jc)
        _close(model(torch.from_numpy(toks).long(), tc), jl)
        toks = np.asarray(jl)[:, -1:].argmax(-1)


@pytest.mark.parametrize("mode,seed", [("q6_k", 0), ("q4_k", 2), ("q5_k", 0), ("int8", 0),
                                       ("q2_k", 0), ("q3_k", 0)])
def test_quantized_paged_forwards_match_jax(mode, seed, pallas):
    """A prefill bucket per row, a decode step, then a mixed step of
    B·T = 48 > 32 lanes (the fused-dequant kernels; for q5_k, q2_k and q3_k
    the dense weight and one product; int8 takes its own kernel at every
    M)."""
    cfg = CFG
    params, model = _models(cfg, mode)
    BS, NT, B = 16, 4, 3
    N = 1 + B * NT
    tables = np.random.default_rng(0).permutation(np.arange(1, N)).reshape(
        B, NT).astype(np.int32)
    jc = JaxPagedKVCache.zeros(cfg, N, BS, B, NT, dtype=jnp.float32)._replace(
        tables=jnp.asarray(tables))
    tc = PagedKVCache.zeros(model.cfg, N, BS, B, NT, dtype=torch.float32)
    tc.tables = torch.from_numpy(tables)
    # f32 summation order in front of a quantizer can flip one activation
    # code at a rounding tie (then a row differs by ~1e-2); these inputs
    # have no such tie, so the packages agree to f32 rounding
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, 8))
    rng = np.random.default_rng(5 + seed)
    jl, jc = jax_forward_paged_last(params, cfg, jnp.asarray(toks, jnp.int32), jc,
                                    jnp.asarray(5, jnp.int32))
    _close(model.forward_paged_last(torch.from_numpy(toks).long(), tc, 5), jl)
    step = np.asarray(jl).argmax(-1)[:, None]
    jl, jc = jax_forward_paged(params, cfg, jnp.asarray(step, jnp.int32), jc)
    _close(model.forward_paged(torch.from_numpy(step).long(), tc), jl)
    block = rng.integers(0, cfg.vocab_size, (B, 16))
    n_tok = np.asarray([16, 1, 9], np.int32)
    jl, jc = jax_forward_paged_mixed(params, cfg, jnp.asarray(block, jnp.int32), jc,
                                     jnp.asarray(n_tok))
    _close(model.forward_paged_mixed(torch.from_numpy(block).long(), tc,
                                     torch.from_numpy(n_tok)), jl)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [25, 10, 18]


@pytest.mark.parametrize("mode", ["q8_0", "q6_k", "q4_k", "q5_k", "int8", "q2_k", "q3_k"])
def test_quantize_params_packs_like_jax(mode):
    """The port's ``quantize_params`` on the dense weights gives the packs the
    JAX one gives, field for field; the K-quants fall back to Q8_0 where
    D % 256, int8 to a power-of-two group (64 at D = 320)."""
    cfg = UNTIED.replace(hidden_dim=320)        # w_down's D = 320: the fallback
    dense = jax.tree.map(np.asarray, random_params(cfg, jax.random.PRNGKey(1),
                                                   dtype=jnp.float32))
    want = params_from_jax(jax_quantize_params(dense, cfg, mode))
    got = quantize_params(params_from_jax(dense), ModelConfig(**dataclasses.asdict(cfg)),
                          mode)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, QuantPack):
            assert type(g) is type(w), key
            for f in w.fields:
                assert torch.equal(getattr(g, f), getattr(w, f)), (key, f)
        else:
            assert torch.equal(g, w), key
    assert got["layers.0.w_down"].kind == ("int8" if mode == "int8" else "q8_0")
    assert got["layers.0.w_down"].group == (64 if mode == "int8" else 32)
    assert got["layers.0.w_up"].kind == KIND[mode]
