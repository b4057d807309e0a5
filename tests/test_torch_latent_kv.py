"""The port's latent KV (``kv_mode="latent"``) against the JAX package's, on
the CPU at f32.

- ``latent_factorize`` gives the reference's bases bit for bit (both are
  numpy float64 SVDs of the same matrices).
- ``latent_project`` / ``absorb_queries`` / ``unproject_values`` within
  1e-6 of the reference's.
- ``latent_attention_plain`` (what the CUDA kernel is held to on the card)
  against the reference's ``latent_attention_ref`` and its Pallas kernel in
  interpret mode, within 2e-6: one-token and multi-token steps, a window, a
  softcap, q8_0 pools.
- Engines: the single-stream latent engine's greedy text equals the
  reference's, and the paged latent forwards (prefill, decode, a mixed step
  with a parked row) give logits within 1e-4 of the reference's; a latent
  SlotScheduler streams the reference's greedy tokens.
- At full rank the latent path reproduces the dense one within 1e-4 (the
  reference's own anchor), and the default rank's pools cost at most a
  quarter of dense bf16 bytes.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS as JAX_PRESETS
from distributed_llm_pipeline_tpu.models import PagedKVCache as JaxPagedKVCache
from distributed_llm_pipeline_tpu.models import forward_paged as jax_forward_paged
from distributed_llm_pipeline_tpu.models import forward_paged_last as jax_forward_paged_last
from distributed_llm_pipeline_tpu.models import forward_paged_mixed as jax_forward_paged_mixed
from distributed_llm_pipeline_tpu.models import random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models import convert as jax_convert
from distributed_llm_pipeline_tpu.models.llama import kv_quantize as jax_kv_quantize
from distributed_llm_pipeline_tpu.ops import latent_attention as jax_la
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu_torch.models import (KVCache, LlamaModel, ModelConfig,
                                                       PagedKVCache, params_from_jax)
from distributed_llm_pipeline_tpu_torch.models import convert
from distributed_llm_pipeline_tpu_torch.ops import latent_attention as la
from distributed_llm_pipeline_tpu_torch.runtime import (Engine, GenerationConfig,
                                                        SlotScheduler)
from distributed_llm_pipeline_tpu_torch.runtime.paged import kv_token_bytes

from .fixtures import make_spm_vocab, spm_metadata

CFG = JAX_PRESETS["tiny"].replace(max_seq_len=128)
BS, NT, B = 16, 4, 3
N = 1 + B * NT


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rank", [None, 16, 32], ids=["default", "16", "full"])
def test_latent_factorize_is_bit_equal_to_the_reference(rank):
    params = random_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = jax_convert.latent_factorize(params, CFG, rank)["layers"]
    got = convert.latent_factorize(params_from_jax(jax.tree.map(np.asarray, params)),
                                   _port_cfg(CFG), rank)
    for i in range(CFG.n_layers):
        for name in ("w_lk", "w_lv"):
            np.testing.assert_array_equal(got[f"layers.{i}.{name}"].numpy(),
                                          np.asarray(want[name][i]))
    assert convert.latent_default_rank(_port_cfg(CFG)) == jax_convert.latent_default_rank(CFG)
    assert convert.latent_max_rank(_port_cfg(CFG)) == jax_convert.latent_max_rank(CFG)


def test_latent_factorize_refuses_packs_and_bad_ranks():
    params = params_from_jax(jax.tree.map(np.asarray, random_params(
        CFG, jax.random.PRNGKey(0), dtype=jnp.float32)))
    with pytest.raises(ValueError, match="out of range"):
        convert.latent_factorize(params, _port_cfg(CFG), 33)
    from distributed_llm_pipeline_tpu_torch.ops.quant_matmul import pack_q8_0

    params["layers.0.wk"] = pack_q8_0(params["layers.0.wk"])
    with pytest.raises(ValueError, match="dense wk"):
        convert.latent_factorize(params, _port_cfg(CFG), 8)


def test_projection_helpers_match_the_reference():
    rng = np.random.default_rng(0)
    K, Hd, H, r = 2, 16, 4, 8
    kv = rng.standard_normal((2, 3, K, Hd)).astype(np.float32)
    # an orthonormal basis, as latent_factorize makes
    w = np.linalg.qr(rng.standard_normal((K * Hd, r)))[0].astype(np.float32)
    q = rng.standard_normal((2, 3, H, Hd)).astype(np.float32)
    acc = rng.standard_normal((2, 3, H, r)).astype(np.float32)
    for got, want in (
            (la.latent_project(_t(kv), _t(w)), jax_la.latent_project(kv, w)),
            (la.absorb_queries(_t(q), _t(w), K), jax_la.absorb_queries(q, w, K)),
            (la.unproject_values(_t(acc), _t(w), K, Hd),
             jax_la.unproject_values(acc, w, K, Hd))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("T,window,softcap,quant", [
    (1, 0, 0.0, False), (5, 0, 0.0, False), (5, 20, 30.0, False), (1, 0, 0.0, True),
    (5, 20, 0.0, True)], ids=["decode", "multi_token", "window_softcap", "q8_0",
                               "q8_0_multi_window"])
def test_latent_attention_plain_matches_reference_and_pallas(T, window, softcap, quant):
    rng = np.random.default_rng(T + window)
    H, r, scale = 4, 8, 16 ** -0.5
    qa = rng.standard_normal((B, T, H, r)).astype(np.float32)
    ck = rng.standard_normal((N, BS, 1, r)).astype(np.float32)
    cv = rng.standard_normal((N, BS, 1, r)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N)).reshape(B, NT).astype(np.int32)
    lengths = np.asarray([3, 30, NT * BS - T], np.int32)
    ks = vs = None
    if quant:
        (ck, ks), (cv, vs) = ((np.asarray(a) for a in jax_kv_quantize(jnp.asarray(p)))
                              for p in (ck, cv))
    kw = dict(scale=scale, softcap=softcap, window=window)
    args = (qa, ck, cv, tables, lengths, H)
    want = jax_la.latent_attention_ref(*args, **kw, k_scale=ks, v_scale=vs)
    kern = jax_la.latent_flash_attention(*args, **kw, k_scale=ks, v_scale=vs,
                                         interpret=True)
    got = la.latent_attention_plain(*(_t(a) if isinstance(a, np.ndarray) else a
                                      for a in args), **kw,
                                    k_scale=None if ks is None else _t(ks),
                                    v_scale=None if vs is None else _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="head_dim scale"):
        la.latent_attention_plain(*(_t(a) if isinstance(a, np.ndarray) else a
                                    for a in args), scale=0.0)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = CFG.replace(vocab_size=len(vocab.tokens))
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "latent.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32, kv_mode="latent"),
            Engine(gguf_path, dtype=torch.float32, device="cpu", kv_mode="latent"))


def test_latent_engine_greedy_matches_the_reference(engines):
    ref, port = engines
    assert port.kv_latent_rank == ref.kv_latent_rank == 8
    assert any("latent KV compression active" in e.content for e in port._events_on_load)
    assert port.make_cache().k.shape[-2:] == (1, 8)

    def text(eng, gen):
        return "".join(e.content for e in eng.generate("hello world once upon", gen)
                       if e.kind == "token")

    want = text(ref, JaxGen(max_new_tokens=12, temperature=0.0, stop_on_eos=False))
    got = text(port, GenerationConfig(max_new_tokens=12, temperature=0.0,
                                      stop_on_eos=False))
    assert got == want and got


def test_latent_paged_forwards_match_the_reference(engines):
    """Prefill, a decode step, then a mixed step in which row 0 feeds 5
    tokens, row 1 decodes and row 2 is parked at max_seq."""
    ref, port = engines
    cfg, params = ref.cfg, ref.params
    rank = ref.kv_latent_rank
    tables = np.random.default_rng(0).permutation(np.arange(1, N)).reshape(B, NT)
    tables = tables.astype(np.int32)
    jc = JaxPagedKVCache.zeros(cfg, N, BS, B, NT, dtype=jnp.float32, kv_mode="latent",
                               latent_rank=rank)._replace(tables=jnp.asarray(tables))
    tc = PagedKVCache.zeros(port.cfg, N, BS, B, NT, dtype=torch.float32,
                            kv_mode="latent", latent_rank=rank)
    tc.tables = _t(tables)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, 16))
    jl, jc = jax_forward_paged_last(params, cfg, jnp.asarray(toks, jnp.int32), jc,
                                    jnp.asarray(11, jnp.int32), kv_mode="latent")
    tl = port.model.forward_paged_last(_t(toks).long(), tc, 11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    step = np.asarray(jl).argmax(-1)[:, None]
    jl, jc = jax_forward_paged(params, cfg, jnp.asarray(step, jnp.int32), jc,
                               kv_mode="latent")
    tl = port.model.forward_paged(_t(step).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    block = rng.integers(0, cfg.vocab_size, (B, 8))
    n_tok = np.asarray([5, 1, 0], np.int32)
    lengths = np.asarray([17, 17, NT * BS], np.int32)
    jc = jc._replace(length=jnp.asarray(lengths))
    tc.length = _t(lengths)
    jl, jc = jax_forward_paged_mixed(params, cfg, jnp.asarray(block, jnp.int32), jc,
                                     jnp.asarray(n_tok), kv_mode="latent")
    tl = port.model.forward_paged_mixed(_t(block).long(), tc, _t(n_tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_latent_scheduler_greedy_matches_the_reference(engines):
    ref, port = engines
    kw = dict(n_slots=2, decode_chunk=4, kv_block=BS, prefill_chunk=16)
    prompts = [[int(t) for t in np.random.default_rng(s).integers(5, 250, size=n)]
               for s, n in ((1, 9), (2, 30))]
    out = {}
    for name, eng, cls, gen in (("ref", ref, JaxSlotScheduler, JaxGen),
                                ("port", port, SlotScheduler, GenerationConfig)):
        sched = cls(eng, **kw)
        try:
            texts = {}
            threads = [threading.Thread(target=lambda i=i: texts.__setitem__(
                i, sched.generate_text(prompts[i], gen(max_new_tokens=10, temperature=0.0,
                                                       stop_on_eos=False))))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            out[name] = [texts[i] for i in range(2)]
        finally:
            sched.close()
    assert out["port"] == out["ref"] and all(out["port"])


def test_full_rank_latent_reproduces_dense():
    cfg = _port_cfg(CFG)
    params = params_from_jax(jax.tree.map(np.asarray, random_params(
        CFG, jax.random.PRNGKey(3), dtype=jnp.float32)))
    full = convert.latent_max_rank(cfg)
    dense = LlamaModel(cfg, params)
    latent = LlamaModel(cfg, convert.latent_factorize(params, cfg, full))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 12)))
    caches = (KVCache.zeros(cfg, 1, 32, dtype=torch.float32),
              KVCache.zeros(cfg, 1, 32, dtype=torch.float32, kv_mode="latent",
                            latent_rank=full))
    want, got = dense(toks, caches[0]), latent(toks, caches[1])
    for _ in range(4):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        step = want[:, -1:].argmax(-1)
        want, got = dense(step, caches[0]), latent(step, caches[1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_latent_token_bytes_are_a_quarter_of_dense():
    cfg = _port_cfg(JAX_PRESETS["llama3.2-1b"])
    r = convert.latent_default_rank(cfg)
    assert r == 128
    dense = kv_token_bytes(cfg, None)
    assert kv_token_bytes(cfg, None, "latent", r) * 4 <= dense
    assert kv_token_bytes(cfg, "q8_0", "latent", r) < kv_token_bytes(cfg, None, "latent", r)
    with pytest.raises(ValueError, match="latent_rank"):
        kv_token_bytes(cfg, None, "latent")
    jcfg = JAX_PRESETS["llama3.2-1b"]
    for kv_bytes in (2.0, 1.0):
        assert la.latent_decode_hbm_bytes(cfg, r, 512, 4, kv_bytes) \
            == jax_la.latent_decode_hbm_bytes(jcfg, r, 512, 4, kv_bytes)
        assert la.dense_decode_kv_bytes(cfg, 512, 4, kv_bytes) \
            == jax_la.dense_decode_kv_bytes(jcfg, 512, 4, kv_bytes)
