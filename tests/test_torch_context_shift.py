"""llama.cpp's context shift in the port against the JAX package, on the
CPU.

- ``models.llama.shift_kv`` against the reference's on random caches, for
  both rope pairings, with and without longrope factors, at several
  (keep, drop): f32 within 1e-6, bf16 within one bf16 ulp of the reference
  (both rotate in f32 and cast back once); an int8 cache is refused in the
  reference's words.
- ``Engine.generate`` with ``context_shift`` runs past its context, logs
  each shift in the reference's words and gives the JAX engine's greedy
  tokens and shift lines across the shifts at f32 (the reference's
  ``tests/test_engine.py`` case, and a longer one with the default decode
  chunk); without it, it stops at ctx, as the reference does, and so does
  an int8 or latent cache, which cannot shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import ModelConfig as JaxConfig
from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models.llama import KVCache as JaxKVCache
from distributed_llm_pipeline_tpu.models.llama import shift_kv as jax_shift_kv
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu_torch.models import KVCache, ModelConfig
from distributed_llm_pipeline_tpu_torch.models.llama import shift_kv
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig

from .fixtures import make_spm_vocab, spm_metadata

GEOMETRY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                head_dim=16, hidden_dim=128, max_seq_len=40)
FACTORS = tuple(float(f) for f in np.linspace(1.0, 4.0, 8))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style,factors", [("interleaved", ()), ("half", ()),
                                           ("interleaved", FACTORS), ("half", FACTORS)],
                         ids=["interleaved", "half", "interleaved_longrope",
                              "half_longrope"])
@pytest.mark.parametrize("keep,drop,length", [(0, 20, 40), (4, 18, 40), (2, 1, 5),
                                              (7, 16, 39)])
def test_shift_kv_matches_reference(dtype, style, factors, keep, drop, length):
    geo = dict(GEOMETRY, rope_style=style, rope_factors=factors, rope_theta=500000.0)
    L, B, S, K, Hd = 2, 2, 40, 2, 16
    rng = np.random.default_rng(keep * 100 + drop)
    k = rng.standard_normal((L, B, S, K, Hd)).astype(np.float32) * 2
    v = rng.standard_normal((L, B, S, K, Hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_shift_kv(JaxKVCache(jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                   jnp.int32(length)),
                        keep, drop, length - drop, JaxConfig(**geo))
    # the reference's result is read before the port shifts its own copies
    # in place (jnp.asarray may share the numpy buffers)
    wk = np.array(want.k.astype(jnp.float32))
    wv = np.array(want.v.astype(jnp.float32))
    cache = KVCache(torch.tensor(k).to(tdt), torch.tensor(v).to(tdt), length)
    got = shift_kv(cache, keep, drop, length - drop, ModelConfig(**geo))
    assert got is cache and got.length == length - drop == int(want.length)
    gk, gv = got.k.float().numpy(), got.v.float().numpy()
    # below the new length: the reference's cells. From it on, cells past
    # the length that neither package reads: the port leaves them as they were
    n = length - drop
    np.testing.assert_array_equal(gv[:, :, :n], wv[:, :, :n])
    tol = 1e-6 if dtype == "float32" else _bf16_ulp(wk[:, :, :n])
    assert np.all(np.abs(gk[:, :, :n] - wk[:, :, :n]) <= tol), np.abs(gk - wk).max()
    np.testing.assert_array_equal(gk[:, :, n:], torch.tensor(k).to(tdt).float()[:, :, n:])
    np.testing.assert_array_equal(gv[:, :, n:], torch.tensor(v).to(tdt).float()[:, :, n:])


def test_shift_kv_refuses_an_int8_cache():
    cfg = ModelConfig(**GEOMETRY)
    cache = KVCache.zeros(cfg, batch=1, max_seq=40, kv_quant="q8_0")
    jcache = JaxKVCache.zeros(JaxConfig(**GEOMETRY), batch=1, max_seq=40,
                              kv_quant="q8_0")
    with pytest.raises(NotImplementedError) as want:
        jax_shift_kv(jcache, 0, 4, 0, JaxConfig(**GEOMETRY))
    with pytest.raises(NotImplementedError) as got:
        shift_kv(cache, 0, 4, 0, cfg)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=48)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "cs.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32),
            Engine(gguf_path, dtype=torch.float32, device="cpu"))


PROMPT = "hello world " * 4


def _run(engine, gen):
    events = list(engine.generate(PROMPT, gen))
    assert events[-1].kind == "done"
    ids = [e for e in events if e.kind == "token"]
    shifts = [e.content for e in events if e.kind == "log" and "context shift" in e.content]
    return "".join(e.content for e in ids), events[-1].data, shifts


@pytest.mark.parametrize("chunk,n,keep", [(8, 60, 2), (32, 150, 0), (32, 120, 5)])
def test_engine_generates_past_ctx_with_the_jax_tokens(engines, monkeypatch, chunk, n,
                                                       keep):
    for eng in engines:
        monkeypatch.setattr(eng, "decode_chunk", chunk)
    kw = dict(max_new_tokens=n, temperature=0.0, stop_on_eos=False, context_shift=True,
              keep=keep)
    want = _run(engines[0], JaxGen(**kw))
    before = engines[1].context_shifts
    text, data, shifts = _run(engines[1], GenerationConfig(**kw))
    assert data["n_gen"] == want[1]["n_gen"] == n   # past the 48-token context
    assert shifts and shifts == want[2]
    assert engines[1].context_shifts - before == len(shifts)
    assert text == want[0]
    # the engine serves normally afterwards
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0, stop_on_eos=False)
    assert _run(engines[1], gen)[1]["n_gen"] == 4


def test_without_context_shift_it_stops_at_ctx(engines):
    kw = dict(max_new_tokens=200, temperature=0.0, stop_on_eos=False)
    want = _run(engines[0], JaxGen(**kw))
    text, data, shifts = _run(engines[1], GenerationConfig(**kw))
    assert not shifts and data["n_gen"] == want[1]["n_gen"] < 48
    assert data["finish_reason"] == "length" and text == want[0]


@pytest.mark.parametrize("kind", ["kv_quant", "latent"])
def test_int8_and_latent_caches_do_not_shift(gguf_path, kind):
    opts = {"kv_quant": "q8_0"} if kind == "kv_quant" else {
        "kv_mode": "latent", "kv_latent_rank": 16}
    eng = Engine(gguf_path, dtype=torch.float32, device="cpu", **opts)
    _, data, shifts = _run(eng, GenerationConfig(
        max_new_tokens=200, temperature=0.0, stop_on_eos=False, context_shift=True))
    assert not shifts and data["n_gen"] < 48 and eng.context_shifts == 0
