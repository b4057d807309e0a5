"""The port's single-stream Engine against the JAX package's Engine, on one
fixture GGUF written by the JAX exporter with the tests' SPM vocab.

At f32 greedy decoding is token-identical; stop strings, EOS and
max_new_tokens end both streams at the same place. Sampled streams cannot
match (threefry and Philox differ), so the sampler is held to
``filtered_logits``, the distribution both packages sample from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import (PRESETS, random_params,
                                                 write_model_gguf)
from distributed_llm_pipeline_tpu.ops import sampling as jax_sampling
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import engine as jax_engine_mod
from distributed_llm_pipeline_tpu_torch.ops import sampling
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.runtime import engine as engine_mod

from .fixtures import make_spm_vocab, spm_metadata


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=256)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "engine.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32),
            Engine(gguf_path, dtype=torch.float32, device="cpu"))


def _stream(engine, gen):
    events = list(engine.generate("hello world once upon a time", gen))
    text = "".join(e.content for e in events if e.kind == "token")
    done = events[-1]
    assert done.kind == "done"
    return text, done.data


def _same(engines, **kw):
    jt, jd = _stream(engines[0], JaxGen(temperature=0.0, **kw))
    tt, td = _stream(engines[1], GenerationConfig(temperature=0.0, **kw))
    assert tt == jt
    for key in ("n_prompt", "n_gen", "finish_reason", "stop_match"):
        assert td[key] == jd[key], key
    return tt, td


def test_greedy_16_tokens_match_jax_engine(engines):
    text, done = _same(engines, max_new_tokens=16)
    assert done["n_gen"] == 16 and done["finish_reason"] == "length" and text


def test_max_new_tokens_matches(engines):
    _, done = _same(engines, max_new_tokens=5)
    assert done["n_gen"] == 5


def test_stop_string_matches(engines):
    full, _ = _same(engines, max_new_tokens=16)
    stop = full[len(full) // 2: len(full) // 2 + 2]
    text, done = _same(engines, max_new_tokens=16, stop=(stop,))
    assert done["finish_reason"] == "stop" and done["stop_match"] == stop
    assert stop not in text and full.startswith(text)


def test_eos_inside_a_decode_chunk_matches(gguf_path, engines, monkeypatch):
    """EOS set to the 6th greedy token: both engines stop there, the port
    in the middle of a 4-step decode chunk."""
    monkeypatch.setenv("DLP_DECODE_CHUNK", "4")
    port = Engine(gguf_path, dtype=torch.float32, device="cpu")
    ids = port.tokenizer.encode("hello world once upon a time")
    cache = port.make_cache()
    logits = port.prefill(ids, cache)
    greedy = []
    for _ in range(6):
        greedy.append(int(logits.argmax(-1)))
        logits = port.model(torch.tensor([[greedy[-1]]]), cache)[:, -1]
    for eng in (port, engines[0]):
        monkeypatch.setattr(eng.tokenizer.vocab, "eos_id", greedy[5])
    _, done = _same((engines[0], port), max_new_tokens=16)
    assert done["finish_reason"] == "stop" and done["n_gen"] == greedy.index(greedy[5])


def test_decode_chunk_size_does_not_change_greedy_output(gguf_path, engines,
                                                         monkeypatch):
    monkeypatch.setenv("DLP_DECODE_CHUNK", "3")
    chunked = Engine(gguf_path, dtype=torch.float32, device="cpu")
    assert chunked.decode_chunk == 3
    gen = GenerationConfig(temperature=0.0, max_new_tokens=11)
    assert _stream(chunked, gen)[0] == _stream(engines[1], gen)[0]


@pytest.mark.parametrize("temperature,top_k,top_p,min_p", [
    (0.8, 40, 0.95, 0.0), (1.0, 0, 0.9, 0.0), (0.7, 5, 1.0, 0.05),
    (1.3, 0, 1.0, 0.1), (0.5, 20, 0.5, 0.02)])
def test_filtered_logits_matches_jax(temperature, top_k, top_p, min_p):
    logits = np.random.default_rng(0).standard_normal((2, 300)).astype(np.float32) * 3
    ref = np.asarray(jax_sampling.filtered_logits(
        jnp.asarray(logits), temperature, top_k, top_p, min_p))
    got = sampling.filtered_logits(torch.from_numpy(logits), temperature, top_k,
                                   top_p, min_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    keep = ~np.isneginf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6, atol=1e-6)


def test_penalties_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((1, 50)).astype(np.float32)
    recent = np.array([[-1, 3, 7, 3, 49, 0]], np.int32)
    ref = np.asarray(jax_sampling.apply_penalties(
        jnp.asarray(logits), jnp.asarray(recent), 1.3, 0.4, 0.2))
    got = sampling.apply_penalties(torch.from_numpy(logits),
                                   torch.from_numpy(recent).long(), 1.3, 0.4, 0.2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k", [0, 6])
def test_sample_draws_from_the_filtered_distribution(top_k):
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -0.5, -1.0, -3.0, 0.9]])
    want = torch.softmax(sampling.filtered_logits(logits, 0.9, top_k, 0.9), -1)[0]
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([sampling.sample(logits, gen, 0.9, top_k, 0.9)
                       for _ in range(4000)])
    freq = torch.bincount(draws, minlength=8).float() / len(draws)
    assert (freq[want == 0] == 0).all()
    torch.testing.assert_close(freq, want, rtol=0, atol=0.03)
    assert sampling.sample(logits, None, 0.0).item() == 0   # greedy: argmax


def test_stop_matcher_and_utf8_prefix_match_jax():
    pieces = ["Hel", "lo ", "wo", "rld", "! St", "OP here", " and more"]
    for stops in [("STOP",), ("rld!", "wor"), ("lo w", "o wo"), ()]:
        a = jax_engine_mod.StopMatcher(stops)
        b = engine_mod.StopMatcher(stops)
        for p in pieces:
            assert b.feed(p) == a.feed(p)
        assert (b.flush(), b.matched) == (a.flush(), a.matched)
    for tail in [b"", b"\xc3", b"\xe2\x82", b"\xe2\x82\xac", b"\xf0\x9f\x98",
                 b"\x80", b"\xc0", b"\xf5", b"\xe2A", b"a"]:
        assert engine_mod._utf8_prefix(tail) == jax_engine_mod._utf8_prefix(tail)


def test_engine_from_cfg_tokenizer_params(engines):
    """The in-memory constructor serves what the GGUF constructor serves."""
    port = engines[1]
    built = Engine(cfg=port.cfg, tokenizer=port.tokenizer,
                   params=port.model.state_dict(), max_seq=port.max_seq,
                   dtype=torch.float32, device="cpu")
    gen = GenerationConfig(temperature=0.0, max_new_tokens=8)
    (text, done), (ref_text, ref_done) = _stream(built, gen), _stream(port, gen)
    assert text == ref_text and done["n_gen"] == ref_done["n_gen"] == 8
    with pytest.raises(ValueError, match="cfg"):
        Engine(cfg=port.cfg, tokenizer=port.tokenizer, device="cpu")


def test_engine_refuses_to_run_on_cpu_unasked(gguf_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(gguf_path)
    assert Engine(gguf_path, device="cpu").device.type == "cpu"
