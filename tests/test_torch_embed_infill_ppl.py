"""The port's embeddings, fill-in-middle prompt and perplexity against the
JAX package's, on the CPU at f32, on fixture GGUFs written by the JAX
exporter (the FIM markers as ``tests/test_infill.py`` writes them).

- ``infill_ids``: the reference's ids, PSM order, for short texts and for
  every trim case (a long prefix, a long suffix, both); a vocabulary
  without FIM tokens raises the reference's ``ValueError``.
- ``embed``: each pooling (mean, cls, last) within ``EMBED_TOL`` of the
  reference's vector, unit norm, the reference's token count after
  truncation; a latent engine embeds through a dense scratch cache, as the
  reference's does, so its vectors equal the dense engine's.
- ``perplexity``: ``nll`` and ``n_tokens`` within ``NLL_RTOL`` of the
  reference's at several chunk sizes, the same up to rounding whatever the
  chunk, over one window and over two (a text longer than the context).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu_torch.models.llama import POOLING_TYPES
from distributed_llm_pipeline_tpu_torch.runtime import Engine

from .fixtures import make_spm_vocab, spm_metadata

EMBED_TOL = 1e-5   # unit vectors; f32 hidden states agree to ~1e-7
NLL_RTOL = 1e-5    # f32 log-softmax sums over ~100-250 tokens
CHUNK_RTOL = 1e-5  # the port against itself at another chunk size
TEXT = "hello world once upon a time the world"


def _write(tmp, fim: bool, max_seq: int = 128):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=max_seq)
    params = random_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    md = spm_metadata(vocab)
    if fim:
        md["tokenizer.ggml.prefix_token_id"] = np.int32(10)
        md["tokenizer.ggml.suffix_token_id"] = np.int32(11)
        md["tokenizer.ggml.middle_token_id"] = np.int32(12)
    path = tmp / ("fim.gguf" if fim else "nofim.gguf")
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params), tokenizer_metadata=md)
    return path


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("embed")
    return _write(tmp, True), _write(tmp, False)


@pytest.fixture(scope="module")
def engines(paths):
    return (JaxEngine(paths[0], dtype=jnp.float32),
            Engine(paths[0], dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("pre,suf", [
    ("hello ", "world"), ("", "world"), ("hello", ""),
    ("hello world " * 60, "once"), ("a", "upon a time " * 60),
    ("hello world " * 60, "upon a time " * 60)],
    ids=["short", "no_prefix", "no_suffix", "long_prefix", "long_suffix", "both_long"])
def test_infill_ids_match_the_reference(engines, pre, suf):
    jeng, peng = engines
    ids = peng.infill_ids(pre, suf)
    assert ids == jeng.infill_ids(pre, suf)
    v = peng.tokenizer.vocab
    assert ids[0] == v.bos_id and ids[1] == 10 and ids[-1] == 12 and 11 in ids[2:-1]
    assert len(ids) <= peng.max_prompt - 1


def test_infill_without_fim_tokens_raises_the_reference_error(paths):
    jeng = JaxEngine(paths[1], dtype=jnp.float32)
    peng = Engine(paths[1], dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError) as want:
        jeng.infill_ids("a", "b")
    with pytest.raises(ValueError) as got:
        peng.infill_ids("a", "b")
    assert str(got.value) == str(want.value) and "fill-in-middle" in str(got.value)


@pytest.mark.parametrize("text", ["hello", TEXT, TEXT * 20],
                         ids=["one_word", "sentence", "past_max_prompt"])
@pytest.mark.parametrize("pooling", POOLING_TYPES)
def test_embeddings_match_the_reference(engines, pooling, text):
    jeng, peng = engines
    want, n_want = jeng.embed(text, with_count=True, pooling=pooling)
    got, n = peng.embed(text, with_count=True, pooling=pooling)
    assert n == n_want and n <= peng.max_prompt
    assert len(got) == peng.cfg.dim
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def test_embedding_leaves_the_prefix_cache_alone(engines):
    peng = engines[1]
    list(peng.generate(TEXT * 3, None))
    held = (list(peng._prefix_ids), peng._prefix_cache)
    peng.embed(TEXT)
    assert (peng._prefix_ids, peng._prefix_cache) == held


def test_bad_pooling_raises(engines):
    with pytest.raises(ValueError, match="unsupported pooling"):
        engines[1].embed("x", pooling="max")


def test_latent_engine_embeds_through_a_dense_scratch(paths, engines):
    jlat = JaxEngine(paths[0], dtype=jnp.float32, kv_mode="latent")
    plat = Engine(paths[0], dtype=torch.float32, device="cpu", kv_mode="latent")
    for pooling in POOLING_TYPES:
        got = plat.embed(TEXT, pooling=pooling)
        np.testing.assert_allclose(got, jlat.embed(TEXT, pooling=pooling),
                                   rtol=0, atol=EMBED_TOL)
        np.testing.assert_allclose(got, engines[1].embed(TEXT, pooling=pooling),
                                   rtol=0, atol=EMBED_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_perplexity_matches_the_reference(engines, chunk):
    jeng, peng = engines
    text = TEXT * 12    # ~100 tokens: one window
    want = jeng.perplexity(text, chunk=chunk)
    got = peng.perplexity(text, chunk=chunk)
    assert got["n_tokens"] == want["n_tokens"] == len(peng.tokenizer.encode(text)) - 1
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=NLL_RTOL)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=NLL_RTOL)
    assert set(got) == {"ppl", "nll", "n_tokens"}


def test_perplexity_is_chunk_invariant_and_windows_long_texts(engines):
    jeng, peng = engines
    text = TEXT * 30    # 361 tokens: three 128-token windows
    runs = {c: peng.perplexity(text, chunk=c) for c in (16, 32, 128)}
    for r in runs.values():
        np.testing.assert_allclose(r["nll"], runs[128]["nll"], rtol=CHUNK_RTOL)
    n = len(peng.tokenizer.encode(text))
    # windows of max_seq + 1 tokens that share their ends: every token but
    # the first is scored once, over more than one window
    assert runs[128]["n_tokens"] == n - 1 and n - 1 > peng.max_seq
    want = jeng.perplexity(text, chunk=32)
    assert runs[32]["n_tokens"] == want["n_tokens"]
    np.testing.assert_allclose(runs[32]["nll"], want["nll"], rtol=NLL_RTOL)


def test_perplexity_needs_two_tokens(engines):
    with pytest.raises(ValueError, match="at least 2 tokens"):
        engines[1].perplexity("")
