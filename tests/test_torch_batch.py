"""The port's batch generation (``Engine.generate_batch``: ``n`` > 1 and a
list of prompts) against the JAX package's, on the CPU at f32, on one
fixture GGUF written by the JAX exporter.

- Greedy rows of different lengths give the reference's result dicts
  (text, n_prompt, n_gen, finish_reason), on the dense, the int8 (q8_0) and
  the latent cache, with stop strings cut as the reference cuts them.
- Step by step, fed the same tokens, each row's logits are within
  ``LOGIT_TOL`` of the reference's batch (its per-row vmapped cache) and of
  the port's own single stream over the same prompt: the dense cache's
  per-row lengths (``KVCache.length`` a [B] tensor) give each row exactly
  its own attention window.
- Each greedy row's text equals the single stream's.
- The refusals are the reference's ``ValueError``s; a seeded sampled batch
  repeats under its seed and its rows of one prompt draw apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu_torch.models import KVCache
from distributed_llm_pipeline_tpu_torch.models.llama import write_index
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig

from .fixtures import make_spm_vocab, spm_metadata

LOGIT_TOL = 1e-4   # f32 logits of the two packages agree to ~1e-6
N = 8              # tokens a row
PROMPTS = ["hello world once upon a time the world " * 3, "once upon", "a",
           "hello world"]
MODES = {"dense": {}, "int8": {"kv_quant": "q8_0"}, "latent": {"kv_mode": "latent"}}


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    # the byte tokens' head columns at zero: greedy text of pieces
    params["lm_head"] = params["lm_head"].at[:, 3:259].set(0.0)
    path = tmp_path_factory.mktemp("models") / "batch.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def pairs(gguf_path):
    made = {}

    def get(mode: str):
        if mode not in made:
            kw = MODES[mode]
            made[mode] = (JaxEngine(gguf_path, dtype=jnp.float32, **kw),
                          Engine(gguf_path, dtype=torch.float32, device="cpu", **kw))
        return made[mode]

    return get


def _greedy(**kw):
    args = dict(temperature=0.0, max_new_tokens=N)
    args.update(kw)
    return JaxGen(**args), GenerationConfig(**args)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_rows_of_different_lengths_match_the_reference(pairs, mode):
    jeng, peng = pairs(mode)
    jg, pg = _greedy()
    want = jeng.generate_batch(PROMPTS, jg)
    got = peng.generate_batch(PROMPTS, pg)
    assert got == want
    assert len({r["n_prompt"] for r in got}) == len(PROMPTS)


@pytest.mark.parametrize("kw", [{"stop": ("o",)}, {"max_new_tokens": 3},
                                {"repeat_penalty": 1.3, "frequency_penalty": 0.5},
                                {"logit_bias": ((300, 5.0),)}],
                         ids=["stop", "short_budget", "penalties", "bias"])
def test_batch_options_match_the_reference(pairs, kw):
    jeng, peng = pairs("dense")
    jg, pg = _greedy(**kw)
    assert peng.generate_batch(PROMPTS, pg) == jeng.generate_batch(PROMPTS, jg)


def test_n_rows_of_one_prompt_match_the_reference(pairs):
    jeng, peng = pairs("dense")
    jg, pg = _greedy()
    got = peng.generate_batch([PROMPTS[1]] * 4, pg)
    assert got == jeng.generate_batch([PROMPTS[1]] * 4, jg)
    assert len({r["text"] for r in got}) == 1


def _port_steps(peng, prompts, steps: int):
    """The port's batch logits: the prefill's, then each decode step's,
    fed the argmax."""
    ids = [peng.tokenizer.encode(p) for p in prompts]
    lengths = np.array([len(i) for i in ids], np.int64)
    tokens = np.zeros((len(ids), 64), np.int64)   # the bucket of the longest
    for r, i in enumerate(ids):
        tokens[r, :len(i)] = i
    last, cache = peng._batch_prefill(tokens, lengths)
    outs = [last]
    for _ in range(steps):
        outs.append(peng._batch_step(outs[-1].argmax(-1), cache))
    return ids, lengths, tokens, [o.numpy() for o in outs]


def test_step_logits_match_the_reference_and_the_one_stream(pairs):
    jeng, peng = pairs("dense")
    ids, lengths, tokens, got = _port_steps(peng, PROMPTS, N)
    # the reference's batch, fed the same tokens
    last, cache = jeng._batch_run_prefill(tokens.astype(np.int32),
                                          lengths.astype(np.int32))
    want = [np.asarray(last)]
    for i in range(N):
        tok = jnp.asarray(got[i].argmax(-1).astype(np.int32))
        lg, cache = jeng._batch_step_inner(jeng.params, tok, cache)
        want.append(np.asarray(lg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL)
    # the port's own single stream over each row's prompt, fed the same
    for r, row_ids in enumerate(ids):
        cache = peng.make_cache()
        one = [peng.prefill(row_ids, cache)]
        for i in range(N):
            tok = torch.tensor([[int(got[i][r].argmax())]])
            one.append(peng.model(tok, cache)[:, -1])
        np.testing.assert_allclose(np.stack([g[r] for g in got]),
                                   torch.cat(one).numpy(), rtol=0, atol=LOGIT_TOL)


def test_greedy_rows_equal_the_one_stream(pairs):
    peng = pairs("dense")[1]
    _, pg = _greedy(stop_on_eos=False)
    rows = peng.generate_batch(PROMPTS, pg)
    for p, r in zip(PROMPTS, rows):
        text = "".join(e.content for e in peng.generate(p, pg) if e.kind == "token")
        assert r["text"] == text


def test_per_row_lengths_write_each_row_at_its_own_offset():
    cfg = PRESETS["tiny"]
    cache = KVCache.zeros(cfg, batch=3, max_seq=8, dtype=torch.float32)
    cache.length = torch.tensor([0, 3, 7], dtype=torch.int32)
    rows, pos = write_index(cache, 2)
    assert pos.tolist() == [[0, 1], [3, 4], [7, 7]]   # the last row clamps
    assert rows[:, 0].tolist() == [0, 1, 2]
    cache.length = 5
    assert write_index(cache, 2) == (slice(None), slice(5, 7))


@pytest.mark.parametrize("kw,word", [
    ({"json_mode": True}, "constrained"), ({"grammar": 'root ::= "a"'}, "constrained"),
    ({"logprobs": 2}, "logprobs"), ({"mirostat": 2, "temperature": 0.8}, "mirostat")])
def test_refusals_are_the_reference_errors(pairs, kw, word):
    jeng, peng = pairs("dense")
    with pytest.raises(ValueError) as want:
        jeng.generate_batch(["a"], JaxGen(**kw))
    with pytest.raises(ValueError) as got:
        peng.generate_batch(["a"], GenerationConfig(**kw))
    assert str(got.value) == str(want.value) and word in str(got.value)


def test_empty_batch(pairs):
    assert pairs("dense")[1].generate_batch([]) == []


@pytest.mark.parametrize("kw", [{}, {"typical_p": 0.8}], ids=["chain", "typical"])
def test_seeded_rows_repeat_and_draw_apart(pairs, kw):
    peng = pairs("dense")[1]
    gen = GenerationConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=N,
                           seed=11, stop_on_eos=False, **kw)
    a = peng.generate_batch([PROMPTS[1]] * 4, gen)
    assert a == peng.generate_batch([PROMPTS[1]] * 4, gen)
    assert len({r["text"] for r in a}) > 1
    assert all(r["n_gen"] == N for r in a)
