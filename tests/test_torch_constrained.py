"""Constrained decoding on the port's single-stream Engine against the JAX
package's Engine, on the CPU at f32, on one fixture GGUF written by the JAX
exporter (the tests' SPM vocab with JSON's punctuation as pieces).

JSON mode, a GBNF grammar and a ``json_schema`` grammar give identical
text, greedy and seeded at temperature 0.8: both packages draw constrained
samples from numpy's ``default_rng(seed)`` on the host, over shortlists of
logits that agree to ~1e-6. Each output meets its constraint, or is a valid
prefix when the budget cut it. Every refused combination raises the
reference's ``ValueError``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.ops.json_constraint import prefix_ok
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu_torch.ops.json_schema import schema_to_gbnf
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig

from .fixtures import make_spm_vocab, spm_metadata

JSON_PIECES = [("{", -3.0), ("}", -3.0), ("[", -3.0), ("]", -3.0), ('"', -3.0),
               (":", -3.0), (",", -3.0), ("0", -3.0), ("1", -3.0), ("2", -3.0),
               ("true", -3.0), ("false", -3.0), ("null", -3.0), ("abc", -3.0),
               ("yes", -3.0), ("no", -3.0), ("maybe", -3.0)]
SCHEMA = {"type": "object", "properties": {"n": {"type": "integer"},
                                           "ok": {"type": "boolean"}},
          "required": ["n", "ok"]}
LIST_GRAMMAR = 'root ::= item+\nitem ::= "- " [a-z]+ "\\n"\n'
# name → (constraint fields, prompt, max_new_tokens)
CASES = {
    "json": ({"json_mode": True}, "produce json:", 40),
    "json_hello": ({"json_mode": True}, "hello world once upon a time", 40),
    "gbnf_yes_no": ({"grammar": 'root ::= "yes" | "no" | "maybe"'}, "answer:", 8),
    "gbnf_list": ({"grammar": LIST_GRAMMAR}, "a list:", 24),
    "json_schema": ({"grammar": schema_to_gbnf(SCHEMA)}, "produce:", 48),
}
# (case, seed) of the sampled runs at temperature 0.8
SEEDED = [("json", 3), ("json", 11), ("json_hello", 9), ("gbnf_yes_no", 5),
          ("gbnf_list", 7), ("json_schema", 2), ("json_schema", 13)]


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab(extra_pieces=JSON_PIECES)
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "constrained.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    return (JaxEngine(gguf_path, dtype=jnp.float32),
            Engine(gguf_path, dtype=torch.float32, device="cpu"))


def _run(engine, prompt, gen):
    events = list(engine.generate(prompt, gen))
    assert events[-1].kind == "done"
    return "".join(e.content for e in events if e.kind == "token"), events[-1].data


def _both(engines, name, **kw):
    fields, prompt, n = CASES[name]
    args = dict(fields, max_new_tokens=n, stop_on_eos=False, **kw)
    want = _run(engines[0], prompt, JaxGen(**args))
    got = _run(engines[1], prompt, GenerationConfig(**args))
    for key in ("n_prompt", "n_gen", "finish_reason", "constraint_complete",
                "json_complete"):
        assert got[1][key] == want[1][key], key
    assert got[0] == want[0]
    return got


def _meets(name, text, data):
    """The output satisfies its constraint, or the budget cut it short."""
    fields = CASES[name][0]
    if data["constraint_complete"]:
        assert data["finish_reason"] == "stop"
        if fields.get("json_mode"):
            json.loads(text)
        elif name == "json_schema":
            doc = json.loads(text)
            assert isinstance(doc["n"], int) and isinstance(doc["ok"], bool)
        elif name == "gbnf_yes_no":
            assert text in ("yes", "no", "maybe")
    else:
        assert data["finish_reason"] == "length"
        if fields.get("json_mode"):
            assert prefix_ok(text)


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_constrained_text_matches_jax(engines, name):
    text, data = _both(engines, name, temperature=0.0)
    _meets(name, text, data)
    assert data["readbacks"] == data["n_gen"] + data["shortlist_misses"]


@pytest.mark.parametrize("name,seed", SEEDED)
def test_seeded_constrained_text_matches_jax(engines, name, seed):
    text, data = _both(engines, name, temperature=0.8, seed=seed)
    _meets(name, text, data)


def test_stop_string_inside_constrained_output(engines):
    text, _ = _both(engines, "gbnf_list", temperature=0.0)
    stop = text[3:5]
    got, data = _both(engines, "gbnf_list", temperature=0.0, stop=(stop,))
    assert data["finish_reason"] == "stop" and text.startswith(got) and stop not in got


# the refused combinations, each with the reference's message
REFUSED = {
    "json_and_grammar": dict(json_mode=True, grammar='root ::= "a"'),
    "mirostat": dict(json_mode=True, mirostat=2, temperature=0.8),
    "typical": dict(grammar='root ::= "a"', typical_p=0.9, temperature=0.8),
    "logprobs": dict(json_mode=True, logprobs=2),
    "repeat_penalty": dict(json_mode=True, repeat_penalty=1.3),
    "presence_penalty": dict(grammar='root ::= "a"', presence_penalty=0.5),
    "frequency_penalty": dict(json_mode=True, frequency_penalty=0.5),
    "logit_bias": dict(json_mode=True, logit_bias=((5, 1.0),)),
}


def _error(fn):
    try:
        next(iter(fn()))
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_combinations_raise_the_reference_errors(engines, name):
    jax_msg = _error(lambda: engines[0].generate("x", JaxGen(**REFUSED[name])))
    msg = _error(lambda: engines[1].generate("x", GenerationConfig(**REFUSED[name])))
    assert msg is not None and msg == jax_msg


def test_greedy_constrained_ignores_mirostat_and_typical(engines):
    """At temperature 0 neither sampler runs, so neither is refused."""
    gen = GenerationConfig(json_mode=True, temperature=0.0, mirostat=2, typical_p=0.5,
                           max_new_tokens=8)
    assert list(engines[1].generate("x", gen))[-1].kind == "done"


def test_full_row_fallback_when_the_shortlist_misses(engines, monkeypatch):
    """With a shortlist of 2 the grammar's first token misses it: the full
    [V] row is read back and the text is the 64-wide run's."""
    fields, prompt, n = CASES["gbnf_yes_no"]
    gen = GenerationConfig(**fields, max_new_tokens=n, temperature=0.0)
    want, _ = _run(engines[1], prompt, gen)
    monkeypatch.setattr(engines[1], "_JSON_TOPK", 2)
    got, data = _run(engines[1], prompt, gen)
    assert data["shortlist_misses"] >= 1 and got == want
