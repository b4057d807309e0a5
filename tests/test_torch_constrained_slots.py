"""Constrained rows of the port's SlotScheduler against the port's
single-stream Engine, on the CPU at f32 (the reference's
``tests/test_slots.py`` constrained cases, and more).

A JSON-mode, GBNF or ``json_schema`` request served on a slot gives the
engine's text, greedy and seeded, alone, beside three free requests that
keep decoding in the same batch, fed through chunked-prefill mixed steps,
and on a row a biased request left. Each refused combination raises the
reference's ``ValueError`` at submission.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu_torch.ops.json_schema import schema_to_gbnf
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig, SlotScheduler

from .fixtures import make_spm_vocab, spm_metadata
from .test_torch_constrained import JSON_PIECES, SCHEMA

GRAMMAR = 'root ::= "yes" | "no" | "maybe"'
LONG = "hello world once upon a time " * 6   # > 16 tokens: chunked at 16


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab(extra_pieces=JSON_PIECES)
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "slots.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engine(gguf_path):
    return Engine(gguf_path, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def sched(engine):
    s = SlotScheduler(engine, n_slots=4, prefill_chunk=16)
    yield s
    s.close()


def _run(target, prompt, gen):
    events = list(target.generate(prompt, gen))
    assert events[-1].kind == "done"
    return "".join(e.content for e in events if e.kind == "token"), events[-1].data


# name → (prompt, constraint fields, max_new_tokens, temperature, seed)
CASES = {
    "json_greedy": ("produce json:", {"json_mode": True}, 24, 0.0, None),
    "json_seeded": ("produce json:", {"json_mode": True}, 24, 0.8, 3),
    "gbnf_greedy": ("answer:", {"grammar": GRAMMAR}, 8, 0.0, None),
    "gbnf_seeded": ("answer:", {"grammar": GRAMMAR}, 8, 0.8, 5),
    "schema_greedy": ("produce:", {"grammar": schema_to_gbnf(SCHEMA)}, 48, 0.0, None),
    "schema_seeded": ("produce:", {"grammar": schema_to_gbnf(SCHEMA)}, 48, 0.8, 2),
    "json_chunked_prefill": (LONG, {"json_mode": True}, 24, 0.0, None),
}


def _gen(name):
    _, fields, n, temp, seed = CASES[name]
    return GenerationConfig(**fields, max_new_tokens=n, temperature=temp, seed=seed,
                            stop_on_eos=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_constrained_row_matches_engine(sched, engine, name):
    prompt = CASES[name][0]
    got, data = _run(sched, prompt, _gen(name))
    want, wdata = _run(engine, prompt, _gen(name))
    assert got == want
    for key in ("n_gen", "finish_reason", "constraint_complete", "json_complete"):
        assert data[key] == wdata[key], key
    assert data["readbacks"] == data["n_gen"] + data["shortlist_misses"]


def test_constrained_and_free_requests_progress_together(sched, engine):
    """One JSON-mode and one chunked GBNF request beside three free ones,
    all at once: the free rows keep decoding in the batch while the
    constrained rows advance a step a launch, and every output is the
    engine's."""
    free = GenerationConfig(max_new_tokens=10, temperature=0.0, stop_on_eos=False)
    jobs = {"json": ("emit json:", _gen("json_greedy")),
            "gbnf": (LONG, _gen("gbnf_greedy"))}
    jobs.update({f"free{i}": (f"hello world {i}", free) for i in range(3)})
    results = {}

    def run(tag):
        results[tag] = _run(sched, *jobs[tag])[0]

    threads = [threading.Thread(target=run, args=(tag,)) for tag in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert sorted(results) == sorted(jobs)
    for tag, (prompt, gen) in jobs.items():
        assert results[tag] == _run(engine, prompt, gen)[0], tag
    assert all(len(results[f"free{i}"]) > 0 for i in range(3))


def test_constrained_row_after_a_biased_tenant(engine):
    """A constrained request that takes the row a biased request left (its
    prompt shares the row's retained prefix) zeroes the row's bias and
    gives the engine's text."""
    s = SlotScheduler(engine, n_slots=2)
    try:
        ban = engine.tokenizer.encode(LONG)[-1]
        _run(s, LONG, GenerationConfig(max_new_tokens=4, temperature=0.0,
                                       logit_bias=((ban, -100.0),)))
        row = next(iter(s._bias_rows))
        got, _ = _run(s, LONG + "json:", _gen("json_greedy"))
        ids = engine.tokenizer.encode(LONG + "json:")
        assert s._row_ids[row][:len(ids)] == ids   # it took the biased row
        assert not s._bias_rows and not s._bias_dev[row].any()
        assert got == _run(engine, LONG + "json:", _gen("json_greedy"))[0]
    finally:
        s.close()


REFUSED = {
    "json_and_grammar": dict(json_mode=True, grammar='root ::= "a"'),
    "logprobs": dict(json_mode=True, logprobs=2),
    "repeat_penalty": dict(json_mode=True, repeat_penalty=1.3),
    "logit_bias": dict(grammar='root ::= "a"', logit_bias=((5, 1.0),)),
    "context_shift": dict(context_shift=True),
    "context_shift_greedy": dict(context_shift=True, temperature=0.0, keep=4),
}


@pytest.fixture(scope="module")
def jax_sched(gguf_path):
    s = JaxSlotScheduler(JaxEngine(gguf_path, dtype=jnp.float32), n_slots=2)
    yield s
    s.close()


def _submit_error(s, gen):
    try:
        s.submit("x", gen, emit=lambda ev: None)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_at_submission_with_the_reference_errors(sched, jax_sched, name):
    msg = _submit_error(sched, GenerationConfig(**REFUSED[name]))
    assert msg is not None and msg == _submit_error(jax_sched, JaxGen(**REFUSED[name]))
