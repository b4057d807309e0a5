"""Preemption on the port's paged slots against the JAX package's scheduler,
on the CPU at f32.

A batch-class row preempted mid-decode swaps its KV and sampling chains out
through the handoff wire format into the swap store and back in with no
prefill: on the fast path its own row still holds its blocks (a re-point),
on the slow path an interactive request took the row and ``adopt_row``
writes the payload into another one. Greedy text equals the JAX
``SlotScheduler``'s uninterrupted text on both paths, the prefill counters
stay flat across the swap-in, and a seeded sampled row resumes with the
tokens of its unpreempted run (its ``torch.Generator`` state rides the
payload). A swap entry that expires while parked ends its request with a
typed error carrying ``retry_after_s``. Requests are queued while the
worker is held inside a control operation, so the EDF order alone decides
admission.
"""

import contextlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu_torch.runtime import (Engine, GenerationConfig,
                                                        SlotScheduler)

from .fixtures import make_spm_vocab, spm_metadata

KW = dict(n_slots=2, decode_chunk=4, kv_block=16, prefill_chunk=16)
N_VICTIM = 28
PROMPTS = {"a": [int(t) for t in np.random.default_rng(1).integers(5, 250, 11)],
           "b": [int(t) for t in np.random.default_rng(2).integers(5, 250, 13)],
           "i": [int(t) for t in np.random.default_rng(3).integers(5, 250, 9)]}


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "preempt.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engine(gguf_path):
    return Engine(gguf_path, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def ref_texts(gguf_path):
    """The JAX scheduler's uninterrupted greedy text of each prompt."""
    sched = JaxSlotScheduler(JaxEngine(gguf_path, dtype=jnp.float32), preempt=False,
                             **KW)
    try:
        return {k: sched.generate_text(p, JaxGen(max_new_tokens=N_VICTIM,
                                                 temperature=0.0, stop_on_eos=False,
                                                 priority="batch"))
                for k, p in PROMPTS.items() if k != "i"}
    finally:
        sched.close()


def _gen(kind: str, priority: str = "batch", n: int = N_VICTIM) -> GenerationConfig:
    if kind == "greedy":
        return GenerationConfig(max_new_tokens=n, temperature=0.0, stop_on_eos=False,
                                priority=priority)
    return GenerationConfig(max_new_tokens=n, temperature=0.9, top_k=40, top_p=0.95,
                            seed=7, stop_on_eos=False, priority=priority)


@contextlib.contextmanager
def held(sched):
    """Hold the worker inside a control operation; requests submitted
    meanwhile are admitted together, in EDF order, on release."""
    inside, release = threading.Event(), threading.Event()

    def block():
        inside.set()
        release.wait(60)

    t = threading.Thread(target=sched._control, args=(block,))
    t.start()
    assert inside.wait(60)
    try:
        yield
    finally:
        release.set()
        t.join(60)


def _run(sched, prompt, gen, out: dict, key: str) -> threading.Thread:
    def go():
        evs = list(sched.generate(prompt, gen))
        out[key] = ("".join(e.content for e in evs if e.kind == "token"),
                    [e for e in evs if e.kind == "done"][-1].data, evs)

    t = threading.Thread(target=go)
    t.start()
    return t


def _wait(cond, what: str, timeout: float = 60.0) -> None:
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.005)


class _Watch:
    """Counts adopt_row calls and checks every swap-in leaves the prefill
    counters and the forward count where they were."""

    def __init__(self, sched):
        self.adopted = 0
        self.swap_ins = 0
        be = sched._backend
        adopt, restore = be.adopt_row, sched._restore_swapped

        def adopt_row(*a, **k):
            self.adopted += 1
            return adopt(*a, **k)

        def restore_swapped(free, req):
            keys = ("prefill_tokens_total", "paged_prefix_tokens_total")
            before = ([sched.counters[k] for k in keys], sched.forwards)
            restore(free, req)
            assert ([sched.counters[k] for k in keys], sched.forwards) == before
            self.swap_ins += 1

        be.adopt_row = adopt_row
        sched._restore_swapped = restore_swapped


def _fast(sched, kind: str):
    """One batch request preempted by ``preempt_now`` after its first token;
    nobody takes its row, so it resumes in place."""
    sched.preempt_now()
    out = {}
    _run(sched, PROMPTS["a"], _gen(kind), out, "a").join(120)
    return out["a"]


def _slow(sched, kind: str):
    """Two batch rows decode; an interactive request queued meanwhile
    preempts the less urgent (the later) one and takes its row, so the
    victim resumes through adopt_row in another."""
    out = {}
    ta = _run(sched, PROMPTS["a"], _gen(kind), out, "a")
    _wait(lambda: any(s is not None and s.n_gen >= 1 for s in sched._slots), "a's token")
    tb = _run(sched, PROMPTS["b"], _gen(kind), out, "b")
    _wait(lambda: sum(s is not None and s.n_gen >= 1 for s in sched._slots) == 2,
          "two decoding rows")
    with held(sched):
        ti = _run(sched, PROMPTS["i"], _gen("greedy", "interactive", 6), out, "i")
        _wait(lambda: sched.queue_depth == 1, "the interactive request queued")
    for t in (ta, tb, ti):
        t.join(120)
    return out


@pytest.mark.parametrize("path", ["fast", "slow"])
def test_preempted_greedy_row_gives_the_reference_text(engine, ref_texts, path):
    sched = SlotScheduler(engine, **KW)
    try:
        watch = _Watch(sched)
        if path == "fast":
            got = {"a": _fast(sched, "greedy")}
        else:
            got = _slow(sched, "greedy")
            assert got["i"][1]["finish_reason"] == "length"
            # the interactive request got its first token while the victim
            # (b) was parked: its first token event precedes b's resume log
            b_evs = [e.content for e in got["b"][2] if e.kind == "log"]
            assert any(m.startswith("preempted (slot") for m in b_evs)
        c = sched.counters
        assert c['preemptions_total{class="batch"}'] == 1
        assert c['kv_swaps_total{result="out"}'] == 1
        assert c['kv_swaps_total{result="in"}'] == 1
        assert watch.swap_ins == 1
        assert watch.adopted == (0 if path == "fast" else 1)
        for k, (text, done, _) in got.items():
            if k != "i":
                assert done["finish_reason"] == "length"
                assert text == ref_texts[k], k
    finally:
        sched.close()


@pytest.mark.parametrize("path", ["fast", "slow"])
def test_preempted_seeded_row_resumes_its_own_draws(engine, path):
    sched = SlotScheduler(engine, **KW)
    try:
        want = {k: sched.generate_text(PROMPTS[k], _gen("sampled")) for k in ("a", "b")}
        watch = _Watch(sched)
        got = {"a": _fast(sched, "sampled")} if path == "fast" else _slow(sched, "sampled")
        assert watch.swap_ins == 1
        for k in want:
            if k in got:
                assert got[k][0] == want[k], k
    finally:
        sched.close()


def test_expired_swap_entry_ends_with_a_typed_retry_after(engine):
    """The parked victim's entry outlives its TTL (the swap-out holds the
    worker past it), so the next loop pass ends the request with a typed
    error and ``retry_after_s``; no hang, nothing left in the store."""
    sched = SlotScheduler(engine, swap_ttl_s=0.02, **KW)
    try:
        swap_out = sched._swap_out

        def slow_swap_out(slot):
            ok = swap_out(slot)
            time.sleep(0.1)
            return ok

        sched._swap_out = slow_swap_out
        got = _slow(sched, "greedy")
        text, done, _ = got["b"]
        assert done["finish_reason"] == "error" and done["retry_after_s"] >= 1
        assert "expired in the swap store" in done["error"]
        assert sched.counters['kv_swaps_total{result="expired"}'] == 1
        assert len(sched._swap_store) == 0 and not sched._swapped
        assert got["a"][1]["finish_reason"] == "length"
    finally:
        sched.close()


def test_preemption_is_off_without_pressure_or_when_disabled(engine, ref_texts):
    """``preempt=False`` (``DLP_PREEMPT=0``) ignores ``preempt_now``, and a
    normal-class row is never a victim."""
    for kw, gen in (({"preempt": False}, _gen("greedy")),
                    ({}, _gen("greedy", "normal"))):
        sched = SlotScheduler(engine, **kw, **KW)
        try:
            sched.preempt_now()
            assert sched.generate_text(PROMPTS["a"], gen) == ref_texts["a"]
            assert sched.counters.get('kv_swaps_total{result="out"}', 0) == 0
        finally:
            sched.close()
