"""Fault isolation, the poison detector and the decode watchdog on the
port's slots against the JAX package's scheduler, on the CPU at f32.

Faults are armed through the port's switchboard (``runtime/faults.py``)
and always disarmed in a ``finally``. An injected ``decode_chunk_crash`` on
one row fails that request alone while its siblings give the reference
scheduler's uninjected text; the same holds for a crash at a fed prefill
chunk (the mixed step then runs with that row parked). A request that
crashed its slot ``poison_limit`` times is refused (``PoisonedRequest``, a
400 decision). Admission faults (tokenizer, prefill, an exhausted pool)
fail only their request, the pool's without a poison strike. The watchdog
is driven by a ``device_stall`` several times its budget: the stalled
step's request fails, new work is shed with a 503 while the step hangs,
and the next request after it gives the uncontended text.
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
                                                        SlotScheduler, faults)
from distributed_llm_pipeline_tpu_torch.runtime.scheduler import (PoisonedRequest,
                                                                  SchedulerStalled)

from .fixtures import make_spm_vocab, spm_metadata

KW = dict(n_slots=3, decode_chunk=4, kv_block=16, prefill_chunk=16)
N = 12
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(5, 250, n)]
           for s, n in ((11, 9), (12, 12), (13, 10), (14, 40))]


@pytest.fixture(autouse=True)
def _disarm():
    try:
        yield
    finally:
        faults.disarm()


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "resilience.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engine(gguf_path):
    return Engine(gguf_path, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def ref_texts(gguf_path):
    """The JAX scheduler's uninjected greedy text of each prompt."""
    sched = JaxSlotScheduler(JaxEngine(gguf_path, dtype=jnp.float32), **KW)
    try:
        gen = JaxGen(max_new_tokens=N, temperature=0.0, stop_on_eos=False)
        return [sched.generate_text(p, gen) for p in PROMPTS]
    finally:
        sched.close()


@pytest.fixture(scope="module")
def sched(engine):
    s = SlotScheduler(engine, **KW)
    yield s
    s.close()


GREEDY = GenerationConfig(max_new_tokens=N, temperature=0.0, stop_on_eos=False)


def _collect(sched, prompt, gen=GREEDY):
    events = list(sched.generate(prompt, gen))
    text = "".join(e.content for e in events if e.kind == "token")
    dones = [e for e in events if e.kind == "done"]
    assert len(dones) == 1
    return text, dones[0].data, events


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


def _together(sched, prompts, gen=GREEDY):
    """Admit every prompt in one pass (rows 0, 1, ... in order); results."""
    out = {}
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, _collect(sched, prompts[i], gen))) for i in range(len(prompts))]
    with held(sched):
        for t in threads:
            t.start()
        t_end = time.monotonic() + 60
        while sched.queue_depth < len(prompts):
            assert time.monotonic() < t_end
            time.sleep(0.002)
    for t in threads:
        t.join(120)
    return [out[i] for i in range(len(prompts))]


def _drained(sched) -> None:
    """Erase every idle slot's retained prefix; the pool is then empty:
    quarantined rows gave their blocks back."""
    for i in range(sched.n_slots):
        sched.erase_slot(i)
    al = sched._backend.allocator
    assert al.used == 0, f"leaked {al.used} blocks"
    assert not np.any(al.ref[1:]) and not al.index


def test_decode_crash_fails_one_row_and_spares_its_siblings(sched, ref_texts):
    with faults.armed("decode_chunk_crash", times=1, row=1) as spec:
        got = _together(sched, PROMPTS[:3])
        assert spec.fired == 1
    assert got[1][1]["finish_reason"] == "error"
    assert "slot quarantined" in got[1][1]["error"] and "injected fault" in got[1][1]["error"]
    for i in (0, 2):
        assert got[i][1]["finish_reason"] == "length"
        assert got[i][0] == ref_texts[i], i
    assert sched.counters["slots_quarantined_total"] >= 1
    # one failure is below poison_limit: the same request is served again
    text, done, _ = _collect(sched, PROMPTS[1])
    assert done["finish_reason"] == "length" and text == ref_texts[1]
    _drained(sched)


def test_prefill_chunk_crash_parks_one_row_mid_prefill(sched, ref_texts):
    """The 40-token prompt is fed in 16-token chunks beside a decoding row;
    a crash at its first fed chunk quarantines it there, and the decoding
    sibling gives the reference text."""
    with faults.armed("prefill_chunk_crash", times=1) as spec:
        got = _together(sched, [PROMPTS[0], PROMPTS[3]])
        assert spec.fired == 1
    assert got[1][1]["finish_reason"] == "error"
    assert "mid-prefill-chunk" in got[1][1]["error"]
    assert got[0][1]["finish_reason"] == "length" and got[0][0] == ref_texts[0]
    text, done, _ = _collect(sched, PROMPTS[3])
    assert done["finish_reason"] == "length" and text == ref_texts[3]
    _drained(sched)


@pytest.mark.parametrize("point,poisons", [("tokenizer_error", True),
                                           ("prefill_oom", True),
                                           ("pool_exhausted", False)])
def test_admission_faults_fail_only_their_request(sched, ref_texts, point, poisons):
    # pool_exhausted fires at admission and at its retry after the eviction
    with faults.armed(point, times=2 if point == "pool_exhausted" else 1):
        _, done, _ = _collect(sched, PROMPTS[2])
    assert done["finish_reason"] == "error"
    fp = sched._fingerprint(PROMPTS[2], GREEDY)
    assert (sched._poison.pop(fp, 0) > 0) == poisons
    text, done, _ = _collect(sched, PROMPTS[2])
    assert done["finish_reason"] == "length" and text == ref_texts[2]
    _drained(sched)


def test_pool_exhausted_mid_decode_ends_the_row_gracefully(sched, ref_texts):
    with faults.armed("pool_exhausted", skip=1, times=2):
        text, done, evs = _collect(sched, PROMPTS[0])
    assert done["finish_reason"] == "length" and done["n_gen"] < N
    assert ref_texts[0].startswith(text)
    assert any("pool exhausted" in e.content for e in evs if e.kind == "log")
    _drained(sched)


def test_poisoned_request_is_refused_after_poison_limit(engine, ref_texts):
    s = SlotScheduler(engine, poison_limit=2, **KW)
    try:
        with faults.armed("decode_chunk_crash", times=2):
            for _ in range(2):
                _, done, _ = _collect(s, PROMPTS[0])
                assert done["finish_reason"] == "error"
        with pytest.raises(PoisonedRequest, match="crashed its slot 2 times"):
            s.submit(PROMPTS[0], GREEDY, emit=lambda ev: None)
        shed = s.shed_check(GREEDY, PROMPTS[0])
        assert shed["status"] == 400 and "poison_limit 2" in shed["reason"]
        assert s.counters["requests_poisoned_total"] == 2
        text, done, _ = _collect(s, PROMPTS[1])   # another request is served
        assert done["finish_reason"] == "length" and text == ref_texts[1]
    finally:
        s.close()


def test_watchdog_fails_the_stalled_step_sheds_and_recovers(engine, ref_texts):
    s = SlotScheduler(engine, n_slots=2, decode_chunk=4, kv_block=16)
    got = {}
    try:
        _collect(s, PROMPTS[2])           # a warm step under the default budget
        s.stall_budget_s = 0.25           # the watchdog re-reads it every poll
        with faults.armed("device_stall", seconds=3.0, times=1):
            t = threading.Thread(target=lambda: got.__setitem__(
                "stalled", _collect(s, PROMPTS[0])))
            t.start()
            assert s._stalled.wait(30), "the watchdog never flagged the stall"
            shed = s.shed_check(GREEDY)
            assert shed["status"] == 503 and "stalled" in shed["reason"]
            assert shed["retry_after_s"] >= 1
            with pytest.raises(SchedulerStalled, match="stall budget"):
                s.submit(PROMPTS[1], GREEDY, emit=lambda ev: None)
            t.join(60)
        _, done, _ = got["stalled"]
        assert done["finish_reason"] == "error" and "watchdog" in done["error"]
        assert s.counters["watchdog_stalls_total"] == 1
        assert s.counters["requests_shed_total"] == 2
        t_end = time.monotonic() + 30
        while s._stalled.is_set():
            assert time.monotonic() < t_end, "never recovered"
            time.sleep(0.01)
        text, done, _ = _collect(s, PROMPTS[1])
        assert done["finish_reason"] == "length" and text == ref_texts[1]
    finally:
        s.close()


def test_the_mesh_slots_quarantine_one_row_and_never_preempt(gguf_path, ref_texts):
    """The lifecycle lives in the scheduler, so it holds over a 1x2 mesh's
    dense rows: a crashed row fails alone and its sibling gives the
    reference text; preemption stays off there, as in the reference."""
    from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine

    eng = ShardedEngine(gguf_path, mesh_spec=MeshSpec.parse("1x2"), device="cpu",
                        dtype=torch.float32)
    try:
        s = SlotScheduler(eng, n_slots=2, decode_chunk=4)
        try:
            assert s.preempt is False
            with faults.armed("decode_chunk_crash", times=1, row=1) as spec:
                got = _together(s, PROMPTS[:2])
                assert spec.fired == 1
            assert got[1][1]["finish_reason"] == "error"
            assert got[0][1]["finish_reason"] == "length" and got[0][0] == ref_texts[0]
            s.preempt_now()
            text, done, _ = _collect(s, PROMPTS[1], GenerationConfig(
                max_new_tokens=N, temperature=0.0, stop_on_eos=False, priority="batch"))
            assert done["finish_reason"] == "length" and text == ref_texts[1]
            assert s.counters.get('kv_swaps_total{result="out"}', 0) == 0
        finally:
            s.close()
    finally:
        eng.close()
