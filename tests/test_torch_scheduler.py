"""The port's SlotScheduler against the JAX package's, on one fixture GGUF.

Both schedulers serve the tiny preset at f32 with 3 slots, block size 16,
decode chunks of 4 and prefill chunks of 16, so prompts longer than 16
tokens go through chunked-prefill mixed steps. Greedy streams of concurrent
requests are token-identical to the reference scheduler and to the port's
single-stream Engine; admission counts (prefill tokens, prefix hits) match
the reference; a seeded sampled stream does not depend on its co-tenants;
an exhausted pool ends a stream gracefully without touching its neighbour.
Prompts are token-id lists, so block arithmetic is exact.
"""

import queue
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
                                                        QueueFull, SlotScheduler)

from .fixtures import make_spm_vocab, spm_metadata

BS = 16
KW = dict(n_slots=3, decode_chunk=4, kv_block=BS, prefill_chunk=16)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
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
def port(engine):
    sched = SlotScheduler(engine, **KW)
    yield sched
    sched.close()


@pytest.fixture(scope="module")
def ref(gguf_path):
    sched = JaxSlotScheduler(JaxEngine(gguf_path, dtype=jnp.float32), **KW)
    yield sched
    sched.close()


def _ids(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(5, 250, size=n)]


def _greedy(cls, n):
    return cls(max_new_tokens=n, temperature=0.0, stop_on_eos=False)


def _concurrently(sched, prompts, gens):
    """Stream every request from its own thread at once; the texts."""
    out = {}
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(i, sched.generate_text(prompts[i], gens[i])))
        for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return [out[i] for i in range(len(prompts))]


def _ref_counters(sched):
    return sched.metrics.snapshot()["counters"]


def test_concurrent_greedy_streams_match_reference_and_engine(port, ref, engine):
    """Three concurrent requests, two of them longer than the prefill
    chunk (mixed steps beside a decoding row), token-identical in all
    three implementations."""
    prompts = [_ids(1, 9), _ids(2, 40), _ids(3, 23)]
    lens = [12, 9, 15]
    got = _concurrently(port, prompts, [_greedy(GenerationConfig, n) for n in lens])
    want = _concurrently(ref, prompts, [_greedy(JaxGen, n) for n in lens])
    single = ["".join(e.content for e in engine.generate(p, _greedy(GenerationConfig, n))
                      if e.kind == "token") for p, n in zip(prompts, lens)]
    assert got == want == single
    assert all(got)


def _share_prefix(sched, gen_cls, counters):
    """A long-running first request; once it decodes (its blocks are in the
    prefix index), a second one sharing its first two blocks. The first
    still holds its slot (80 tokens against the second's one-chunk
    admission), so the second takes another slot and finds the blocks in
    the pool. Returns the counter deltas of the second admission and both
    texts. The wait reads the slot's phase: random ids are mostly byte
    tokens, whose text the stream decoder may hold back for a while."""
    base = _ids(7, 2 * BS)
    p1, p2 = base + _ids(8, 8), base + _ids(9, 8)
    out = {}
    t = threading.Thread(target=lambda: out.__setitem__(
        1, sched.generate_text(p1, _greedy(gen_cls, 80))))
    t.start()
    for _ in range(6000):
        if any(s is not None and s.phase == "decode" for s in sched._slots):
            break
        time.sleep(0.001)
    c0 = dict(counters())
    out[2] = sched.generate_text(p2, _greedy(gen_cls, 8))
    c1 = counters()
    t.join(timeout=120)
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in
             ("prefill_tokens_total", "paged_prefix_hits_total",
              "paged_prefix_tokens_total")}
    return delta, out[1], out[2]


def test_shared_prefix_admission_counts_match_reference(port, ref):
    got = _share_prefix(port, GenerationConfig, lambda: port.counters)
    want = _share_prefix(ref, JaxGen, lambda: _ref_counters(ref))
    assert got == want
    # the second admission attached the two shared blocks and computed
    # only its suffix: one mixed-step chunk of 7 and the last token's
    # 16-wide bucket, never the 32 shared tokens
    assert got[0] == {"prefill_tokens_total": 7 + BS,
                      "paged_prefix_hits_total": 1,
                      "paged_prefix_tokens_total": 2 * BS}


def test_chunked_prefill_equals_unchunked_admission(engine, port):
    """A 50-token prompt fed in 16-token chunks beside a decoding co-tenant
    gives the greedy output of a one-shot prefill."""
    unchunked = SlotScheduler(engine, **KW, prefill_chunked=False)
    try:
        prompts = [_ids(11, 50), _ids(12, 6)]
        gens = [_greedy(GenerationConfig, 10), _greedy(GenerationConfig, 30)]
        stolen = port.counters["prefill_steps_stolen_total"]
        chunked = _concurrently(port, prompts, gens)
        assert port.counters["prefill_steps_stolen_total"] >= stolen
        # both schedulers record into the engine's one registry: the
        # unchunked run's own steals are the delta across it
        stolen = unchunked.counters["prefill_steps_stolen_total"]
        assert chunked == _concurrently(unchunked, prompts, gens)
        assert unchunked.counters["prefill_steps_stolen_total"] == stolen
    finally:
        unchunked.close()


def test_seeded_sampled_stream_ignores_co_tenants(port):
    sampled = GenerationConfig(max_new_tokens=16, temperature=0.9, top_k=40,
                               top_p=0.95, min_p=0.02, seed=1234)
    alone = port.generate_text(_ids(21, 10), sampled)
    beside = _concurrently(
        port, [_ids(21, 10), _ids(22, 30), _ids(23, 5)],
        [sampled, _greedy(GenerationConfig, 20),
         GenerationConfig(max_new_tokens=12, temperature=1.2, seed=5)])
    assert beside[0] == alone and alone


def _events(q):
    """One request's events from its emit queue, through its done event."""
    out = [q.get(timeout=120)]
    while out[-1].kind != "done":
        out.append(q.get(timeout=120))
    return out


def test_exhausted_pool_ends_a_stream_and_spares_its_neighbour(engine):
    """A pool of 4 usable blocks: the 60-token stream runs dry near 48
    positions and ends with "length" and a log line; the short neighbour,
    admitted beside it, gets the single-stream engine's text; the scheduler
    still serves."""
    sched = SlotScheduler(engine, **KW, kv_pool_blocks=5)
    long_p, short_p = _ids(31, 8), _ids(32, 4)
    short_gen = _greedy(GenerationConfig, 10)
    try:
        q_long, q_short = queue.Queue(), queue.Queue()
        sched.submit(long_p, _greedy(GenerationConfig, 60), emit=q_long.put)
        sched.submit(short_p, short_gen, emit=q_short.put)
        long_ev, short_ev = _events(q_long), _events(q_short)
        done = long_ev[-1]
        assert done.data["finish_reason"] == "length"
        assert 8 <= done.data["n_gen"] < 60
        assert any("pool exhausted" in e.content for e in long_ev
                   if e.kind == "log")
        assert short_ev[-1].data["finish_reason"] == "length"
        assert "".join(e.content for e in short_ev if e.kind == "token") == \
            "".join(e.content for e in engine.generate(short_p, short_gen)
                    if e.kind == "token")
        assert sched.generate_text(_ids(33, 4), _greedy(GenerationConfig, 4))
    finally:
        sched.close()


def test_bad_configurations_raise_like_the_reference(engine, gguf_path):
    jeng = JaxEngine(gguf_path, dtype=jnp.float32)
    for kw, match in (({"n_slots": 1}, "at least 2 slots"),
                      ({"prefill_chunk": 24}, "power of two"),
                      ({"prefill_chunk": 8}, "power of two")):
        for cls, eng in ((SlotScheduler, engine), (JaxSlotScheduler, jeng)):
            with pytest.raises(ValueError, match=match):
                cls(eng, **{**KW, **kw})


def test_full_queue_refuses_and_abort_frees_the_slot(engine):
    sched = SlotScheduler(engine, **KW, max_queue=0)
    try:
        with pytest.raises(QueueFull):
            sched.submit(_ids(41, 4), emit=lambda ev: None)
    finally:
        sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_ids(41, 4), emit=lambda ev: None)


def test_closing_a_stream_aborts_its_request(port):
    """A consumer that stops reading closes the generator: the request is
    aborted at the next chunk boundary and its slot freed. An aborted row
    keeps no prefix; one that ran to its budget would."""
    prompt = _ids(51, 6)
    stream = port.generate(prompt, _greedy(GenerationConfig, 120))
    for ev in stream:
        if ev.kind == "log" and ev.content.startswith("prefill:"):
            break
    r = next(s.idx for s in port._slots if s is not None and s.ids == prompt)
    stream.close()
    for _ in range(400):
        if port._slots[r] is None:
            break
        time.sleep(0.05)
    assert port._slots[r] is None and port._row_ids[r] == []


def test_worker_thread_enters_inference_mode(port):
    """Inference mode is thread-local: the worker enters it itself, so the
    device chains it writes are inference tensors (no autograd state)."""
    assert port.generate_text(_ids(61, 5), _greedy(GenerationConfig, 6))
    assert port._tok_dev.is_inference() and port._recent_dev.is_inference()
