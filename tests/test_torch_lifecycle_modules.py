"""The port's request-lifecycle modules against the JAX package's, without a
model: the fault switchboard (``runtime/faults.py``) and the swap store
(``runtime/swapstore.py``) driven through the same operation sequences as
their originals, the handoff wire format (``runtime/disagg.py``) loading
each package's payload in the other for dense, ``q8_0`` and latent rows,
extras and bf16 logits included, the EDF admission queue popping the
reference's order with the same per-class and per-tenant depths, the
preemption victim choice on the reference's cases, and the serving layer's
priority validation and ``Retry-After`` rendering.
"""

import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS as JAX_PRESETS
from distributed_llm_pipeline_tpu.models.llama import KVCache as JaxKVCache
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import disagg as jdisagg
from distributed_llm_pipeline_tpu.runtime import faults as jfaults
from distributed_llm_pipeline_tpu.runtime import scheduler as jsched
from distributed_llm_pipeline_tpu.runtime.swapstore import SwapStore as JaxSwapStore
from distributed_llm_pipeline_tpu.serving import common as jcommon
from distributed_llm_pipeline_tpu_torch.models import PRESETS, KVCache
from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig
from distributed_llm_pipeline_tpu_torch.runtime import disagg, faults
from distributed_llm_pipeline_tpu_torch.runtime import scheduler as psched
from distributed_llm_pipeline_tpu_torch.runtime.swapstore import SwapStore
from distributed_llm_pipeline_tpu_torch.serving import common


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


# -- faults ---------------------------------------------------------------

def test_fault_points_are_the_reference_catalog():
    assert set(faults.POINTS) == set(jfaults.POINTS)
    for name in ("ACTIVE", "arm", "disarm", "fires", "check", "stall", "armed",
                 "arm_from_env", "stats", "delay", "InjectedFault", "FaultSpec"):
        assert hasattr(faults, name), name


@pytest.mark.parametrize("spec", [
    dict(point="decode_chunk_crash", skip=2, times=1, row=1),
    dict(point="prefill_oom", skip=0, times=3),
    dict(point="pool_exhausted", skip=1, times=2, row=0),
    dict(point="prefill_chunk_crash", skip=1, times=1, row=2, phase="finish"),
])
def test_fault_trigger_semantics_match(spec):
    """Armed alike, both switchboards fire on the same evaluations of a
    sequence of contexts, and count the same hits."""
    spec = dict(spec)
    point = spec.pop("point")
    rng = np.random.default_rng(len(point))
    ctxs = [dict(row=int(rng.integers(0, 3)), phase=str(rng.choice(["finish", "feed"])))
            for _ in range(40)]
    got_spec = faults.arm(point, **spec)
    want_spec = jfaults.arm(point, **spec)
    assert faults.ACTIVE and jfaults.ACTIVE
    got = [faults.fires(point, **c) for c in ctxs]
    want = [jfaults.fires(point, **c) for c in ctxs]
    assert got == want and any(got)
    assert (got_spec.hits, got_spec.fired) == (want_spec.hits, want_spec.fired)
    assert faults.stats() == jfaults.stats()
    faults.disarm(point)
    jfaults.disarm(point)
    assert not faults.ACTIVE


def test_fault_env_parsing_check_and_armed_match():
    value = "prefill_oom:skip=1,times=2;device_stall:seconds=0.5,row=2,phase=feed"
    got, want = faults.arm_from_env(value), jfaults.arm_from_env(value)
    assert [(s.point, s.skip, s.times, s.seconds, s.match) for s in got] == \
        [(s.point, s.skip, s.times, s.seconds, s.match) for s in want]
    assert faults.stats() == jfaults.stats()
    faults.disarm()
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.arm("warp_core_breach")
    with faults.armed("tokenizer_error") as spec:
        with pytest.raises(faults.InjectedFault, match="tokenizer_error"):
            faults.check("tokenizer_error")
        assert spec.fired == 1
    assert not faults.ACTIVE
    faults.check("tokenizer_error")   # disarmed: nothing happens
    with faults.armed("device_stall", seconds=0.01, times=1):
        assert faults.stall("device_stall") == 0.01
        assert faults.stall("device_stall") == 0.0


# -- the swap store -------------------------------------------------------

def _store_run(cls, ops):
    evicted = []
    store = cls(100, ttl_s=5.0, on_evict=evicted.append)
    out = []
    for op, *args in ops:
        if op == "put":
            out.append(store.put(*args))
        elif op == "take":
            out.append(store.take(*args))
        elif op == "sweep":
            t0 = min(e["t"] for e in store._entries.values()) if store._entries else 0.0
            out.append(sorted(store.sweep(now=t0 + args[0])))
        else:
            store.clear()
        out.append((store.bytes_used, len(store), tuple(evicted)))
    return out


def test_swap_store_matches_the_reference():
    ops = [("put", "a", b"x" * 40), ("put", "b", b"y" * 40), ("take", "a"),
           ("put", "c", b"z" * 50), ("put", "big", b"q" * 101),   # refused
           ("take", "b"), ("take", "zz"), ("sweep", 1.0), ("sweep", 10.0),
           ("put", "e", b"e" * 100), ("take", "e"), ("put", "f", b"f"), ("clear",)]
    assert _store_run(SwapStore, ops) == _store_run(JaxSwapStore, ops)
    with pytest.raises(ValueError, match="must be positive"):
        SwapStore(0, 1.0)


def test_swap_store_evicts_oldest_first():
    """Over budget, ``put`` evicts oldest-first and reports each victim.
    (The reference's store keeps its entries in a plain dict, whose
    ``popitem`` takes no ``last``: its eviction raises TypeError, so this
    case is held to the documented LRU behaviour, not to the reference.)"""
    ops = [("put", "a", b"x" * 40), ("put", "b", b"y" * 40), ("take", "a"),
           ("put", "c", b"z" * 50), ("put", "d", b"w" * 30),   # evicts b
           ("put", "g", b"g" * 90),                           # evicts c, d
           ("take", "b"), ("take", "g")]
    assert _store_run(SwapStore, ops) == [
        True, (40, 1, ()), True, (80, 2, ()), b"x" * 40, (40, 1, ()),
        True, (90, 2, ()), True, (80, 2, ("b",)), True, (90, 1, ("b", "c", "d")),
        None, (90, 1, ("b", "c", "d")), b"g" * 90, (0, 0, ("b", "c", "d"))]


# -- the handoff wire format ----------------------------------------------

def _rows(kv_quant, kv_mode, S=32, length=11, seed=0):
    """A port row cache and a reference one holding the same values."""
    cfg = PRESETS["tiny"].replace(max_seq_len=S)
    jcfg = JAX_PRESETS["tiny"].replace(max_seq_len=S)
    rank = 8 if kv_mode == "latent" else None
    port = KVCache.zeros(cfg, batch=1, max_seq=S, dtype=torch.float32,
                         kv_quant=kv_quant, kv_mode=kv_mode, latent_rank=rank)
    ref = JaxKVCache.zeros(jcfg, batch=1, max_seq=S, dtype=jnp.float32,
                           kv_quant=kv_quant, kv_mode=kv_mode, latent_rank=rank)
    rng = np.random.default_rng(seed)
    vals = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(port, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            a = rng.integers(-127, 128, size=tuple(t.shape)).astype(np.int8)
        else:
            a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        a[..., length:, :, :] = 0
        t.copy_(torch.from_numpy(a))
        vals[name] = a
    ref = ref._replace(**{n: jnp.asarray(a) for n, a in vals.items()})
    tmpl = (lambda: KVCache.zeros(cfg, batch=1, max_seq=S, dtype=torch.float32,
                                  kv_quant=kv_quant, kv_mode=kv_mode, latent_rank=rank),
            lambda: JaxKVCache.zeros(jcfg, batch=1, max_seq=S, dtype=jnp.float32,
                                     kv_quant=kv_quant, kv_mode=kv_mode,
                                     latent_rank=rank))
    return port, ref, vals, tmpl


MODES = [(None, "dense"), ("q8_0", "dense"), (None, "latent")]


@pytest.mark.parametrize("kv_quant,kv_mode", MODES)
def test_port_payload_loads_in_the_reference(kv_quant, kv_mode):
    port, _, vals, (_, jtmpl) = _rows(kv_quant, kv_mode)
    ids = list(range(3, 14))
    logits = torch.randn(1, 50, generator=torch.Generator().manual_seed(1)).bfloat16()
    extras = {"tok": np.asarray(7), "recent": np.arange(64),
              "rng": torch.Generator().manual_seed(3).get_state().numpy()}
    label = disagg.kv_mode_label(kv_quant, kv_mode)
    assert label == jdisagg.kv_mode_label(kv_quant, kv_mode)
    data = disagg.save_handoff_bytes(ids, port, len(ids), logits, kv_mode=label,
                                     text="héllo", extras=extras)
    cache, got_ids, got_lg, text = jdisagg.load_handoff_bytes(data, jtmpl(), 32)
    assert got_ids == ids and text == "héllo" and int(cache.length) == len(ids)
    for name, a in vals.items():
        np.testing.assert_array_equal(np.asarray(getattr(cache, name)), a)
    assert got_lg.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got_lg.view(np.uint16),
                                  logits.view(torch.int16).numpy().view(np.uint16))
    got_x = jdisagg.handoff_extras(data)
    assert set(got_x) == set(extras)
    for k in extras:
        np.testing.assert_array_equal(got_x[k], extras[k])
    assert jdisagg.handoff_mode(data) == disagg.handoff_mode(data) == label
    assert disagg.handoff_digest(data) == jdisagg.handoff_digest(data)


@pytest.mark.parametrize("kv_quant,kv_mode", MODES)
def test_reference_payload_loads_in_the_port(kv_quant, kv_mode):
    _, ref, vals, (ptmpl, _) = _rows(kv_quant, kv_mode, seed=1)
    ids = list(range(20, 31))
    logits = np.linspace(-3, 3, 40, dtype=np.float32).astype(ml_dtypes.bfloat16)[None]
    data = jdisagg.save_handoff_bytes(ids, ref, len(ids), jnp.asarray(logits),
                                      kv_mode=jdisagg.kv_mode_label(kv_quant, kv_mode),
                                      extras={"keys": np.asarray([1, 2], np.uint32)})
    cache, got_ids, got_lg, text = disagg.load_handoff_bytes(data, ptmpl(), 32)
    assert got_ids == ids and text is None and cache.length == len(ids)
    for name, a in vals.items():
        np.testing.assert_array_equal(getattr(cache, name).numpy(), a)
    assert got_lg.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_lg.view(torch.int16).numpy().view(np.uint16),
                                  logits.view(np.uint16))
    np.testing.assert_array_equal(disagg.handoff_extras(data)["keys"], [1, 2])
    # f32 logits round-trip as themselves
    f32 = np.arange(6, dtype=np.float32)[None]
    data = jdisagg.save_handoff_bytes(ids, ref, len(ids), f32)
    got = disagg.load_handoff_bytes(data, ptmpl(), 32)[2]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), f32)


@pytest.mark.parametrize("src,dst", [(0, 1), (1, 0), (0, 2), (2, 1)])
def test_mismatched_representation_is_refused_by_both(src, dst):
    port, ref, _, _ = _rows(*MODES[src])
    _, _, _, (ptmpl, jtmpl) = _rows(*MODES[dst])
    ids = list(range(11))
    lg = np.zeros((1, 4), np.float32)
    from_port = disagg.save_handoff_bytes(ids, port, 11, lg)
    from_ref = jdisagg.save_handoff_bytes(ids, ref, 11, lg)
    for data in (from_port, from_ref):
        assert disagg.load_handoff_bytes(data, ptmpl(), 32) is None
        assert jdisagg.load_handoff_bytes(data, jtmpl(), 32) is None
    # a payload longer than the adopting pool's context is refused too
    assert disagg.load_handoff_bytes(from_ref, ptmpl(), 8) is None
    assert jdisagg.load_handoff_bytes(from_port, jtmpl(), 8) is None


# -- the EDF admission queue ------------------------------------------------

def _reqs(mod, gen_cls, seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        gen = gen_cls(priority=str(rng.choice(["interactive", "normal", "batch"])),
                      deadline_ms=(None if rng.random() < 0.4
                                   else float(rng.choice([50, 100, 2000]))))
        req = mod._Request(prompt=f"p{i}", gen=gen, emit=lambda ev: None,
                           abort=threading.Event(),
                           tenant=str(rng.choice(["a", "b", "default"])))
        req.submitted = float(rng.integers(0, 5)) * 0.01
        out.append(req)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_deadline_queue_pops_the_reference_order(seed):
    port_q, ref_q = psched._DeadlineQueue(), jsched._DeadlineQueue()
    port_r = _reqs(psched, GenerationConfig, seed)
    ref_r = _reqs(jsched, JaxGen, seed)
    order_p, order_r = [], []
    for k, (a, b) in enumerate(zip(port_r, ref_r)):
        port_q.put(a)
        ref_q.put(b)
        if k % 7 == 6:   # interleaved pops
            order_p.append(port_q.get_nowait().prompt)
            order_r.append(ref_q.get_nowait().prompt)
        for rank in range(3):
            assert port_q.depth_for(rank) == ref_q.depth_for(rank)
        for t in ("a", "b", "default", "nobody"):
            assert port_q.tenant_depth(t) == ref_q.tenant_depth(t)
    while ref_q.qsize():
        order_p.append(port_q.get_nowait().prompt)
        order_r.append(ref_q.get_nowait().prompt)
    assert order_p == order_r and port_q.qsize() == 0
    assert psched._edf_key(port_r[0]) == jsched._edf_key(ref_r[0])


# -- preemption victims -----------------------------------------------------

def _mkreq(mod, gen_cls, priority="batch", tenant="default", deadline_ms=None,
           submitted=0.0):
    gen = gen_cls(max_new_tokens=4, temperature=0.0, priority=priority,
                  deadline_ms=deadline_ms)
    req = mod._Request(prompt="p", gen=gen, emit=lambda ev: None,
                       abort=threading.Event(), tenant=tenant)
    req.submitted = submitted
    return req


def _mkslot(mod, idx, req, n_gen=2, phase="decode", sampler=None):
    s = mod._Slot(idx, idx, req)
    s.phase = phase
    s.n_gen = n_gen
    s.sampler = sampler
    return s


def _bare(mod, slots, deferred=()):
    """A scheduler skeleton with exactly the state ``_find_victim`` reads."""
    sched = mod.SlotScheduler.__new__(mod.SlotScheduler)
    sched._slots = list(slots)
    sched._pinned_rows = set()
    sched._deferred_rows = lambda: set(deferred)
    return sched


# the reference's cases (its tests/test_preemption.py), each as (slot specs,
# deferred rows); a spec is (priority, tenant, deadline_ms, submitted, n_gen,
# phase, constrained). The port has no published (pinned) rows
VICTIM_CASES = {
    "never_interactive_or_normal": ([("interactive", "default", None, 0.0, 2, "decode", False),
                                     ("normal", "default", None, 0.0, 2, "decode", False)], ()),
    "eligible": ([("batch", "default", None, 0.0, 2, "decode", False)], ()),
    "deferred": ([("batch", "default", None, 0.0, 2, "decode", False)], (0,)),
    "no_token_yet": ([("batch", "default", None, 0.0, 0, "decode", False)], ()),
    "mid_prefill": ([("batch", "default", None, 0.0, 2, "prefill", False)], ()),
    "constrained": ([("batch", "default", None, 0.0, 2, "decode", True)], ()),
    "fair_share": ([("interactive", "a", None, 0.0, 2, "decode", False),
                    ("batch", "a", None, 5.0, 2, "decode", False),
                    ("batch", "b", None, 99.0, 2, "decode", False)], ()),
    "reverse_edf": ([("batch", "a", 1000, 0.0, 2, "decode", False),
                     ("batch", "a", None, 0.0, 2, "decode", False)], ()),
}


@pytest.mark.parametrize("name", sorted(VICTIM_CASES))
def test_victim_choice_matches_the_reference(name):
    specs, deferred = VICTIM_CASES[name]
    picks = []
    for mod, gen_cls in ((psched, GenerationConfig), (jsched, JaxGen)):
        slots = [_mkslot(mod, i, _mkreq(mod, gen_cls, p, t, d, sub), n_gen=g, phase=ph,
                         sampler=object() if c else None)
                 for i, (p, t, d, sub, g, ph, c) in enumerate(specs)]
        v = _bare(mod, slots, deferred)._find_victim()
        picks.append(None if v is None else v.idx)
    assert picks[0] == picks[1]
    assert (picks[0] is not None) == (name in ("eligible", "fair_share", "reverse_edf"))


# -- the serving layer's helpers ------------------------------------------------

@pytest.mark.parametrize("value", [None, "interactive", "normal", "batch", "high", 3, ""])
def test_priority_error_matches(value):
    assert common.priority_error(value) == jcommon.priority_error(value)


@pytest.mark.parametrize("seconds", [0, 0.2, 1, 1.5, 2.0, 59.01])
def test_retry_after_value_matches(seconds):
    assert common.retry_after_value(seconds) == jcommon.retry_after_value(seconds)
    assert common.retry_after_value(seconds).isdigit()
