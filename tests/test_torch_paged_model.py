"""The port's paged forward, block allocator and per-row sampler against the
JAX package's.

- ``forward_paged`` / ``forward_paged_last`` / ``forward_paged_mixed`` run on
  identical pools and tables in both packages at f32: logits within atol
  1e-4 (f32 summation order through a few layers, as test_torch_model), and
  the pool blocks the steps wrote are equal within the same tolerance.
- The paged forward equals the port's own dense forward.
- ``BlockAllocator`` is driven by identical seeded random op sequences in
  both packages; tables, refcounts, free lists and copy-on-write pairs stay
  identical.
- ``sample_rows``: greedy rows are exact, and the filtered per-row logits
  have the JAX chain's support and probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PagedKVCache as JaxPagedKVCache
from distributed_llm_pipeline_tpu.models import (forward_paged as jax_forward_paged,
                                                 forward_paged_last as jax_forward_paged_last,
                                                 forward_paged_mixed as jax_forward_paged_mixed)
from distributed_llm_pipeline_tpu.ops import sampling as jax_sampling
from distributed_llm_pipeline_tpu.runtime import paged as jax_paged
from distributed_llm_pipeline_tpu_torch.models import (KVCache, LlamaModel,
                                                       PagedKVCache, params_from_jax)
from distributed_llm_pipeline_tpu_torch.ops import sampling
from distributed_llm_pipeline_tpu_torch.runtime import paged

from .test_torch_model import CONFIGS, _jax_params, _port_cfg

BS, NT, B = 16, 4, 3
N = 1 + B * NT


def _tables(seed=0):
    """Each row maps all NT logical blocks to distinct shuffled physical
    blocks; block 0 stays the sentinel."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, N))
    return perm.reshape(B, NT).astype(np.int32)


def _pools_equal(jcache, tcache):
    # block 0 takes the junk lanes, whose duplicate writes have no order
    for name in ("k", "v", "k_scale", "v_scale"):
        j, t = getattr(jcache, name), getattr(tcache, name)
        if j is None:
            assert t is None
            continue
        np.testing.assert_allclose(t[:, 1:].float().numpy(),
                                   np.asarray(j[:, 1:], np.float32),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("name,kv_quant", [("llama3_tied", None),
                                           ("gemma2", None),
                                           ("llama3_tied", "q8_0")])
def test_paged_forwards_match_jax(name, kv_quant):
    """A per-row prefill bucket, a decode step, then a mixed step in which
    row 0 feeds a 5-token chunk, row 1 decodes and row 2 is parked at
    max_seq with no real lane."""
    cfg = CONFIGS[name]
    params = _jax_params(cfg)
    tcfg = _port_cfg(cfg)
    model = LlamaModel(tcfg, params_from_jax(jax.tree.map(np.asarray, params)))
    tables = _tables()
    jc = JaxPagedKVCache.zeros(cfg, N, BS, B, NT, dtype=jnp.float32,
                               kv_quant=kv_quant)
    jc = jc._replace(tables=jnp.asarray(tables))
    tc = PagedKVCache.zeros(tcfg, N, BS, B, NT, dtype=torch.float32,
                            kv_quant=kv_quant)
    tc.tables = torch.from_numpy(tables)
    rng = np.random.default_rng(5)

    toks = rng.integers(0, cfg.vocab_size, (B, 16))
    jl, jc = jax_forward_paged_last(params, cfg, jnp.asarray(toks, jnp.int32),
                                    jc, jnp.asarray(11, jnp.int32))
    tl = model.forward_paged_last(torch.from_numpy(toks).long(), tc, 11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [16] * B

    step = np.asarray(jl).argmax(-1)[:, None]
    jl, jc = jax_forward_paged(params, cfg, jnp.asarray(step, jnp.int32), jc)
    tl = model.forward_paged(torch.from_numpy(step).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)

    block = rng.integers(0, cfg.vocab_size, (B, 8))
    n_tok = np.asarray([5, 1, 0], np.int32)
    lengths = np.asarray([17, 17, NT * BS], np.int32)
    jc = jc._replace(length=jnp.asarray(lengths))
    tc.length = torch.from_numpy(lengths)
    jl, jc = jax_forward_paged_mixed(params, cfg, jnp.asarray(block, jnp.int32),
                                     jc, jnp.asarray(n_tok))
    tl = model.forward_paged_mixed(torch.from_numpy(block).long(), tc,
                                   torch.from_numpy(n_tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [22, 18, NT * BS]
    _pools_equal(jc, tc)


def test_paged_forward_equals_dense_forward():
    cfg = CONFIGS["qwen3_qk_norm"]
    tcfg = _port_cfg(cfg)
    model = LlamaModel(tcfg, params_from_jax(jax.tree.map(np.asarray,
                                                          _jax_params(cfg))))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 12))
    dense = KVCache.zeros(tcfg, 1, NT * BS, dtype=torch.float32)
    pool = PagedKVCache.zeros(tcfg, N, BS, 1, NT, dtype=torch.float32)
    pool.tables = torch.from_numpy(_tables()[:1])
    t = torch.from_numpy(toks).long()
    want, got = model(t, dense), model.forward_paged(t, pool)
    for _ in range(4):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        t = want[:, -1:].argmax(-1)
        want, got = model(t, dense), model.forward_paged(t, pool)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _alloc_state(al):
    return (al.tables.tolist(), al.ref.tolist(), list(al.free),
            [list(r) for r in al.rows], al.cow_copies, al.used, al.shared)


@pytest.mark.parametrize("seed", range(4))
def test_block_allocator_matches_jax(seed):
    """Admissions (prefix match, attach or release, writable range,
    registration), decode extensions and releases, drawn from a seed over a
    3-token alphabet so prefixes collide often; some prompts repeat an
    earlier one cut to whole blocks, whose full match rewrites a shared
    block (copy-on-write); a small pool so exhaustion happens. Both
    allocators see the same ops and must agree on every result and on
    their whole state."""
    rng = np.random.default_rng(seed)
    bs, n_slots, n_tables, n_blocks = 4, 3, 6, 12
    ours = paged.BlockAllocator(n_blocks, bs, n_slots, n_tables)
    ref = jax_paged.BlockAllocator(n_blocks, bs, n_slots, n_tables)
    pos = [0] * n_slots

    def both(op, *args):
        out = []
        for al in (ours, ref):
            try:
                out.append(("ok", getattr(al, op)(*args)))
            except RuntimeError as e:   # PoolExhausted of either package
                out.append((type(e).__name__, None))
        assert out[0] == out[1], (op, args)
        assert _alloc_state(ours) == _alloc_state(ref)
        return out[0]

    exhausted, seen = 0, []
    for _ in range(300):
        r = int(rng.integers(n_slots))
        op = rng.choice(["admit", "extend", "release"], p=[0.4, 0.45, 0.15])
        if op == "admit":
            ids = [int(t) for t in rng.integers(1, 4, size=rng.integers(1, 18))]
            old = [p for p in seen if len(p) >= bs]
            if old and rng.random() < 0.4:
                ids = old[int(rng.integers(len(old)))]
                ids = ids[:len(ids) // bs * bs]
            seen.append(ids)
            _, match = both("match_prefix", ids)
            k = min(len(match) * bs, len(ids) - 1)
            if k > 0:
                both("attach_shared", r, match)
            else:
                both("release_row", r)
                k = 0
            kind, _ = both("ensure_writable", r, k, len(ids))
            exhausted += kind != "ok"
            if kind == "ok":
                both("register_row", r, ids)
            pos[r] = len(ids) if kind == "ok" else 0
            if kind != "ok":
                both("release_row", r)
        elif op == "extend":
            w = int(rng.integers(1, 6))
            end = min(pos[r] + w, n_tables * bs)
            kind, _ = both("ensure_writable", r, pos[r], end)
            exhausted += kind != "ok"
            if kind == "ok":
                pos[r] = end
        else:
            both("release_row", r)
            pos[r] = 0
    assert exhausted > 0 and ours.cow_copies > 0


def _row_params(B):
    rng = np.random.default_rng(0)
    return (np.asarray([0.8, 0.0, 1.3, 0.5, 1.0][:B], np.float32),   # temperature
            np.asarray([40, 0, 0, 5, 0][:B], np.int64),             # top_k
            np.asarray([0.95, 1.0, 0.9, 1.0, 0.5][:B], np.float32),  # top_p
            np.asarray([0.0, 0.0, 0.1, 0.05, 0.0][:B], np.float32),  # min_p
            rng)


def test_filtered_rows_match_the_jax_chain_per_row():
    B, V = 5, 300
    temp, tk, tp, mp, rng = _row_params(B)
    logits = rng.permutation(np.arange(B * V)).reshape(B, V).astype(np.float32) / 40.0
    got = sampling.filtered_rows(torch.from_numpy(logits), torch.from_numpy(temp),
                                 torch.from_numpy(tk), torch.from_numpy(tp),
                                 torch.from_numpy(mp)).numpy()
    for b in range(B):
        if temp[b] <= 0:
            continue
        want = np.asarray(jax_sampling.filtered_logits(
            jnp.asarray(logits[b]), float(temp[b]), int(tk[b]), float(tp[b]),
            float(mp[b])))
        np.testing.assert_array_equal(np.isneginf(got[b]), np.isneginf(want))
        keep = ~np.isneginf(want)
        np.testing.assert_allclose(np.asarray(jax.nn.softmax(got[b])),
                                   np.asarray(jax.nn.softmax(want)),
                                   rtol=1e-5, atol=1e-7)
        assert keep.sum() >= 1


def test_sample_rows_greedy_rows_and_seeded_rows_stand_alone():
    B, V = 5, 300
    temp, tk, tp, mp, rng = _row_params(B)
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (temp, tk, tp, mp)]

    def gens(rows):
        return [torch.Generator().manual_seed(100 + b) if b in rows else None
                for b in range(B)]

    draws = [sampling.sample_rows(logits, *args, gens(range(B))) for _ in range(3)]
    greedy = logits.argmax(-1)
    for d in draws:
        assert d[1] == greedy[1]     # temperature 0: the argmax, exactly
    # row 0 alone (every co-tenant greedy, no other generator drawing) draws
    # what it drew beside four co-tenants
    alone_args = [a.clone() for a in args]
    alone_args[0][1:] = 0.0
    g_all, g_alone = gens(range(B)), gens({0})
    for _ in range(5):
        a = sampling.sample_rows(logits, *args, g_all)
        b = sampling.sample_rows(logits, *alone_args, g_alone)
        assert a[0] == b[0]
        assert (b[1:] == greedy[1:]).all()
