"""The dense cache's split-KV attention (csrc/flash_attention.cu over
csrc/paged_tile.cuh's DenseKV policy) on the CPU.

- ``flash_attention.dense_plan`` cuts the dense walk into virtual pages of
  ``DENSE_PAGE`` columns with the paged kernel's split plan: every column of
  the cache lies in exactly one run, and the plan depends on shapes only,
  at the shapes the served paths and chip_smoke.py's phase 3 use, for the
  H100's SM count and for one SM.
- A plain mirror of the kernel's algorithm over the dense cache (a partial
  softmax per (row, kv head, query tile, run), merged by log-sum-exp in run
  order) agrees with the JAX package's ``flash_attention`` in Pallas
  interpret mode and with its einsum path: numpy inputs from a seed, f32,
  atol 1e-5 (only the summation order differs). The mirror lives here;
  nothing on the served path runs it.
- The bf16 kernels' P.V takes P as bf16 terms on the tensor cores: a torch
  mirror of the split shows three terms (the dense policy's) carry every
  f32 P of [2^-100, 1] exactly, and two (the paged and latent policies')
  to 2^-16.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from distributed_llm_pipeline_tpu.ops.flash_attention import (
    attention_any as jax_attention_any, flash_attention as jax_flash)
from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa
from distributed_llm_pipeline_tpu_torch.ops import paged_attention as pa

NEG_INF = -1e30
H100_SMS = 132


def geometry(head_dim: int) -> pa.TileGeometry:
    """The split kernel's tiling as csrc/paged_tile.cuh writes it (32 columns
    a staged tile up to head width 128, 16 above; a warp per 128 output
    dims; 4 warps a block). On the card the wrapper reads it from the
    library (``tile_geometry``); here, with no CUDA compiler, from this."""
    return pa.TileGeometry(32 if head_dim <= 128 else 16, max(1, head_dim // 128), 4)


def column_runs(plan: pa.SplitPlan, S: int) -> list[range]:
    """The cache columns of each run, as the kernel walks them."""
    span = plan.pages_per_split * fa.DENSE_PAGE
    return [range(s * span, min(S, (s + 1) * span)) for s in range(plan.splits)]


# (B, T, H, K, S, head_dim) of the dense launches of the served paths and
# phase 3: Llama-3.2-1B (H 32, K 8, Hd 64, S 2048) one-stream decode, a
# T = 512 prefill and per-row decode at B = 4; the ragged S of
# chunk_ragged_tail (2000) and gemma2_window_softcap (5000, H 16, Hd 256);
# llama3-8b (Hd 128); the one-stream latent path (K = 1, n_rep = H) at rank
# 128 (prefill) and 512 (decode)
SERVED_SHAPES = {
    "decode": (1, 1, 32, 8, 2048, 64),
    "prefill_t512": (1, 512, 32, 8, 2048, 64),
    "decode_per_row_b4": (4, 1, 32, 8, 2048, 64),
    "chunk_ragged_tail_s2000": (1, 100, 32, 8, 2000, 64),
    "gemma2_window_softcap_s5000": (1, 128, 16, 8, 5000, 256),
    "llama3_8b_hd128": (1, 256, 32, 8, 4096, 128),
    "mha_n_rep_1": (1, 64, 32, 32, 1024, 64),
    "latent_r128_prefill": (1, 512, 32, 1, 2048, 128),
    "latent_r512_decode": (1, 1, 32, 1, 2048, 512),
}
# the one-stream decode launches: at least one block per SM on the H100
DECODE_SHAPES = ("decode", "decode_per_row_b4", "latent_r512_decode")


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("name", list(SERVED_SHAPES))
def test_dense_plan_covers_every_column_once(name, sms):
    B, T, H, K, S, hd = SERVED_SHAPES[name]
    plan = fa.dense_plan(B, T, H, K, S, geometry(hd), sms)
    runs = column_runs(plan, S)
    assert all(len(r) for r in runs)
    assert [c for r in runs for c in r] == list(range(S))
    rows = T * (H // K)
    assert plan.q_tiles * plan.rows_per_block >= rows > (plan.q_tiles - 1) * plan.rows_per_block
    assert 1 <= plan.warps <= 4
    assert plan.warps == -(-plan.rows_per_block // 16) * geometry(hd).dim_slices
    # a run holds at least one staged tile of columns
    assert plan.pages_per_split * fa.DENSE_PAGE >= geometry(hd).tile_columns
    if name in DECODE_SHAPES and sms == H100_SMS:
        assert plan.q_tiles * plan.splits * B * K >= H100_SMS


@pytest.mark.parametrize("name", list(SERVED_SHAPES))
def test_dense_plan_and_workspace_depend_on_shapes_only(name):
    """The plan's inputs are shapes and the kernel's tiling (never
    ``cache_len``, which a host read would sync the card for), and it is
    the paged plan over ceil(S / DENSE_PAGE) virtual pages."""
    assert list(inspect.signature(fa.dense_plan).parameters) == [
        "B", "T", "H", "K", "S", "geometry", "sm_count"]
    B, T, H, K, S, hd = SERVED_SHAPES[name]
    plan = fa.dense_plan(B, T, H, K, S, geometry(hd), H100_SMS)
    NT = -(-S // fa.DENSE_PAGE)
    assert plan == pa.split_plan.__wrapped__(B, T, H, K, NT, fa.DENSE_PAGE, geometry(hd),
                                             H100_SMS)
    n = pa.workspace_numel(plan, B, T, H, hd)
    assert n == (plan.splits * B * T * H * (hd + 2) if plan.splits > 1 else 0)


def dense_split_mirror(q, k, v, cache_len, n_rep, *, scale, softcap=0.0, window=0,
                       k_scale=None, v_scale=None, sm_count=H100_SMS):
    """The kernel's algorithm over the dense cache in plain torch: for each
    (row, kv head, query tile, run) the columns of the run that the tile
    needs (from the first in its first row's window to the last its last
    row sees causally), one partial softmax (m, l, unnormalised acc) per
    folded query row, an empty run giving m = -1e30, l = 0; then per output
    row the runs merged in run order by log-sum-exp. Int8 codes dequantize
    as code * scale rounded to q's dtype."""
    B, T, H, Hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k_scale is not None:
        k = (k.float() * k_scale).to(q.dtype)
        v = (v.float() * v_scale).to(q.dtype)
    lens = torch.as_tensor(cache_len).reshape(-1).expand(B)
    plan = fa.dense_plan(B, T, H, K, S, geometry(Hd), sm_count)
    rows, runs = T * n_rep, column_runs(plan, S)
    m_all = torch.full((plan.splits, B, T, H), NEG_INF)
    l_all = torch.zeros(plan.splits, B, T, H)
    acc_all = torch.zeros(plan.splits, B, T, H, Hd)
    for b in range(B):
        cl = int(lens[b])
        for kvh in range(K):
            for qt in range(plan.q_tiles):
                q0 = qt * plan.rows_per_block
                q_end = min(q0 + plan.rows_per_block, rows)
                r = torch.arange(q0, q_end)
                t, h = r // n_rep, kvh * n_rep + r % n_rep
                pos = (cl + t)[:, None]
                kv_end = min(S, cl + (q_end - 1) // n_rep + 1)
                kv_begin = max(0, cl + q0 // n_rep - window + 1) if window else 0
                for s, run in enumerate(runs):
                    lo, hi = max(kv_begin, run.start), min(kv_end, run.stop)
                    if lo >= hi:
                        continue
                    c = torch.arange(lo, hi)
                    sc = q[b, t, h].float() @ k[b, c, kvh].float().T * scale
                    if softcap:
                        sc = softcap * torch.tanh(sc / softcap)
                    vis = c[None, :] <= pos
                    if window:
                        vis &= pos - c[None, :] < window
                    sc = torch.where(vis, sc, torch.tensor(NEG_INF))
                    m = sc.amax(-1)
                    p = torch.where(vis, torch.exp(sc - m[:, None]), torch.tensor(0.0))
                    m_all[s, b, t, h] = m
                    l_all[s, b, t, h] = p.sum(-1)
                    acc_all[s, b, t, h] = p @ v[b, c, kvh].float()
    live = l_all > 0
    M = torch.where(live, m_all, torch.tensor(NEG_INF)).amax(0)
    L = torch.zeros(B, T, H)
    acc = torch.zeros(B, T, H, Hd)
    for s in range(plan.splits):
        f = torch.where(live[s], torch.exp(m_all[s] - M), torch.tensor(0.0))
        L = L + f * l_all[s]
        acc = acc + f[..., None] * acc_all[s]
    out = torch.where(L[..., None] > 0, acc / L.clamp_min(1e-30)[..., None], 0.0)
    return out.to(q.dtype), plan


# id: (B, T, S, K, n_rep, Hd, cache_len, options)
CASES = {
    "scalar_len_decode": (1, 1, 300, 2, 4, 64, 200, {}),
    "per_row_len": (3, 4, 260, 2, 2, 64, [0, 100, 255], {}),
    # S = 197 is no multiple of the virtual page: the last run is ragged
    "ragged_s_prefill": (1, 20, 197, 2, 2, 64, 170, {}),
    "window_per_row": (2, 3, 400, 2, 2, 64, [300, 50], dict(window=64)),
    "softcap_explicit_scale_hd256": (1, 2, 300, 1, 2, 256, 250,
                                     dict(window=128, softcap=50.0, scale=0.1)),
    "int8_kv_per_row": (2, 5, 260, 2, 2, 64, [30, 200], dict(quant=True)),
    # the one-stream latent path: K = 1 at head width 512, every head reads it
    "latent_hd512_k1": (1, 1, 260, 1, 8, 512, 250, dict(scale=0.125)),
    # row 0's later runs lie past its causal edge, row 1's first runs
    # wholly before its window
    "runs_past_causal_edge_and_before_window": (2, 1, 1024, 1, 2, 64, [10, 900],
                                                dict(window=40)),
}


def _inputs(case, seed=0):
    B, T, S, K, n_rep, Hd, cache_len, opt = case
    opt = dict(opt)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, K * n_rep, Hd), dtype=np.float32)
    k = rng.standard_normal((B, S, K, Hd), dtype=np.float32)
    v = rng.standard_normal((B, S, K, Hd), dtype=np.float32)
    scales = (None, None)
    if opt.pop("quant", False):   # per-head-vector symmetric int8, as the cache stores it
        def q8(x):
            s = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-12)
            return (np.clip(np.round(x / s), -127, 127).astype(np.int8),
                    s.astype(np.float32))
        (k, ks), (v, vs) = q8(k), q8(v)
        scales = (ks, vs)
    return (q, k, v, np.asarray(cache_len, np.int32)), scales, opt


@pytest.mark.parametrize("name", list(CASES))
def test_dense_split_mirror_matches_jax_flash_interpret_and_einsum(name):
    B, T, S, K, n_rep = CASES[name][:5]
    (q, k, v, cl), (ks, vs), opt = _inputs(CASES[name])
    hd = q.shape[-1]
    scale = opt.get("scale", 0.0)
    jkw = dict(scale=scale, softcap=opt.get("softcap", 0.0), window=opt.get("window", 0),
               k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl), n_rep)
    flash = np.asarray(jax_flash(*jargs, interpret=True, **jkw))
    einsum = np.asarray(jax_attention_any(*jargs, **jkw))
    t = torch.from_numpy
    got, plan = dense_split_mirror(
        t(q), t(k), t(v), t(cl) if cl.ndim else int(cl), n_rep, scale=scale or hd ** -0.5,
        softcap=opt.get("softcap", 0.0), window=opt.get("window", 0),
        k_scale=None if ks is None else t(ks), v_scale=None if vs is None else t(vs))
    assert plan.splits > 1   # the run-order merge is exercised
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), flash, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), einsum, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["runs_past_causal_edge_and_before_window"])
def test_mirror_sees_runs_past_the_causal_edge_and_before_the_window(name):
    """The window/causal case has runs that a block finds empty on each
    side: past row 0's causal edge and wholly before row 1's window."""
    B, T, S, K, n_rep, Hd, lens, opt = CASES[name]
    plan = fa.dense_plan(B, T, K * n_rep, K, S, geometry(Hd), H100_SMS)
    runs = column_runs(plan, S)
    assert [r for r in runs if r.start > lens[0]]
    assert [r for r in runs if r.stop <= lens[1] - opt["window"] + 1]


def _split(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """The kernel's split of f32 P into bf16 terms (split_bf16, split3_bf16):
    each term the bf16 rounding of what the terms before it leave, the
    residual taken in f32 (exactly)."""
    out, r = [], x
    for _ in range(terms):
        t = r.bfloat16()
        out.append(t)
        r = r - t.float()
    return out


@pytest.mark.parametrize("terms", [2, 3])
def test_p_split_into_bf16_terms(terms):
    """Three terms carry every f32 P in [2^-100, 1] exactly (their products
    with a bf16 V are exact on the tensor cores, so P.V is an f32 product
    summed in f32; a P below 2^-100 of the row's largest, 1, is lost in the
    f32 sum anyway, and its last residual would fall below f32's normal
    range); two leave at most 2^-16 of P."""
    g = torch.Generator().manual_seed(terms)
    x = torch.cat([torch.rand(100_000, generator=g),
                   torch.exp(-torch.rand(100_000, generator=g) * 69)])   # exp(s - m)
    parts = _split(x, terms)
    total = sum(t.double() for t in parts)
    err = (total - x.double()).abs() / x.double()
    if terms == 3:
        assert torch.equal(total, x.double())
    else:
        assert err.max().item() <= 2.0 ** -16
        assert (err > 0).any()


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_kernel_wrapper_refuses_a_misaligned_view_before_any_launch(monkeypatch, which):
    """The kernel stages q and the cache with 16-byte cp.async: a contiguous
    view off that grain raises ValueError before the library is touched
    (on the card it would fault and end the CUDA context)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def boom(*a, **k):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(fa, "_kernel", boom)
    shapes = dict(q=(1, 1, 32, 64), k=(1, 256, 8, 64), v=(1, 256, 8, 64))
    t = {n: torch.zeros(shp, dtype=torch.bfloat16) for n, shp in shapes.items()}
    n = t[which].numel()
    t[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shapes[which])
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fa.flash_attention(t["q"], t["k"], t["v"], 100, 4)
