"""The split-KV algebra of the paged and latent kernels (csrc/paged_tile.cuh)
on the CPU.

- ``split_plan`` covers every page exactly once at the shapes the served
  paths and chip_smoke.py's phase 3 use, and depends on shapes only.
- A plain mirror of the kernel's algorithm (partials per (row, kv head,
  query tile, run of pages), merged by log-sum-exp in run order) agrees with
  the JAX package's ``paged_attention_ref`` and ``latent_attention_ref``:
  numpy inputs from a seed, f32, atol 1e-5 (only the summation order
  differs). The mirror lives here; nothing on the served path runs it.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from distributed_llm_pipeline_tpu.ops.latent_attention import (
    latent_attention_ref as jax_latent_ref)
from distributed_llm_pipeline_tpu.ops.paged_attention import (
    paged_attention_ref as jax_paged_ref)
from distributed_llm_pipeline_tpu_torch.ops import paged_attention as pa

NEG_INF = -1e30
H100_SMS = 132

# (B, T, H, K, NT, bs, head_dim) of every launch the served paths and phase 3
# make at Llama-3.2-1B (H 32, K 8, Hd 64, bs 64, NT 32) and gemma2-9b
# (H 16, K 8, Hd 256, bs 32, NT 160) geometry; K = 1 rows are latent
SERVED_SHAPES = {
    "paged_decode_b4": (4, 1, 32, 8, 32, 64, 64),
    "paged_decode_single_long": (1, 1, 32, 8, 32, 64, 64),
    "paged_mixed_t64": (4, 64, 32, 8, 32, 64, 64),
    "paged_prefill_t512": (1, 512, 32, 8, 32, 64, 64),
    "paged_prefix_suffix_t32": (1, 32, 32, 8, 32, 64, 64),
    "paged_gemma2_decode": (2, 1, 16, 8, 160, 32, 256),
    "paged_block_size_16": (4, 1, 32, 8, 128, 16, 64),
    "latent_r128_decode": (4, 1, 32, 1, 32, 64, 128),
    "latent_r128_decode_single_long": (1, 1, 32, 1, 32, 64, 128),
    "latent_r128_mixed": (4, 64, 32, 1, 32, 64, 128),
    "latent_r512_decode": (4, 1, 32, 1, 32, 64, 512),
    "latent_r512_mixed": (4, 64, 32, 1, 32, 64, 512),
    "latent_gemma2_r512": (2, 1, 16, 1, 160, 32, 512),
}
# the timed decode cases launch at least one block per SM
DECODE_SHAPES = ("paged_decode_b4", "paged_decode_single_long",
                 "latent_r128_decode", "latent_r128_decode_single_long")


def geometry(head_dim: int) -> pa.TileGeometry:
    """The split kernel's tiling as csrc/paged_tile.cuh writes it (32 columns
    a staged tile up to head width 128, 16 above; a warp per 128 output
    dims; 4 warps a block). On the card the wrappers read it from the
    library (``tile_geometry``); here, with no CUDA compiler, from this."""
    return pa.TileGeometry(32 if head_dim <= 128 else 16,
                           max(1, head_dim // 128), 4)


def runs(plan: pa.SplitPlan, NT: int) -> list[range]:
    """The pages of each run, as the kernel takes them."""
    return [range(s * plan.pages_per_split,
                  min(NT, (s + 1) * plan.pages_per_split))
            for s in range(plan.splits)]


@pytest.mark.parametrize("sms", [1, 78, H100_SMS])
@pytest.mark.parametrize("name", list(SERVED_SHAPES))
def test_split_plan_covers_every_page_once(name, sms):
    B, T, H, K, NT, bs, hd = SERVED_SHAPES[name]
    plan = pa.split_plan(B, T, H, K, NT, bs, geometry(hd), sms)
    pages = [p for r in runs(plan, NT) for p in r]
    assert pages == list(range(NT)) and all(len(r) for r in runs(plan, NT))
    assert plan.q_tiles * plan.rows_per_block >= T * (H // K) \
        > (plan.q_tiles - 1) * plan.rows_per_block
    assert 1 <= plan.warps <= 4
    assert plan.warps == -(-plan.rows_per_block // 16) * geometry(hd).dim_slices
    blocks = plan.q_tiles * plan.splits * B * K
    if name in DECODE_SHAPES and sms == H100_SMS:
        assert blocks >= H100_SMS


def test_pages_per_split_handles_more_splits_than_pages_and_one_split():
    assert pa.pages_per_split(5, 9) == (1, 5)
    assert pa.pages_per_split(5, 1) == (5, 1)
    assert pa.pages_per_split(32, 17) == (2, 16)
    assert pa.pages_per_split(7, 0) == (7, 1)
    for nt in range(1, 40):
        for want in range(1, 50):
            pps, n = pa.pages_per_split(nt, want)
            assert n <= min(nt, want) and (n - 1) * pps < nt <= n * pps


def test_one_run_needs_no_workspace():
    plan = pa.split_plan(4, 64, 32, 1, 32, 64, geometry(512), H100_SMS)
    assert plan.splits == 1
    assert pa.workspace_numel(plan, 4, 64, 32, 512) == 0
    plan = pa.split_plan(4, 1, 32, 8, 32, 64, geometry(64), H100_SMS)
    assert pa.workspace_numel(plan, 4, 1, 32, 64) == plan.splits * 4 * 32 * 66


def test_plan_and_workspace_depend_on_shapes_only(monkeypatch):
    """The plan's inputs are shapes and the kernel's tiling; planning a
    launch reads no tensor's values (meta tensors have none) and gives the
    same plan and workspace for any lengths and tables."""
    assert list(inspect.signature(pa.split_plan).parameters) == [
        "B", "T", "H", "K", "NT", "bs", "geometry", "sm_count"]
    monkeypatch.setattr(pa, "sm_count", lambda index: H100_SMS)
    q = torch.empty(4, 1, 32, 64, device="meta")
    tables = torch.empty(4, 32, dtype=torch.int32, device="meta")
    plan, ws = pa.plan_launch(q, tables, 64, 8, geometry(64))
    assert plan == pa.split_plan(4, 1, 32, 8, 32, 64, geometry(64), H100_SMS)
    assert ws.device.type == "meta" and ws.dtype == torch.float32
    assert ws.numel() == pa.workspace_numel(plan, 4, 1, 32, 64)
    for seed in range(2):
        rng = np.random.default_rng(seed)
        t = torch.from_numpy(rng.integers(0, 99, (4, 32), dtype=np.int32))
        qc = torch.zeros(4, 1, 32, 64)
        got, ws_c = pa.plan_launch(qc, t, 64, 8, geometry(64))
        assert got == plan and ws_c.numel() == ws.numel()


def split_mirror(q, kp, vp, tables, lengths, n_rep, *, scale, softcap=0.0,
                 window=0, k_scale=None, v_scale=None, sm_count=H100_SMS):
    """The kernel's algorithm in plain torch: for each (row, kv head, query
    tile, run) the columns inside the run that the tile needs, one partial
    softmax (m, l, unnormalised acc) per folded query row, an empty run
    giving m = -1e30, l = 0; then per output row the runs merged in run
    order by log-sum-exp. K/V int8 codes dequantize as code * scale rounded
    to q's dtype."""
    B, T, H, Hd = q.shape
    bs, K = kp.shape[1], kp.shape[2]
    NT = tables.shape[1]
    if k_scale is not None:
        kp = (kp.float() * k_scale).to(q.dtype)
        vp = (vp.float() * v_scale).to(q.dtype)
    plan = pa.split_plan(B, T, H, K, NT, bs, geometry(Hd), sm_count)
    rows, S, pps = T * n_rep, NT * bs, plan.pages_per_split
    m_all = torch.full((plan.splits, B, T, H), NEG_INF)
    l_all = torch.zeros(plan.splits, B, T, H)
    acc_all = torch.zeros(plan.splits, B, T, H, Hd)
    for b in range(B):
        cl = int(lengths[b])
        for kvh in range(K):
            for qt in range(plan.q_tiles):
                q0 = qt * plan.rows_per_block
                q_end = min(q0 + plan.rows_per_block, rows)
                r = torch.arange(q0, q_end)
                t, h = r // n_rep, kvh * n_rep + r % n_rep
                pos = (cl + t)[:, None]
                kv_end = min(S, cl + (q_end - 1) // n_rep + 1)
                kv_begin = max(0, cl + q0 // n_rep - window + 1) if window else 0
                for s in range(plan.splits):
                    lo = max(kv_begin, s * pps * bs)
                    hi = min(kv_end, min(NT, (s + 1) * pps) * bs)
                    if lo >= hi:
                        continue
                    c = torch.arange(lo, hi)
                    blk = tables[b, c // bs].long()
                    k = kp[blk, c % bs, kvh].float()
                    v = vp[blk, c % bs, kvh].float()
                    sc = q[b, t, h].float() @ k.T * scale
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
                    acc_all[s, b, t, h] = p @ v
    live = l_all > 0
    M = torch.where(live, m_all, torch.tensor(NEG_INF)).amax(0)
    L = torch.zeros(B, T, H)
    acc = torch.zeros(B, T, H, Hd)
    for s in range(plan.splits):
        f = torch.where(live[s], torch.exp(m_all[s] - M), torch.tensor(0.0))
        L = L + f * l_all[s]
        acc = acc + f[..., None] * acc_all[s]
    return (acc / L[..., None]).to(q.dtype), plan


# id: (B, T, H, K, Hd, bs, NT, lengths, options); latent cases have K = 1,
# H = n_rep and Hd = r
CASES = {
    "paged_t1_per_row": (3, 1, 4, 2, 64, 32, 8, [100, 5, 250], {}),
    "paged_t64_per_row": (2, 64, 4, 2, 64, 32, 8, [40, 170], {}),
    # row 0's later runs lie past its causal edge, row 1's first runs
    # wholly before its window
    "paged_empty_runs_causal_and_window": (2, 1, 4, 2, 64, 16, 16, [10, 200],
                                           dict(window=40)),
    "paged_parked_row_at_max_seq": (3, 2, 4, 2, 64, 32, 6, [30, 0, 150],
                                    dict(parked=1)),
    "paged_shared_prefix": (3, 3, 4, 2, 64, 16, 8, [70, 90, 20], dict(shared=3)),
    "paged_block_size_16": (2, 4, 4, 2, 64, 16, 8, [60, 100], {}),
    # gemma2-9b's geometry at narrow width: window 4096, softcap 50, Hd 256
    "paged_gemma2_window_4096_softcap_50": (2, 1, 2, 1, 256, 32, 160, [4500, 300],
                                            dict(window=4096, softcap=50.0,
                                                 scale=256 ** -0.5)),
    "paged_int8_pools": (2, 5, 4, 2, 64, 32, 6, [33, 120], dict(quant=True)),
    "paged_int8_t64_window": (2, 64, 4, 2, 64, 32, 8, [60, 150],
                              dict(quant=True, window=48)),
    "latent_r128_t1": (2, 1, 4, 1, 128, 32, 8, [100, 250], dict(scale=0.125)),
    "latent_r128_t64_int8": (2, 64, 4, 1, 128, 32, 8, [40, 180],
                             dict(scale=0.125, quant=True)),
    "latent_r512_t1": (2, 1, 4, 1, 512, 32, 8, [100, 250], dict(scale=0.125)),
    "latent_r512_t64_parked": (2, 64, 2, 1, 512, 32, 6, [70, 0],
                               dict(scale=0.125, parked=1)),
}


def _inputs(case, seed=0):
    """numpy q, pools, tables, lengths (and int8 codes + scales) for a case:
    each row's needed pages map to distinct physical blocks in shuffled
    order, the rest of its table 0 (the sentinel); ``shared`` makes rows 0
    and 1 name the same first blocks; ``parked`` sets that row's length to
    NT * bs (a free slot) and maps nothing."""
    B, T, H, K, Hd, bs, NT, lengths, opt = case
    opt = dict(opt)
    rng = np.random.default_rng(seed)
    lengths = list(lengths)
    parked = opt.pop("parked", None)
    if parked is not None:
        lengths[parked] = NT * bs
    need = [0 if b == parked else min(NT, -(-(lengths[b] + T) // bs))
            for b in range(B)]
    N = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, NT), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = free.pop()
    if "shared" in opt:
        n = opt.pop("shared")
        tables[1, :n] = tables[0, :n]
    q = rng.standard_normal((B, T, H, Hd), dtype=np.float32)
    kp = rng.standard_normal((N, bs, K, Hd), dtype=np.float32)
    vp = rng.standard_normal((N, bs, K, Hd), dtype=np.float32)
    scales = (None, None)
    if opt.pop("quant", False):   # per-vector symmetric int8
        def q8(x):
            s = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-12)
            return (np.clip(np.round(x / s), -127, 127).astype(np.int8),
                    s.astype(np.float32))
        (kp, ks), (vp, vs) = q8(kp), q8(vp)
        scales = (ks, vs)
    return (q, kp, vp, tables, np.asarray(lengths, np.int32)), scales, opt


@pytest.mark.parametrize("name", list(CASES))
def test_split_mirror_matches_the_jax_reference(name):
    B, T, H, K = CASES[name][:4]
    (q, kp, vp, tables, lengths), (ks, vs), opt = _inputs(CASES[name])
    n_rep = H // K
    latent = name.startswith("latent")
    hd = q.shape[-1]
    kw = dict(softcap=opt.get("softcap", 0.0), window=opt.get("window", 0))
    scale = opt.get("scale", 0.0)
    ref_fn = jax_latent_ref if latent else jax_paged_ref
    ref = np.asarray(ref_fn(*(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
                            n_rep, scale=scale, **kw,
                            k_scale=None if ks is None else jnp.asarray(ks),
                            v_scale=None if vs is None else jnp.asarray(vs)))
    t = torch.from_numpy
    got, plan = split_mirror(t(q), t(kp), t(vp), t(tables), t(lengths), n_rep,
                             scale=scale or hd ** -0.5, **kw,
                             k_scale=None if ks is None else t(ks),
                             v_scale=None if vs is None else t(vs))
    assert plan.splits > 1   # the merge is exercised
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_split_mirror_sees_empty_runs():
    """The window/causal case has runs that some block finds empty on each
    side: past row 0's causal edge and wholly before row 1's window."""
    B, T, H, K, Hd, bs, NT, lengths, opt = CASES["paged_empty_runs_causal_and_window"]
    plan = pa.split_plan(B, T, H, K, NT, bs, geometry(Hd), H100_SMS)
    spans = [(r.start * bs, r.stop * bs) for r in runs(plan, NT)]
    past_edge = [s for s in spans if s[0] > lengths[0]]
    before_window = [s for s in spans if s[1] <= lengths[1] - opt["window"] + 1]
    assert past_edge and before_window


def test_misaligned_view_raises():
    """The kernels stage q and the pools with 16-byte cp.async: a contiguous
    view off that grain is refused before any launch."""
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    pa.check_aligned("paged_flash_attention", base[:256].view(4, 64))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        pa.check_aligned("paged_flash_attention", base[1:257].view(4, 64))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        pa.check_aligned("latent_flash_attention", base[:256], base[4:260])
