"""The fused decode kernel's cut and order of operations (csrc/fused_decode.cu)
on the CPU.

- ``fused_plan`` covers every Q/K/V row of a head, every visible key of every
  row and every output column exactly once over a cluster's CTAs, at the
  served geometries (Llama-3.2-1B, llama3-8b), head dims 128 and 256, B 1 to
  16, K 1, 2, 8 and 32, ragged lengths and windows; it depends on shapes
  only, and its shared memory is the sum of ``fused_layout``, whose arrays
  live at once never overlap. The largest batch that fuses at the presets
  is at least the one-block-a-head kernel's, at either activation dtype and
  pool kind.
- A plain mirror of the kernel's order (each row's dot as its 256-column
  units added in column order; per CTA an online-softmax partial over its
  key run, tile by tile; the CTAs' partials merged in CTA order with the
  diagonal term added in the merge; each head's O-projection partial, summed
  in head order) agrees with the JAX package's ``fused_decode_ref`` at f32:
  numpy inputs from a seed, atol 2e-5 on y (only summation orders differ;
  the composition test of tests/test_torch_fused_decode.py holds the same
  bound), 4e-6 on the new K/V (a projection's 512-term f32 dot in another
  order than XLA's; with q8_0 weights up to 1.1e-6 on these inputs), the
  int8 codes of the new K/V equal. The mirror lives here; nothing on the
  served path runs it.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS as JAX_PRESETS
from distributed_llm_pipeline_tpu.models import random_params
from distributed_llm_pipeline_tpu.models.llama import kv_quantize as jax_kv_quantize
from distributed_llm_pipeline_tpu.models.llama import quantize_params as jax_quantize_params
from distributed_llm_pipeline_tpu.models.llama import rope_freqs as jax_rope_freqs
from distributed_llm_pipeline_tpu.ops import fused_decode as jax_fd
from distributed_llm_pipeline_tpu_torch.models import LlamaModel, ModelConfig, params_from_jax
from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd

NEG_INF = -1e30

# (D, H, K, Hd) of the geometries the plan is held at
GEOMETRIES = {
    "llama3.2-1b": (2048, 32, 8, 64),
    "llama3-8b": (4096, 32, 8, 128),
    "hd256": (3584, 16, 8, 256),
    "k1_hd128": (2048, 16, 1, 128),
    "k2_hd128": (1024, 8, 2, 128),
    "k32_mha": (4096, 32, 32, 128),
}
# (lengths, window, positions in the pool) of a batch of rows; each case
# uses the first B lengths, cycled
LENGTH_CASES = [([512] * 16, 0, 2048),
                ([5, 37, 100, 1000, 0, 1, 31, 33, 64, 65, 700, 2047, 2048, 3000, 17, 256],
                 0, 2048),
                ([512, 300, 700, 1000, 1, 383, 384, 385, 2048, 9, 33, 0, 64, 1500, 95, 2],
                 384, 2048)]


def cta_rows(plan: fd.FusedPlan, total: int, per: int, c: int) -> range:
    return range(min(total, c * per), min(total, (c + 1) * per))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["act_pool", "int8_pool"])
@pytest.mark.parametrize("w_q8", [False, True], ids=["dense_w", "q8_0_w"])
@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fused_plan_covers_rows_keys_and_columns_once(name, B, w_q8, kv_int8):
    D, H, K, Hd = GEOMETRIES[name]
    R = H // K
    nq = R * Hd + 2 * Hd
    try:
        plan = fd.fused_plan(B, D, H, K, Hd, 2, w_q8, kv_int8)
    except ValueError:
        # where no cut fits, the engine is told so and decodes unfused
        cfg = ModelConfig(dim=D, n_heads=H, n_kv_heads=K, head_dim=Hd)
        assert fd.fused_supported(cfg, batch=B, weight_kind="q8_0" if w_q8 else None,
                                  kv_int8=kv_int8).startswith("vmem:")
        assert (name, B) in (("hd256", 16), ("llama3-8b", 16)) or B == 16
        return
    C = plan.cluster
    assert plan.ctas == K * C and C & (C - 1) == 0 and C <= fd.FUSED_CLUSTER
    assert C * K <= fd.H100_SMS or C == 1
    # Q/K/V rows: each CTA's run in ring tiles cut at the wq | wk | wv edges
    rows, per_cta_chunks = [], []
    for c in range(C):
        r = cta_rows(plan, nq, plan.qkv_rows, c)
        tiles = fd.qkv_tiles(r.start, r.stop, R * Hd, Hd, plan.qkv_tile)
        for a, n in tiles:
            assert 1 <= n <= plan.qkv_tile
            edge = next(e for e in (R * Hd, R * Hd + Hd, nq) if a < e)
            assert a + n <= edge   # one projection a tile
            rows += range(a, a + n)
        per_cta_chunks.append(len(tiles))
    assert rows == list(range(nq))
    # output columns: each CTA a slice of wo's rows, the same of y
    cols = [n for c in range(C) for n in cta_rows(plan, D, plan.out_rows, c)]
    assert cols == list(range(D))
    assert 1 <= plan.stages <= min(fd.MAX_STAGES, max(per_cta_chunks))
    # shared memory: the layout's sum, within the limit; a stage holds a tile
    lay = fd.fused_layout(B, D, R, Hd, 2, w_q8, kv_int8, plan)
    assert plan.smem == lay["total"] <= fd.SMEM_LIMIT_BYTES
    assert plan.smem == fd.fused_smem_bytes(B, D, Hd, R, 2, n_kv_heads=K, w_q8=w_q8,
                                            kv_int8=kv_int8)
    assert plan.stage_bytes % 16 == 0
    assert plan.stage_bytes >= lay["qkv_need"]
    # a stage's rows 16 bytes past their length apart (a fragment's 8 rows in
    # distinct banks), then a q8_0 tile's scales
    assert lay["qkv_need"] >= plan.qkv_tile * (D * (1 if w_q8 else 2) + 16)
    # keys: every visible key of every row once, in tiles of at most 32
    assert 1 <= plan.kv_round <= min(B, fd.MAX_KV_ROUND) and plan.kv_buffers in (1, 2)
    for lengths, window, max_pos in LENGTH_CASES:
        lens = [lengths[b % len(lengths)] for b in range(B)]
        seen = [[] for _ in range(B)]
        for c in range(C):
            runs = [fd.key_run(*fd.visible(n, window, max_pos), c, C) for n in lens]
            for rnd in fd.key_tiles(runs, plan.kv_round):
                assert 1 <= len(rnd) <= plan.kv_round
                for b, k0, nk in rnd:
                    assert 1 <= nk <= fd.KEY_TILE and runs[b][0] <= k0 and k0 + nk <= runs[b][1]
                    seen[b] += range(k0, k0 + nk)
        for b, n in enumerate(lens):
            lo, end = fd.visible(n, window, max_pos)
            assert seen[b] == list(range(lo, max(lo, end)))


def test_fused_plan_depends_on_shapes_only():
    """The plan's inputs are shapes and dtypes' widths: the wrapper plans a
    launch before reading a value, and the same shapes give the same plan."""
    assert list(inspect.signature(fd.fused_plan).parameters) == [
        "batch", "dim", "n_heads", "n_kv_heads", "head_dim", "act_bytes", "w_q8",
        "kv_int8"]
    a = fd.fused_plan(4, 2048, 32, 8, 64)
    fd.fused_plan.cache_clear()
    assert fd.fused_plan(4, 2048, 32, 8, 64) == a
    # up to 16 kv heads: 8 CTAs a head (the H100 holds 15 clusters of 8 at
    # once, 7 of 16); more kv heads than 132 / 8: a smaller cluster, one
    # wave of CTAs
    assert (a.cluster, a.ctas, a.late_keys) == (8, 64, 0)
    for K, C in ((16, 8), (32, 4), (64, 2), (128, 1)):
        assert fd.fused_plan(1, 8192, 128, K, 64).cluster == C


def test_fused_layout_widens_misaligned_scale_runs():
    """A q8_0 tile's run of scales that is no multiple of 16 bytes (D % 256
    != 0) gets a 16-byte grain of room for its widened copy; one that is
    (D % 256 == 0) and dense weights need none."""
    plan = fd.fused_plan(4, 2080, 12, 2, 64, 2, True, False)   # D/16 = 130 bytes a row
    lay = fd.fused_layout(4, 2080, 6, 64, 2, True, False, plan)
    assert lay["qkv_need"] == lay["qkv_sc"] + fd._a16(plan.qkv_tile * 130) + 16
    plan = fd.fused_plan(4, 2048, 32, 8, 64, 2, True)   # D/16 = 128 bytes a row
    q8 = fd.fused_layout(4, 2048, 4, 64, 2, True, False, plan)
    assert q8["qkv_need"] == q8["qkv_sc"] + plan.qkv_tile * 128
    dense = fd.fused_layout(4, 2048, 4, 64, 2, False, False, fd.fused_plan(4, 2048, 32, 8, 64))
    assert dense["qkv_need"] == dense["qkv_sc"]


def _spans(B, D, R, Hd, ab, w_q8, kv_int8, plan):
    """Each array of fused_layout as [start, end), and the arrays live at
    once in each step of the kernel: the norm and the Q/K/V tiles, RoPE,
    then attention, the merge and the O-projection. The key tiles are in
    flight from the norm on, or with late_keys from after RoPE."""
    lay = fd.fused_layout(B, D, R, Hd, ab, w_q8, kv_int8, plan)
    a16, pad, rhd = fd._a16, 8 if ab == 2 else 0, R * Hd
    sizes = {"runs": a16(2 * B * 4), "h": a16(B * (D + pad) * ab), "qr": a16(B * rhd * ab),
             "kd": a16(B * Hd * 4), "vd": a16(B * Hd * 4), "prod": a16(B * (rhd + 2 * Hd) * 4),
             "at": a16(B * (rhd + pad) * ab), "pm": a16(B * R * 4), "pl": a16(B * R * 4),
             "pacc": a16(B * R * Hd * 4), "red": 2 * lay["red_stage"],
             "items": a16(plan.kv_buffers * plan.kv_round * 12),
             "vecs": plan.kv_buffers * plan.kv_round * fd.KEY_TILE * 4,
             "kv": plan.kv_buffers * plan.kv_round * lay["slot"],
             "kvc": plan.kv_round * lay["cslot"], "ring": plan.stages * plan.stage_bytes,
             "bars": a16(8 * plan.stages), "flag": 16 + 4 * 16}
    span = {k: (lay[k], lay[k] + n) for k, n in sizes.items()}
    keys = ("items", "vecs", "kv", "kvc")
    early = () if plan.late_keys else keys
    steps = [("runs", "h", "prod", "red", "ring", "bars", "flag") + early,
             ("runs", "prod", "qr", "kd", "vd", "bars", "flag") + early,
             ("runs", "qr", "kd", "vd", "at", "pm", "pl", "pacc", "bars", "flag") + keys]
    return lay, span, steps


@pytest.mark.parametrize("seed", range(4))
def test_fused_layout_keeps_live_arrays_apart(seed):
    """Arrays live at once never share a byte, and every array lies within
    the total: at the served plans and at random cuts, with the key tiles
    before the ring or in its place (late_keys)."""
    rng = np.random.default_rng(seed)
    cases = [((B, 2048, 32, 8, 64, ab, w, kv), None) for B in (1, 4, 20, 22, 39)
             for ab, w in ((2, False), (2, True), (4, False)) for kv in (False, True)]
    for _ in range(150):
        B, D = int(rng.choice([1, 3, 4, 9, 16, 33])), int(rng.choice([512, 2048, 2080, 4096]))
        R, Hd, ab = int(rng.choice([1, 4, 8, 64])), int(rng.choice([8, 64, 128, 256])), \
            int(rng.choice([2, 4]))
        plan = fd.FusedPlan(8, 64, int(rng.integers(1, 600)), int(rng.integers(1, 600)),
                            int(rng.choice([1, 2, 16])), int(rng.integers(1, 9)),
                            16 * int(rng.integers(1, 4000)), int(rng.integers(1, 9)),
                            int(rng.integers(1, 3)), int(rng.integers(0, 2)), 0)
        cases.append(((B, D, R * 8, 8, Hd, ab, ab == 2 and bool(rng.integers(0, 2)),
                       bool(rng.integers(0, 2))), plan))
    for (B, D, H, K, Hd, ab, w, kv), plan in cases:
        if plan is None:
            try:
                plan = fd.fused_plan(B, D, H, K, Hd, ab, w, kv)
            except ValueError:
                continue
        lay, span, steps = _spans(B, D, H // K, Hd, ab, w, kv, plan)
        assert all(0 <= a <= e <= lay["total"] for a, e in span.values())
        for live in steps:
            got = sorted(span[k] + (k,) for k in live if span[k][1] > span[k][0])
            for (a0, e0, n0), (a1, e1, n1) in zip(got, got[1:]):
                assert e0 <= a1, f"{n0} and {n1} overlap: {plan}"


# PR 6's one-block-a-head kernel's shared memory (16 warps, 4 tasks each):
# the normalized x and the attention output in the activation dtype, the
# rounded q, the diagonal K/V and the partials in f32
def _one_block_smem(B, D, Hd, R, ab):
    a16 = fd._a16
    return (a16(B * D * ab) + a16(B * R * Hd * 4) + 2 * a16(B * Hd * 4)
            + a16(B * R * Hd * ab) + 2 * a16(16 * 4 * 4) + a16(16 * 4 * Hd * 4) + 16)


@pytest.mark.parametrize("preset", ["llama3.2-1b", "llama3-8b", "llama3-70b", "llama2-7b",
                                    "mixtral-8x7b"])
def test_every_batch_the_one_block_kernel_fused_still_fuses(preset):
    """At each preset, activation dtype, weight kind and pool kind, every B
    that fit the one-block kernel's shared memory fuses (f32 Llama-3.2-1B up
    to 20 rows, llama3-8b 9, llama3-70b 4)."""
    from distributed_llm_pipeline_tpu_torch.models import PRESETS

    cfg = PRESETS[preset]
    R = cfg.n_heads // cfg.n_kv_heads
    for ab, w in ((2, None), (2, "q8_0"), (4, None)):
        old = [B for B in range(1, 65)
               if _one_block_smem(B, cfg.dim, cfg.head_dim, R, ab) <= fd.SMEM_LIMIT_BYTES]
        assert old, preset
        for kv_int8 in (False, True):
            for B in old:
                assert fd.fused_supported(cfg, weight_kind=w, batch=B, act_bytes=ab,
                                          kv_int8=kv_int8) is None, (preset, ab, w, kv_int8, B)
    limits = {"llama3.2-1b": 20, "llama3-8b": 9, "llama3-70b": 4}
    if preset in limits:
        assert max(B for B in range(1, 65) if _one_block_smem(
            B, cfg.dim, cfg.head_dim, R, 4) <= fd.SMEM_LIMIT_BYTES) == limits[preset]


# (D, Hd, H, K, f32 activations, int8 pools): the geometries of the grid
# below where the largest batch that fuses is one row short of the one-block
# kernel's (MQA in f32: the partials of all R heads a row beside the products)
ONE_ROW_SHORT = {(512, 64, 8, 1, True, True), (2048, 256, 8, 1, True, True),
                 (3072, 256, 12, 1, True, True), (4096, 256, 16, 1, True, True),
                 (8192, 128, 64, 1, True, False), (8192, 128, 64, 1, True, True)}


@pytest.mark.parametrize("D", [512, 1024, 2048, 3072, 4096, 5120, 8192])
def test_every_batch_the_one_block_kernel_fused_fuses_at_the_grid(D):
    """Geometries with H·Hd = D, Hd 64 to 256, H 8 to 64, K 1 to 64: each B
    up to 64 that fit the one-block kernel fuses, bf16 (dense or q8_0
    weights) or f32, either pool kind, but at ONE_ROW_SHORT's largest B."""
    cfg0 = ModelConfig(dim=D)
    short = set()
    for Hd in (64, 80, 96, 128, 256):
        if D % Hd or not 8 <= D // Hd <= 64:
            continue
        H = D // Hd
        for K in (k for k in (1, 2, 4, 8, 16, 32, 64) if k <= H and H % k == 0):
            cfg = dataclasses.replace(cfg0, n_heads=H, n_kv_heads=K, head_dim=Hd)
            for ab, w in ((2, None), (2, "q8_0"), (4, None)):
                if w and (H // K * Hd) % fd.QBLOCK:
                    continue   # q8_0-align, as before
                old = [B for B in range(1, 65) if _one_block_smem(
                    B, D, Hd, H // K, ab) <= fd.SMEM_LIMIT_BYTES]
                for kv_int8 in (False, True):
                    new = [B for B in old if fd.fused_supported(
                        cfg, weight_kind=w, batch=B, act_bytes=ab, kv_int8=kv_int8) is None]
                    if new != old:
                        assert new == old[:-1], (D, Hd, H, K, ab, w, kv_int8)
                        short.add((D, Hd, H, K, ab == 4, kv_int8))
    assert short == {c for c in ONE_ROW_SHORT if c[0] == D}


# ---------------------------------------------------------------------------
# the mirror of the kernel's order against the JAX reference

BS, NT = 16, 8
LENGTHS = [5, 37, 100]   # mid-block, straddling a block edge, long
BASE = JAX_PRESETS["tiny"].replace(dim=512, n_heads=8, n_kv_heads=2, head_dim=32,
                                   max_seq_len=BS * NT)


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _setup(w_q8, kv_int8, window, softcap, rope_style, seed=0):
    """One layer's inputs in both packages: the reference's layer params and
    pools (bf16-valued f32 pools, or int8 codes and scales), and the port's
    block (layer 0 of a model over the same weights)."""
    cfg = BASE.replace(sliding_window=16 if window else 0,
                       attn_softcap=30.0 if softcap else 0.0, rope_style=rope_style)
    params = random_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if w_q8:
        params = jax_quantize_params(params, cfg, "q8_0")
    lp = {k: ({f: a[0] for f, a in v.items()} if isinstance(v, dict) else v[0])
          for k, v in params["layers"].items()}
    rng = np.random.default_rng(seed)
    B, K, Hd = len(LENGTHS), cfg.n_kv_heads, cfg.head_dim
    pools = [rng.standard_normal((B * NT + 1, BS, K, Hd)).astype(np.float32) for _ in "kv"]
    ks = vs = None
    if kv_int8:
        (kp, ks), (vp, vs) = (tuple(np.asarray(a) for a in jax_kv_quantize(jnp.asarray(p)))
                              for p in pools)
    else:   # values a bf16 pool holds
        kp, vp = (torch.from_numpy(p).bfloat16().float().numpy() for p in pools)
    tables = rng.permutation(B * NT).astype(np.int32).reshape(B, NT) + 1
    lengths = np.asarray(LENGTHS, np.int32)
    x = rng.standard_normal((B, 1, cfg.dim)).astype(np.float32)
    cos, sin = (np.asarray(t) for t in jax_rope_freqs(cfg, jnp.asarray(lengths)[:, None]))
    ref = dict(cfg=cfg, lp=lp, kp=kp, vp=vp, ks=ks, vs=vs, tables=tables,
               lengths=lengths, x=x, cos=cos, sin=sin)
    model = LlamaModel(_port_cfg(cfg), params_from_jax(jax.tree.map(np.asarray, params)))
    return ref, model.layers[0]


def _dense(block, name):
    w = block._modules[name] if name in block._modules else block._parameters[name]
    return w.dequant(torch.float32) if hasattr(w, "dequant") else w.float()


def _units_dot(w: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
    """acts [B, L] against rows w [n, L] as the kernel sums them: each
    256-column unit's dot in f32, the units added in column order."""
    out = None
    for c0 in range(0, w.shape[1], 256):
        part = acts[:, c0:c0 + 256] @ w[:, c0:c0 + 256].T
        out = part if out is None else out + part
    return out


def _rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, half: bool) -> torch.Tensor:
    """RoPE of [B, n, Hd] at [B, Hd/2] angles, the kernel's pairs."""
    h = t.shape[-1] // 2
    i0 = torch.arange(h) if half else 2 * torch.arange(h)
    i1 = i0 + h if half else i0 + 1
    t0, t1 = t[..., i0], t[..., i1]
    c, s = cos[:, None], sin[:, None]
    out = t.clone()
    out[..., i0] = t0 * c - t1 * s
    out[..., i1] = t0 * s + t1 * c
    return out


def fused_mirror(x, block, cos, sin, kp, vp, tables, lengths, *, k_scale=None,
                 v_scale=None, plan: fd.FusedPlan):
    """The kernel's algorithm in plain torch at f32 (where every rounding to
    the activation dtype is exact): returns (y, k_new, v_new) and reads the
    pools as they were (the diagonal term stands for the new token)."""
    cfg = block.cfg
    B, D = x.shape
    H, K, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    R = H // K
    rhd, nq = R * Hd, R * Hd + 2 * Hd
    C = plan.cluster
    scale = cfg.attn_scale or Hd ** -0.5
    softcap, window = cfg.attn_softcap or 0.0, block.window
    S = tables.shape[1] * kp.shape[1]
    w = {n: _dense(block, n) for n in ("wq", "wk", "wv", "wo")}
    norm_w = block._parameters["attn_norm"].float()
    h = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps) * norm_w
    ys = []
    k_new = torch.zeros(B, K, Hd)
    v_new = torch.zeros(B, K, Hd)
    for g in range(K):
        # 2. each CTA's tiles of the head's Q/K/V rows
        heads = torch.cat([w["wq"][g * rhd:(g + 1) * rhd], w["wk"][g * Hd:(g + 1) * Hd],
                           w["wv"][g * Hd:(g + 1) * Hd]])
        prod = torch.zeros(B, nq)
        for c in range(C):
            r = cta_rows(plan, nq, plan.qkv_rows, c)
            for a, n in fd.qkv_tiles(r.start, r.stop, rhd, Hd, plan.qkv_tile):
                prod[:, a:a + n] = _units_dot(heads[a:a + n], h)
        # 3. RoPE over the gathered head
        half = cfg.rope_style == "half"
        q = _rope(prod[:, :rhd].reshape(B, R, Hd), cos, sin, half)
        kd = _rope(prod[:, None, rhd:rhd + Hd], cos, sin, half)[:, 0]
        vd = prod[:, rhd + Hd:].clone()
        k_new[:, g], v_new[:, g] = kd, vd
        if k_scale is not None:   # the diagonal as the int8 pool write stores it
            for t in (kd, vd):
                s = torch.clamp(t.abs().amax(-1, keepdim=True) * np.float32(1 / 127), min=1e-12)
                t.copy_(torch.clamp(torch.round(t / s), -127, 127) * s)
        # 4. per CTA and row: an online-softmax partial over its key run
        att = torch.zeros(B, R, Hd)
        for b in range(B):
            lo, end = fd.visible(int(lengths[b]), window, S)
            parts = []
            for c in range(C):
                m = torch.full((R,), NEG_INF)
                l = torch.zeros(R)
                acc = torch.zeros(R, Hd)
                k0, k1 = fd.key_run(lo, end, c, C)
                for t0 in range(k0, k1, fd.KEY_TILE):
                    pos = torch.arange(t0, min(k1, t0 + fd.KEY_TILE))
                    vec = tables[b, pos // kp.shape[1]].long(), pos % kp.shape[1]
                    kt, vt = kp[vec[0], vec[1], g].float(), vp[vec[0], vec[1], g].float()
                    if k_scale is not None:
                        kt = kt * k_scale[vec[0], vec[1], g]
                        vt = vt * v_scale[vec[0], vec[1], g]
                    xs = (q[b] @ kt.T) * scale
                    if softcap:
                        xs = softcap * torch.tanh(xs / softcap)
                    m_new = torch.maximum(m, xs.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(xs - m_new[:, None])
                    l = alpha * l + p.sum(-1)
                    acc = alpha[:, None] * acc + p @ vt
                    m = m_new
                parts.append((m, l, acc))
            # 5. the CTA partials in CTA order, then the diagonal
            m = torch.stack([pm for pm, _, _ in parts]).amax(0)
            l, acc = torch.zeros(R), torch.zeros(R, Hd)
            for pm, pl, pacc in parts:
                f = torch.exp(pm - m)
                l = l + f * pl
                acc = acc + f[:, None] * pacc
            sd = (q[b] @ kd[b]) * scale
            if softcap:
                sd = softcap * torch.tanh(sd / softcap)
            m_new = torch.maximum(m, sd)
            alpha, pd = torch.exp(m - m_new), torch.exp(sd - m_new)
            att[b] = (alpha[:, None] * acc + pd[:, None] * vd[b]) / (alpha * l + pd)[:, None]
        # 6. this head's O-projection partial, each CTA's slice of rows
        ws = torch.zeros(B, D)
        for c in range(C):
            r = cta_rows(plan, D, plan.out_rows, c)
            ws[:, r.start:r.stop] = _units_dot(w["wo"][r.start:r.stop, g * rhd:(g + 1) * rhd],
                                               att.reshape(B, rhd))
        ys.append(ws)
    total = ys[0]
    for ws in ys[1:]:   # head order 0..K-1
        total = total + ws
    return x + total, k_new, v_new


_ref_jit = jax.jit(jax_fd.fused_decode_ref, static_argnums=(8,))


@pytest.mark.parametrize("rope_style", ["interleaved", "half"])
@pytest.mark.parametrize("softcap", [False, True], ids=["nocap", "softcap"])
@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16_pool", "int8_pool"])
@pytest.mark.parametrize("w_q8", [False, True], ids=["dense_w", "q8_0_w"])
def test_fused_mirror_matches_the_jax_reference(w_q8, kv_int8, window, softcap, rope_style):
    ref, block = _setup(w_q8, kv_int8, window, softcap, rope_style)
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in ref.items()
         if k not in ("cfg", "lp")}
    yref, nk, nv, _, _ = _ref_jit(j["x"], ref["lp"], j["kp"], j["vp"], j["cos"], j["sin"],
                                  j["tables"], j["lengths"], ref["cfg"], j["ks"], j["vs"])
    cfg = ref["cfg"]
    t = {k: None if ref[k] is None else torch.from_numpy(np.array(ref[k]))
         for k in ("kp", "vp", "ks", "vs", "tables", "lengths")}
    B = len(LENGTHS)
    # the wrapper's plan (8 CTAs a head: runs of at most 13 keys at these
    # lengths) and the same cut over 2 CTAs (two key tiles a run at length
    # 100)
    served = fd.fused_plan(B, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4, w_q8,
                           kv_int8)
    assert served.cluster == 8
    nq = (cfg.n_heads // cfg.n_kv_heads + 2) * cfg.head_dim
    for plan in (served, served._replace(cluster=2, ctas=2 * cfg.n_kv_heads,
                                         qkv_rows=-(-nq // 2), out_rows=-(-cfg.dim // 2))):
        y, kn, vn = fused_mirror(torch.from_numpy(np.array(ref["x"][:, 0])), block,
                                 torch.from_numpy(np.array(ref["cos"][:, 0])),
                                 torch.from_numpy(np.array(ref["sin"][:, 0])), t["kp"], t["vp"],
                                 t["tables"], t["lengths"], k_scale=t["ks"], v_scale=t["vs"],
                                 plan=plan)
        np.testing.assert_allclose(y.numpy(), np.asarray(yref)[:, 0], rtol=0, atol=2e-5)
        for b, ln in enumerate(LENGTHS):
            blk, off = ref["tables"][b, ln // BS], ln % BS
            if kv_int8:   # the new token's codes, as the reference's pool write
                for got, want in ((kn, nk), (vn, nv)):
                    codes = jax_kv_quantize(jnp.asarray(got[b].numpy()))[0]
                    np.testing.assert_array_equal(np.asarray(codes), np.asarray(want)[blk, off])
            else:
                np.testing.assert_allclose(kn[b].numpy(), np.asarray(nk)[blk, off],
                                           rtol=0, atol=4e-6)
                np.testing.assert_allclose(vn[b].numpy(), np.asarray(nv)[blk, off],
                                           rtol=0, atol=4e-6)


def test_the_mirror_merges_empty_runs_and_a_zero_length_row():
    """A row with no pool keys (length 0) attends only its diagonal: every
    CTA's run is empty (m = -1e30, l = 0) and the merge leaves v_new."""
    ref, block = _setup(False, False, False, False, "interleaved")
    t = {k: torch.from_numpy(np.array(ref[k])) for k in ("kp", "vp", "tables")}
    cfg = ref["cfg"]
    lengths = torch.zeros(len(LENGTHS), dtype=torch.int32)
    plan = fd.fused_plan(len(LENGTHS), cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4)
    x = torch.from_numpy(np.array(ref["x"][:, 0]))
    y, kn, vn = fused_mirror(x, block, torch.ones(len(LENGTHS), cfg.head_dim // 2),
                             torch.zeros(len(LENGTHS), cfg.head_dim // 2), t["kp"], t["vp"],
                             t["tables"], lengths, plan=plan)
    R = cfg.n_heads // cfg.n_kv_heads
    att = vn.repeat_interleave(R, dim=1).reshape(len(LENGTHS), -1)   # each head: its v
    want = x + att @ _dense(block, "wo").T
    torch.testing.assert_close(y, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("which", ["x", "k_pool", "v_pool", "wq"])
def test_fused_wrapper_refuses_a_misaligned_view_before_any_launch(monkeypatch, which):
    """The kernel's bulk and 16-byte copies need 16-byte addresses: a
    contiguous view off that grain raises ValueError before the library is
    touched (on the card it would fault and end the CUDA context)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def boom(*a, **k):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(fd, "_kernel", boom)
    cfg = _port_cfg(BASE)
    model = LlamaModel(cfg, params_from_jax(jax.tree.map(
        np.asarray, random_params(BASE, jax.random.PRNGKey(0), dtype=jnp.float32))))
    block = model.layers[0]
    B, K, Hd = 2, cfg.n_kv_heads, cfg.head_dim

    def off16(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
        return flat.view(t.shape)

    x = torch.zeros(B, cfg.dim)
    kp = torch.zeros(4, BS, K, Hd)
    vp = torch.zeros(4, BS, K, Hd)
    if which == "x":
        x = off16(x)
    elif which == "k_pool":
        kp = off16(kp)
    elif which == "v_pool":
        vp = off16(vp)
    else:
        block._parameters["wq"] = torch.nn.Parameter(off16(block._parameters["wq"].data),
                                                     requires_grad=False)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fd.fused_decode_attn(x, block, torch.zeros(B, Hd // 2), torch.zeros(B, Hd // 2), kp, vp,
                             torch.zeros(B, 2, dtype=torch.int32),
                             torch.ones(B, dtype=torch.int32))
