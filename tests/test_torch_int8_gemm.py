"""The int8 GEMM (``csrc/int8_matmul.cu``: TMA + ``wgmma`` s8, an exact fold
per weight group) on the CPU, where its CUDA kernel cannot run: what
surrounds the kernel, and mirrors of its arithmetic.

- The fold's conversion off the conversion pipe: the float whose bits are
  0x4B400000 + P, less 12582912.0f (1.5 · 2²³), is float(P) exactly for
  every |P| ≤ 2²² (the kernel's P is at most 256 · 128 · 127 in size), a
  vectorised sweep, endpoints included.
- The plan (``ops.quant_matmul.int8_plan``) at the shapes phase 3 of
  ``chip_smoke.py`` and the served paths use, at several SM counts: every
  output tile once, every group of D in whole k-steps of its own and in
  order (a group of 256 in two), its scales in its last step, no split,
  the narrower tile only where its grid fits one wave of the card, and a
  ``ValueError`` for what the kernel refuses; the producer lanes' copy of a
  step's scales fills every slot of the stage once.
- The fold order: a plain mirror of the kernel (per output tile, k-steps of
  128 columns, each group's exact integer dot converted as above, times
  ``xs · gs``, added in group order) is ``int8_matmul_plain`` bit for bit,
  and is held against the JAX ``int8_matmul_pallas`` in interpret mode at
  the tolerance of ``test_torch_int8_matmul.py``: 1e-5 of max |ref| in
  f32, one bf16 ulp of max |ref| in bf16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm

jax_quantize_acts = jax.jit(jqm.quantize_acts, static_argnums=1)

MAGIC = 0x4B400000        # the bits of 12582912.0f
MAGIC_F = 12582912.0

# the tiling (int8_matmul.cu Geo and geometry) as the card's
# dlp_int8_matmul_geometry entry reports it: one block an SM
INT8_GEOMETRY = {
    (256, 128): qm.Int8Geometry(128, 128, 128, 6, 288, 203872, 1),
    (128, 128): qm.Int8Geometry(128, 128, 128, 6, 288, 203872, 1),
    (64, 128): qm.Int8Geometry(128, 128, 128, 6, 288, 210016, 1),
    (32, 128): qm.Int8Geometry(128, 128, 128, 6, 288, 222304, 1),
    (256, 64): qm.Int8Geometry(128, 64, 128, 8, 288, 205952, 1),
    (128, 64): qm.Int8Geometry(128, 64, 128, 8, 288, 205952, 1),
    (64, 64): qm.Int8Geometry(128, 64, 128, 8, 288, 214144, 1),
    (32, 64): qm.Int8Geometry(128, 64, 128, 8, 288, 222336, 1),
}


# ---------------------------------------------------------------------------
# the fold's conversion

def _magic_float(p: torch.Tensor) -> torch.Tensor:
    """The kernel's float(P): the int32 bits 0x4B400000 + P as f32, less
    12582912.0f (an f32 subtraction)."""
    return (p.to(torch.int32) + MAGIC).view(torch.float32) - torch.tensor(MAGIC_F)


def test_magic_conversion_is_exact_for_every_p():
    p = torch.arange(-(2 ** 22), 2 ** 22 + 1, dtype=torch.int32)
    got = _magic_float(p)
    assert got.dtype == torch.float32
    assert torch.equal(got, p.float())
    assert got[0].item() == -(2 ** 22) and got[-1].item() == 2 ** 22
    # the largest |P| a group of 256 can give: the quantized activations are
    # clipped to +-127, the codes any byte
    assert 256 * 127 * 128 <= 2 ** 22 and 256 * 127 * 127 == 4129024


# ---------------------------------------------------------------------------
# the plan

# (D, F, group): Llama-3.2-1B's projections and head, phase 3's odd F and
# its group-32 (D = 2080) and group-128 (D = 1152) edges, a group-64 width
PLAN_SHAPES = [(2048, 2048, 256), (2048, 512, 256), (2048, 8192, 256), (8192, 2048, 256),
               (2048, 128256, 256), (2048, 1001, 256), (2080, 1024, 32), (1152, 1024, 128),
               (320, 160, 64)]
# the GEMM's M: above INT8_W8A8_MAX_M, phase 3's (16, 32, 33, 100, 256, 512),
# the identity probe's 2048 and served prefill buckets
PLAN_M = (5, 16, 32, 33, 64, 100, 256, 481, 512, 2048)
SM_COUNTS = (1, 8, 132, 144)


def _group_steps(plan) -> list[list[int]]:
    """The k-steps each group's MMAs read, as the kernel walks them: group
    g of 256 steps 2g and 2g + 1; of a smaller group, step g / (128 /
    group)."""
    if plan.group > qm.INT8_KSTEP:
        spg = plan.group // qm.INT8_KSTEP
        return [list(range(g * spg, (g + 1) * spg)) for g in range(plan.groups)]
    return [[g // (qm.INT8_KSTEP // plan.group)] for g in range(plan.groups)]


def _scale_step(plan, g: int) -> int:
    """The k-step whose stage the producer fills with group g's scales: the
    steps i with (i + 1) % SPG == 0 take groups i / SPG · GPK on."""
    spg = max(1, plan.group // qm.INT8_KSTEP)
    gpk = max(1, qm.INT8_KSTEP // plan.group)
    return next(i for i in range(plan.steps) if (i + 1) % spg == 0
                and i // spg * gpk <= g < i // spg * gpk + gpk)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("D,F,group", PLAN_SHAPES)
def test_int8_plan_covers_every_tile_and_group_once(D, F, group, sms):
    for M in PLAN_M:
        plan = qm.int8_plan(M, D, F, group, sms)
        assert plan.bm == qm.INT8_BM == 128 and plan.bn in qm.INT8_BNS
        assert plan.splits == 1 and plan.group == group
        # every output tile once
        assert (plan.tiles_m - 1) * plan.bm < M <= plan.tiles_m * plan.bm
        assert (plan.tiles_n - 1) * plan.bn < F <= plan.tiles_n * plan.bn
        # the k-steps cover D in order (the last ragged where 128 does not
        # divide D); each group lies in whole steps of its own (a group of
        # 256 in two), taken in order, its scales in the stage of its last
        assert plan.groups == D // group
        assert (plan.steps - 1) * qm.INT8_KSTEP < D <= plan.steps * qm.INT8_KSTEP
        steps = _group_steps(plan)
        walk = [t for g in range(plan.groups) for t in steps[g]]
        assert walk == sorted(walk) and sorted(set(walk)) == list(range(plan.steps))
        for g, ts in enumerate(steps):
            assert ts[0] * 128 <= g * group and (g + 1) * group <= min(D, (ts[-1] + 1) * 128)
            assert _scale_step(plan, g) == ts[-1]
        # the narrower tile only where its grid fits one wave, and so fills
        # more SMs than the wider one's
        tiles = {bn: plan.tiles_m * -(-F // bn) for bn in qm.INT8_BNS}
        if plan.bn == 64:
            assert tiles[128] < tiles[64] <= sms
        else:
            assert tiles[64] > sms
        assert plan == qm.int8_plan.__wrapped__(M, D, F, group, sms)


@pytest.mark.parametrize("M,D,F,group", [(0, 2048, 512, 256), (33, 2048, 0, 256),
                                         (33, 2080, 512, 256), (33, 2048, 512, 16),
                                         (33, 96, 512, 128), (65536 * 128 + 1, 2048, 512, 256)])
def test_int8_plan_refuses_what_the_kernel_refuses(M, D, F, group):
    """The kernel takes M, F >= 1, a group of 256, 128, 64 or 32 that
    divides D, and at most 65535 row tiles."""
    with pytest.raises(ValueError):
        qm.int8_plan(M, D, F, group, 132)


@pytest.mark.parametrize("group,bn", sorted(INT8_GEOMETRY))
def test_int8_geometry_and_the_producers_scale_copy(group, bn):
    """The tiling the plan assumes (rows of x a block, columns a k-step) is
    the library's, a block fits the SM's shared memory, and the producer
    warp's copy of a group's scales (lane l's j-th value: row l + 32 j of
    the group's [BM + BN] slot, xs for j < BM / 32, gs after) writes every
    slot of the stage's [GPK][BM + BN] block once."""
    geo = INT8_GEOMETRY[(group, bn)]
    assert geo.bm == qm.INT8_BM and geo.bn == bn and geo.kstep == qm.INT8_KSTEP
    assert geo.smem <= 232448 and geo.threads == 288
    gpk, row = max(1, qm.INT8_KSTEP // group), geo.bm + bn
    assert row % 32 == 0 and geo.bm % 32 == 0
    slots = [gi * row + lane + 32 * j for gi in range(gpk) for lane in range(32)
             for j in range(row // 32)]
    assert sorted(slots) == list(range(gpk * row))


# ---------------------------------------------------------------------------
# the fold order

def _kernel_mirror(x: torch.Tensor, pack, plan, out_dtype) -> torch.Tensor:
    """The kernel's function in its own order: the activations quantized as
    the quantize launch does (``quantize_acts``); per output tile of
    ``bm × bn``, its groups in order over the k-steps each spans: the
    exact integer dot P, float(P) through the bits 0x4B400000 + P, times
    ``xs · gs`` (rounded), added to the tile's f32 sums (rounded)."""
    xq, xs = qm.quantize_acts(x, pack.group)
    M, D = xq.shape
    F, g = pack.shape[0], plan.group
    steps = _group_steps(plan)
    out = torch.empty(M, F)
    for tm in range(plan.tiles_m):
        rows = slice(tm * plan.bm, min(M, (tm + 1) * plan.bm))
        for tn in range(plan.tiles_n):
            cols = slice(tn * plan.bn, min(F, (tn + 1) * plan.bn))
            acc = torch.zeros(rows.stop - rows.start, cols.stop - cols.start)
            for gi, ts in enumerate(steps):
                # the group's columns, step by step (exact integer sums)
                p = sum(xq[rows, c].long() @ pack.qs[cols, c].long().t() for c in (
                    slice(max(gi * g, 128 * t), min((gi + 1) * g, 128 * t + 128)) for t in ts))
                s = xs[rows, gi][:, None] * pack.gs[cols, gi][None, :]
                acc = acc + _magic_float(p) * s
            out[rows, cols] = acc
    return out.to(out_dtype)


def _weight(D, F, seed=0):
    return (np.random.default_rng(seed).normal(size=(D, F)) * 0.05).astype(np.float32)


# (M, D, F, SM count): groups 256, 128 (a ragged last step of half a step),
# 64 and 32 (a ragged last step of one group); tiles of 128 and 64 columns;
# ragged M and F edges, F odd
ORDER_CASES = [(40, 512, 160, 132), (130, 1152, 96, 4), (33, 320, 192, 1),
               (70, 2080, 101, 8), (5, 256, 64, 132)]


@pytest.mark.parametrize("M,D,F,sms", ORDER_CASES)
def test_fold_mirror_is_the_plain_version_bit_for_bit(M, D, F, sms):
    pack = qm.pack_int8(_weight(D, F, seed=M).T)
    plan = qm.int8_plan(M, D, F, pack.group, sms)
    x = torch.from_numpy(np.random.default_rng(D + F).normal(size=(M, D)).astype(np.float32))
    x[0, : pack.group] = 0   # a zero group: xs = 0, its terms +0
    for out_dtype in (torch.float32, torch.bfloat16):
        got = _kernel_mirror(x, pack, plan, out_dtype)
        want = qm.int8_matmul_plain(x, pack, out_dtype)
        assert got.dtype == want.dtype == out_dtype
        assert torch.equal(got.view(torch.int16 if out_dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if out_dtype == torch.bfloat16
                                     else torch.int32))


def _jax_int8(x, jp, out_dtype):
    xq, xs = jax_quantize_acts(x, x.shape[1] // jp["gs"].shape[0])
    return jqm.int8_matmul_pallas(xq, xs, jnp.asarray(jp["qs"]), jnp.asarray(jp["gs"]),
                                  out_dtype=out_dtype, interpret=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,D,F,sms", ORDER_CASES[:4])
def test_fold_mirror_matches_jax_pallas(M, D, F, sms, dtype):
    w = _weight(D, F, seed=M + 1)
    jp, pack = jqm.pack_int8(w), qm.pack_int8(w.T)
    plan = qm.int8_plan(M, D, F, pack.group, sms)
    x32 = np.random.default_rng(M * D).normal(size=(M, D)).astype(np.float32)
    if dtype == "f32":
        want = np.asarray(_jax_int8(jnp.asarray(x32), jp, jnp.float32))
        got = _kernel_mirror(torch.from_numpy(x32), pack, plan, torch.float32).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        x = torch.from_numpy(x32).bfloat16()
        want = np.asarray(_jax_int8(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jp,
                                    jnp.bfloat16), np.float32)
        got = _kernel_mirror(x, pack, plan, torch.bfloat16)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
