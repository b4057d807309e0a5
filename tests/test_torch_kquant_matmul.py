"""The port's Q4_K, Q5_KS, Q2_KS and Q3_KS packs and the plain versions of
their five kernels against the JAX package's (and, in bf16, the plain Q6_K
fused dequant too).

- Packs (from dense weights and from raw GGUF blocks): every field equals
  the JAX field transposed to out-features-major, exactly (a fifth or third
  bit on the wrong row of a bit plane shows here), and the dequantized
  weights are equal.
- Each plain kernel version against its JAX Pallas kernel in interpret mode
  (``q4_k_matmul_pallas``, ``q4_k_w8a8_matmul_pallas``,
  ``q5_ks_w8a8_matmul_pallas``, ``q2_ks_w8a8_matmul_pallas``,
  ``q3_ks_w8a8_matmul_pallas``), on the same packs and inputs, at activation
  groups 256 and 32 (the group divides the band: D/2, or D/4 for the
  four-band packs): max error ≤ 1e-5 × max |ref| in f32 (f32 summation
  order), ≤ one bf16 ulp of max |ref| with bf16 x.
- ``proj`` against the JAX ``proj`` under the Pallas impl at M = 32 and 33:
  W8A8 below the cutover, the fused dequant (Q4_K) or the dense weight and
  one product (Q5_KS, Q2_KS, Q3_KS, as the reference's einsum) above.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.ops import kquant_matmul as jkq
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.gguf.quants import (quant_q2_k, quant_q3_k, quant_q4_k,
                                                            quant_q5_k, quant_q6_k)
from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm

# the reference's activation quantization as its serving path runs it (jitted)
jax_quantize_acts = jax.jit(jqm.quantize_acts, static_argnums=1)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's quantized matmuls through their Pallas kernels (in
    interpret mode on the CPU), restored to "auto" after the module."""
    jqm.set_quant_matmul_impl("pallas")
    try:
        yield
    finally:
        jqm.set_quant_matmul_impl("auto")


def _weight(D, F, seed=0):
    return (np.random.default_rng(seed).normal(size=(D, F)) * 0.05).astype(np.float32)


# kind: (GGUF encoder, packer name, sub-block, code range)
KINDS = {"q4_k": (quant_q4_k, "pack_q4_k", 32, (0, 15)),
         "q6_k": (quant_q6_k, "pack_q6_k", 16, (-32, 31)),
         "q5_ks": (quant_q5_k, "pack_q5_ks", 32, (0, 31)),
         "q2_ks": (quant_q2_k, "pack_q2_ks", 16, (0, 3)),
         "q3_ks": (quant_q3_k, "pack_q3_ks", 16, (-4, 3))}


def _packs(kind, w, source="dense"):
    """(JAX pack as numpy fields, port pack) of w [D, F]."""
    D, F = w.shape
    encode, name = KINDS[kind][:2]
    if source == "dense":
        return getattr(jkq, name)(w), getattr(kq, name)(w.T)
    raw = np.frombuffer(encode(np.ascontiguousarray(w.T).reshape(-1)), np.uint8)
    return (getattr(jkq, f"{name}_from_gguf")(raw, (D, F)),
            getattr(kq, f"{name}_from_gguf")(raw, (D, F)))


def _t(a):
    """A JAX field (numpy, bf16 via ml_dtypes) as a torch tensor, transposed."""
    a = np.ascontiguousarray(np.asarray(a).T)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("source", ["dense", "gguf"])
@pytest.mark.parametrize("kind", ["q4_k", "q5_ks", "q2_ks", "q3_ks"])
def test_packs_equal_the_jax_packs(kind, source):
    w = _weight(768, 96, seed=2)
    jp, tp = _packs(kind, w, source)
    sub, (lo, hi) = KINDS[kind][2:]
    assert tp.kind == kind and tp.shape == (96, 768) and tp.sub == sub
    assert set(jp) == set(tp.fields)
    for f in tp.fields:
        want = _t(jp[f])
        got = getattr(tp, f)
        assert got.dtype == want.dtype and torch.equal(got, want), f
    codes = tp.codes_and_scales()[0]
    assert codes.min() >= lo and codes.max() == hi
    wd = jkq.dequant_pack({k: jnp.asarray(v) for k, v in jp.items()}, jnp.float32)
    np.testing.assert_array_equal(tp.dequant(torch.float32).numpy(), np.asarray(wd).T)


@pytest.mark.parametrize("kind,D,group", [("q4_k", 512, 256), ("q4_k", 1280, 32),
                                          ("q5_ks", 1024, 256), ("q5_ks", 256, 32),
                                          ("q2_ks", 1024, 256), ("q2_ks", 1280, 32),
                                          ("q3_ks", 2048, 256), ("q3_ks", 512, 32)])
def test_activation_group_divides_the_band(kind, D, group):
    """256 where the band (D/2, or D/4 for the four-band packs) allows it,
    else 32, so no group straddles the bands (Q8_0 would take 256 at
    D = 1280)."""
    _, tp = _packs(kind, _weight(D, 32))
    assert tp.group == group


def _block_d(D2):
    """A tile of packed rows that divides D/2, as the reference's dispatch
    picks one."""
    return jqm.divisor_tile(D2, (512, 384, 256, 128), 512)


def _jax_kernel(kind, kernel, x, jp, out_dtype):
    """The JAX Pallas kernel (interpret mode) on x and the JAX pack."""
    f = {k: jnp.asarray(v) for k, v in jp.items()}
    D = x.shape[1]
    if kernel == "dequant" and kind == "q6_k":
        return jkq.q6_k_matmul_pallas(x, f["ql"], f["qh"], f["s"],
                                      block_d=jqm.divisor_tile(D // 4, (256, 128, 64, 32), 256),
                                      out_dtype=out_dtype, interpret=True)
    if kernel == "dequant":
        return jkq.q4_k_matmul_pallas(x, f["qs"], f["a"], f["b"], block_d=_block_d(D // 2),
                                      out_dtype=out_dtype, interpret=True)
    bands = 4 if kind in ("q2_ks", "q3_ks") else 2
    xq, xs = jax_quantize_acts(x, 256 if (D // bands) % 256 == 0 else 32)
    if kind == "q4_k":
        return jkq.q4_k_w8a8_matmul_pallas(xq, xs, f["qs"], f["a"], f["b"],
                                           out_dtype=out_dtype, interpret=True)
    if kind == "q2_ks":
        return jkq.q2_ks_w8a8_matmul_pallas(xq, xs, f["q2l"], f["a"], f["b"],
                                            out_dtype=out_dtype, interpret=True)
    if kind == "q3_ks":
        return jkq.q3_ks_w8a8_matmul_pallas(xq, xs, f["q3l"], f["q3h"], f["s"],
                                            out_dtype=out_dtype, interpret=True)
    return jkq.q5_ks_w8a8_matmul_pallas(xq, xs, f["q5n"], f["q5h"], f["a"], f["b"],
                                        out_dtype=out_dtype, interpret=True)


# (kind, kernel, M, D, F): M of {1, 3, 32, 33, 64}, groups 256 (the band a
# multiple of 256) and 32 (D = 256, 1280; 512 for four bands), an F that is
# no multiple of 128
KERNEL_CASES = [
    ("q4_k", "w8a8", 1, 512, 192), ("q4_k", "w8a8", 3, 1280, 160),
    ("q4_k", "w8a8", 32, 1024, 192),
    ("q4_k", "dequant", 33, 512, 160), ("q4_k", "dequant", 64, 1280, 192),
    ("q4_k", "dequant", 3, 256, 192),
    ("q5_ks", "w8a8", 1, 256, 192), ("q5_ks", "w8a8", 3, 512, 160),
    ("q5_ks", "w8a8", 32, 1280, 192),
    ("q2_ks", "w8a8", 1, 1024, 192), ("q2_ks", "w8a8", 3, 512, 160),
    ("q2_ks", "w8a8", 32, 1280, 192),
    ("q3_ks", "w8a8", 1, 1280, 160), ("q3_ks", "w8a8", 3, 1024, 192),
    ("q3_ks", "w8a8", 32, 256, 160),
]


def _plain(kernel):
    return qm.w8a8_plain if kernel == "w8a8" else qm.dequant_matmul_plain


@pytest.mark.parametrize("kind,kernel,M,D,F", KERNEL_CASES)
def test_plain_kernel_matches_jax_pallas_f32(kind, kernel, M, D, F):
    jp, tp = _packs(kind, _weight(D, F, seed=M))
    x = np.random.default_rng(D + F).normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(_jax_kernel(kind, kernel, jnp.asarray(x), jp, jnp.float32))
    got = _plain(kernel)(torch.from_numpy(x), tp, torch.float32).numpy()
    assert got.shape == (M, F)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind,kernel,M,D,F", [
    ("q4_k", "w8a8", 4, 512, 192), ("q4_k", "w8a8", 16, 1280, 160),
    ("q4_k", "dequant", 64, 512, 192), ("q4_k", "dequant", 40, 1280, 160),
    ("q6_k", "dequant", 64, 512, 192), ("q6_k", "dequant", 40, 1280, 160),
    ("q6_k", "dequant", 100, 1024, 320),
    ("q5_ks", "w8a8", 4, 1024, 160), ("q5_ks", "w8a8", 32, 1280, 192),
    ("q2_ks", "w8a8", 4, 1024, 160), ("q2_ks", "w8a8", 16, 1280, 192),
    ("q3_ks", "w8a8", 4, 1024, 192), ("q3_ks", "w8a8", 32, 512, 160)])
def test_plain_kernel_matches_jax_pallas_bf16(kind, kernel, M, D, F):
    jp, tp = _packs(kind, _weight(D, F, seed=7))
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(M, D)).astype(
        np.float32)).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(_jax_kernel(kind, kernel, xj, jp, jnp.bfloat16), np.float32)
    got = _plain(kernel)(x, tp, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("M", [32, 33])
@pytest.mark.parametrize("kind", ["q4_k", "q5_ks", "q2_ks", "q3_ks"])
def test_proj_routes_like_jax(kind, M, pallas):
    """M ≤ 32 quantizes the activations (W8A8), M > 32 does not: a routing
    difference would show as an activation-quantization-sized error."""
    D, F = 512, 192
    jp, tp = _packs(kind, _weight(D, F, seed=3))
    x = np.random.default_rng(M).normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(jqm.proj(jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()}))
    got = qm.proj(torch.from_numpy(x), tp).numpy()
    assert got.shape == ref.shape == (M, F)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_q5_ks_has_no_fused_dequant_kernel():
    """M > 32 against a Q5_KS pack takes the dense weight and one product
    on every device; the fused-dequant wrapper refuses the pack, and no
    kernel counter moves on the CPU."""
    _, tp = _packs("q5_ks", _weight(256, 64))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(40, 256)).astype(np.float32))
    want = torch.nn.functional.linear(x, tp.dequant(torch.float32))
    assert torch.equal(qm.quant_matmul(x, tp), want)
    with pytest.raises(ValueError, match="no kernel for pack kind 'q5_ks'"):
        qm.dequant_matmul(x.bfloat16(), tp, torch.bfloat16)
    assert all(n == 0 for n in qm.launches.values())


@pytest.mark.parametrize("kind", ["q2_ks", "q3_ks"])
def test_sub_byte_four_band_packs_take_the_dense_product_above_32(kind):
    """As Q5_KS: M > 32 takes the dense weight and one product on every
    device, the fused-dequant wrapper refuses the pack, ``route`` names no
    kernel there and the W8A8 kernel below."""
    _, tp = _packs(kind, _weight(256, 64))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(40, 256)).astype(np.float32))
    want = torch.nn.functional.linear(x, tp.dequant(torch.float32))
    assert torch.equal(qm.quant_matmul(x, tp), want)
    with pytest.raises(ValueError, match=f"no kernel for pack kind '{kind}'"):
        qm.dequant_matmul(x.bfloat16(), tp, torch.bfloat16)
    assert qm.route(kind, 33) is None and qm.route(kind, 32) == f"{kind}_w8a8_matmul"
    assert all(n == 0 for n in qm.launches.values())
