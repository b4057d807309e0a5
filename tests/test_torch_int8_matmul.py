"""The port's int8 pack and the plain version of its int8 kernel against the
JAX package's.

- ``pack_int8`` (group 256, else the largest power of two of 128, 64, 32
  dividing D): codes and f32 group scales equal the JAX
  fields transposed to out-features-major, exactly, and so do the
  dequantized weights.
- ``int8_matmul_plain`` against ``int8_matmul_pallas`` in interpret mode, on
  the same pack and the activations quantized by the reference's jitted
  ``quantize_acts``, at M on both sides of 32: max error ≤ 1e-5 × max |ref|
  in f32 (f32 summation order), ≤ one bf16 ulp of max |ref| with bf16 x.
- ``proj`` against the JAX ``proj`` under the Pallas impl at M = 32 and 33:
  an int8 pack takes its own kernel at every M (the activations are
  quantized on both sides of the W8A8 cutover).
- The CUDA wrapper takes CUDA tensors only; the fused-dequant wrapper has no
  int8 kernel.
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


@pytest.mark.parametrize("D,want", [(512, 256), (1152, 128), (640, 128), (320, 64),
                                    (2080, 32), (96, 32)])
def test_pack_int8_equals_the_jax_pack(D, want):
    w = _weight(D, 48, seed=D)
    w[:, 5] = 0.0                                      # an all-zero column: gs = 0
    jp = jqm.pack_int8(w)
    tp = qm.pack_int8(w.T)
    assert tp.kind == "int8" and tp.shape == (48, D) and tp.group == tp.sub == want
    assert tp.qs.dtype == torch.int8 and tp.gs.dtype == torch.float32
    assert torch.equal(tp.qs, _t(jp["qs"])) and torch.equal(tp.gs, _t(jp["gs"]))
    assert not tp.qs[5].any() and not tp.gs[5].any()
    wd = jqm.dequant_int8({k: jnp.asarray(v) for k, v in jp.items()}, jnp.float32)
    np.testing.assert_array_equal(tp.dequant(torch.float32).numpy(), np.asarray(wd).T)


@pytest.mark.parametrize("D", [48, 100])
def test_pack_int8_needs_a_group(D):
    """No power-of-two group of at least 32 divides D: both packages refuse
    (their ``quantize_params`` then fall back to Q8_0, which refuses too)."""
    w = _weight(D, 16)
    with pytest.raises(ValueError, match="no int8 group"):
        jqm.pack_int8(w)
    with pytest.raises(ValueError, match="no int8 group"):
        qm.pack_int8(w.T)


def _jax_int8(x, jp, out_dtype):
    xq, xs = jax_quantize_acts(x, x.shape[1] // jp["gs"].shape[0])
    return jqm.int8_matmul_pallas(xq, xs, jnp.asarray(jp["qs"]), jnp.asarray(jp["gs"]),
                                  out_dtype=out_dtype, interpret=True)


# (M, D, F): M on both sides of 32, groups 256, 128, 64 and 32, an F that is
# no multiple of 128
CASES = [(1, 512, 192), (3, 1152, 160), (32, 320, 192), (33, 512, 160),
         (64, 1152, 192), (40, 320, 160), (5, 2080, 96), (48, 2080, 96)]


@pytest.mark.parametrize("M,D,F", CASES)
def test_plain_matches_jax_pallas_f32(M, D, F):
    w = _weight(D, F, seed=M)
    jp, tp = jqm.pack_int8(w), qm.pack_int8(w.T)
    x = np.random.default_rng(D + F).normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(_jax_int8(jnp.asarray(x), jp, jnp.float32))
    got = qm.int8_matmul_plain(torch.from_numpy(x), tp, torch.float32).numpy()
    assert got.shape == (M, F)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("M,D,F", [(4, 512, 192), (32, 1152, 160), (33, 320, 192),
                                   (64, 512, 160)])
def test_plain_matches_jax_pallas_bf16(M, D, F):
    w = _weight(D, F, seed=7)
    jp, tp = jqm.pack_int8(w), qm.pack_int8(w.T)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(M, D)).astype(
        np.float32)).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(_jax_int8(xj, jp, jnp.bfloat16), np.float32)
    got = qm.int8_matmul_plain(x, tp, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("M", [32, 33])
def test_proj_routes_like_jax(M, pallas):
    """Both packages quantize the activations at every M: a dense route above
    the cutover would show as an activation-quantization-sized error."""
    D, F = 512, 192
    w = _weight(D, F, seed=3)
    jp, tp = jqm.pack_int8(w), qm.pack_int8(w.T)
    x = np.random.default_rng(M).normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(jqm.proj(jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()}))
    got = qm.proj(torch.from_numpy(x), tp).numpy()
    assert got.shape == ref.shape == (M, F)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    dense = x @ np.asarray(jqm.dequant_int8(jp, jnp.float32))
    assert np.abs(got - dense).max() > 1e-3 * np.abs(dense).max()


def test_route_names_one_kernel_at_every_m():
    assert qm.route("int8", 1) == qm.route("int8", 512) == "int8_matmul"
    assert qm.route("q8_0", 32) == "gw8a8_matmul" and qm.route("q8_0", 33) == "q8_0_matmul"


def test_cuda_wrappers_refuse_cpu_tensors_and_dequant_refuses_int8():
    tp = qm.pack_int8(_weight(256, 64).T)
    for M in (2, 40):
        x = torch.zeros(M, 256, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            qm.int8_matmul(x, tp, torch.bfloat16)
        with pytest.raises(ValueError, match="no kernel for pack kind 'int8'"):
            qm.dequant_matmul(x, tp, torch.bfloat16)
    with pytest.raises(ValueError, match="int8 only"):
        qm.int8_matmul(torch.zeros(2, 256), qm.pack_q8_0(_weight(256, 64).T), torch.float32)
    assert all(n == 0 for n in qm.launches.values())
