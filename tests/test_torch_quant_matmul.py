"""The port's quantized packs, activation quantization and the plain versions
of its four quantized matmul kernels against the JAX package's.

- Packs (Q8_0, Q6_K; from dense weights and from raw GGUF blocks): every
  field equals the JAX field transposed to out-features-major, and the
  dequantized weights are equal.
- ``quantize_acts``: codes and scales bit-equal to the JAX ones as the JAX
  package serves them, under jit (groups 256 and 32, an all-zero row).
- Each plain kernel version against its JAX Pallas kernel in interpret mode,
  on the same packs and inputs: max error ≤ 1e-5 × max |ref| in f32 (f32
  summation order), ≤ one bf16 ulp of max |ref| with bf16 x (the same
  values, then the same final rounding).
- ``proj`` against the JAX ``proj`` under the Pallas impl at M = 32 and 33,
  so the W8A8 / fused-dequant routing is the same.
- A bf16 model's head on the CPU accumulates in f32 as the JAX ``lm_logits``
  does, dense and packed.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS as JAX_PRESETS
from distributed_llm_pipeline_tpu.models import random_params
from distributed_llm_pipeline_tpu.models.llama import lm_logits as jax_lm_logits
from distributed_llm_pipeline_tpu.models.llama import quantize_params as jax_quantize_params
from distributed_llm_pipeline_tpu.ops import kquant_matmul as jkq
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.gguf.quants import quant_q6_k, quant_q8_0
from distributed_llm_pipeline_tpu_torch.models import LlamaModel, ModelConfig, params_from_jax
from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm


# the reference's activation quantization as its serving path runs it: under
# jit, where XLA folds ``amax / 127`` into a product with f32(1/127)
jax_quantize_acts = jax.jit(jqm.quantize_acts, static_argnums=1)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's quantized matmuls through their Pallas kernels (in
    interpret mode on the CPU), restored to "auto" after the module: setting
    the impl clears JAX's caches, so it is set once."""
    jqm.set_quant_matmul_impl("pallas")
    try:
        yield
    finally:
        jqm.set_quant_matmul_impl("auto")


def _weight(D, F, seed=0):
    return (np.random.default_rng(seed).normal(size=(D, F)) * 0.05).astype(np.float32)


def _jax_pack(kind, w, source):
    """The JAX pack of w [D, F] (numpy fields)."""
    D, F = w.shape
    if source == "dense":
        return jqm.pack_q8_0(w) if kind == "q8_0" else jkq.pack_q6_k(w)
    raw = np.frombuffer((quant_q8_0 if kind == "q8_0" else quant_q6_k)(
        np.ascontiguousarray(w.T).reshape(-1)), np.uint8)
    if kind == "q8_0":
        return jqm.pack_q8_0_from_gguf(raw, (D, F))
    return jkq.pack_q6_k_from_gguf(raw, (D, F))


def _port_pack(kind, w, source):
    D, F = w.shape
    if source == "dense":
        return (qm.pack_q8_0 if kind == "q8_0" else kq.pack_q6_k)(w.T)
    raw = np.frombuffer((quant_q8_0 if kind == "q8_0" else quant_q6_k)(
        np.ascontiguousarray(w.T).reshape(-1)), np.uint8)
    if kind == "q8_0":
        return qm.pack_q8_0_from_gguf(raw, (D, F))
    return kq.pack_q6_k_from_gguf(raw, (D, F))


def _t(a):
    """A JAX field (numpy, bf16 via ml_dtypes) as a torch tensor, transposed."""
    a = np.ascontiguousarray(np.asarray(a).T)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _jax_dequant(kind, pack):
    pj = {k: jnp.asarray(v) for k, v in pack.items()}
    w = (jqm.dequant_q8_0(pj, jnp.float32) if kind == "q8_0"
         else jkq.dequant_pack(pj, jnp.float32))
    return np.asarray(w).T


@pytest.mark.parametrize("source", ["dense", "gguf"])
@pytest.mark.parametrize("kind", ["q8_0", "q6_k"])
def test_packs_equal_the_jax_packs(kind, source):
    w = _weight(512, 192)
    jp, tp = _jax_pack(kind, w, source), _port_pack(kind, w, source)
    assert tp.kind == kind and tp.shape == (192, 512)
    assert set(jp) == set(tp.fields)
    for f in tp.fields:
        want = _t(jp[f])
        got = getattr(tp, f)
        assert got.dtype == want.dtype and torch.equal(got, want), f
    np.testing.assert_array_equal(tp.dequant(torch.float32).numpy(),
                                  _jax_dequant(kind, jp))


@pytest.mark.parametrize("group", [256, 32])
def test_quantize_acts_bit_equal(group):
    x = np.random.default_rng(1).normal(size=(5, 512)).astype(np.float32)
    x[2] = 0.0                                          # xs = 0, inv = 0
    x[3, :group] *= 1e-3                                # a small group
    jxq, jxs = jax_quantize_acts(jnp.asarray(x), group)
    txq, txs = qm.quantize_acts(torch.from_numpy(x), group)
    assert txq.dtype == torch.int8 and txs.dtype == torch.float32
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert not txq[2].any() and not txs[2].any()


def _jax_kernel(kind, kernel, x, jp, out_dtype):
    """The JAX Pallas kernel (interpret mode) on x and the JAX pack."""
    f = {k: jnp.asarray(v) for k, v in jp.items()}
    if kernel == "w8a8":
        D = x.shape[1]
        group = (256 if D % 256 == 0 else 32) if kind == "q8_0" else \
            (256 if (D // 4) % 256 == 0 else 32)
        xq, xs = jax_quantize_acts(x, group)
        if kind == "q8_0":
            return jqm.gw8a8_matmul_pallas(xq, xs, f["qs"], f["scale"], sb=32,
                                           out_dtype=out_dtype, interpret=True)
        return jkq.q6_k_w8a8_matmul_pallas(xq, xs, f["ql"], f["qh"], f["s"],
                                           out_dtype=out_dtype, interpret=True)
    if kind == "q8_0":
        return jqm.q8_0_matmul_pallas(x, f["qs"], f["scale"], out_dtype=out_dtype,
                                      interpret=True)
    return jkq.q6_k_matmul_pallas(x, f["ql"], f["qh"], f["s"], out_dtype=out_dtype,
                                  interpret=True)


# (kind, kernel, M, D, F): every M of {1, 3, 32, 33, 64}, D of {256, 512,
# 1024} and F of {192, 320} for each format, group 32 for Q8_0 at D = 160
# and for Q6_K where D/4 is not a multiple of 256
KERNEL_CASES = [
    ("q8_0", "w8a8", 1, 256, 192), ("q8_0", "w8a8", 3, 512, 320),
    ("q8_0", "w8a8", 32, 1024, 192), ("q8_0", "w8a8", 3, 160, 320),
    ("q8_0", "dequant", 33, 256, 320), ("q8_0", "dequant", 64, 1024, 192),
    ("q8_0", "dequant", 33, 160, 192),
    ("q6_k", "w8a8", 1, 256, 320), ("q6_k", "w8a8", 3, 512, 192),
    ("q6_k", "w8a8", 32, 1024, 320),
    ("q6_k", "dequant", 33, 512, 320), ("q6_k", "dequant", 64, 256, 192),
    ("q6_k", "dequant", 3, 1024, 192),
]


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("kind,kernel,M,D,F", KERNEL_CASES)
def test_plain_kernel_matches_jax_pallas_f32(kind, kernel, M, D, F):
    w = _weight(D, F, seed=M)
    jp, tp = _jax_pack(kind, w, "dense"), _port_pack(kind, w, "dense")
    x = np.random.default_rng(D + F).normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(_jax_kernel(kind, kernel, jnp.asarray(x), jp, jnp.float32))
    plain = qm.w8a8_plain if kernel == "w8a8" else qm.dequant_matmul_plain
    got = plain(torch.from_numpy(x), tp, torch.float32).numpy()
    assert got.shape == (M, F)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("kind,kernel,M,D,F", [
    ("q8_0", "w8a8", 3, 512, 320), ("q8_0", "dequant", 33, 256, 192),
    ("q6_k", "w8a8", 32, 1024, 192), ("q6_k", "dequant", 64, 512, 320)])
def test_plain_kernel_matches_jax_pallas_bf16(kind, kernel, M, D, F):
    w = _weight(D, F, seed=7)
    jp, tp = _jax_pack(kind, w, "dense"), _port_pack(kind, w, "dense")
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(M, D)).astype(
        np.float32)).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(_jax_kernel(kind, kernel, xj, jp, jnp.bfloat16), np.float32)
    plain = qm.w8a8_plain if kernel == "w8a8" else qm.dequant_matmul_plain
    got = plain(x, tp, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("M", [32, 33])
@pytest.mark.parametrize("kind", ["q8_0", "q6_k"])
def test_proj_routes_like_jax(kind, M, pallas):
    """M ≤ 32 quantizes the activations (W8A8), M > 32 does not: a routing
    difference would show as an activation-quantization-sized error."""
    D, F = 1024, 192
    w = _weight(D, F, seed=3)
    jp, tp = _jax_pack(kind, w, "dense"), _port_pack(kind, w, "dense")
    x = np.random.default_rng(M).normal(size=(2, M // 2, D)).astype(np.float32) \
        if M % 2 == 0 else np.random.default_rng(M).normal(size=(M, D)).astype(np.float32)
    ref = np.asarray(jqm.proj(jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()}))
    got = qm.proj(torch.from_numpy(x), tp).numpy()
    assert got.shape == ref.shape == x.shape[:-1] + (F,)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_proj_head_f32_out_from_bf16(pallas):
    """The head's call: bf16 x, a packed weight, f32 logits."""
    D, F = 512, 320
    w = _weight(D, F, seed=4)
    jp, tp = _jax_pack("q8_0", w, "dense"), _port_pack("q8_0", w, "dense")
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 2, D)).astype(
        np.float32)).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jqm.proj(xj, {k: jnp.asarray(v) for k, v in jp.items()},
                              out_dtype=jnp.float32))
    got = qm.proj(x, tp, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only; the CPU goes through the
    plain versions by the dispatch, never by a fallback inside a wrapper."""
    tp = qm.pack_q8_0(_weight(256, 64).T)
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        qm.w8a8_matmul(x, tp, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        qm.dequant_matmul(x, tp, torch.bfloat16)
    assert all(n == 0 for n in qm.launches.values())


def test_pack_kernel_pointers_follow_the_buffers():
    """A pack checks its fields for a kernel once per placement; moving the
    buffers (``.to``) drops the cached pointers, a field on another device
    raises."""
    tp = kq.pack_q6_k(_weight(256, 64).T)
    cpu = torch.device("cpu")
    want = tuple(getattr(tp, f).data_ptr() for f in tp.fields)
    assert tp.kernel_ptrs(cpu) == want
    tp.to(torch.float32)     # casts the bf16 scales: new buffers
    assert tp.s.dtype == torch.float32
    assert tp.kernel_ptrs(cpu) == tuple(getattr(tp, f).data_ptr() for f in tp.fields)
    assert tp.kernel_ptrs(cpu) != want
    with pytest.raises(ValueError, match="contiguous on meta"):
        tp.kernel_ptrs(torch.device("meta"))


_HEAD_CFG = JAX_PRESETS["llama3.2-1b"].replace(
    vocab_size=256, dim=64, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16,
    hidden_dim=128, max_seq_len=64)


@pytest.mark.parametrize("quant", [None, "q8_0"])
def test_bf16_head_accumulates_in_f32_on_the_cpu(quant, pallas):
    """A bf16 model's CPU logits agree with the JAX ``lm_logits`` to f32
    precision (rounding them to bf16 first was off by one bf16 ulp), with the
    tied head dense and packed."""
    cfg = _HEAD_CFG
    params = jax.tree.map(np.asarray, random_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16, scale=0.2))
    if quant:
        params = jax_quantize_params(params, cfg, quant)
    model = LlamaModel(ModelConfig(**dataclasses.asdict(cfg)), params_from_jax(params))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 4, cfg.dim)).astype(
        np.float32)).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jax_lm_logits(jax.tree.map(jnp.asarray, params), cfg, xj))
    got = model.lm_logits(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
