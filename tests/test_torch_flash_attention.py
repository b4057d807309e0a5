"""The port's attention on the CPU (the plain version behind attention_any)
against the JAX package's flash_attention kernel, run by the Pallas
interpreter, and against its einsum path (attention_any on the CPU).

Inputs come from numpy with a seed and go to both packages. Tolerances: f32
atol 1e-5 (summation order only); bf16 atol = rtol = 2e-2 (outputs of order
1 are rounded to bf16, whose spacing there is 2^-7 to 2^-6, at different
points by the two packages).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from distributed_llm_pipeline_tpu.ops.flash_attention import (
    attention_any as jax_attention_any, flash_attention as jax_flash)
from distributed_llm_pipeline_tpu_torch.ops import cuda_build
from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa

# id: (B, T, S, K, n_rep, Hd, cache_len, options)
CASES = {
    "decode_mha": (1, 1, 200, 2, 1, 16, 17, {}),
    "decode_gqa_pos0": (1, 1, 200, 2, 4, 16, 0, {}),
    "prefill_gqa_ragged_s": (1, 24, 130, 2, 4, 16, 0, {}),
    "chunk_mid_cache": (1, 8, 300, 2, 4, 16, 100, {}),
    "per_row_prefill": (3, 4, 160, 2, 4, 16, [0, 50, 150], {}),
    "per_row_decode": (2, 1, 64, 1, 4, 16, [10, 63], {}),
    "gemma2_window_softcap_scale": (1, 16, 200, 2, 2, 32, 100,
                                    dict(window=32, softcap=50.0, scale=0.1)),
    "gemma2_per_row_window": (2, 6, 150, 2, 2, 16, [5, 120],
                              dict(window=40, softcap=30.0)),
    "int8_kv": (1, 8, 140, 2, 4, 16, 60, dict(quant=True)),
    "int8_kv_window_per_row": (2, 4, 140, 2, 2, 16, [20, 100],
                               dict(window=48, quant=True)),
}


def _inputs(B, T, S, K, n_rep, Hd, quant, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, K * n_rep, Hd), dtype=np.float32)
    k = rng.standard_normal((B, S, K, Hd), dtype=np.float32)
    v = rng.standard_normal((B, S, K, Hd), dtype=np.float32)
    scales = (None, None)
    if quant:   # per-head-vector symmetric int8, as the KV cache stores it
        def q8(x):
            s = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-12)
            return np.clip(np.round(x / s), -127, 127).astype(np.int8), \
                s.astype(np.float32)
        (k, ks), (v, vs) = q8(k), q8(v)
        scales = (ks, vs)
    return q, k, v, scales


def _both(case):
    B, T, S, K, n_rep, Hd, cache_len, opt = case
    opt = dict(opt)
    quant = opt.pop("quant", False)
    q, k, v, (ks, vs) = _inputs(B, T, S, K, n_rep, Hd, quant)
    cl = np.asarray(cache_len, np.int32)
    jkw = dict(opt, k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    tkw = dict(opt, k_scale=None if ks is None else torch.from_numpy(ks),
               v_scale=None if vs is None else torch.from_numpy(vs))
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl), n_rep)
    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(cl) if cl.ndim else int(cl), n_rep)
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_flash_interpret_and_einsum(name):
    jargs, jkw, targs, tkw = _both(CASES[name])
    got = fa.attention_any(*targs, **tkw)
    assert got.dtype == torch.float32 and got.shape == targs[0].shape
    flash = np.asarray(jax_flash(*jargs, interpret=True, **jkw))
    einsum = np.asarray(jax_attention_any(*jargs, **jkw))
    np.testing.assert_allclose(got.numpy(), flash, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), einsum, rtol=0, atol=1e-5)


def test_plain_matches_jax_flash_bf16():
    B, T, S, K, n_rep, Hd, cl = 1, 16, 256, 2, 4, 64, 32
    q, k, v, _ = _inputs(B, T, S, K, n_rep, Hd, quant=False, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, jnp.asarray(cl, jnp.int32), n_rep, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = fa.attention_any(tq, tk, tv, cl, n_rep)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_cpu_dispatch_never_touches_the_kernel_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CUDA kernel loader ran for a CPU tensor")

    monkeypatch.setattr(fa, "_kernel", boom)
    monkeypatch.setattr(cuda_build, "load_library", boom)
    monkeypatch.setattr(cuda_build, "build", boom)
    jargs, jkw, targs, tkw = _both(CASES["int8_kv_window_per_row"])
    before = fa.launches
    fa.attention_any(*targs, **tkw)
    assert fa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper raises on what it cannot take; it never runs
    the plain version instead."""
    _, _, targs, tkw = _both(CASES["decode_gqa_pos0"])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*targs, **tkw)


def test_cuda_build_names_library_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("DLP_TORCH_BUILD_DIR", str(tmp_path))
    a = cuda_build._target("flash_attention")
    assert a.parent == tmp_path and a.name.startswith("libflash_attention-")
    assert a == cuda_build._target("flash_attention")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-G",))
    assert cuda_build._target("flash_attention") != a
