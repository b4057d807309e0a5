"""The port's paged attention on the CPU (the plain version behind
paged_attention_any) against the JAX package's paged_attention_ref and its
paged_flash_attention kernel, run by the Pallas interpreter.

Inputs come from numpy with a seed and go to both packages. Tolerance: f32
atol 1e-5, since only the summation order (and the Pallas kernel's
integer-exponent softmax rescale, exact to f32 rounding) differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from distributed_llm_pipeline_tpu.ops.paged_attention import (
    paged_attention_ref as jax_paged_ref, paged_flash_attention as jax_paged_flash)
from distributed_llm_pipeline_tpu_torch.ops import cuda_build
from distributed_llm_pipeline_tpu_torch.ops import paged_attention as pa

# id: (B, T, K, n_rep, bs, NT, lengths, options); Hd = 32
CASES = {
    "decode_gqa_per_row": (3, 1, 2, 3, 16, 6, [5, 37, 90], {}),
    "decode_mha": (2, 1, 4, 1, 16, 4, [0, 63], {}),
    "chunk_gqa_per_row": (2, 7, 2, 2, 16, 6, [20, 50], {}),
    "prefill_mha_from_zero": (1, 24, 2, 1, 16, 4, [0], {}),
    "shared_blocks_across_rows": (3, 3, 2, 2, 16, 6, [40, 45, 10],
                                  dict(shared=2)),
    "parked_row_at_max_seq": (3, 1, 2, 2, 16, 4, [30, 64, 12],
                              dict(parked=1)),
    "mixed_step_wide_parked": (3, 16, 2, 2, 16, 6, [96, 33, 0],
                               dict(parked=0)),
    "window_softcap_scale": (2, 5, 2, 2, 16, 6, [70, 12],
                             dict(window=24, softcap=30.0, scale=0.2)),
    "int8_pools": (2, 4, 2, 2, 16, 5, [33, 60], dict(quant=True)),
    "int8_pools_window": (2, 1, 2, 4, 32, 3, [80, 8],
                          dict(quant=True, window=40)),
    "block_size_32": (2, 6, 2, 3, 32, 4, [70, 30], {}),
}
HD = 32


def _inputs(case, seed=0):
    """q, pools, tables, lengths and scales for a case. Each row's needed
    logical blocks map to distinct physical blocks; the rest of its table
    stays 0, the sentinel. ``shared`` makes rows 0 and 1 name the same
    first blocks; ``parked`` sets that row's length to NT * bs."""
    B, T, K, n_rep, bs, NT, lengths, opt = case
    opt = dict(opt)
    rng = np.random.default_rng(seed)
    lengths = list(lengths)
    if "parked" in opt:
        lengths[opt.pop("parked")] = NT * bs
    N = 1 + B * NT
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, NT), np.int32)
    for b in range(B):
        need = min(NT, -(-(lengths[b] + T) // bs))
        for j in range(need):
            tables[b, j] = free.pop()
    if "shared" in opt:
        n = opt.pop("shared")
        tables[1, :n] = tables[0, :n]
    q = rng.standard_normal((B, T, K * n_rep, HD), dtype=np.float32)
    kp = rng.standard_normal((N, bs, K, HD), dtype=np.float32)
    vp = rng.standard_normal((N, bs, K, HD), dtype=np.float32)
    scales = (None, None)
    if opt.pop("quant", False):   # per-head-vector symmetric int8
        def q8(x):
            s = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-12)
            return np.clip(np.round(x / s), -127, 127).astype(np.int8), \
                s.astype(np.float32)
        (kp, ks), (vp, vs) = q8(kp), q8(vp)
        scales = (ks, vs)
    return (q, kp, vp, tables, np.asarray(lengths, np.int32), n_rep), scales, opt


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_paged_ref_and_interpreted_kernel(name):
    args, (ks, vs), opt = _inputs(CASES[name])
    jargs = tuple(jnp.asarray(a) for a in args[:5]) + (args[5],)
    targs = tuple(torch.from_numpy(a) for a in args[:5]) + (args[5],)
    jkw = dict(opt, k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    tkw = dict(opt, k_scale=None if ks is None else torch.from_numpy(ks),
               v_scale=None if vs is None else torch.from_numpy(vs))
    got = pa.paged_attention_any(*targs, **tkw)
    assert got.dtype == torch.float32 and got.shape == targs[0].shape
    assert torch.isfinite(got).all()
    ref = np.asarray(jax_paged_ref(*jargs, **jkw))
    kern = np.asarray(jax_paged_flash(*jargs, interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=1e-5)


def test_gather_paged_kv_walks_the_tables():
    pool = torch.arange(5 * 4, dtype=torch.float32).reshape(5, 4, 1, 1)
    tables = torch.tensor([[3, 1], [0, 4]], dtype=torch.int32)
    got = pa.gather_paged_kv(pool, tables)[..., 0, 0]
    assert got.tolist() == [[12, 13, 14, 15, 4, 5, 6, 7],
                            [0, 1, 2, 3, 16, 17, 18, 19]]


def test_cpu_dispatch_never_touches_the_kernel_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CUDA kernel loader ran for a CPU tensor")

    monkeypatch.setattr(pa, "_kernel", boom)
    monkeypatch.setattr(cuda_build, "load_library", boom)
    monkeypatch.setattr(cuda_build, "build", boom)
    args, (ks, vs), opt = _inputs(CASES["int8_pools"])
    targs = tuple(torch.from_numpy(a) for a in args[:5]) + (args[5],)
    before = pa.launches
    pa.paged_attention_any(*targs, k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs), **opt)
    assert pa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper raises on what it cannot take; it never runs
    the plain version instead."""
    args, _, opt = _inputs(CASES["decode_mha"])
    targs = tuple(torch.from_numpy(a) for a in args[:5]) + (args[5],)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_flash_attention(*targs, **opt)
