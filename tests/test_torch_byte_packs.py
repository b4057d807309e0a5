"""The port's byte-code K-quant packs (the tp-shardable ``q4_k8``, ``q5_k`` and
``q6_k8`` of tp > 1 meshes) and the plain versions of their kernels against
the JAX package's.

- Packs, from dense weights and from raw GGUF blocks: every field equals the
  JAX field transposed to out-features-major, bit for bit, and the
  dequantized weights are equal.
- ``q5_k_matmul_plain`` against ``q5_k_matmul_pallas`` in interpret mode at
  f32, rtol/atol 2e-4 (``tests/test_quant_matmul.py``'s tolerance), on a
  whole weight and on a tp row shard whose D = 96 only 32 divides.
- The W8A8 plain version over each byte pack against ``gw8a8_matmul_pallas``
  in interpret mode on the same activations (``quantize_acts`` under
  ``jax.jit``, as the reference serves it), at activation groups 256 and 32.
- ``quant_matmul_plain`` against the JAX ``proj`` (Pallas impl) at M = 32
  and 33: W8A8 below the cutover, ``q5_k_matmul`` or the dense weight and
  one product above; and the launch counter each route names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.ops import kquant_matmul as jkq
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.gguf.quants import quant_q4_k, quant_q5_k, quant_q6_k
from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm
from distributed_llm_pipeline_tpu_torch.parallel.pipeline import shard_leaf

jax_quantize_acts = jax.jit(jqm.quantize_acts, static_argnums=1)

# kind: (GGUF encoder, packer name, JAX packer name, sub-block, code range)
KINDS = {"q4_k8": (quant_q4_k, "pack_q4_k8", 32, (0, 15)),
         "q5_k": (quant_q5_k, "pack_q5_k", 32, (0, 31)),
         "q6_k8": (quant_q6_k, "pack_q6_k8", 16, (-32, 31))}


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


def _j(fields):
    return {k: jnp.asarray(v) for k, v in fields.items()}


@pytest.mark.parametrize("source", ["dense", "gguf"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_byte_packs_equal_the_jax_packs(kind, source):
    w = _weight(512, 96, seed=2)
    jp, tp = _packs(kind, w, source)
    sub, (lo, hi) = KINDS[kind][2:]
    assert tp.kind == kind and tp.shape == (96, 512) and tp.sub == sub
    assert set(jp) == set(tp.fields)
    for f in tp.fields:
        want = _t(jp[f])
        got = getattr(tp, f)
        assert got.dtype == want.dtype and torch.equal(got, want), f
    codes = tp.codes_and_scales()[0]
    assert codes.min() >= lo and codes.max() <= hi and codes.max() > hi // 2
    wd = jkq.dequant_pack(_j(jp), jnp.float32)
    np.testing.assert_array_equal(tp.dequant(torch.float32).numpy(), np.asarray(wd).T)


def _row_shard(kind, jp, tp, n_shards, i):
    """Shard i of a row (contraction) split of both packs: the port's
    ``shard_leaf`` and the JAX fields sliced along their D axis."""
    sub = KINDS[kind][2]
    D = tp.shape[1]
    d = D // n_shards
    jshard = {f: (np.asarray(a)[i * d:(i + 1) * d] if a.shape[0] == D
                  else np.asarray(a)[i * d // sub:(i + 1) * d // sub])
              for f, a in jp.items()}
    return jshard, shard_leaf(tp, "row", n_shards, i, kind)


@pytest.mark.parametrize("case", ["whole", "row_shard"])
def test_q5_k_matmul_plain_matches_pallas(case):
    if case == "whole":
        jp, tp = _packs("q5_k", _weight(512, 256, seed=3))
        M = 40
    else:   # a tp row shard of D = 768 over 8 ranks: D = 96, only 32 divides it
        jp, tp = _packs("q5_k", _weight(768, 256, seed=4))
        jp, tp = _row_shard("q5_k", jp, tp, 8, 3)
        M = 40
    D = tp.shape[1]
    assert tp.shape == (256, D) and tp.group == (256 if D % 256 == 0 else 32)
    x = np.random.default_rng(5).normal(size=(M, D)).astype(np.float32)
    got = kq.q5_k_matmul_plain(torch.from_numpy(x), tp, torch.float32).numpy()
    f = _j(jp)
    want = jkq.q5_k_matmul_pallas(
        jnp.asarray(x), f["q5"], f["a"], f["b"],
        block_d=jqm.divisor_tile(D, (512, 384, 256, 128, 64), 32),
        block_f=256, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("D", [512, 96])
def test_w8a8_plain_matches_gw8a8_pallas(kind, D):
    w = _weight(512 if D == 512 else 768, 128, seed=6)
    jp, tp = _packs(kind, w)
    if D == 96:
        jp, tp = _row_shard(kind, jp, tp, 8, 5)
    group = 256 if D % 256 == 0 else 32
    assert tp.group == group
    x = np.random.default_rng(7).normal(size=(4, D)).astype(np.float32)
    got = qm.w8a8_plain(torch.from_numpy(x), tp, torch.float32).numpy()
    xq, xs = jax_quantize_acts(jnp.asarray(x), group)
    f = _j(jp)
    code, sc = f[tp.fields[0]], f[tp.fields[1]]
    off = f["b"] if "b" in f else None
    want = jqm.gw8a8_matmul_pallas(xq, xs, code, sc, off, sb=KINDS[kind][2],
                                   block_d=jqm.divisor_tile(D, (1024, 512, 256), 32),
                                   block_f=128, out_dtype=jnp.float32, interpret=True)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", list(KINDS))
def test_routes_match_the_jax_proj(kind, pallas):
    """M = 32 takes W8A8, M = 33 ``q5_k_matmul`` (q5_k) or the dense weight
    and one product (q4_k8, q6_k8), in both packages; each route names its
    launch counter."""
    jp, tp = _packs(kind, _weight(256, 128, seed=8))
    for M in (32, 33):
        x = np.random.default_rng(M).normal(size=(1, M, 256)).astype(np.float32)
        got = qm.quant_matmul_plain(torch.from_numpy(x), tp, torch.float32).numpy()
        want = np.asarray(jqm.proj(jnp.asarray(x), _j(jp), out_dtype=jnp.float32))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)
    assert qm.route(kind, 32) == f"{kind}_w8a8_matmul"
    assert qm.route(kind, 33) == ("q5_k_matmul" if kind == "q5_k" else None)
