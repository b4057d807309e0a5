"""The port's fused decode step (``ops/fused_decode.py``) against the JAX
package's, on the CPU at f32.

- ``fused_decode_plain`` (the unfused composition the CUDA kernel is held
  to on the card) against the reference's oracle ``fused_decode_ref``
  (jitted, so its W8A8 activation scales round as the port's do) on every
  combination of dense or q8_0 weights, f32 or q8_0 pools, global or
  windowed attention, with or without softcap: y within atol 2e-5, the new
  token's K/V within 1e-6 (its int8 codes equal on a q8_0 pool).
- Against the reference's Pallas kernel in interpret mode: dense weights
  within 2e-5; q8_0 weights within 2e-3, the reference's own bound (its
  kernel multiplies dequantized weights, the composition runs W8A8).
- ``fused_supported`` answers as the reference on the reference's support
  matrix, except where the CUDA kernel's own limits differ (its shared
  memory against the TPU's VMEM, head dims above 256), and every reason's
  family is declared in ``runtime/capabilities.DEGRADE_REASONS``.
- A fused SlotScheduler gives the reference's fused scheduler's greedy
  tokens and runs the fused route; fused plus latent KV, or a config the
  kernel cannot take, logs its reason once and decodes unfused.
"""

import dataclasses

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
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu_torch.models import (PRESETS, LlamaModel, ModelConfig,
                                                       PagedKVCache, params_from_jax)
from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd
from distributed_llm_pipeline_tpu_torch.runtime import capabilities

from .fixtures import make_spm_vocab, spm_metadata

B, BS, NT = 3, 16, 8
LENGTHS = [5, 37, 100]   # mid-block, straddling a block edge, long


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _setup(w_quant=False, kv_quant=False, window=False, softcap=False, seed=0):
    """One layer's inputs in both packages: the reference's layer params and
    pools, and the port's block (layer 0 of a model over the same weights)
    and pools."""
    cfg = JAX_PRESETS["tiny"].replace(max_seq_len=BS * NT,
                                      sliding_window=16 if window else 0,
                                      attn_softcap=30.0 if softcap else 0.0)
    params = random_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if w_quant:
        params = jax_quantize_params(params, cfg, "q8_0")
    lp = {k: ({f: a[0] for f, a in v.items()} if isinstance(v, dict) else v[0])
          for k, v in params["layers"].items()}
    rng = np.random.default_rng(seed)
    K, Hd = cfg.n_kv_heads, cfg.head_dim
    kp = rng.standard_normal((B * NT + 1, BS, K, Hd)).astype(np.float32)
    vp = rng.standard_normal((B * NT + 1, BS, K, Hd)).astype(np.float32)
    tables = (1 + np.arange(B * NT, dtype=np.int32)).reshape(B, NT)
    lengths = np.asarray(LENGTHS, np.int32)
    x = rng.standard_normal((B, 1, cfg.dim)).astype(np.float32)
    cos, sin = (np.asarray(t) for t in jax_rope_freqs(cfg, jnp.asarray(lengths)[:, None]))
    ks = vs = None
    if kv_quant:
        (kp, ks), (vp, vs) = ((np.asarray(a) for a in jax_kv_quantize(jnp.asarray(p)))
                              for p in (kp, vp))
    ref = dict(cfg=cfg, lp=lp, kp=kp, vp=vp, ks=ks, vs=vs, tables=tables,
               lengths=lengths, x=x, cos=cos, sin=sin)
    model = LlamaModel(_port_cfg(cfg), params_from_jax(jax.tree.map(np.asarray, params)))
    block = model.layers[0]
    assert block.window == (16 if window else 0)
    return ref, block


def _port_plain(ref, block):
    pools = [None if a is None else _t(a) for a in (ref["kp"], ref["vp"], ref["ks"], ref["vs"])]
    y, kn, vn = fd.fused_decode_plain(
        _t(ref["x"][:, 0]), block, _t(ref["cos"][:, 0]), _t(ref["sin"][:, 0]),
        pools[0], pools[1], _t(ref["tables"]), _t(ref["lengths"]),
        k_scale=pools[2], v_scale=pools[3])
    return y, kn, vn, pools


_ref_jit = jax.jit(jax_fd.fused_decode_ref, static_argnums=(8,))


@pytest.fixture(scope="module")
def pallas_impl():
    """The reference's q8_0 projections through its W8A8 Pallas kernel (in
    interpret mode), the route the port's composition takes at M <= 32; its
    default CPU route multiplies dequantized weights. Setting the impl
    clears JAX's caches, so it is set once for the module."""
    jqm.set_quant_matmul_impl("pallas")
    try:
        yield
    finally:
        jqm.set_quant_matmul_impl("auto")


@pytest.mark.parametrize("softcap", [False, True], ids=["nocap", "softcap"])
@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32_pool", "q8_0_pool"])
@pytest.mark.parametrize("w_quant", [False, True], ids=["dense_w", "q8_0_w"])
def test_fused_plain_matches_reference_oracle(w_quant, kv_quant, window, softcap,
                                              request):
    if w_quant:
        request.getfixturevalue("pallas_impl")
    ref, block = _setup(w_quant, kv_quant, window, softcap)
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in ref.items()
         if k not in ("cfg", "lp")}
    yref, nk, nv, nks, nvs = _ref_jit(j["x"], ref["lp"], j["kp"], j["vp"], j["cos"],
                                      j["sin"], j["tables"], j["lengths"], ref["cfg"],
                                      j["ks"], j["vs"])
    y, kn, vn, pools = _port_plain(ref, block)
    np.testing.assert_allclose(y.numpy(), np.asarray(yref)[:, 0], rtol=0, atol=2e-5)
    for b, ln in enumerate(LENGTHS):
        blk, off = ref["tables"][b, ln // BS], ln % BS
        if kv_quant:   # the pools hold the same codes, scales to f32 rounding
            for got, want in zip(pools, (nk, nv, nks, nvs)):
                g, w = got[blk, off].numpy(), np.asarray(want)[blk, off]
                if g.dtype == np.int8:
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(kn[b].numpy(), np.asarray(nk)[blk, off],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(vn[b].numpy(), np.asarray(nv)[blk, off],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("w_quant,atol", [(False, 2e-5), (True, 2e-3)],
                         ids=["dense_w", "q8_0_w"])
def test_fused_plain_matches_the_pallas_kernel(w_quant, atol):
    ref, block = _setup(w_quant, window=True)
    lp, cfg = ref["lp"], ref["cfg"]
    j = {k: jnp.asarray(v) for k, v in ref.items()
         if k not in ("cfg", "lp", "ks", "vs")}
    y, kn, vn = jax_fd.fused_decode_attn(
        j["x"][:, 0], lp["wq"], lp["wk"], lp["wv"], lp["wo"], lp["attn_norm"],
        j["cos"][:, 0], j["sin"][:, 0], j["kp"], j["vp"], j["tables"], j["lengths"],
        n_rep=cfg.n_heads // cfg.n_kv_heads, rope_style=cfg.rope_style,
        norm_eps=cfg.norm_eps, scale=cfg.attn_scale, softcap=cfg.attn_softcap,
        window=lp.get("swa"), interpret=True)
    got_y, got_k, got_v, _ = _port_plain(ref, block)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), rtol=0, atol=atol)
    # the new K/V come straight out of a projection, without the O-proj and
    # residual that average W8A8's activation rounding (up to half an int8
    # code of h per element) in y: with q8_0 weights they differ by up to
    # 2.9e-3 on these inputs, held at 5e-3
    kv_atol = atol if not w_quant else 5e-3
    np.testing.assert_allclose(got_k.numpy(), np.asarray(kn), rtol=0, atol=kv_atol)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(vn), rtol=0, atol=kv_atol)


def _support_cases():
    tiny = JAX_PRESETS["tiny"]
    return [(tiny, {}), (tiny, {"weight_kind": "q8_0"}),
            (tiny.replace(norm_type="layer"), {}), (tiny.replace(qk_norm=True), {}),
            (tiny.replace(attn_bias=True), {}), (tiny.replace(post_norms=True), {}),
            (tiny.replace(pre_norms=False), {}), (tiny, {"weight_kind": "q4_k"}),
            (tiny.replace(n_kv_heads=4), {"weight_kind": "q8_0"}),
            (tiny.replace(n_kv_heads=4), {}), (tiny.replace(sliding_window=16), {}),
            (tiny.replace(attn_softcap=30.0), {}), (tiny.replace(norm_offset=1.0), {}),
            (tiny.replace(rope_style="neox"), {}), (tiny.replace(head_dim=12), {}),
            (tiny.replace(n_kv_heads=3), {}), (JAX_PRESETS["llama3.2-1b"], {}),
            (JAX_PRESETS["llama3.2-1b"], {"weight_kind": "q8_0"})]


@pytest.mark.parametrize("i", range(len(_support_cases())))
def test_fused_supported_answers_as_the_reference(i):
    cfg, kw = _support_cases()[i]
    got = fd.fused_supported(_port_cfg(cfg), **kw)
    assert got == jax_fd.fused_supported(cfg, **kw)
    if got is not None:
        capabilities.check_reason(got)


def test_fused_supported_kernel_limits():
    """Where the CUDA kernel's limits are not the TPU's: a 70B-class
    geometry fits its shared memory at one row (the reference's VMEM
    estimate of the weight tiles refuses it) but not at 64; head dims above
    256 are refused."""
    for big, kw in ((JAX_PRESETS["llama3-70b"], {}),
                    (JAX_PRESETS["llama3-8b"], {"weight_kind": "q8_0"})):
        assert jax_fd.fused_supported(big, **kw).startswith("vmem:")
        assert fd.fused_supported(_port_cfg(big), **kw) is None
    big = JAX_PRESETS["llama3-70b"]
    reason = fd.fused_supported(_port_cfg(big), batch=64)
    assert reason.startswith("vmem:") and capabilities.check_reason(reason)
    assert fd.fused_supported(PRESETS["tiny"].replace(head_dim=512)) == "head-dim:512"
    assert fd.fused_smem_bytes(4, 2048, 64, 4) < fd.SMEM_LIMIT_BYTES
    assert fd.decode_hbm_bytes(PRESETS["tiny"], 100) == jax_fd.decode_hbm_bytes(
        JAX_PRESETS["tiny"], 100)
    assert fd.decode_hbm_bytes(PRESETS["tiny"], 100, fused=True) \
        < fd.decode_hbm_bytes(PRESETS["tiny"], 100, fused=False)


def test_forward_paged_fused_equals_unfused():
    """On the CPU the fused route is the unfused composition: a prefill,
    then decode steps across a block edge, bit-equal logits and pools."""
    ref, _ = _setup()
    cfg = _port_cfg(ref["cfg"])
    params = params_from_jax(jax.tree.map(np.asarray, random_params(
        ref["cfg"], jax.random.PRNGKey(0), dtype=jnp.float32)))
    model = LlamaModel(cfg, params)
    pools = []
    for _ in range(2):
        p = PagedKVCache.zeros(cfg, 2 * NT + 2, BS, 2, NT, dtype=torch.float32)
        p.tables = (1 + torch.arange(2 * NT, dtype=torch.int32)).reshape(2, NT)
        model.forward_paged(torch.arange(1, 14).repeat(2, 1), p)
        pools.append(p)
    for i in range(5):
        t = torch.tensor([[3 + i], [9 + i]])
        a = model.forward_paged(t, pools[0], fused=True)
        b = model.forward_paged(t, pools[1])
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(pools[0].k, pools[1].k, rtol=0, atol=0)
    assert model.fused_forwards == 5


def _engines(monkeypatch, cfg, env):
    """The reference's and the port's engine over the same f32 weights, with
    ``env`` set when each is built."""
    from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
    from distributed_llm_pipeline_tpu.tokenizer import tokenizer_from_metadata as jax_tok
    from distributed_llm_pipeline_tpu_torch.runtime import Engine
    from distributed_llm_pipeline_tpu_torch.tokenizer import tokenizer_from_metadata

    for k in ("DLP_FUSED_DECODE", "DLP_KV_LATENT", "DLP_KV_LATENT_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    meta = spm_metadata(make_spm_vocab())
    cfg = cfg.replace(vocab_size=len(make_spm_vocab().tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    ref = JaxEngine(cfg=cfg, tokenizer=jax_tok(meta), params=params, dtype=jnp.float32)
    port = Engine(cfg=_port_cfg(cfg), tokenizer=tokenizer_from_metadata(meta),
                  params=params_from_jax(jax.tree.map(np.asarray, params)),
                  dtype=torch.float32, device="cpu")
    return ref, port


def test_fused_scheduler_greedy_matches_the_reference(monkeypatch):
    from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
    from distributed_llm_pipeline_tpu.runtime.engine import GenerationConfig as JaxGen
    from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig, SlotScheduler

    ref, port = _engines(monkeypatch, JAX_PRESETS["tiny"], {"DLP_FUSED_DECODE": "1"})
    calls = []
    plain = fd.fused_decode_plain
    monkeypatch.setattr(fd, "fused_decode_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = {}
    for name, eng, sched_cls, gen_cls in (("ref", ref, JaxSlotScheduler, JaxGen),
                                          ("port", port, SlotScheduler, GenerationConfig)):
        sched = sched_cls(eng, n_slots=2, decode_chunk=4)
        try:
            out[name] = sched.generate_text("the quick brown fox", gen_cls(
                max_new_tokens=10, temperature=0.0, stop_on_eos=False))
            if name == "port":
                assert sched.fused_decode is True
        finally:
            sched.close()
    assert out["port"] == out["ref"] and out["port"]
    # every decode step (a chunk runs ahead of the readback) through each layer
    assert len(calls) >= 9 * port.cfg.n_layers
    assert len(calls) == port.model.fused_forwards * port.cfg.n_layers
    assert sum("fused decode-step kernel active" in e.content
               for e in port._events_on_load) == 1


@pytest.mark.parametrize("cfg_kw,env,reason", [
    ({}, {"DLP_FUSED_DECODE": "1", "DLP_KV_LATENT": "1"}, "latent-kv"),
    ({"qk_norm": True}, {"DLP_FUSED_DECODE": "1"}, "qk-norm")], ids=["latent", "qk_norm"])
def test_fused_fallback_logs_its_reason_once_and_decodes_unfused(monkeypatch, cfg_kw,
                                                                  env, reason):
    from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig, SlotScheduler

    _, port = _engines(monkeypatch, JAX_PRESETS["tiny"].replace(**cfg_kw), env)
    assert port.kv_mode == ("latent" if "DLP_KV_LATENT" in env else "dense")
    monkeypatch.setattr(fd, "fused_decode_plain", None)   # must not be reached
    sched = SlotScheduler(port, n_slots=2, decode_chunk=4)
    try:
        assert sched.fused_decode is False
        assert sched.generate_text("hello", GenerationConfig(
            max_new_tokens=4, temperature=0.0, stop_on_eos=False))
        SlotScheduler(port, n_slots=2, decode_chunk=4).close()   # resolved once
    finally:
        sched.close()
    logs = [e.content for e in port._events_on_load if "falling back" in e.content]
    assert len(logs) == 1 and logs[0].endswith(reason)
