"""LoRA merged at load (llama.cpp ``--lora``) on the port against the JAX
package, on the CPU.

``parse_lora_arg`` parses as the reference's; an adapter GGUF written by
either package is read by the other; merged weights are bit-equal to the
reference's ``apply_lora`` on the same GGUF at f32 and bf16 (the delta in
numpy f32, added to the weight's f32 values, cast back with round to
nearest even, on the host before placement). With the adapter, greedy
tokens are identical to the JAX ``Engine``'s on one stream and on the
slots, and f32 prefill logits agree within ``LOGIT_TOL`` 1e-4 (the port's
model-level tolerance, ``test_torch_model.py``). Two adapters at half scale
sum to one at full scale, a zero scale is the identity, the merge composes
with ``quant="int8"`` (the int8 packs of the merged weights equal the packs
of the host merge), a 1x2 CPU mesh merges before it shards and gives the
single device's greedy text, and every error path gives the reference's
text. ``GET /lora-adapters`` lists the adapters as the reference's does.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models import lora as jax_lora
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.serving import ChatServer as JaxChatServer
from distributed_llm_pipeline_tpu_torch.models import lora
from distributed_llm_pipeline_tpu_torch.models.convert import params_from_jax
from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig, SlotScheduler
from distributed_llm_pipeline_tpu_torch.serving import ChatServer

from .fixtures import make_spm_vocab, spm_metadata

LOGIT_TOL = 1e-4
PROMPT = "hello world once upon a time"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=64)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    root = tmp_path_factory.mktemp("lora")
    model = root / "base.gguf"
    write_model_gguf(model, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    rng = np.random.default_rng(7)
    r, D = 4, cfg.dim
    A = rng.standard_normal((r, D)).astype(np.float32) * 0.1   # [r, in]
    Bq = rng.standard_normal((cfg.n_heads * cfg.head_dim, r)).astype(np.float32) * 0.1
    Bg = rng.standard_normal((cfg.hidden_dim, r)).astype(np.float32) * 0.1
    Bo = rng.standard_normal((cfg.vocab_size, r)).astype(np.float32) * 0.1
    Ad = rng.standard_normal((r, cfg.hidden_dim)).astype(np.float32) * 0.1
    Bd = rng.standard_normal((D, r)).astype(np.float32) * 0.1
    tensors = {"blk.0.attn_q.weight": (A, Bq), "blk.1.ffn_gate.weight": (A, Bg),
               "blk.1.ffn_down.weight": (Ad, Bd)}
    if "lm_head" in params:
        tensors["output.weight"] = (A, Bo)
    adapter = lora.write_lora_gguf(root / "adapter.gguf", alpha=8.0, tensors=tensors)
    return model, adapter, cfg, (A, Bq), len(tensors)


def _port(model, **kw):
    kw.setdefault("dtype", torch.float32)
    return Engine(model, device="cpu", **kw)


def _jax(model, **kw):
    kw.setdefault("dtype", jnp.float32)
    return JaxEngine(model, **kw)


def _greedy(n=8):
    return dict(max_new_tokens=n, temperature=0.0, stop_on_eos=False)


def _text(engine, n=8) -> str:
    gen = GenerationConfig(**_greedy(n))
    return "".join(e.content for e in engine.generate(PROMPT, gen) if e.kind == "token")


@pytest.mark.parametrize("spec", ["a.gguf", "a.gguf=0.5", "weird=name.gguf=2",
                                  "x=y", "=3", "dir/a.gguf=-1.5e-1"])
def test_parse_lora_arg_matches_the_reference(spec):
    assert lora.parse_lora_arg(spec) == jax_lora.parse_lora_arg(spec)


def test_adapter_files_cross_the_packages(setup, tmp_path):
    """An adapter written by either package reads back in the other with
    the same alpha, pairs and factor bytes."""
    _, _, _, (A, Bq), _ = setup
    tensors = {"blk.0.attn_v.weight": (A, Bq[:16])}
    for write, read in ((lora.write_lora_gguf, jax_lora.read_adapter),
                        (jax_lora.write_lora_gguf, lora.read_adapter)):
        path = write(tmp_path / f"{write.__module__}.gguf", 2.5, tensors)
        reader, alpha, pairs = read(path)
        try:
            assert alpha == 2.5 and pairs == {"blk.0.attn_v.weight": (
                "blk.0.attn_v.weight.lora_a", "blk.0.attn_v.weight.lora_b")}
            np.testing.assert_array_equal(reader.tensor_f32(pairs["blk.0.attn_v.weight"][0]), A)
            np.testing.assert_array_equal(reader.tensor_f32(pairs["blk.0.attn_v.weight"][1]),
                                          Bq[:16])
        finally:
            reader.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_weights_are_bit_equal_to_the_reference(setup, dtype):
    model, adapter, _, _, n = setup
    ads = [(str(adapter), 0.75), (str(adapter), -0.5)]
    jeng = _jax(model, dtype=getattr(jnp, dtype), lora=ads)
    peng = _port(model, dtype=getattr(torch, dtype), lora=ads)
    assert peng.lora_adapters == jeng.lora_adapters == ads
    want = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    got = peng.model.state_dict()
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k].view(bits), w.view(bits)), k
    base = _port(model, dtype=getattr(torch, dtype)).model.state_dict()
    assert sum(not torch.equal(got[k], base[k]) for k in base) == n


def _param_state(engine) -> dict:
    return {k: v.detach().clone() for k, v in engine.model.state_dict().items()}


def test_greedy_tokens_and_logits_match_the_jax_engine(setup):
    model, adapter, _, _, n = setup
    ads = [(str(adapter), 1.5)]
    jeng, peng = _jax(model, lora=ads), _port(model, lora=ads)
    ids = peng.tokenizer.encode(PROMPT)
    jl, _ = jeng.prefill(ids, jeng.make_cache(), start=0)
    tl = peng.prefill(ids, peng.make_cache())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1] if np.asarray(jl).ndim == 3
                               else np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    want = jeng.generate_text(PROMPT, JaxGen(**_greedy()))
    assert _text(peng) == want
    base = _text(_port(model))
    assert base != want   # the adapter changed the text
    logs = [e.content for e in peng.generate(PROMPT, GenerationConfig(**_greedy(1)))
            if e.kind == "log"]
    assert f"lora adapter adapter.gguf: merged {n} tensors (alpha=8, scale=1.5)" in logs
    s = SlotScheduler(peng, n_slots=2, decode_chunk=4, kv_block=16)
    try:
        assert s.generate_text(PROMPT, GenerationConfig(**_greedy())) == want
    finally:
        s.close()


def test_two_adapters_sum_and_zero_scale_is_the_identity(setup):
    model, adapter, _, _, _ = setup
    half = _param_state(_port(model, lora=[(str(adapter), 0.25), (str(adapter), 0.25)]))
    whole = _param_state(_port(model, lora=[(str(adapter), 0.5)]))
    base = _param_state(_port(model))
    zero = _param_state(_port(model, lora=[(str(adapter), 0.0)]))
    for k in base:
        torch.testing.assert_close(half[k], whole[k], rtol=2e-5, atol=2e-5, msg=k)
        assert torch.equal(zero[k], base[k]), k


def test_merge_composes_with_int8(setup):
    """``quant="int8"`` packs the merged weights: every pack equals the
    pack of the host merge, and the greedy text is the JAX engine's at the
    same mode."""
    from distributed_llm_pipeline_tpu_torch.models.llama import quantize_params

    model, adapter, _, _, _ = setup
    ads = [(str(adapter), 1.0)]
    peng = _port(model, lora=ads, quant="int8")
    merged = _port(model, lora=ads)
    packs = quantize_params(dict(merged.model.state_dict()), merged.cfg, "int8")
    got = peng.model.state_dict()
    n = 0
    for k, p in packs.items():
        for f, t in (p.state_dict().items() if hasattr(p, "state_dict") else ()):
            assert torch.equal(got[f"{k}.{f}"], t), (k, f)
            n += 1
    assert n > 0
    want = _jax(model, lora=ads, quant="int8").generate_text(PROMPT, JaxGen(**_greedy()))
    assert _text(peng) == want


def test_a_mesh_merges_before_it_shards(setup):
    model, adapter, _, _, n = setup
    ads = [(str(adapter), 1.0)]
    want = _text(_port(model, lora=ads))
    eng = ShardedEngine(model, mesh_spec=MeshSpec.parse("1x2"), device="cpu",
                        dtype=torch.float32, lora=ads)
    try:
        assert eng.lora_adapters == ads
        assert _text(eng) == want
        logs = [e.content for e in eng._events_on_load]
        assert any(f"merged {n} tensors" in line for line in logs)
    finally:
        eng.close()


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def test_error_paths_give_the_reference_texts(setup, tmp_path):
    model, adapter, cfg, (A, Bq), _ = setup
    cases = {
        "norm_target": {"blk.0.attn_norm.weight": (A, Bq)},
        "wrong_shape": {"blk.0.ffn_down.weight": (A, Bq)},
        "far_layer": {f"blk.{cfg.n_layers}.attn_q.weight": (A, Bq)},
        "odd_name": {"blk.0.attn_q.bias": (A, Bq)},
        "rank_mismatch": {"blk.0.attn_q.weight": (A[:2], Bq)},
    }
    for name, tensors in cases.items():
        path = lora.write_lora_gguf(tmp_path / f"{name}.gguf", 1.0, tensors)
        want = _error(lambda: _jax(model, lora=[(str(path), 1.0)]))
        got = _error(lambda: _port(model, lora=[(str(path), 1.0)]))
        assert got == want and got.startswith("LoRAError"), name
    # not an adapter file; a lone lora_a; no model path
    half = tmp_path / "half.gguf"
    from distributed_llm_pipeline_tpu_torch.gguf.writer import GGUFWriter
    w = GGUFWriter(half)
    w.add("general.type", "adapter")
    w.add_tensor("blk.0.attn_q.weight.lora_a", A)
    w.write()
    for ads in ([(str(model), 1.0)], [(str(half), 1.0)]):
        want = _error(lambda: _jax(model, lora=ads))
        assert _error(lambda: _port(model, lora=ads)) == want
    ads = [(str(adapter), 1.0)]
    want = _error(lambda: JaxEngine(cfg=cfg, tokenizer=object(), lora=ads))
    assert want.startswith("ValueError: --lora needs a GGUF model path")
    assert _error(lambda: Engine(cfg=object(), tokenizer=object(), params={}, lora=ads,
                                 device="cpu")) == want
    # --lora with --quant native: refused when the settings are read
    from distributed_llm_pipeline_tpu.config import AppConfig as JaxConfig
    from distributed_llm_pipeline_tpu_torch.config import AppConfig

    want = _error(lambda: JaxConfig(lora=str(adapter), quant="native").validate())
    assert want.startswith("ValueError: --lora merges into dense weights")
    assert _error(lambda: AppConfig(lora=str(adapter), quant="native").validate()) == want
    spec = f"{adapter}=0.5, {adapter}"
    assert AppConfig(lora=spec).lora_adapters() == JaxConfig(lora=spec).lora_adapters()


def test_lora_adapters_route_matches_the_reference(setup):
    model, adapter, _, _, _ = setup
    ads = [(str(adapter), 0.5), (str(adapter), 0.25)]

    async def ask(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for body in (None, {"prompt": "hello", "n_predict": 4, "temperature": 0.0,
                                "lora": [{"id": 0, "scale": 2.0}]}):
                r = await (client.get("/lora-adapters") if body is None
                           else client.post("/completion", json=body))
                out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()

    want = asyncio.run(ask(JaxChatServer(_jax(model, lora=ads), JaxGen()).app))
    got = asyncio.run(ask(ChatServer(_port(model, lora=ads), GenerationConfig()).app))
    assert got[0] == want[0] and want[0][1] == [
        {"id": 0, "path": str(adapter), "scale": 0.5},
        {"id": 1, "path": str(adapter), "scale": 0.25}]
    assert got[1][0] == want[1][0] == 200
    assert got[1][1]["content"] == want[1][1]["content"]
