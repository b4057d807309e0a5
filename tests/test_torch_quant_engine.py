"""The port's Engine and server over quantized weights against the JAX
package's.

- Engine: the port's Engine against the JAX Engine at f32 on the CPU (the
  JAX quantized matmuls through their Pallas kernels in interpret mode),
  greedy tokens identical, for ``int8``, ``q8_0``, ``q2_k``, ``q3_k``,
  ``q4_k``, ``q5_k``, ``q6_k`` and ``native`` over GGUFs the JAX exporter
  wrote with Q8_0, Q2_K, Q3_K, Q4_K, Q5_K and Q6_K projections, and over a
  GGUF with llama.cpp's Q4_K_M mix (its attn_v and ffn_down stacks mix Q4_K
  and Q6_K over the layers, so both packages load them dense). The native
  packs equal the JAX ``native_quant_layers`` packs field by field; an
  unknown mode is a ``ValueError``.
- Server: ``ChatServer`` over a quantized CPU engine answers ``/chat`` with
  ``parallel`` 1 and 2; the server's own ``main`` with ``--quant q2_k
  --cpu`` builds one that answers ``/chat``.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.gguf import GGMLType as JaxGGMLType
from distributed_llm_pipeline_tpu.gguf import GGUFReader as JaxReader
from distributed_llm_pipeline_tpu.models import random_params, write_model_gguf
from distributed_llm_pipeline_tpu.models.convert import native_quant_layers as jax_native
from distributed_llm_pipeline_tpu.ops import quant_matmul as jqm
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from chip_smoke import q4_k_m_types, write_model
from distributed_llm_pipeline_tpu_torch.gguf import GGUFReader
from distributed_llm_pipeline_tpu_torch.models import ModelConfig, params_from_jax
from distributed_llm_pipeline_tpu_torch.models.convert import native_quant_layers
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.serving.server import main as server_main

from .fixtures import make_spm_vocab, spm_metadata
from .test_torch_quant_model import CFG


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


def _gguf(tmp_path_factory, quant, name):
    vocab = make_spm_vocab()
    cfg = CFG.replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / name
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab), quant=quant)
    return path


@pytest.fixture(scope="module")
def f32_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.F32, "f32.gguf")


@pytest.fixture(scope="module")
def q8_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.Q8_0, "q8_0.gguf")


@pytest.fixture(scope="module")
def q6_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.Q6_K, "q6_k.gguf")


@pytest.fixture(scope="module")
def q4_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.Q4_K, "q4_k.gguf")


@pytest.fixture(scope="module")
def q5_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.Q5_K, "q5_k.gguf")


@pytest.fixture(scope="module")
def q2_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.Q2_K, "q2_k.gguf")


@pytest.fixture(scope="module")
def q3_gguf(tmp_path_factory):
    return _gguf(tmp_path_factory, JaxGGMLType.Q3_K, "q3_k.gguf")


@pytest.fixture(scope="module")
def q4km_gguf(tmp_path_factory):
    """llama.cpp's Q4_K_M assignment over 2 layers: attn_v and ffn_down in
    Q6_K on layer 1 (``use_more_bits``) and Q4_K on layer 0, the other
    projections Q4_K, token_embd Q6_K (the writer chip_smoke.py serves)."""
    cfg = ModelConfig(**dataclasses.asdict(CFG)).replace(vocab_size=320, max_seq_len=128)
    path = tmp_path_factory.mktemp("models") / "q4_k_m.gguf"
    write_model(path, cfg, 0, device="cpu", wtype=q4_k_m_types(cfg.n_layers))
    return path


def _greedy(engine, gen_cls, n=8):
    events = list(engine.generate("hello world once upon a time",
                                  gen_cls(temperature=0.0, max_new_tokens=n)))
    assert events[-1].kind == "done"
    return "".join(e.content for e in events if e.kind == "token"), events[-1].data


@pytest.mark.parametrize("quant,gguf", [
    ("q8_0", "f32_gguf"), ("q6_k", "f32_gguf"), ("native", "q8_gguf"),
    ("native", "q6_gguf"), ("q4_k", "f32_gguf"), ("q5_k", "f32_gguf"),
    ("native", "q4_gguf"), ("native", "q5_gguf"), ("native", "q4km_gguf"),
    ("int8", "f32_gguf"), ("q2_k", "f32_gguf"), ("q3_k", "f32_gguf"),
    ("native", "q2_gguf"), ("native", "q3_gguf")])
def test_engine_greedy_matches_jax_engine(quant, gguf, request, pallas):
    path = request.getfixturevalue(gguf)
    ours = Engine(path, dtype=torch.float32, device="cpu", quant=quant)
    ref = JaxEngine(path, dtype=jnp.float32, quant=quant)
    assert ours.quant == quant
    assert any(f"({quant})" in e.content for e in ours._events_on_load)
    text, done = _greedy(ours, GenerationConfig)
    want, jdone = _greedy(ref, JaxGen)
    assert text == want and done["n_gen"] == jdone["n_gen"] == 8


@pytest.mark.parametrize("gguf,kinds", [
    ("q8_gguf", {"q8_0"}), ("q6_gguf", {"q6_k"}), ("q4_gguf", {"q4_k"}),
    ("q5_gguf", {"q5_ks"}), ("q4km_gguf", {"q4_k"}), ("q2_gguf", {"q2_ks"}),
    ("q3_gguf", {"q3_ks"})])
def test_native_packs_equal_jax_native_packs(gguf, kinds, request):
    """Uniform stacks pack in both packages; the Q4_K_M mix's attn_v and
    ffn_down stacks (Q4_K on one layer, Q6_K on the other) load dense in
    both."""
    path = request.getfixturevalue(gguf)
    with GGUFReader(path) as r:
        cfg = ModelConfig.from_gguf_metadata(r.metadata)
        ours = native_quant_layers(r, cfg)
    want = params_from_jax({"layers": jax_native(JaxReader(path), cfg)})
    leaves = {k.rsplit(".", 1)[1] for k in ours}
    mixed = {"wv", "w_down"} if gguf == "q4km_gguf" else set()
    assert leaves == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"} - mixed
    assert set(ours) == set(want) and len(ours) == len(leaves) * cfg.n_layers
    assert {p.kind for p in ours.values()} == kinds
    for key, w in want.items():
        assert type(ours[key]) is type(w), key
        for f in w.fields:
            assert torch.equal(getattr(ours[key], f), getattr(w, f)), (key, f)


def test_native_needs_quantized_stacks(f32_gguf):
    with pytest.raises(ValueError, match="Q8_0, Q4_K, Q5_K or Q6_K"):
        Engine(f32_gguf, dtype=torch.float32, device="cpu", quant="native")


@pytest.mark.parametrize("quant", ["q4_0", "int4", "q8_k"])
def test_unknown_quant_mode_is_a_value_error(quant, f32_gguf, capsys):
    with pytest.raises(ValueError, match=f"unsupported quant mode '{quant}'"):
        Engine(f32_gguf, dtype=torch.float32, device="cpu", quant=quant)
    with pytest.raises(SystemExit) as exc:      # argparse refuses it first
        server_main(["--model", str(f32_gguf), "--cpu", "--quant", quant])
    assert exc.value.code == 2 and "invalid choice" in capsys.readouterr().err


def _chat(app, body):
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/chat", json=body)
            assert resp.status == 200
            return (await resp.read()).decode()
        finally:
            await client.close()

    text = asyncio.run(go())
    return [json.loads(line[6:]) for line in text.split("\n")
            if line.startswith("data: ")]


@pytest.mark.parametrize("parallel", [1, 2])
def test_chat_over_a_quantized_engine(parallel, q6_gguf):
    engine = Engine(q6_gguf, dtype=torch.float32, device="cpu", quant="native")
    server = ChatServer(engine, GenerationConfig(temperature=0.0), parallel=parallel)
    events = _chat(server.app, {"prompt": "hello world", "max_new_tokens": 5})
    assert {e["msg_type"] for e in events} == {"log", "token"}
    assert any("native weights" in e["content"] for e in events
               if e["msg_type"] == "log")
    assert events[-1]["finish_reason"] == "length" and events[-1]["n_gen"] == 5
    if server.scheduler is not None:
        server.scheduler.close()


@pytest.mark.parametrize("parallel", [1, 2])
def test_server_main_serves_quant_q2_k(parallel, f32_gguf, monkeypatch):
    """``--quant q2_k --cpu`` through the server's own ``main``: the app it
    would run answers ``/chat`` from a q2_k engine."""
    from distributed_llm_pipeline_tpu_torch.serving import server as srv

    apps = []
    monkeypatch.setattr(srv.web, "run_app", lambda app, **kw: apps.append(app))
    server_main(["--model", str(f32_gguf), "--cpu", "--quant", "q2_k",
                 "--parallel", str(parallel), "--n-predict", "4"])
    events = _chat(apps[0], {"prompt": "hello world", "temperature": 0.0})
    assert any("(q2_k)" in e["content"] for e in events if e["msg_type"] == "log")
    assert events[-1]["finish_reason"] == "length" and events[-1]["n_gen"] == 4
