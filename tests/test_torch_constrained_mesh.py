"""Constrained decoding and the context shift on the port's pp × tp mesh
(``ShardedEngine``, ranks spawned as gloo processes on the CPU), in the
style of ``tests/test_torch_mesh.py``.

On a 2 × 2 mesh at f32, against the JAX package's pipelined
``ShardedEngine`` on a 2 × 2 mesh of the conftest's CPU devices, loaded from
the same GGUF: a JSON-mode request gives the JAX mesh's text, token count
and ``constraint_complete`` (the constrained path runs the mesh's prefill
and forward unchanged), and so does the port mesh's slot path; a
context-shift request runs past the 48-token context, each rank shifting
its own stage's layers and heads (the ``shift`` rank command), and gives
the JAX mesh's greedy text, token count and shift lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import ModelConfig as JaxConfig
from distributed_llm_pipeline_tpu.models import random_params, write_model_gguf
from distributed_llm_pipeline_tpu.parallel import MeshSpec as JaxMeshSpec
from distributed_llm_pipeline_tpu.parallel import ShardedEngine as JaxShardedEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine
from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig, SlotScheduler

from .fixtures import make_spm_vocab, spm_metadata
from .test_torch_constrained import JSON_PIECES

CTX = 48


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab(extra_pieces=JSON_PIECES)
    cfg = JaxConfig(vocab_size=len(vocab.tokens), max_seq_len=CTX, dim=64, n_layers=4,
                    n_heads=4, n_kv_heads=2, head_dim=16, hidden_dim=128)
    params = random_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "mesh_cs.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def engines(gguf_path):
    mesh = ShardedEngine(gguf_path, mesh_spec=MeshSpec.parse("2x2"), device="cpu",
                         dtype=torch.float32)
    try:
        yield mesh, JaxShardedEngine(gguf_path, mesh_spec=JaxMeshSpec(pp=2, tp=2),
                                     devices=jax.devices()[:4], dtype=jnp.float32)
    finally:
        mesh.close()


def _run(target, prompt, gen):
    events = list(target.generate(prompt, gen))
    assert events[-1].kind == "done", events[-1]
    shifts = [e.content for e in events if e.kind == "log" and "context shift" in e.content]
    return ("".join(e.content for e in events if e.kind == "token"), events[-1].data,
            shifts)


JSON = dict(json_mode=True, max_new_tokens=24, temperature=0.0, stop_on_eos=False)


def test_constrained_request_on_the_mesh(engines):
    mesh, ref = engines
    got = _run(mesh, "produce json:", GenerationConfig(**JSON))
    want = _run(ref, "produce json:", JaxGen(**JSON))
    assert got[0] == want[0] and got[0]
    for key in ("n_gen", "finish_reason", "constraint_complete"):
        assert got[1][key] == want[1][key], key
    s = SlotScheduler(mesh, n_slots=2)
    try:
        assert _run(s, "produce json:", GenerationConfig(**JSON))[0] == want[0]
    finally:
        s.close()


def test_shifted_request_on_the_mesh(engines):
    mesh, ref = engines
    kw = dict(max_new_tokens=90, temperature=0.0, stop_on_eos=False,
              context_shift=True, keep=3)
    got = _run(mesh, "hello world " * 4, GenerationConfig(**kw))
    want = _run(ref, "hello world " * 4, JaxGen(**kw))
    assert got[1]["n_gen"] == want[1]["n_gen"] == 90
    assert len(got[2]) >= 2 and got[2] == want[2]
    assert got[0] == want[0]
    assert mesh.model.broken is None
