"""The port's capability lattice (``runtime/capabilities.py``) against the
JAX package's, on the CPU.

The declared tables are the reference's; ``resolve`` / ``classify`` give the
reference's answer for every cell of ``enumerate_cells()`` (the same status,
resolved cell, degradations and refusal reason and text), with and without
explicit axes, and count the same degradations on ``/metrics``;
``resolve_boot`` resolves the same boot cells under ``DLP_KV_LATENT``. The
engine's boot and its fused-decode answer go through the lattice: a latent
pool's fused request degrades with the reference's counters, and the mesh
keeps its own refusal of latent KV (the lattice serves the cell, the port
has not ported it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_pipeline_tpu.runtime.capabilities as ref
import distributed_llm_pipeline_tpu.utils.metrics as ref_metrics
from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine
from distributed_llm_pipeline_tpu_torch.runtime import Engine
from distributed_llm_pipeline_tpu_torch.runtime import capabilities as caps
from distributed_llm_pipeline_tpu_torch.utils import metrics

from .fixtures import make_spm_vocab, spm_metadata

CELLS = list(ref.enumerate_cells())


def _res(res) -> dict | None:
    return None if res is None else {
        "requested": res.requested, "features": res.features, "cell": res.cell,
        "status": res.status,
        "degradations": [dataclasses.asdict(d) for d in res.degradations]}


def _outcome(mod, cell, explicit=frozenset()):
    try:
        return ("ok", _res(mod.resolve(cell, explicit=explicit)))
    except mod.CapabilityError as e:
        return ("refused", e.reason, str(e), isinstance(e, NotImplementedError))


def test_the_declared_tables_are_the_reference_s():
    for name in ("AXES", "RUNTIME_VOCAB", "LATTICE", "PARITY_AXES", "DEGRADE_REASONS",
                 "REJECT_REASONS", "REJECT_MESSAGES", "CAPABILITY_ENVS", "DEGRADE_LOG"):
        assert getattr(caps, name) == getattr(ref, name), name
    assert list(caps.enumerate_cells()) == CELLS
    assert len(CELLS) == 2 * 4 * 2 * 5 * 3


def test_every_cell_classifies_as_the_reference():
    seen = set()
    for cell in CELLS:
        got, want = caps.classify(cell), ref.classify(cell)
        assert (got[0], _res(got[1]), got[2]) == (want[0], _res(want[1]), want[2]), cell
        assert caps.cpu_reachable(cell) == ref.cpu_reachable(cell), cell
        assert caps.cell_label(cell) == ref.cell_label(cell)
        seen.add(got[0])
    assert seen == {"supported", "degrades", "rejected"}


@pytest.mark.parametrize("explicit", [frozenset(), frozenset({"decode"}),
                                      frozenset({"kv_repr"}),
                                      frozenset({"decode", "kv_layout"})],
                         ids=lambda e: "+".join(sorted(e)) or "none")
def test_every_cell_resolves_as_the_reference(explicit):
    for cell in CELLS:
        assert _outcome(caps, cell, explicit) == _outcome(ref, cell, explicit), cell


def test_degradations_count_the_reference_series():
    got, want = metrics.Metrics(), ref_metrics.Metrics()
    for cell in CELLS:
        for mod, m in ((caps, got), (ref, want)):
            try:
                mod.resolve(cell, metrics=m)
            except mod.CapabilityError:
                pass
    assert got.snapshot()["counters"] == want.snapshot()["counters"]
    assert got.snapshot()["counters"]["capability_degradations_total"] > 0


@pytest.mark.parametrize("env", ["0", "1"])
def test_resolve_boot_matches_the_reference(monkeypatch, env):
    monkeypatch.setenv("DLP_KV_LATENT", env)
    for backend in ("engine", "mesh", "ring", "dense-slots"):
        for kv_mode in (None, "dense", "latent"):
            for kv_quant in (None, "q8_0"):
                kw = dict(kv_mode=kv_mode, kv_quant=kv_quant, backend=backend)
                g_mode, g_res = caps.resolve_boot(**kw)
                w_mode, w_res = ref.resolve_boot(**kw)
                assert (g_mode, _res(g_res)) == (w_mode, _res(w_res)), kw


def test_reasons_and_labels_match():
    for reason in ("latent-kv", "vmem:28MiB", "weight-pack:q4_k"):
        assert caps.reason_family(reason) == ref.reason_family(reason)
        assert caps.check_reason(reason) == ref.check_reason(reason)
    for bad in ("made-up", "multichip-dense-kv"):
        with pytest.raises(ValueError):
            caps.check_reason(bad)
    for kv_quant in (None, "q8_0"):
        for kv_mode in ("dense", "latent"):
            label = caps.kv_repr_label(kv_quant, kv_mode)
            assert label == ref.kv_repr_label(kv_quant, kv_mode)
            assert caps.repr_kv_mode(label) == ref.repr_kv_mode(label) == kv_mode


# -- the boot paths that route through the lattice ------------------------------


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=64)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "caps.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


def test_engine_boot_and_fused_decode_resolve_on_the_lattice(gguf_path, monkeypatch):
    monkeypatch.setenv("DLP_KV_LATENT", "1")
    monkeypatch.setenv("DLP_FUSED_DECODE", "1")
    port = Engine(gguf_path, dtype=torch.float32, device="cpu")
    jax_engine = JaxEngine(gguf_path, dtype=jnp.float32)
    assert port.kv_mode == jax_engine.kv_mode == "latent"
    assert port.capability_resolution.cell == jax_engine.capability_resolution.cell
    assert port.capability_resolution.status == "supported"
    assert port.resolve_fused_decode(16, 2) is jax_engine.resolve_fused_decode(16, 2) is False

    def degrades(m) -> dict:
        return {k: v for k, v in m.snapshot()["counters"].items()
                if k.startswith(("capability_degradations_total",
                                 "fused_decode_fallbacks_total"))}

    assert degrades(port.metrics) == degrades(jax_engine.metrics)
    assert degrades(port.metrics)[
        'capability_degradations_total{axis="decode",reason="latent-kv"}'] == 1
    # an explicit kv_mode pins the representation: the lattice serves it
    assert Engine(gguf_path, dtype=torch.float32, device="cpu",
                  kv_mode="dense").capability_resolution.cell == \
        "dense/bf16/unfused/engine/both"


def test_the_mesh_keeps_its_refusal_of_latent_kv(gguf_path, monkeypatch):
    """The lattice serves latent KV on a mesh (the reference's TPLA); the
    port has not ported it and refuses the resolved cell, explicit or by
    the env default, with its own text, before any rank starts."""
    assert caps.classify({"kv_layout": "dense", "kv_repr": "latent",
                          "decode": "unfused", "backend": "mesh",
                          "role": "both"})[0] == "supported"
    with pytest.raises(NotImplementedError, match="latent KV .TPLA. on a mesh is not ported"):
        ShardedEngine(gguf_path, mesh_spec=MeshSpec.parse("1x2"), device="cpu",
                      kv_mode="latent")
    monkeypatch.setenv("DLP_KV_LATENT", "1")
    with pytest.raises(NotImplementedError, match="latent KV .TPLA. on a mesh is not ported"):
        ShardedEngine(gguf_path, mesh_spec=MeshSpec.parse("1x2"), device="cpu")
    assert ShardedEngine.capability_backend == "mesh"
    assert Engine.capability_backend == "engine"
