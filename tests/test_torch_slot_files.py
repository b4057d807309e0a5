"""The port's slot files (``SlotScheduler.save_slot`` / ``erase_slot`` /
``restore_slot`` over the paged pool: ``PagedSlotBackend.gather``,
``adopt_row``, ``row_cache``) against the JAX package's ``SlotScheduler``, on
the CPU at f32, on one fixture GGUF written by the JAX exporter.

- Save after a request, erase, restore: the reference's token counts, and
  the next request that extends the restored row prefills only its suffix
  (the reference's reuse count) and gives the reference's text, which is
  also the text of the same request on the row before it was erased; on
  the dense and the int8 (q8_0) pool.
- Slot files cross the packages both ways, and are session files: a port
  slot file loads as a port or reference engine session, and an engine's
  session restores into a slot.
- Refusals match the reference's: a slot id out of range, nothing to save,
  a file of another KV layout.
- On a mesh, the slot files, sessions, embeddings, perplexity and batches
  are refused with a 400 (or an error) that names them.
"""

import asyncio
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime import SlotScheduler as JaxSlotScheduler
from distributed_llm_pipeline_tpu_torch.runtime import (Engine, GenerationConfig,
                                                        SlotScheduler)

from .fixtures import make_spm_vocab, spm_metadata

KW = dict(n_slots=3, decode_chunk=4, prefill_chunk=16)
N = 6
# mode → (engine options, pool block size: int8 pools take 32 and up)
MODES = {"dense": ({}, 16), "int8": ({"kv_quant": "q8_0"}, 32)}


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(9), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "slotfiles.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def scheds(gguf_path):
    """mode → (JAX scheduler, port scheduler), made on first use."""
    made = {}

    def get(mode: str):
        if mode not in made:
            kw, bs = MODES[mode]
            made[mode] = (
                JaxSlotScheduler(JaxEngine(gguf_path, dtype=jnp.float32, **kw),
                                 kv_block=bs, **KW),
                SlotScheduler(Engine(gguf_path, dtype=torch.float32, device="cpu", **kw),
                              kv_block=bs, **KW))
        return made[mode]

    yield get
    for pair in made.values():
        for s in pair:
            s.close()


def _ids(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(5, 250, size=n)]


def _gen(sched, n=N):
    cls = GenerationConfig if isinstance(sched, SlotScheduler) else JaxGen
    return cls(temperature=0.0, max_new_tokens=n, stop_on_eos=False)


def _run(sched, ids):
    events = list(sched.generate(ids, _gen(sched)))
    reused = [int(m[1]) for e in events if e.kind == "log"
              for m in [re.search(r"prefix cache hit \(slot \d+\): reused KV for (\d+)",
                                  e.content)] if m]
    return "".join(e.content for e in events if e.kind == "token"), reused


def _retained_row(sched):
    return next(r for r in range(sched.n_slots) if sched._row_ids[r])


def _cycle(sched, path, seed):
    """A request, save its row, a warm request that extends it, erase,
    restore, the same request again."""
    for r in range(sched.n_slots):
        sched.erase_slot(r)
    _run(sched, _ids(seed, 40))
    r = _retained_row(sched)
    n_saved = sched.save_slot(r, path)
    x = list(sched._row_ids[r]) + _ids(seed + 1, 9)
    warm = _run(sched, x)
    sched.erase_slot(r)
    erased = not sched._row_ids[r]
    n_restored = sched.restore_slot(r, path)
    return {"saved": n_saved, "erased": erased, "restored": n_restored,
            "warm": warm, "restored_run": _run(sched, x)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_save_erase_restore_matches_the_reference(scheds, mode, tmp_path):
    ref, port = scheds(mode)
    want = _cycle(ref, tmp_path / "ref.bin", 1)
    got = _cycle(port, tmp_path / "port.bin", 1)
    assert got == want
    assert got["saved"] == 40 + N - 1 and got["erased"]
    text, reused = got["restored_run"]
    assert reused == [got["restored"]] and text == got["warm"][0]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_slot_files_cross_the_packages(scheds, direction, tmp_path):
    ref, port = scheds("dense")
    saver, loader = (ref, port) if direction == "jax_to_port" else (port, ref)
    for s in (ref, port):
        for r in range(s.n_slots):
            s.erase_slot(r)
    _run(saver, _ids(3, 35))
    r = _retained_row(saver)
    path = tmp_path / "slot.bin"
    n = saver.save_slot(r, path)
    x = list(saver._row_ids[r]) + _ids(4, 7)
    want = _run(saver, x)
    assert loader.restore_slot(1, path) == n
    got = _run(loader, x)
    assert got == want and got[1] == [n]


def test_slot_files_are_session_files(scheds, gguf_path, tmp_path):
    _, port = scheds("dense")
    for r in range(port.n_slots):
        port.erase_slot(r)
    _run(port, _ids(5, 30))
    r = _retained_row(port)
    path = tmp_path / "slot.bin"
    n = port.save_slot(r, path)
    held = list(port._row_ids[r])
    jeng = JaxEngine(gguf_path, dtype=jnp.float32)
    peng = Engine(gguf_path, dtype=torch.float32, device="cpu")
    assert peng.load_session(path) == jeng.load_session(path) == n
    assert peng._prefix_ids == jeng._prefix_ids == held
    # and an engine's session restores into a slot
    sess = tmp_path / "session.bin"
    assert peng.save_session(sess)
    assert port.restore_slot(2, sess) == n and port._row_ids[2] == held


def test_refusals_match_the_reference(scheds, tmp_path):
    ref, port = scheds("dense")
    for s in (ref, port):
        with pytest.raises(ValueError) as e:
            s.save_slot(7, tmp_path / "x")
        assert str(e.value) == "slot id 7 out of range (0..2)"
        s.erase_slot(0)
        assert s.save_slot(0, tmp_path / "x") == 0
    # an int8 pool's file does not restore into a dense pool
    ref8, port8 = scheds("int8")
    _run(port8, _ids(6, 20))
    path = tmp_path / "int8.bin"
    assert port8.save_slot(_retained_row(port8), path)
    assert port.restore_slot(0, path) == ref.restore_slot(0, path) == 0
    del ref8


MESH_ROUTES = [
    ("/slots/0?action=save", {"filename": "a.bin"}, "slot save/restore/erase on a mesh"),
    ("/slots/0?action=erase", {}, "slot save/restore/erase on a mesh"),
    ("/embedding", {"content": "hello"}, "embeddings run on the single-device engine"),
    ("/v1/embeddings", {"input": "hello"}, "embeddings run on the single-device engine"),
    ("/v1/completions", {"prompt": "hello", "n": 2}, "batch generation"),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "n": 2},
     "batch generation"),
]


def test_the_mesh_refuses_with_a_400_that_names_it(gguf_path, tmp_path):
    from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine
    from distributed_llm_pipeline_tpu_torch.serving import ChatServer

    eng = ShardedEngine(gguf_path, mesh_spec=MeshSpec.parse("1x2"), device="cpu",
                        dtype=torch.float32)
    try:
        assert eng.prefix_cache_enabled is False
        for call, word in ((lambda: eng.perplexity("hello world"), "perplexity"),
                           (lambda: eng.save_session(tmp_path / "s"), "session"),
                           (lambda: eng.load_session(tmp_path / "s"), "session"),
                           (lambda: eng.generate_batch(["a", "b"]), "batch")):
            with pytest.raises(NotImplementedError, match=word):
                call()
        out = {}
        for slots in (1, 2):
            server = ChatServer(eng, GenerationConfig(temperature=0.0, max_new_tokens=2),
                                parallel=slots, slot_save_path=str(tmp_path))

            async def go():
                client = TestClient(TestServer(server.app))
                await client.start_server()
                try:
                    got = []
                    for route, body, _ in MESH_ROUTES:
                        r = await client.post(route, json=body)
                        got.append((r.status, await r.json()))
                    return got
                finally:
                    await client.close()

            out[slots] = asyncio.run(go())
        for slots, answers in out.items():
            for (route, _, word), (status, body) in zip(MESH_ROUTES, answers):
                if slots == 1 and route.startswith("/slots"):
                    word = "session and slot files on a mesh"
                err = body["error"]
                msg = err["message"] if isinstance(err, dict) else err
                assert status == 400 and word in msg, (slots, route, body)
        # the mesh still serves a plain request, with the same text either way
        done = list(eng.generate("hello world", GenerationConfig(
            temperature=0.0, max_new_tokens=3)))[-1]
        assert done.data["n_gen"] == 3
    finally:
        eng.close()
