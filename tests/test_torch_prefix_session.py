"""The port's prefix cache and session files against the JAX package's, on
the CPU at f32, on one fixture GGUF written by the JAX exporter.

- A prompt that extends the stored prefix by at least 16 tokens reuses it:
  the same reuse count in the same log line, the same greedy continuation,
  the same ids stored afterwards (the fed tokens: the prompt and all but
  the newest generated token).
- The stored prefix is dropped, or replaced, where the reference's is: a
  prompt sharing fewer than 16 tokens (a miss, which reuses the stored
  buffers), caching switched off, a context shift, a constrained request,
  a batch, a zero budget.
- Session files cross the packages both ways for the dense, the int8 (q8_0)
  and the latent cache: a file one package saves loads into the other and
  continues with the saver's own greedy tokens; both packages write the
  same arrays (keys, dtypes, shapes and ids exactly; f32 values within
  1e-5) holding only ``length`` positions. A file that does not match (a
  dense file on an int8 engine, a latent file on a dense one, a session
  longer than the context) loads as None / 0 in both.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime.engine import load_kv_file as jax_load_kv_file
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.runtime.engine import load_kv_file

from .fixtures import make_spm_vocab, spm_metadata

KV_TOL = 1e-5      # f32 KV of the two packages agree to ~1e-7
N = 6              # greedy tokens a request
BASE = "hello world once upon a time " * 4     # 42 tokens with bos
MODES = {"dense": {}, "int8": {"kv_quant": "q8_0"}, "latent": {"kv_mode": "latent"}}


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "prefix.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


@pytest.fixture(scope="module")
def pairs(gguf_path):
    """mode → (JAX engine, port engine), made on first use."""
    made = {}

    def get(mode: str):
        if mode not in made:
            kw = MODES[mode]
            made[mode] = (JaxEngine(gguf_path, dtype=jnp.float32, **kw),
                          Engine(gguf_path, dtype=torch.float32, device="cpu", **kw))
        return made[mode]

    return get


def _reset(*engines):
    for e in engines:
        e.prefix_cache_enabled = True
        e._prefix_ids, e._prefix_cache = [], None


def _run(engine, prompt, gen_cls, **kw):
    args = dict(temperature=0.0, max_new_tokens=N, stop_on_eos=False)
    args.update(kw)
    events = list(engine.generate(prompt, gen_cls(**args)))
    hits = [e.content for e in events if e.kind == "log" and "prefix cache hit" in e.content]
    return "".join(e.content for e in events if e.kind == "token"), hits


def _both(pair, prompt, **kw):
    jeng, peng = pair
    return _run(jeng, prompt, JaxGen, **kw), _run(peng, prompt, GenerationConfig, **kw)


def test_prefix_hit_reuses_what_the_reference_reuses(pairs):
    pair = pairs("dense")
    _reset(*pair)
    pair[1].prefix_hits = pair[1].prefix_tokens = 0
    first = _both(pair, BASE)
    assert first[0] == first[1] and not first[1][1]
    assert pair[1]._prefix_ids == pair[0]._prefix_ids
    assert len(pair[1]._prefix_ids) == len(pair[1].tokenizer.encode(BASE)) + N - 1
    second = _both(pair, BASE + " the world")
    assert second[0] == second[1] and len(second[1][1]) == 1
    k = int(re.match(r"prefix cache hit: reused KV for (\d+) of ", second[1][1][0])[1])
    assert k >= 16
    assert pair[1]._prefix_ids == pair[0]._prefix_ids
    assert (pair[1].prefix_hits, pair[1].prefix_tokens) == (1, k)
    # the hit's continuation is the cold run's
    _reset(*pair)
    assert _run(pair[1], BASE + " the world", GenerationConfig)[0] == second[1][0]


def test_hit_continues_a_previous_generation(pairs):
    """A chat's next turn: the prompt holds the last prompt and what was
    generated; all of it but the newest token is reused."""
    pair = pairs("dense")
    _reset(*pair)
    _both(pair, BASE)
    ids = list(pair[1]._prefix_ids)
    turn = ids + pair[1].tokenizer.encode(" hello", add_bos=False)
    got = _both(pair, turn)
    assert got[0] == got[1]
    assert got[1][1] == [f"prefix cache hit: reused KV for {len(ids)} of {len(turn)} "
                         f"prompt tokens"]


def _drop(pair, case: str):
    """Run ``case`` after a stored prefix on both engines."""
    jeng, peng = pair
    _reset(jeng, peng)
    _both(pair, BASE)
    if case == "short":            # fewer than 16 shared tokens: a miss
        return _both(pair, "hello world once upon a time the time")
    if case == "mismatch":
        return _both(pair, "a world of " * 6)
    if case == "disabled":
        jeng.prefix_cache_enabled = peng.prefix_cache_enabled = False
        return _both(pair, BASE + " the world")
    if case == "shift":
        return _both(pair, BASE, max_new_tokens=110, context_shift=True)
    if case == "constrained":
        return _both(pair, BASE + " the", json_mode=True, max_new_tokens=4)
    if case == "zero_budget":
        return _both(pair, BASE, max_new_tokens=0)
    assert case == "batch"
    g = dict(temperature=0.0, max_new_tokens=2)
    return (jeng.generate_batch(["hello", "world"], JaxGen(**g)),
            peng.generate_batch(["hello", "world"], GenerationConfig(**g)))


@pytest.mark.parametrize("case", ["short", "mismatch", "disabled", "shift",
                                  "constrained", "zero_budget", "batch"])
def test_drops_and_misses_match_the_reference(pairs, case):
    pair = pairs("dense")
    got = _drop(pair, case)
    assert got[0] == got[1]
    if case in ("short", "mismatch"):
        assert not got[1][1]
    assert pair[1]._prefix_ids == pair[0]._prefix_ids
    assert (pair[1]._prefix_cache is None) == (pair[0]._prefix_cache is None)
    if case in ("short", "mismatch"):
        # a miss stores the new request's ids in the buffers it reused
        assert pair[1]._prefix_ids and pair[1]._prefix_cache is not None
    else:
        assert pair[1]._prefix_cache is None and not pair[1]._prefix_ids
    _reset(*pair)


def test_a_miss_reuses_the_stored_buffers(pairs):
    peng = pairs("dense")[1]
    _reset(peng)
    _run(peng, BASE, GenerationConfig)
    stored = peng._prefix_cache
    _run(peng, "a world of " * 6, GenerationConfig)
    assert peng._prefix_cache is stored


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_session_files_hold_the_reference_arrays(pairs, mode, tmp_path):
    pair = pairs(mode)
    _reset(*pair)
    _both(pair, BASE)
    files = [tmp_path / "jax.bin", tmp_path / "port.bin"]
    assert pair[0].save_session(files[0]) and pair[1].save_session(files[1])
    want, got = _arrays(files[0]), _arrays(files[1])
    assert sorted(got) == sorted(want)
    assert ("ks" in got) == (mode == "int8")
    n = int(got["length"])
    assert n == len(pair[1]._prefix_ids) == len(got["ids"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["dtype"] == want["dtype"]
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert k in ("ids", "length", "dtype") or got[k].shape[-3] == n
    tol = {"int8": 1}.get(mode, 0)   # int8 codes: one code at a rounding tie
    for k in ("k", "v"):
        if mode == "int8":
            assert np.abs(got[k].astype(np.int32) - want[k]).max() <= tol
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=KV_TOL)
    for k in ("ks", "vs"):
        if k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sessions_cross_the_packages(pairs, mode, direction, tmp_path):
    jeng, peng = pairs(mode)
    saver, loader = (jeng, peng) if direction == "jax_to_port" else (peng, jeng)
    saver_gen, loader_gen = ((JaxGen, GenerationConfig) if saver is jeng
                             else (GenerationConfig, JaxGen))
    _reset(jeng, peng)
    _run(saver, BASE, saver_gen)
    path = tmp_path / "session.bin"
    assert saver.save_session(path)
    held = list(saver._prefix_ids)
    turn = held + peng.tokenizer.encode(" the world", add_bos=False)
    want = _run(saver, turn, saver_gen)
    assert loader.load_session(path) == len(held)
    assert list(loader._prefix_ids) == held
    got = _run(loader, turn, loader_gen)
    assert got == want and want[1] == [
        f"prefix cache hit: reused KV for {len(held)} of {len(turn)} prompt tokens"]


@pytest.mark.parametrize("saved,loaded", [("dense", "int8"), ("int8", "dense"),
                                          ("latent", "dense"), ("dense", "latent")])
def test_mismatched_session_files_load_as_nothing(pairs, saved, loaded, tmp_path):
    src = pairs(saved)[1]
    _reset(src)
    _run(src, BASE, GenerationConfig)
    path = tmp_path / "s.bin"
    assert src.save_session(path)
    jeng, peng = pairs(loaded)
    _reset(jeng, peng)
    assert peng.load_session(path) == jeng.load_session(path) == 0
    assert peng._prefix_cache is None and jeng._prefix_cache is None


def test_a_session_longer_than_the_context_loads_as_nothing(pairs, gguf_path, tmp_path):
    src = pairs("dense")[1]
    _reset(src)
    _run(src, BASE, GenerationConfig)
    path = tmp_path / "s.bin"
    assert src.save_session(path)
    small = (JaxEngine(gguf_path, dtype=jnp.float32, max_seq=32),
             Engine(gguf_path, dtype=torch.float32, device="cpu", max_seq=32))
    assert small[1].load_session(path) == small[0].load_session(path) == 0
    assert load_kv_file(path, small[1].make_cache(), 32) is None
    assert jax_load_kv_file(path, small[0].make_cache(), 32) is None
    # under a context it fits, the file loads whole
    assert load_kv_file(path, src.make_cache(), src.max_seq)[0].length == \
        len(src._prefix_ids)


def test_nothing_to_save(pairs, tmp_path):
    jeng, peng = pairs("dense")
    _reset(jeng, peng)
    assert peng.save_session(tmp_path / "x") is jeng.save_session(tmp_path / "y") is False
