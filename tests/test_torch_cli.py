"""The port's CLI (``dlp-tpu-torch``) against the JAX package's ``dlp-tpu``
on the CPU, on the same tiny f32 GGUF, greedy: one-shot ``-p`` puts the
reference's text on stdout and the logs on stderr; interactive turns
(``-i``, ``--interactive-first`` with ``--in-prefix`` / ``--in-suffix``,
``-cnv``) read stdin and give the reference's text; settings layer as the
reference's (config file < env < flags); ``--json``, ``--grammar-file`` and
``--json-schema`` constrain the output as the reference's do; past the
context it shifts by default and gives the reference's text, and stops at
ctx with ``--no-context-shift``; and without ``--cpu`` on a machine with no
CUDA device it raises instead of running on the CPU. The server's entry
point reads the same settings. ``--prompt-cache`` saves the prompt's KV at
exit and loads it at the next start (the reference's lines, text and file;
a file of another model is ignored), and ``--perplexity`` prints the
reference's score.
"""

import asyncio
import io
import json
import re
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from distributed_llm_pipeline_tpu import cli as jax_cli
from distributed_llm_pipeline_tpu.config import AppConfig as JaxAppConfig
from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu_torch import cli
from distributed_llm_pipeline_tpu_torch.config import AppConfig
from distributed_llm_pipeline_tpu_torch.serving import server as srv

from .fixtures import make_spm_vocab, spm_metadata

ROOT = Path(__file__).resolve().parents[1]
BASE = ["-c", "128", "-n", "5", "--temp", "0", "--cpu", "--dtype", "float32"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    # the specials' and byte tokens' head columns at zero: the greedy text is
    # the vocabulary's pieces
    params["lm_head"] = params["lm_head"].at[:, :259].set(0.0)
    path = tmp_path_factory.mktemp("models") / "cli.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return str(path)


def _run(main, model_path, extra, monkeypatch, capsys, stdin=""):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(["-m", model_path, *BASE, *extra])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(model_path, extra, monkeypatch, capsys, stdin=""):
    return (_run(jax_cli.main, model_path, extra, monkeypatch, capsys, stdin),
            _run(cli.main, model_path, extra, monkeypatch, capsys, stdin))


def _prompt_lengths(err: str) -> list[int]:
    return [int(n) for n in re.findall(r"prompt: (\d+) tokens", err)]


def test_one_shot_prints_the_reference_text(model_path, monkeypatch, capsys):
    (rc_ref, out_ref, _), (rc, out, err) = _both(
        model_path, ["-p", "once upon a time"], monkeypatch, capsys)
    assert rc == rc_ref == 0
    assert out == out_ref and len(out.strip()) > 3
    # stderr: the closing summary only; no token text on it, no log on stdout
    assert "generated 5 tokens" in err and "offloaded" not in err
    assert "generated" not in out and out.strip() not in err


def test_verbose_and_log_file(model_path, monkeypatch, capsys, tmp_path):
    log = tmp_path / "run.log"
    rc, out, err = _run(cli.main, model_path, ["-p", "hello", "--verbose",
                                               "--log-file", str(log)],
                        monkeypatch, capsys)
    assert rc == 0 and "offloaded" in err and "generated 5 tokens" in err
    text = log.read_text()
    assert "offloaded" in text and "prompt: " in text and out.strip() not in text


@pytest.mark.parametrize("mode,extra,stdin,turns", [
    ("interactive", ["-i", "-p", "once upon"], "hello\n\nworld\n", 3),
    ("interactive_first", ["--interactive-first", "-p", "a story",
                           "--in-prefix", "User: ", "--in-suffix", "Reply:"],
     "hello there\n", 1),
    ("conversation", ["-cnv", "-p", "you tell stories"], "hello\nmore\n", 2),
    ("reverse_prompt", ["-i", "-p", "once upon", "-r", "QQQ"], "hello\n", 2),
])
def test_interactive_turns_match_the_reference(model_path, monkeypatch, capsys, mode,
                                               extra, stdin, turns):
    (rc_ref, out_ref, err_ref), (rc, out, err) = _both(
        model_path, [*extra, "--verbose"], monkeypatch, capsys, stdin)
    assert rc == rc_ref == 0
    assert out == out_ref and len(out.strip()) > 3
    assert err.count("generated") == err_ref.count("generated") == turns
    # each turn's prompt (the transcript so far, prefix and suffix
    # included) has the reference's length
    assert _prompt_lengths(err) == _prompt_lengths(err_ref)


def test_reverse_prompt_stops_and_is_withheld(model_path, monkeypatch, capsys):
    _, full, _ = _run(cli.main, model_path, ["-p", "once upon", "-n", "12"],
                      monkeypatch, capsys)
    marker = full.strip()[3:6]
    rc, got, err = _run(cli.main, model_path, ["-p", "once upon", "-n", "12",
                                               "-r", marker], monkeypatch, capsys)
    assert rc == 0 and marker and marker not in got
    assert full.startswith(got.rstrip("\n")) and len(got.strip()) < len(full.strip())


def test_logit_bias_flag_matches_the_reference(model_path, monkeypatch, capsys):
    _, plain, _ = _run(cli.main, model_path, ["-p", "once upon", "--verbose"],
                       monkeypatch, capsys)
    from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig

    eng = Engine(model_path, dtype=torch.float32, device="cpu", max_seq=128)
    first = next(e.data["id"] for e in eng.generate("once upon", GenerationConfig(
        temperature=0.0, max_new_tokens=1, logprobs=1)) if e.kind == "token")
    (_, out_ref, _), (rc, out, _) = _both(
        model_path, ["-p", "once upon", "--logit-bias", f"{first}-inf,3+0.5"],
        monkeypatch, capsys)
    assert rc == 0 and out == out_ref and out != plain


@pytest.mark.parametrize("spec", ["", "29871+1.5,15043-1", "5-inf", "7+false",
                                  "12-1e+2, 3+0", "9-false"])
def test_logit_bias_parsing_matches_the_reference(spec):
    assert AppConfig(logit_bias=spec).logit_bias_pairs() == \
        JaxAppConfig(logit_bias=spec).logit_bias_pairs()


def test_bad_settings_exit_2(model_path, monkeypatch, capsys):
    rc, _, err = _run(cli.main, model_path, ["--logit-bias", "12"], monkeypatch, capsys)
    assert rc == 2 and "--logit-bias entry '12'" in err
    with pytest.raises(SystemExit) as exc:      # argparse refuses it first
        _run(cli.main, model_path, ["--dtype", "int3"], monkeypatch, capsys)
    assert exc.value.code == 2
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert cli.main(["-p", "x", "--cpu"]) == 2
    assert "no model configured" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [[], ["-i"]])
def test_without_cpu_and_without_a_gpu_it_raises(model_path, monkeypatch, capsys, flag):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello\n"))
    args = [a for a in BASE if a != "--cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-m", model_path, *args, "-p", "hi", *flag])
    assert capsys.readouterr().out == ""


def test_settings_layer_file_env_flags(model_path, monkeypatch, capsys, tmp_path):
    """defaults < --config file < DLP_* env < flags, as the reference's."""
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"model": model_path, "n_predict": 2,
                                "temperature": 0.0, "cpu": True,
                                "dtype": "float32", "ctx_size": 128}))
    toml = tmp_path / "c.toml"
    toml.write_text(f'model = "{model_path}"\nn_predict = 4\ncpu = true\n'
                    f'temperature = 0.0\ndtype = "float32"\nctx_size = 128\n')
    for argv, env, n in ((["--config", str(conf)], {}, 2),
                         (["--config", str(conf)], {"DLP_N_PREDICT": "3"}, 3),
                         (["--config", str(conf), "-n", "1"], {"DLP_N_PREDICT": "3"}, 1),
                         (["--config", str(toml)], {}, 4)):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        assert cli.main([*argv, "-p", "hello"]) == 0
        assert f"generated {n} tokens" in capsys.readouterr().err
        for k in env:
            monkeypatch.delenv(k)
    ref = JaxAppConfig.load(conf, env={"DLP_TOP_K": "7"}, overrides={"top_p": 0.5})
    got = AppConfig.load(conf, env={"DLP_TOP_K": "7"}, overrides={"top_p": 0.5})
    for f in AppConfig.field_names():
        assert getattr(got, f) == getattr(ref, f), f
    with pytest.raises(ValueError, match="unknown config keys"):
        AppConfig.load(overrides={"draft": "x.gguf"})


def test_server_main_reads_the_settings_and_serves_the_routes(model_path, monkeypatch,
                                                              tmp_path):
    conf = tmp_path / "s.json"
    conf.write_text(json.dumps({"model": model_path, "cpu": True, "dtype": "float32",
                                "n_predict": 3, "ctx_size": 128}))
    apps = []
    monkeypatch.setattr(srv.web, "run_app", lambda app, **kw: apps.append((app, kw)))
    monkeypatch.setenv("DLP_PORT", "3999")
    srv.main(["--config", str(conf), "--parallel", "2"])
    app, kw = apps[0]
    assert kw["port"] == 3999

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            models = await (await client.get("/v1/models")).json()
            r = await client.post("/v1/completions", json={"prompt": "hello",
                                                           "temperature": 0.0})
            props = await (await client.get("/props")).json()
            return models, r.status, await r.json(), props
        finally:
            await client.close()

    models, status, body, props = asyncio.run(go())
    assert models["data"][0]["id"] == "cli"   # the model file's stem
    assert status == 200 and body["usage"]["completion_tokens"] == 3
    assert props["total_slots"] == 2 and props["model"]["n_ctx"] == 128


def test_console_scripts_name_the_entry_points():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["dlp-tpu-torch"] == "distributed_llm_pipeline_tpu_torch.cli:main"
    assert scripts["dlp-serve-torch"] == \
        "distributed_llm_pipeline_tpu_torch.serving.server:main"
    assert cli.build_argparser().prog == "dlp-tpu-torch"
    assert srv.build_argparser().prog == "dlp-serve-torch"


SCHEMA = '{"type": "object", "properties": {"n": {"type": "integer"}}, "required": ["n"]}'


@pytest.mark.parametrize("kind", ["json", "grammar_file", "json_schema", "json_schema_file"])
def test_constraint_flags_match_the_reference(model_path, monkeypatch, capsys, tmp_path,
                                              kind):
    gfile = tmp_path / "g.gbnf"
    gfile.write_text('root ::= "once" | "upon" | "time"\n')
    sfile = tmp_path / "s.json"
    sfile.write_text(SCHEMA)
    flags = {"json": ["--json"], "grammar_file": ["--grammar-file", str(gfile)],
             "json_schema": ["--json-schema", SCHEMA],
             "json_schema_file": ["--json-schema", f"@{sfile}"]}[kind]
    (rc_ref, out_ref, _), (rc, out, err) = _both(
        model_path, ["-p", "produce:", "-n", "40", *flags], monkeypatch, capsys)
    assert rc == rc_ref == 0 and out == out_ref
    text = out.rstrip("\n")
    if "constraint satisfied" in err:
        if kind == "grammar_file":
            assert text in ("once", "upon", "time")
        else:
            doc = json.loads(text)
            assert kind == "json" or isinstance(doc["n"], int)
    else:
        assert "constraint truncated" in err


@pytest.mark.parametrize("extra,needle", [
    (["--json", "--grammar-file", "x.gbnf"], "mutually exclusive"),
    (["--json", "--repeat-penalty", "1.2"], "--repeat-penalty"),
    (["--grammar-file", "missing.gbnf"], "--grammar-file"),
    (["--json-schema", '{"type": "array", "maxItems": 1000}'], "--json-schema"),
    (["--json-schema", "not json"], "--json-schema"),
])
def test_bad_constraint_flags_exit_2(model_path, monkeypatch, capsys, tmp_path, extra,
                                     needle):
    monkeypatch.chdir(tmp_path)
    (rc_ref, _, err_ref), (rc, _, err) = _both(model_path, ["-p", "x", *extra],
                                               monkeypatch, capsys)
    assert rc == rc_ref == 2 and needle in err
    line = [x for x in err.splitlines() if x.startswith("error:")]
    assert line == [x for x in err_ref.splitlines() if x.startswith("error:")]


@pytest.mark.parametrize("shift", [True, False])
def test_context_shift_by_default_and_no_context_shift(model_path, monkeypatch, capsys,
                                                       shift):
    extra = ["-p", "once upon a time", "-c", "48", "-n", "100", "--keep", "2", "--verbose"]
    if not shift:
        extra.append("--no-context-shift")
    (rc_ref, out_ref, err_ref), (rc, out, err) = _both(model_path, extra, monkeypatch,
                                                       capsys)
    assert rc == rc_ref == 0 and out == out_ref
    shifts = [x for x in err.splitlines() if "context shift: dropped" in x]
    assert shifts == [x for x in err_ref.splitlines() if "context shift: dropped" in x]
    n = int(re.search(r"generated (\d+) tokens", err).group(1))
    if shift:
        assert len(shifts) >= 2 and n == 100
    else:
        assert not shifts and n < 48


def test_prompt_cache_saves_then_loads_as_the_reference(model_path, monkeypatch, capsys,
                                                        tmp_path):
    """--prompt-cache FILE: the first run saves the prompt's KV at exit, the
    second loads it at start and prefills only what the file lacks; the
    texts, the stderr lines and the files are the reference's."""
    runs = {}
    for who, main in (("ref", jax_cli.main), ("port", cli.main)):
        cache = tmp_path / f"{who}.bin"
        extra = ["-p", "once upon a time the world hello world " * 2, "--prompt-cache",
                 str(cache), "--verbose"]
        first = _run(main, model_path, extra, monkeypatch, capsys)
        second = _run(main, model_path, extra[:1] + [extra[1] + "once"] + extra[2:],
                      monkeypatch, capsys)
        runs[who] = (first, second, cache)
    for (rc1, out1, err1), (rc2, out2, err2), cache in runs.values():
        assert rc1 == rc2 == 0 and cache.exists()
        assert f"prompt cache: saved to {cache}" in err1 and "prompt cache: loaded" not in err1
        assert re.search(rf"prompt cache: loaded \d+ tokens from {re.escape(str(cache))}",
                         err2)
        assert "prefix cache hit: reused KV for" in err2
    (ref1, ref2, ref_cache), (got1, got2, got_cache) = runs["ref"], runs["port"]
    assert got1[1] == ref1[1] and got2[1] == ref2[1]
    hits = [[x for x in err.splitlines() if "prefix cache hit" in x or "cache: loaded" in x]
            for err in (ref2[2], got2[2])]
    assert [h.replace(str(ref_cache), "F") for h in hits[0]] == \
        [h.replace(str(got_cache), "F") for h in hits[1]]
    with np.load(ref_cache) as a, np.load(got_cache) as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(a["ids"], b["ids"])


def test_prompt_cache_of_another_model_is_ignored(model_path, monkeypatch, capsys,
                                                  tmp_path):
    for main in (jax_cli.main, cli.main):
        bad = tmp_path / "bad.bin"   # a one-layer cache of another width
        with open(bad, "wb") as fh:
            np.savez(fh, ids=np.arange(3, dtype=np.int32),
                     k=np.zeros((1, 1, 3, 1, 4), np.float32),
                     v=np.zeros((1, 1, 3, 1, 4), np.float32),
                     dtype=np.bytes_("float32"), length=np.asarray(3, np.int32))
        rc, _, err = _run(main, model_path, ["-p", "hello", "--prompt-cache", str(bad)],
                          monkeypatch, capsys)
        assert rc == 0 and "does not match this model/ctx; ignored" in err


def test_perplexity_flag_matches_the_reference(model_path, monkeypatch, capsys, tmp_path):
    text = tmp_path / "t.txt"
    text.write_text("hello world once upon a time the world " * 12)
    (rc_ref, out_ref, err_ref), (rc, out, err) = _both(
        model_path, ["--perplexity", str(text)], monkeypatch, capsys)
    assert rc == rc_ref == 0
    got, want = json.loads(out), json.loads(out_ref)
    assert got["n_tokens"] == want["n_tokens"] > 100
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    assert err.startswith("perplexity: ") and err_ref.startswith("perplexity: ")
    rc, _, err = _run(cli.main, model_path, ["--perplexity", str(tmp_path / "none")],
                      monkeypatch, capsys)
    assert rc == 2 and err.startswith("error: ")
