"""The port's CLI (``dlp-tpu-torch``) against the JAX package's ``dlp-tpu``
on the CPU, on the same tiny f32 GGUF, greedy: one-shot ``-p`` puts the
reference's text on stdout and the logs on stderr; interactive turns
(``-i``, ``--interactive-first`` with ``--in-prefix`` / ``--in-suffix``,
``-cnv``) read stdin and give the reference's text; settings layer as the
reference's (config file < env < flags); and without ``--cpu`` on a machine
with no CUDA device it raises instead of running on the CPU. The server's
entry point reads the same settings.
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
        AppConfig.load(overrides={"lora": "x.gguf"})


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
