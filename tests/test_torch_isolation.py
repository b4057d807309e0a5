"""The port stands alone: it imports neither jax nor anything of the JAX
package (distributed_llm_pipeline_tpu) nor ml_dtypes (the card's machine has
none), and neither do chip_smoke.py, the timing scripts of scripts/, the
mesh's spawned follower processes, nor the CLI and the completion routes
while they serve: the batch, embedding, /infill and slot-file routes, a
prompt cache, perplexity, the tracer, the perf monitor and torch.profiler
(/debug/*, --profile-dir) included."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_llm_pipeline_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "distributed_llm_pipeline_tpu", "ml_dtypes")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
import distributed_llm_pipeline_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
NEW = {{"cli", "config", "serving.openai", "serving.chat_template", "ops.gbnf",
       "ops.json_constraint", "ops.json_schema", "runtime.constrained",
       "runtime.faults", "runtime.swapstore", "runtime.disagg",
       "utils.metrics", "serving.supervisor", "models.lora", "utils.tracing",
       "utils.perf", "utils.profile_trace", "runtime.capabilities"}}
missing = {{n for n in NEW if pkg.__name__ + "." + n not in names}}
assert not missing, missing
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not leaked, leaked
print(len(names))
"""


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_every_port_module_imports_with_jax_blocked():
    code = _BLOCKED_IMPORT.format(forbidden=FORBIDDEN, root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "mesh_pack_time.py",
    ROOT / "scripts" / "dequant_time.py", ROOT / "scripts" / "flash_time.py",
    ROOT / "scripts" / "logit_drift.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            bad = [node.module] if node.module and _is_forbidden(node.module) else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_SITE_BLOCK = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
"""

_MESH_RUN = r"""
import sys, torch
from pathlib import Path
sys.path.insert(0, {root!r})
import chip_smoke
from distributed_llm_pipeline_tpu_torch.models import ModelConfig
from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec, ShardedEngine
from distributed_llm_pipeline_tpu_torch.runtime import GenerationConfig

cfg = ModelConfig(vocab_size=320, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=16, hidden_dim=128, max_seq_len=64)
path = Path({tmp!r}) / "m.gguf"
chip_smoke.write_model(path, cfg, 0, device="cpu")
engine = ShardedEngine(path, mesh_spec=MeshSpec.parse("1x2"), device="cpu")
try:
    done = list(engine.generate([5, 6, 7], GenerationConfig(max_new_tokens=2)))[-1]
    assert done.data["n_gen"] == 2, done
finally:
    engine.close()
leaked = [m for m in sys.modules if m.split(".")[0] in {forbidden!r}]
assert not leaked, leaked
print("ok")
"""


_SERVE_RUN = r"""
import asyncio, io, sys
from pathlib import Path
sys.path.insert(0, {root!r})
import chip_smoke
from aiohttp.test_utils import TestClient, TestServer
from distributed_llm_pipeline_tpu_torch import cli
from distributed_llm_pipeline_tpu_torch.models import ModelConfig
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.serving import ChatServer

cfg = ModelConfig(vocab_size=320, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  head_dim=16, hidden_dim=128, max_seq_len=64)
path = Path({tmp!r}) / "m.gguf"
chip_smoke.write_model(path, cfg, 0, device="cpu")
sys.stdin = io.StringIO("hello\n")
assert cli.main(["-m", str(path), "--cpu", "-n", "2", "-c", "64", "-i", "-p", "hi"]) == 0
assert cli.main(["-m", str(path), "--cpu", "-n", "4", "-c", "64", "--json", "-p", "hi"]) == 0
assert cli.main(["-m", str(path), "--cpu", "-n", "70", "-c", "64", "-p", "hi"]) == 0
assert cli.main(["-m", str(path), "--cpu", "-n", "2", "-c", "64", "-p", "hi",
                 "--profile-dir", str(Path({tmp!r}) / "prof")]) == 0
assert list((Path({tmp!r}) / "prof" / "plugins" / "profile").glob("*/trace.json"))
cache = str(Path({tmp!r}) / "prompt.bin")
for _ in range(2):
    assert cli.main(["-m", str(path), "--cpu", "-n", "2", "-c", "64", "-p", "hi " * 20,
                     "--prompt-cache", cache]) == 0
text = Path({tmp!r}) / "t.txt"
text.write_text("hi " * 80)
assert cli.main(["-m", str(path), "--cpu", "-c", "64", "--perplexity", str(text)]) == 0
import numpy as np
from distributed_llm_pipeline_tpu_torch.models.lora import write_lora_gguf
a = np.full((2, 64), 0.01, np.float32)
adapter = write_lora_gguf(Path({tmp!r}) / "a.gguf", 4.0,
                          {{"blk.0.attn_q.weight": (a, a.T.copy())}})
assert cli.main(["-m", str(path), "--cpu", "-n", "2", "-c", "64", "-p", "hi",
                 "--lora", f"{{adapter}}=0.5"]) == 0
engine = Engine(path, device="cpu")
server = ChatServer(engine, GenerationConfig(max_new_tokens=2), parallel=2,
                    slot_save_path={tmp!r})
single = ChatServer(engine, GenerationConfig(max_new_tokens=2),
                    slot_save_path={tmp!r})

async def go():
    client = TestClient(TestServer(server.app))
    await client.start_server()
    try:
        out = []
        for route, body in (("/v1/chat/completions", {{"messages": [
                                {{"role": "user", "content": "hi"}}], "logprobs": True,
                                "top_logprobs": 2}}),
                            ("/completion", {{"prompt": "hi", "n_probs": 2, "stream": True,
                                             "logit_bias": [[5, False]]}}),
                            ("/v1/completions", {{"prompt": "hi", "typical_p": 0.9,
                                                 "mirostat": 2, "temperature": 0.9}}),
                            ("/apply-template", {{"messages": [
                                {{"role": "user", "content": "hi"}}]}}),
                            ("/v1/completions", {{"prompt": "hi", "max_tokens": 4,
                                "response_format": {{"type": "json_schema", "json_schema":
                                    {{"schema": {{"type": "object"}}}}}}}}),
                            ("/completion", {{"prompt": "hi", "grammar": 'root ::= "a"'}}),
                            ("/completion", {{"prompt": "hi", "n_predict": 70,
                                             "context_shift": True}}),
                            ("/v1/completions", {{"prompt": ["hi", "hello"], "n": 1}}),
                            ("/v1/chat/completions", {{"messages": [
                                {{"role": "user", "content": "hi"}}], "n": 2}}),
                            ("/embedding", {{"content": "hi", "pooling": "last"}}),
                            ("/v1/embeddings", {{"input": ["hi", "hello"]}}),
                            ("/infill", {{"input_prefix": "a", "input_suffix": "b"}}),
                            ("/completion", {{"prompt": "hi " * 30}}),
                            ("/slots/0?action=save", {{"filename": "s.bin"}}),
                            ("/slots/0?action=erase", {{}}),
                            ("/slots/0?action=restore", {{"filename": "s.bin"}})):
            out.append((await client.post(route, json=body)).status)
        out.append((await client.post("/debug/profile", json={{"steps": 1,
                                                               "timeout_s": 0.5}})).status)
        for route in ("/metrics", "/models", "/lora-adapters", "/debug/trace",
                      "/debug/perf"):
            out.append((await client.get(route)).status)
        return out
    finally:
        await client.close()

assert asyncio.run(go()) == [200] * 22
server = single
assert asyncio.run(go())[-10:] == [200] * 10
leaked = [m for m in sys.modules if m.split(".")[0] in {forbidden!r}]
assert not leaked, leaked
print("ok")
"""


def test_cli_and_completion_routes_serve_with_jax_blocked(tmp_path):
    """The CLI (an interactive turn, --json, a run past the context, a
    profiled run, a prompt cache saved and loaded, perplexity, a LoRA
    adapter) and the completion routes (logprobs, a bias, typical-p and
    mirostat, the chat template, a json_schema, a grammar, a context shift,
    batches, embeddings, /infill, slot files on the slots and on the engine,
    /debug/profile, /metrics, /models, /lora-adapters, /debug/trace,
    /debug/perf) run with jax, the JAX package and ml_dtypes blocked from
    import."""
    (tmp_path / "sitecustomize.py").write_text(_SITE_BLOCK.format(forbidden=FORBIDDEN))
    code = _SERVE_RUN.format(root=str(ROOT), tmp=str(tmp_path), forbidden=FORBIDDEN)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)]),
           "DLP_PROFILE_DIR": str(tmp_path / "debug-profile")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_spawned_follower_ranks_import_no_jax(tmp_path):
    """A mesh's follower ranks are spawned interpreters: a sitecustomize on
    their path blocks jax and the JAX package in every one of them, and the
    mesh still starts and serves."""
    (tmp_path / "sitecustomize.py").write_text(_SITE_BLOCK.format(forbidden=FORBIDDEN))
    code = _MESH_RUN.format(root=str(ROOT), tmp=str(tmp_path), forbidden=FORBIDDEN)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
