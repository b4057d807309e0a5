"""The port stands alone: it imports neither jax nor anything of the JAX
package (distributed_llm_pipeline_tpu), and neither do chip_smoke.py, the
timing scripts of scripts/, nor the mesh's spawned follower processes."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_llm_pipeline_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "distributed_llm_pipeline_tpu")

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
