"""Build the package's CUDA sources (``csrc/*.cu``) with ``nvcc`` into shared
libraries with a plain C interface, loaded with ``ctypes``.

Each source compiles on its own for Hopper (``sm_90a``) at first use, into a
build directory beside the sources (``csrc/build/``, or
``DLP_TORCH_BUILD_DIR``). A library is named by a hash of its source and
flags, so an edited source rebuilds and concurrent processes never load a
half-written file (the compiler writes a temporary name that is renamed into
place). ``build`` starts one ``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every kernel source of the package (csrc/<name>.cu)
SOURCES = ("flash_attention", "paged_attention", "dequant_matmul", "w8a8_matmul",
           "int8_matmul", "fused_decode", "latent_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float      # compile wall time; 0.0 when the library was cached
    ptxas: str          # the compiler's -Xptxas -v report (registers, smem)


def build_dir() -> Path:
    return Path(os.environ.get("DLP_TORCH_BUILD_DIR") or CSRC / "build")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels build from source at first use")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | tuple[str, ...]) -> dict[str, Built]:
    """Compile every named source that has no library yet, one ``nvcc`` per
    source, all started together. Raises with the compiler's output when a
    build fails."""
    out: dict[str, Built] = {}
    procs = {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = None
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists():
            out[name] = Built(name, target, 0.0,
                              log.read_text() if log.exists() else "")
            continue
        nvcc = nvcc or find_nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.monotonic(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        report, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{report}")
            continue
        target.with_suffix(".log").write_text(report)
        os.replace(tmp, target)
        out[name] = Built(name, target, seconds, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name].path))
            _loaded[name] = lib
        return lib
