"""How a model load in one thread holds back a stream served from another,
for the PyTorch port (``distributed_llm_pipeline_tpu_torch``).

``POST /models/load`` builds its engine in an executor thread while the
default model streams. This script serves that case without the HTTP layer:
a default ``Engine`` streams a greedy request (``--prompt-tokens`` tokens
of "hello", ``--new-tokens`` new ones) while another thread builds an
``Engine`` from a second GGUF, and reports:

- ``alone``: the stream's TTFT and its largest gap between token events
  (the engine emits a decode chunk's tokens together) with nothing else
  running, and the load's milliseconds with nothing else running;
- ``contended`` (``--reps`` times): the same stream started 10 ms after the
  load, its TTFT, its largest gap, the tokens it delivered before the load
  ended, and the load's milliseconds;
- ``lock_held_ms``: a ticker thread wakes every 0.2 ms during each load;
  the sum of its gaps beyond 2 ms is time the loading thread held the
  interpreter lock without letting go. ``alone.phases`` splits the lone
  load's milliseconds and its lock held over the engine's steps (the GGUF
  parse, the tokenizer, the weights' load and placement, the model's
  construction) and the rest of its construction.

Both GGUFs are random BF16 at a preset's widths (``--seed``), written with
``chip_smoke.write_model``: the default model at ``--layers`` layers, the
loaded one at ``--load-layers``. On the CUDA device unless ``--cpu``.
``--tree DIR`` imports the port from another checkout (to compare two
commits in one run). Prints one JSON line with the card's name and power
limit.

Run: ``python scripts/load_contention.py [--preset llama3.2-1b] [--layers 16]
[--load-layers 8] [--reps 2] [--cpu] [--tree DIR] [--dir DIR]``.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def card(device: torch.device) -> str:
    if device.type != "cuda":
        return "CPU"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


class Ticker:
    """A thread that wakes every 0.2 ms; its gaps beyond 2 ms are time it
    could not take the interpreter lock back."""

    def __init__(self):
        self.ticks: list[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.ticks.append(time.monotonic())
            time.sleep(0.0002)

    def __enter__(self) -> "Ticker":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def held_ms(self, t0: float, t1: float) -> float:
        t = np.array([x for x in self.ticks if t0 <= x <= t1])
        g = np.diff(t) * 1e3
        return float(g[g > 2.0].sum()) if len(g) else 0.0


def stream(engine, prompt: str, gen) -> list[float]:
    """The stream's token event times, after a start time at index 0."""
    times = [time.monotonic()]
    for ev in engine.generate(prompt, gen):
        if ev.kind == "token":
            times.append(time.monotonic())
    return times


def timed_steps() -> list[tuple[str, float, float]]:
    """Record (name, start, end) of each step of an ``Engine``'s load, by
    wrapping the names its module calls them by."""
    from distributed_llm_pipeline_tpu_torch.runtime import engine as mod

    spans: list[tuple[str, float, float]] = []

    def wrap(name: str):
        fn = getattr(mod, name)

        def timed(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            spans.append((name, t0, time.monotonic()))
            return out
        setattr(mod, name, timed)

    for name in ("GGUFReader", "tokenizer_from_metadata", "load_params", "LlamaModel"):
        wrap(name)
    return spans


def lock_probe(path: Path, device: torch.device) -> dict:
    """The lock held (ticker gaps beyond 2 ms) and the milliseconds of the
    GGUF parse and the tokenizer of ``path``, and of a 300 ms pure-Python
    loop, at each switch interval, in the main thread; then the same with
    the work in a second thread while the main one waits."""
    from distributed_llm_pipeline_tpu_torch.gguf import GGUFReader
    from distributed_llm_pipeline_tpu_torch.tokenizer import tokenizer_from_metadata

    if device.type == "cuda":
        torch.ones(1, device=device).sum().item()   # the context up

    def parse():
        with GGUFReader(path) as r:
            tokenizer_from_metadata(r.metadata)

    def spin():
        t_end, n = time.monotonic() + 0.3, 0
        while time.monotonic() < t_end:
            n += 1

    saved = sys.getswitchinterval()
    out = {}
    try:
        for interval in (5e-3, 2e-4, 5e-5):
            sys.setswitchinterval(interval)
            for name, fn in (("parse", parse), ("spin", spin)):
                for where in ("main", "thread"):
                    with Ticker() as tick:
                        t0 = time.monotonic()
                        if where == "main":
                            fn()
                        else:
                            th = threading.Thread(target=fn)
                            th.start()
                            th.join()
                        t1 = time.monotonic()
                    out[f"{interval:g}s {name} {where}"] = {
                        "ms": (t1 - t0) * 1e3, "lock_held_ms": tick.held_ms(t0, t1),
                        "switch_interval": sys.getswitchinterval()}
    finally:
        sys.setswitchinterval(saved)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="llama3.2-1b")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--load-layers", type=int, default=8)
    ap.add_argument("--prompt-tokens", type=int, default=480)
    ap.add_argument("--new-tokens", type=int, default=96)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="import the port from this checkout instead")
    ap.add_argument("--dir", default=None, help="where the GGUFs are written")
    ap.add_argument("--probe", action="store_true",
                    help="only the lock probe: the loaded GGUF's parse and "
                         "tokenizer, and a pure-Python loop, at each switch "
                         "interval")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))   # chip_smoke.write_model
    import chip_smoke

    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else ROOT))
    from distributed_llm_pipeline_tpu_torch.models import PRESETS
    from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig

    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --cpu)")
    cfg = PRESETS[args.preset]
    out_dir = Path(args.dir or tempfile.mkdtemp(prefix="load_contention-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, layers in (("default", args.layers), ("loaded", args.load_layers)):
        paths[name] = out_dir / f"{args.preset}-{layers}layers-seed{args.seed}.gguf"
        if not paths[name].exists():
            chip_smoke.write_model(paths[name], cfg.replace(n_layers=layers),
                                   args.seed, device=device.type)
    if args.probe:
        print(json.dumps({"lock_probe": lock_probe(paths["loaded"], device),
                          "card": card(device)}), flush=True)
        return
    dtype = torch.float32 if args.cpu else torch.bfloat16
    kw = dict(dtype=dtype, device=device.type, max_seq=2048)
    engine = Engine(paths["default"], **kw)
    prompt = " ".join(["hello"] * args.prompt_tokens)
    gen = GenerationConfig(max_new_tokens=args.new_tokens, temperature=0.0,
                           stop_on_eos=False)
    stream(engine, prompt, gen)   # warm: the kernels built, the buckets seen

    def load() -> dict:
        t0 = time.monotonic()
        e = Engine(paths["loaded"], **kw)
        sync(device)
        t1 = time.monotonic()
        del e
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return {"t0": t0, "t1": t1}

    def read(times: list[float]) -> dict:
        t = np.array(times)
        return {"ttft_ms": float((t[1] - t[0]) * 1e3),
                "max_gap_ms": float(np.diff(t[1:]).max() * 1e3),
                "tokens": len(t) - 1}

    alone = read(stream(engine, prompt, gen))
    spans = timed_steps()
    with Ticker() as tick:
        span = load()
    alone["load_ms"] = (span["t1"] - span["t0"]) * 1e3
    alone["lock_held_ms"] = tick.held_ms(span["t0"], span["t1"])
    phases = {}
    for name, a, b in spans:
        phases[name] = {"ms": (b - a) * 1e3, "lock_held_ms": tick.held_ms(a, b)}
    spans.clear()
    phases["rest"] = {k: alone[k2] - sum(p[k] for p in phases.values())
                      for k, k2 in (("ms", "load_ms"), ("lock_held_ms", "lock_held_ms"))}
    alone["phases"] = phases

    contended = []
    for _ in range(args.reps):
        span, times = {}, []
        loader = threading.Thread(target=lambda: span.update(load()))
        with Ticker() as tick:
            loader.start()
            time.sleep(0.01)
            times[:] = stream(engine, prompt, gen)
            loader.join()
        r = read(times)
        r["load_ms"] = (span["t1"] - span["t0"]) * 1e3
        r["tokens_before_load_end"] = int(sum(1 for x in times[1:] if x < span["t1"]))
        r["lock_held_ms"] = tick.held_ms(span["t0"], span["t1"])
        contended.append(r)
    print(json.dumps({"load_contention": {
        "tree": args.tree or ".", "preset": args.preset, "layers": args.layers,
        "load_layers": args.load_layers, "prompt_tokens": args.prompt_tokens,
        "new_tokens": args.new_tokens, "alone": alone, "contended": contended},
        "card": card(device)}), flush=True)


if __name__ == "__main__":
    main()
