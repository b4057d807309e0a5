"""Host seconds each rank of a tp mesh takes to pack its layers' shard, two
ways, for the PyTorch port (``distributed_llm_pipeline_tpu_torch``):

- ``split_first``: split each dense weight to the rank's slice, then pack
  the slice (what ``parallel.pipeline.rank_params`` does where that gives
  the same packs);
- ``whole_first``: pack each whole weight, then split the pack field-wise.

Both must give the same packs; the script fails if they differ. The
weights are random bf16 at a preset's widths (``--seed``); the layers'
projections only (the head is packed once, on rank 0, either way). Each
rank's share is timed in turn with torch's threads at
``os.cpu_count() // ranks``, as each ``ShardedEngine`` rank runs.

Run: ``python scripts/mesh_pack_time.py [--preset llama3.2-1b] [--mesh 1x2]
[--quant q5_k] [--layers N]``. Prints one JSON line per rank.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_llm_pipeline_tpu_torch.models import PRESETS  # noqa: E402
from distributed_llm_pipeline_tpu_torch.models.llama import quantize_params  # noqa: E402
from distributed_llm_pipeline_tpu_torch.ops.quant_matmul import QuantPack  # noqa: E402
from distributed_llm_pipeline_tpu_torch.parallel import MeshSpec  # noqa: E402
from distributed_llm_pipeline_tpu_torch.parallel.pipeline import (  # noqa: E402
    shard_model_params, stage_counts)


def layer_weights(cfg, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random bf16 projections of every layer, out-features-major [F, D]."""
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (q, cfg.dim), "wk": (kv, cfg.dim), "wv": (kv, cfg.dim),
              "wo": (cfg.dim, q), "w_gate": (cfg.hidden_dim, cfg.dim),
              "w_up": (cfg.hidden_dim, cfg.dim), "w_down": (cfg.dim, cfg.hidden_dim)}
    return {f"layers.{i}.{name}": (torch.randn(shape, generator=gen) * 0.02).bfloat16()
            for i in range(cfg.n_layers) for name, shape in shapes.items()}


def same(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for key, w in a.items():
        v = b[key]
        if isinstance(w, QuantPack):
            if type(v) is not type(w) or any(
                    not torch.equal(w._buffers[f], v._buffers[f]) for f in w.fields):
                return False
        elif not torch.equal(w, v):
            return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="llama3.2-1b")
    ap.add_argument("--mesh", default="1x2")
    ap.add_argument("--quant", default="q5_k")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spec = MeshSpec.parse(args.mesh)
    cfg = PRESETS[args.preset]
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    world = spec.pp * spec.tp
    threads = max(1, (os.cpu_count() or 1) // world)
    torch.set_num_threads(threads)
    params = layer_weights(cfg, torch.Generator().manual_seed(args.seed))
    counts = stage_counts(cfg, spec.pp)
    byte_codes = spec.tp > 1
    for rank in range(world):
        t0 = time.perf_counter()
        split = quantize_params(shard_model_params(params, cfg, spec.pp, spec.tp, rank,
                                                   counts),
                                cfg, args.quant, byte_codes=byte_codes)
        t1 = time.perf_counter()
        stage = shard_model_params(params, cfg, spec.pp, 1, rank // spec.tp, counts)
        whole = quantize_params(stage, cfg, args.quant, byte_codes=byte_codes)
        # the stage's packs under its own layer numbering, then this rank's slice
        whole = shard_model_params(whole, cfg.replace(n_layers=len(stage) // 7), 1,
                                   spec.tp, rank % spec.tp)
        t2 = time.perf_counter()
        if not same(split, whole):
            print(f"rank {rank}: split-first and whole-first packs differ", file=sys.stderr)
            return 1
        print(json.dumps({"rank": rank, "preset": args.preset, "layers": cfg.n_layers,
                          "mesh": args.mesh, "quant": args.quant, "threads": threads,
                          "split_first_s": t1 - t0, "whole_first_s": t2 - t1,
                          "packs": sum(isinstance(w, QuantPack) for w in split.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
