#!/usr/bin/env python3
"""Time the fused decode step (``ops.fused_decode.fused_decode_attn``) of one
tree of the port at ``chip_smoke.py``'s phase-3 cases (``FUSED_CASES``), or
serve its fused slots, on one CUDA card.

    python scripts/fused_time.py [--root DIR] [--label NAME] [--seed N]
                                 [--reps N] [--serve]

``--root`` is the directory whose ``distributed_llm_pipeline_tpu_torch``
package is timed (default: this checkout), for example an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR``; its kernels build
from its own sources. Cases, inputs and the timing (median device time; the
L2 flushed before each call, and warm) come from this checkout's
``chip_smoke.py``, with the same seed, so two trees timed in one call see the
same inputs. Each case is checked against the plain version first
(``FUSED_Y_ULPS`` / ``FUSED_KV_ULPS``). Prints the card's name and power
limit, then one JSON line per case: kernel ms cold and warm L2, the
wrapper's host µs a call (``host_us``) and the same with its C entry
stubbed out (``host_us_without_entry``: the Python checks and allocations
alone), the bound, and where the tree has one its plan and the clusters the
card holds at once.

``--serve`` serves phase 10's fused slots instead (``DLP_FUSED_DECODE=1``,
``ChatServer(parallel=4)``, the phase-5 requests; bf16, then q8_0 weights
over q8_0 pools) from a bf16 Llama-3.2-1B GGUF under ``build/fused_time/``
(written at first use, weights from the seed), and prints each run's
``slots_served`` line (aggregate tok/s) and a profiled fused B = 4 decode
step at 512 cached tokens (wall and device ms, busy share, the host's
Python functions by self time).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def time_cases(cs, args, card: str) -> int:
    """The kernel at FUSED_CASES: one JSON line a case."""
    import torch

    from distributed_llm_pipeline_tpu_torch.models import PRESETS, llama
    from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd
    from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")   # 256 MiB > L2
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for c in cs.FUSED_CASES:
        cfg = PRESETS[c["preset"]].replace(rope_style=c.get("rope_style", "interleaved"))
        g = cs.paged_geometry(dict(B=c["B"], T=1, lengths=c["lengths"], H=cfg.n_heads,
                                   K=cfg.n_kv_heads, Hd=cfg.head_dim,
                                   window=c.get("window", 0), quant=c["kv"] == "q8_0"))
        x = cs.paged_inputs(g, gen)
        kp, vp, tables, lengths = (x[k] for k in ("kp", "vp", "tables", "lengths"))
        ks = vs = None
        if g["quant"]:
            (kp, ks), (vp, vs) = llama.kv_quantize(kp), llama.kv_quantize(vp)
        block, dense = cs.fused_block(llama, qm, cfg, c["w"], g["window"], gen)
        xin = (cs.FUSED_X_SCALE * torch.randn(c["B"], cfg.dim, generator=gen,
                                              device="cuda")).bfloat16()
        cos, sin = (t[:, 0].contiguous() for t in llama.rope_freqs(cfg, lengths.long()[:, None]))

        def kern():
            return fd.fused_decode_attn(xin, block, cos, sin, kp, vp, tables, lengths,
                                        k_scale=ks, v_scale=vs)

        got = kern()
        torch.cuda.synchronize()
        pools = [t.clone() if t is not None else None for t in (kp, vp, ks, vs)]
        want = fd.fused_decode_plain(xin, dense, cos, sin, pools[0], pools[1], tables,
                                     lengths, k_scale=pools[2], v_scale=pools[3])
        errs = {}
        for name, a, b, ulps in zip(("y", "k_new", "v_new"), got, want,
                                    (cs.FUSED_Y_ULPS, cs.FUSED_KV_ULPS, cs.FUSED_KV_ULPS)):
            err = (a.float() - b.float()).abs().max().item()
            if not err <= ulps * cs.bf16_ulp(b.float().abs().max().item()):
                print(json.dumps({"label": args.label, "case": c["name"],
                                  "error": f"{name} max abs err {err}"}), flush=True)
                return 1
            errs[name] = err
        row = {"label": args.label, "case": c["name"], "ms": cs.event_ms(kern, args.reps, flush),
               "warm_l2_ms": cs.event_ms(kern, args.reps, None), "host_us": cs.host_us(kern)}
        entry = fd._kernel()
        fd._fn = lambda *a: 0     # the wrapper without its C entry: nothing launches
        try:
            row["host_us_without_entry"] = cs.host_us(kern)
        finally:
            fd._fn = entry
        row.update(bound_ms=cs.fused_bound(cfg, g, c["w"])[0], max_abs_err=errs)
        if hasattr(fd, "fused_plan"):
            w_q8, ab = c["w"] == "q8_0", xin.element_size()
            plan = fd.fused_plan(c["B"], cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ab,
                                 w_q8, g["quant"])
            row["plan"] = plan._asdict()
            row["max_active_clusters"] = fd.max_active_clusters(
                plan, c["B"], cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ab, w_q8,
                g["quant"])
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


def serve(cs, args, card: str) -> int:
    """Phase 10's fused slots, bf16 then q8_0 weights over q8_0 pools."""
    import torch

    from distributed_llm_pipeline_tpu_torch.models import PRESETS
    from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa
    from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd
    from distributed_llm_pipeline_tpu_torch.ops import paged_attention as pa
    from distributed_llm_pipeline_tpu_torch.runtime import Engine

    cfg = PRESETS["llama3.2-1b"]
    path = HERE / "build" / "fused_time" / f"llama3.2-1b-seed{args.seed}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        cs.write_model(tmp, cfg, args.seed)
        tmp.rename(path)
    os.environ["DLP_FUSED_DECODE"] = "1"
    for quant in (None, "q8_0"):
        t0 = time.monotonic()
        engine = cs.load_kv_engine(Engine, path, card, quant=quant, kv_quant=quant)
        print(json.dumps({"label": args.label, "engine_up_s": time.monotonic() - t0}),
              flush=True)
        cs.serve_slots(engine, pa, fa, cfg, card, args.seed, fd=fd)
        row = cs.profile_paged_decode(engine, fused=True)
        print(json.dumps({"label": args.label, "fused_decode_step_b4": {
            "quant": quant, **row}, "card": card}), flush=True)
        del engine
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="tree whose package is timed")
    ap.add_argument("--label", default="", help="a name printed with each line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--serve", action="store_true", help="serve the fused slots instead")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("fused_time: no CUDA device", file=sys.stderr)
        return 1
    from distributed_llm_pipeline_tpu_torch.ops import fused_decode as fd

    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"label": args.label, "package": str(Path(fd.__file__).resolve()),
                      "cluster": getattr(fd, "FUSED_CLUSTER", None)}), flush=True)
    return serve(cs, args, card) if args.serve else time_cases(cs, args, card)


if __name__ == "__main__":
    sys.exit(main())
