#!/usr/bin/env python3
"""Measure how far the served logits of one tree of the port drift between its
attention kernels and their plain versions, over several prompts, on one CUDA
card: ``chip_smoke.py``'s phase-6 comparisons, each read over N prompts instead
of one.

    python scripts/logit_drift.py [--root DIR] [--label NAME] [--prompts N]

``--root`` is the directory whose ``distributed_llm_pipeline_tpu_torch``
package runs (default: this checkout), for example an earlier commit unpacked
with ``git archive <commit> | tar -x -C DIR``; its kernels build from its own
sources. The model (Llama-3.2-1B geometry, bf16 weights random from seed 0,
as phase 4 writes it), the prompts (seeds 0 .. N-1: a 512-token prefill and
four greedy decode steps) and the measurement come from this checkout's
``chip_smoke.py``. Prints the card's name and power limit, then two JSON
lines: the dense attention kernel against ``flash_attention_plain`` on the
card, and the paged forward on a pool against the dense forward, each with
the max abs logit error by prompt and what of it passes ``LOGIT_TOL``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="tree whose package runs")
    ap.add_argument("--label", default="", help="a name printed with each line")
    ap.add_argument("--prompts", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("logit_drift: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_llm_pipeline_tpu_torch.models import PRESETS, llama
    from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa
    from distributed_llm_pipeline_tpu_torch.runtime import Engine

    card = cs.card_line()
    print(card, flush=True)
    path = HERE / "build" / "chip_smoke" / "logit-drift-llama3.2-1b-seed0.gguf"
    if not path.exists():   # written once, reused by the next tree's run
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        cs.write_model(tmp, PRESETS["llama3.2-1b"], 0)
        tmp.rename(path)
    engine = Engine(path, max_seq=2048)
    plain, paged = [], []
    for i in range(args.prompts):
        ids = cs.prompt_ids(engine, i)
        dense, fed = cs.greedy_run(engine, ids, None)   # the kernels' greedy run
        orig = llama.attention_any
        llama.attention_any = fa.flash_attention_plain
        try:
            plain.append((dense, cs.greedy_run(engine, ids, fed)[0]))
        finally:
            llama.attention_any = orig
        paged.append((cs.greedy_run(engine, ids, fed, paged=True)[0], dense))
    for what, runs, names in (("kernel_vs_plain", plain, ("kernel", "plain")),
                              ("paged_vs_dense", paged, ("paged", "dense"))):
        summary, problem = cs.measure_prompts(runs, *names, cs.LOGIT_TOL)
        print(json.dumps({"label": args.label, what: summary, "over_tol": problem,
                          "package": str(Path(fa.__file__).resolve()), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
