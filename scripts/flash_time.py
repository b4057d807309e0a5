#!/usr/bin/env python3
"""Time the dense cache's attention kernel (``ops.flash_attention.flash_attention``)
of one tree of the port at ``chip_smoke.py``'s phase-3 cases, on one CUDA card.

    python scripts/flash_time.py [--root DIR] [--label NAME] [--seed N]

``--root`` is the directory whose ``distributed_llm_pipeline_tpu_torch``
package is timed (default: this checkout), for example an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR``; its kernels build
from its own sources. Cases, inputs and the timing (median device time, the
L2 flushed before each call) come from this checkout's ``chip_smoke.py``,
with the same seed, so two trees timed in one process run see the same
inputs. Prints the card's name and power limit, then one JSON line per case
(name, kernel ms cold and warm L2).
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
    ap.add_argument("--root", default=str(HERE), help="tree whose package is timed")
    ap.add_argument("--label", default="", help="a name printed with each line")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("flash_time: no CUDA device", file=sys.stderr)
        return 1
    from distributed_llm_pipeline_tpu_torch.models import llama
    from distributed_llm_pipeline_tpu_torch.ops import flash_attention as fa

    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"label": args.label, "package": str(Path(fa.__file__).resolve())}),
          flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")   # 256 MiB > L2
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for c in cs.ATTN_CASES:
        q, k, v, cache_len, kw = cs.attn_inputs(c, llama.kv_quantize, gen)

        def kernel():
            return fa.flash_attention(q, k, v, cache_len, c["H"] // c["K"], **kw)

        print(json.dumps({"label": args.label, "case": c["name"],
                          "ms": cs.event_ms(kernel, 50, flush),
                          "warm_l2_ms": cs.event_ms(kernel, 50, None), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
