#!/usr/bin/env python3
"""Time the fused-dequant kernels (``ops.quant_matmul.dequant_matmul``: Q4_K,
Q6_K, Q5_K, Q8_0), the int8 GEMM (``ops.quant_matmul.int8_matmul``) and the
W8A8 kernels (``ops.quant_matmul.w8a8_matmul``) of one tree of the port at
``chip_smoke.py``'s phase-3 cases, on one CUDA card.

    python scripts/dequant_time.py [--root DIR] [--label NAME] [--seed N]
                                   [--kinds q6_k,q4_k,q5_k,q8_0,int8,q2_ks,q5_ks,q8_0:w8a8,int8:w8a8]
                                   [--ttft DIR]

``--root`` is the directory whose ``distributed_llm_pipeline_tpu_torch``
package is timed (default: this checkout), for example an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR``; its kernels build
from its own sources. Packs, inputs and the timing (median device time, the
L2 flushed before each call) come from this checkout's ``chip_smoke.py``,
with the same seed, so two trees timed in one process run see the same
cases. Prints the card's name and power limit, then one JSON line per case
(kind, projection pair, M, D, F, ms). Q6_K and Q4_K run at Llama-3.2-1B's
projection pairs at phase 3's M; Q8_0 and int8 there too (M = 33, 256, 512:
the int8 cases above the W8A8 cutover) and at phase 3's edges at M = 100
(the odd F; group 32, D = 2080; int8's group 128, D = 1152), and int8 at M
>= 256 also prints its quantize and GEMM launches' µs apart. Q5_K (the byte
codes of tp = 2 meshes) runs at the shard pairs and the D = 1056 edge at
the shard M, then one line gives its device time a mixed step of the
``--mesh 1x2 --parallel 4 --quant q5_k`` path (rank 0, M = 64): 16 layers
of wq, wk, wv, wo, gate, up and down.

A kind with no fused-dequant kernel (Q2_KS, Q5_KS, Q3_KS, Q4_K8, Q6_K8), or
any kind written ``<kind>:w8a8``, times its W8A8 kernel instead, at phase
3's W8A8 cases: the projection pairs (a byte-code kind's tp = 2 shard pairs,
its head at M <= 4) at M = 1, 4, 16, 32, the odd F and the activation-group-32
edge at M = 3, each line with the wrapper's host µs a call (``host_us``).
Q5_KS, Q2_KS, Q8_0, Q6_K, Q4_K and Q3_KS then print the W8A8 device time
of the decode step that serves them, by these times: a B = 4 slot step of
``--quant q5_k`` (16 layers), ``--quant q2_k`` (8 layers, as phase 9
serves it) and ``--quant q8_0`` (16 layers), the layers' wq, wk, wv, wo,
gate, up and down and the head at M = 4; and the one-stream steps at M =
1 of the native Q6_K GGUF (16 layers, every projection), of the Q4_K_M
GGUF (16 layers; its Q4_K projections wq, wk, wo, gate and up, as
``chip_smoke.q4_k_m_types`` leaves wv and down in mixed stacks that load
dense) and of the Q3_K GGUF (8 layers, as phase 9 serves it, every
projection); their heads are dense.

``int8:w8a8`` times the route the served int8 decode steps take: int8
at M <= 4 (``INT8_W8A8_MAX_M``) runs ``w8a8_matmul``'s ``w8a8_kernel``
(int8 has no GEMV decoder at any D). At gate_up (D 2048, F 8192), M = 1 and
M = 4, each line is ``chip_smoke.quant_case``'s: the kernel held to its
plain version, its cold- and warm-L2 device time, the bound (the pack, x and
the output once over HBM, or the int8 operations over the tensor-core peak,
whichever is longer) and ``F.linear``'s time on the dense bf16 weight the
pack represents, with the launch counter the route moves.

With ``--ttft DIR``, it also serves ``chip_smoke.py``'s phase-7 and phase-8
models (Llama-3.2-1B geometry, Q6_K and Q4_K_M GGUFs from the same seeds,
written to DIR once and reused) through the tree's ``Engine(quant="native")``
one stream, and prints the median engine TTFT of 5 runs of the ~481-token
greedy request after a warm-up.
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
    ap.add_argument("--kinds", default="q6_k,q4_k,q5_k", help="pack kinds to time "
                    "(of q6_k, q4_k, q5_k, q8_0, int8; q2_ks, q5_ks, q3_ks, q4_k8, "
                    "q6_k8 or <kind>:w8a8 for a W8A8 kernel; int8:w8a8 for int8's "
                    "decode route at gate_up)")
    ap.add_argument("--ttft", default="", help="directory for the served models' GGUFs")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("dequant_time: no CUDA device", file=sys.stderr)
        return 1
    from distributed_llm_pipeline_tpu_torch.ops import kquant_matmul as kq
    from distributed_llm_pipeline_tpu_torch.ops import quant_matmul as qm

    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"label": args.label, "package": str(Path(qm.__file__).resolve())}),
          flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")   # 256 MiB > L2
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for spec in args.kinds.split(","):
        kind, _, route = spec.partition(":")
        if spec == "int8:w8a8":
            time_int8_decode(cs, qm, kq, gen, flush, card, args.label)
            continue
        if route == "w8a8" or qm._NAMES[kind][0] is None:
            time_w8a8(cs, qm, kq, kind, gen, flush, card, args.label)
            continue
        at64 = {}
        for pair, D, F, ms_of in cases(cs, kind):
            pack = cs.random_pack(qm, kq, kind, D, F, gen)
            out_dtype = torch.float32 if pair == "head" else torch.bfloat16
            for M in ms_of:
                x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
                if kind == "int8":
                    def call():
                        return qm.int8_matmul(x, pack, out_dtype)
                else:
                    def call():
                        return qm.dequant_matmul(x, pack, out_dtype)
                row = {"label": args.label, "kind": kind, "pair": pair, "M": M, "D": D, "F": F,
                       "ms": cs.event_ms(call, 50, flush)}
                if kind == "int8" and M >= 256:
                    row["device_us"] = cs.split_kernel_us(call, 20, flush, cs.INT8_KERNELS)
                print(json.dumps({**row, "card": card}), flush=True)
                if M == 64:
                    at64[pair] = row["ms"]
            del pack
        if kind == "q5_k":
            # a layer: wq, wk and wv (wk_wv twice), wo, gate and up, down
            layer = (at64["wq"] + 2 * at64["wk_wv"] + at64["wo"] + 2 * at64["gate_up"]
                     + at64["down"])
            print(json.dumps({"label": args.label, "q5_k_mixed_step_ms": 16 * layer,
                              "of": "16 x (wq + 2 wk_wv + wo + 2 gate_up + down) at M = 64, "
                                    "cold L2", "card": card}), flush=True)
    del flush
    if args.ttft:
        serve_ttft(cs, Path(args.ttft), args.seed, args.label, card)
    return 0


# the served decode steps whose W8A8 time is summed: kind -> (layers, M,
# whether the head is packed, a layer's launches by pair)
EVERY = {"wq_wo": 2, "wk_wv": 2, "gate_up": 2, "down": 1}
STEPS = {"q5_ks": (16, 4, True, EVERY), "q2_ks": (8, 4, True, EVERY),
         "q8_0": (16, 4, True, EVERY), "q6_k": (16, 1, False, EVERY),
         "q4_k": (16, 1, False, {"wq_wo": 2, "wk_wv": 1, "gate_up": 2}),
         "q3_ks": (8, 1, False, EVERY)}


def time_w8a8(cs, qm, kq, kind: str, gen, flush, card: str, label: str) -> None:
    """The W8A8 kernel of ``kind`` at phase 3's W8A8 cases, one line each."""
    import torch

    byte = kind in cs.BYTE_KINDS
    cases = [(p, D, F, M) for p, D, F in (cs.SHARD_PAIRS if byte else cs.QUANT_PAIRS)
             for M in cs.W8A8_M if not (byte and p == "head" and M > 4)]
    for e in cs.QUANT_EDGES:
        if isinstance(e["D"], dict) and kind not in e["D"]:
            continue
        D = e["D"][kind] if isinstance(e["D"], dict) else e["D"]
        cases.append((e["name"], D, e["F"], 3))
    at, packs = {}, {}
    for pair, D, F, M in cases:
        if pair not in packs:
            packs[pair] = cs.random_pack(qm, kq, kind, D, F, gen)
        pack = packs[pair]
        out_dtype = torch.float32 if pair == "head" else torch.bfloat16
        x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()

        def call():
            return qm.w8a8_matmul(x, pack, out_dtype)

        row = {"label": label, "kind": kind, "route": "w8a8", "pair": pair, "M": M, "D": D,
               "F": F, "ms": cs.event_ms(call, 50, flush), "host_us": cs.host_us(call)}
        print(json.dumps({**row, "card": card}), flush=True)
        at[pair, M] = row["ms"]
    if kind in STEPS:
        n, M, head, layer = STEPS[kind]
        step = n * sum(c * at[p, M] for p, c in layer.items()) + (at["head", M] if head else 0.0)
        terms = " + ".join(f"{c} {p}" for p, c in layer.items())
        print(json.dumps({"label": label, f"{kind}_decode_step_w8a8_ms": step,
                          "of": f"{n} x ({terms}){' + head' if head else ''} at M = {M}, "
                                "cold L2", "card": card}), flush=True)


def time_int8_decode(cs, qm, kq, gen, flush, card: str, label: str) -> None:
    """int8 at gate_up on the decode route (M = 1 and 4): the kernel, its
    bound and ``F.linear`` on the dense weight, as phase 3 holds them."""
    import torch

    pair, D, F = next(c for c in cs.QUANT_PAIRS if c[0] == "gate_up")
    pack = cs.random_pack(qm, kq, "int8", D, F, gen)
    for M in (1, 4):
        row = cs.quant_case(qm, pack, "int8", M, torch.bfloat16, gen, flush)
        print(json.dumps({"label": label, "pair": pair, "route": qm.route("int8", M),
                          "gemv": qm.gemv_takes("int8", D), **row, "card": card}),
              flush=True)


def cases(cs, kind: str) -> list[tuple[str, int, int, tuple[int, ...]]]:
    """(pair, D, F, the M timed) of phase 3 for ``kind``."""
    if kind == "q5_k":
        # the shard pairs (a byte head serves only M <= 4) and the edge
        return [(p, D, F, cs.SHARD_DEQUANT_M) for p, D, F in cs.SHARD_PAIRS if p != "head"] + [
            ("group32", cs.QUANT_EDGES[1]["D"]["q5_k"], cs.QUANT_EDGES[1]["F"],
             cs.SHARD_DEQUANT_M)]
    out = [(p, D, F, cs.DEQUANT_M) for p, D, F in cs.QUANT_PAIRS]
    if kind in ("q8_0", "int8"):
        for e in cs.QUANT_EDGES:
            if not isinstance(e["D"], dict):
                out.append((e["name"], e["D"], e["F"], (100,)))
            elif kind in e["D"]:
                out.append((e["name"], e["D"][kind], e["F"], (100,)))
    return out


def serve_ttft(cs, where: Path, seed: int, label: str, card: str) -> None:
    """The one-stream engine TTFT of phases 7 (Q6_K) and 8 (Q4_K_M)."""
    import torch

    from distributed_llm_pipeline_tpu_torch.gguf import GGMLType
    from distributed_llm_pipeline_tpu_torch.models import PRESETS
    from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig

    cfg = PRESETS["llama3.2-1b"]
    where.mkdir(parents=True, exist_ok=True)
    prompt = " ".join(["hello"] * 480)
    for phase, name, wtype, model_seed in (
            (7, "q6_k", GGMLType.Q6_K, seed + 1),
            (8, "q4_k_m", cs.q4_k_m_types(cfg.n_layers), seed + 2)):
        path = where / f"llama3.2-1b-{name}-seed{model_seed}.gguf"
        if not path.exists():
            tmp = path.with_suffix(".tmp")
            cs.write_model(tmp, cfg, model_seed, wtype=wtype)
            tmp.rename(path)
        engine = Engine(path, max_seq=2048, quant="native")
        gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
        ttfts = []
        for _ in range(6):
            ttfts.append(list(engine.generate(prompt, gen))[-1].data["ttft_ms"])
        runs = sorted(ttfts[1:])
        print(json.dumps({"label": label, "phase": phase, "model": name,
                          "engine_ttft_ms": runs[len(runs) // 2], "runs_ms": ttfts[1:],
                          "warm_up_ms": ttfts[0], "card": card}), flush=True)
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
