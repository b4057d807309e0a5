"""The llama-cli-style command line of the PyTorch/CUDA port.

The counterpart of ``distributed_llm_pipeline_tpu/cli.py`` (``dlp-tpu``):
generated tokens stream to stdout; the engine's log lines go to stderr
(with ``--verbose``; the closing summary always) and to ``--log-file``. One
shot with ``-p``, or interactive with ``-i`` / ``--interactive-first``
(stdin lines, each wrapped in ``--in-prefix`` / ``--in-suffix``), or a chat
through the model's template with ``-cnv``.

Settings: defaults < ``--config`` file (JSON/TOML) < ``DLP_*`` env < flags.
Without ``--cpu`` it runs on the CUDA device, and raises when there is none.

Usage:
    dlp-tpu-torch -m model.gguf -p "Once upon" -n 64
    python -m distributed_llm_pipeline_tpu_torch.cli -m model.gguf -i
"""

from __future__ import annotations

import argparse
import sys

from .config import DTYPES, config_from_args


def build_argparser() -> argparse.ArgumentParser:
    from .models.llama import QUANT_MODES

    ap = argparse.ArgumentParser(prog="dlp-tpu-torch",
                                 description="GGUF LLM inference on PyTorch/CUDA")
    ap.add_argument("-m", "--model", default=None, help="path to .gguf model")
    ap.add_argument("-p", "--prompt", default=None,
                    help="prompt text (conversation mode: the system prompt)")
    ap.add_argument("-n", "--n-predict", type=int, default=200)
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="after the first generation, keep reading input "
                         "from stdin (llama-cli -i)")
    ap.add_argument("--interactive-first", action="store_true",
                    help="wait for stdin input before generating anything "
                         "(implies -i)")
    ap.add_argument("-cnv", "--conversation", action="store_true",
                    help="multi-turn chat through the model's chat template; "
                         "-p becomes the system prompt")
    ap.add_argument("-r", "--reverse-prompt", action="append", default=[],
                    metavar="TEXT",
                    help="stop and return control to the user when TEXT "
                         "appears (repeatable)")
    ap.add_argument("--in-prefix", default="",
                    help="string put before each interactive input")
    ap.add_argument("--in-suffix", default="",
                    help="string put after each interactive input")
    ap.add_argument("-c", "--ctx-size", type=int, default=2048)
    ap.add_argument("--temp", dest="temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="drop tokens below this fraction of the top token's "
                         "probability (0 disables)")
    ap.add_argument("--typical", dest="typical_p", type=float, default=1.0,
                    help="locally-typical sampling cutoff; 1.0 disables")
    ap.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2],
                    help="mirostat sampling: 0 off, 1 v1, 2 v2 (replaces "
                         "top-k / top-p / typical / min-p)")
    ap.add_argument("--mirostat-ent", dest="mirostat_tau", type=float,
                    default=5.0, help="mirostat target entropy tau")
    ap.add_argument("--mirostat-lr", dest="mirostat_eta", type=float,
                    default=0.1, help="mirostat learning rate eta")
    ap.add_argument("--repeat-penalty", type=float, default=1.0,
                    help="penalize tokens of the recent window (1.0 disables)")
    ap.add_argument("--repeat-last-n", type=int, default=64,
                    help="penalty window size")
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--logit-bias", default=None, metavar="ID(+|-)BIAS,...",
                    help="bias token ids (llama.cpp's format, e.g. "
                         "'29871+1.5,15043-1'); ID-inf bans a token")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="stages x chips, e.g. 2x1 (pp x tp ranks, one process each)")
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES,
                    help="weight and activation dtype")
    ap.add_argument("--quant", default=None, choices=QUANT_MODES,
                    help="keep the weights quantized on the device")
    ap.add_argument("--kv-quant", default=None, choices=["q8_0"],
                    help="int8 KV cache (llama.cpp -ctk/-ctv q8_0)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    return ap


def _drain(events, cfg, log_fh, catch_interrupt: bool = False) -> tuple[str, dict]:
    """Print one generation's events: tokens to stdout, log lines to
    ``--log-file`` and (with ``--verbose``, the closing summary always) to
    stderr. Returns (the text emitted, the done event's data). With
    ``catch_interrupt`` ctrl-C cuts the generation short and returns what
    was emitted."""
    pieces: list[str] = []
    data: dict = {}
    try:
        for ev in events:
            if ev.kind == "token":
                print(ev.content, end="", flush=True)
                pieces.append(ev.content)
                continue
            if ev.kind == "done" and ev.data:
                data = ev.data
            if log_fh:
                print(ev.content, file=log_fh, flush=True)
            if cfg.verbose or ev.kind == "done":
                print(ev.content, file=sys.stderr, flush=True)
    except KeyboardInterrupt:
        if not catch_interrupt:
            raise
        events.close()
    print(flush=True)
    return "".join(pieces), data


def _interactive_loop(engine, gen, cfg, args, log_fh) -> None:
    """llama-cli's interactive and conversation modes: each turn grows one
    transcript (``-i``) or message list rendered through the chat template
    (``-cnv``) and generates again over all of it. A matched reverse prompt
    is withheld from stdout but stays in the transcript. ctrl-C during a
    generation returns control; EOF or ctrl-C at the prompt ends the
    session."""
    from .serving.openai import build_prompt

    conv = args.conversation
    messages: list[dict] = []
    transcript = ""
    if conv:
        if args.prompt:
            messages.append({"role": "system", "content": args.prompt})
    else:
        transcript = args.prompt or ""

    def read_user() -> str | None:
        print("\n> ", end="", file=sys.stderr, flush=True)
        line = sys.stdin.readline()
        return None if not line else line.rstrip("\n")

    def run_turn(prompt_text: str) -> str:
        out, data = _drain(engine.generate(prompt_text, gen), cfg, log_fh,
                           catch_interrupt=True)
        return out + (data.get("stop_match") or "")

    try:
        if not conv and transcript and not args.interactive_first:
            transcript += run_turn(transcript)
        while True:
            line = read_user()
            if line is None:
                return
            if not line.strip():
                continue
            if conv:
                messages.append({"role": "user", "content": line})
                out = run_turn(build_prompt(messages, engine.tokenizer))
                messages.append({"role": "assistant", "content": out})
            else:
                # the typed newline stays in context, so the user's words
                # never merge into the model's last token
                transcript += args.in_prefix + line + "\n" + args.in_suffix
                transcript += run_turn(transcript)
    except KeyboardInterrupt:
        print(flush=True)


def main(argv: list[str] | None = None) -> int:
    try:
        cfg, args = config_from_args(argv, build_argparser)
        cfg.require_model()
        cfg.validate()
        bias_pairs = cfg.logit_bias_pairs()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from .runtime import GenerationConfig
    from .serving.server import build_engine

    log_fh = open(cfg.log_file, "a") if cfg.log_file else None
    try:
        try:
            engine = build_engine(cfg)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        gen = GenerationConfig(max_new_tokens=cfg.n_predict,
                               temperature=cfg.temperature, top_k=cfg.top_k,
                               top_p=cfg.top_p, min_p=cfg.min_p,
                               typical_p=cfg.typical_p, mirostat=cfg.mirostat,
                               mirostat_tau=cfg.mirostat_tau,
                               mirostat_eta=cfg.mirostat_eta,
                               repeat_penalty=cfg.repeat_penalty,
                               repeat_last_n=cfg.repeat_last_n,
                               presence_penalty=cfg.presence_penalty,
                               frequency_penalty=cfg.frequency_penalty,
                               logit_bias=bias_pairs, seed=cfg.seed,
                               # reverse prompts are stop strings in both modes
                               stop=tuple(args.reverse_prompt))
        try:
            if args.interactive or args.interactive_first or args.conversation:
                _interactive_loop(engine, gen, cfg, args, log_fh)
            else:
                prompt = args.prompt if args.prompt is not None else "Once upon a time"
                _drain(engine.generate(prompt, gen), cfg, log_fh)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        finally:
            if cfg.mesh:
                engine.close()
    finally:
        if log_fh:
            log_fh.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
