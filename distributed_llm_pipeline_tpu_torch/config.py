"""Layered settings of the CLI and the server: defaults < config file < env < flags.

The counterpart of ``distributed_llm_pipeline_tpu/config.py`` for the keys
the port serves: the same knobs come from a JSON or TOML file
(``--config``), ``DLP_*`` environment variables and command-line flags,
later layers winning.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tomllib
from dataclasses import dataclass
from pathlib import Path
from typing import Any

DTYPES = ("bfloat16", "bf16", "float16", "f16", "float32", "f32")


@dataclass
class AppConfig:
    """Every tunable shared by the CLI and the server."""

    model: str | None = None         # path to .gguf
    mesh: str | None = None          # "PPxTP" pipeline stages x tensor ranks
    ctx_size: int = 2048
    n_predict: int = 200
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0               # 0 disables
    typical_p: float = 1.0           # llama.cpp --typical; 1 disables
    mirostat: int = 0                # llama.cpp --mirostat 0|1|2
    mirostat_tau: float = 5.0        # --mirostat-ent (target entropy)
    mirostat_eta: float = 0.1        # --mirostat-lr (learning rate)
    repeat_penalty: float = 1.0      # 1 disables
    repeat_last_n: int = 64          # penalty window
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: str | None = None    # "TOKEN_ID(+|-)BIAS,..." (llama.cpp)
    seed: int | None = None
    host: str = "0.0.0.0"
    port: int = 3005
    cpu: bool = False                # run on the CPU (default: the CUDA device)
    dtype: str = "bfloat16"          # weight and activation dtype
    quant: str | None = None         # keep the weights quantized on the device
    kv_quant: str | None = None      # int8 KV cache (llama.cpp -ctk/-ctv q8_0)
    parallel: int = 1                # server decode slots (llama-server -np)
    log_file: str | None = None
    verbose: bool = False

    _INT = ("ctx_size", "n_predict", "top_k", "seed", "port", "repeat_last_n",
            "parallel", "mirostat")
    _FLOAT = ("temperature", "top_p", "min_p", "repeat_penalty", "typical_p",
              "mirostat_tau", "mirostat_eta", "presence_penalty", "frequency_penalty")
    _BOOL = ("cpu", "verbose")

    @classmethod
    def field_names(cls) -> list[str]:
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def _coerce(cls, key: str, value: Any) -> Any:
        if value is None:
            return None
        if key in cls._BOOL:
            if isinstance(value, bool):
                return value
            return str(value).strip().lower() in ("1", "true", "yes", "on")
        if key in cls._INT:
            return int(value)
        if key in cls._FLOAT:
            return float(value)
        return str(value)

    @classmethod
    def load(cls, config_file: str | Path | None = None,
             env: dict[str, str] | None = None,
             overrides: dict[str, Any] | None = None) -> "AppConfig":
        """Merge: dataclass defaults < config file < DLP_* env < overrides
        (the flags actually given; absent keys are left out)."""
        merged: dict[str, Any] = {}
        if config_file:
            merged.update(read_config_file(config_file))
        for key in cls.field_names():
            env_val = (env if env is not None else os.environ).get(f"DLP_{key.upper()}")
            if env_val is not None:
                merged[key] = env_val
        if overrides:
            merged.update({k: v for k, v in overrides.items() if v is not None})
        unknown = set(merged) - set(cls.field_names())
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)} "
                             f"(valid: {cls.field_names()})")
        return cls(**{k: cls._coerce(k, v) for k, v in merged.items()})

    def require_model(self) -> str:
        if not self.model:
            raise ValueError("no model configured: pass -m/--model, set "
                             "DLP_MODEL, or put 'model' in the config file")
        return self.model

    def validate(self) -> None:
        """Checks that fail before a model load starts (env and config-file
        values bypass argparse's choices)."""
        from .models.llama import check_kv_quant, check_quant

        check_quant(self.quant)
        check_kv_quant(self.kv_quant)
        if self.mirostat not in (0, 1, 2):
            raise ValueError(f"mirostat must be 0, 1 or 2, got {self.mirostat}")
        if self.parallel < 1:
            raise ValueError(f"--parallel must be >= 1, got {self.parallel}")
        self.torch_dtype()

    def logit_bias_pairs(self) -> tuple[tuple[int, float], ...]:
        """The parsed --logit-bias: comma-separated TOKEN_ID(+|-)BIAS entries
        (llama.cpp's format, e.g. "29871+1.5,15043-1"); TOKEN_ID-inf (or
        "false") bans the token."""
        if not self.logit_bias:
            return ()
        out = []
        for item in self.logit_bias.split(","):
            item = item.strip()
            if not item:
                continue
            # split at the first sign of the entry: a bias like 123-1e+2
            # splits at the '-', not inside 'e+2'
            cuts = [i for i in (item.find("+", 1), item.find("-", 1)) if i > 0]
            if not cuts:
                raise ValueError(f"--logit-bias entry {item!r}: expected "
                                 f"TOKEN_ID(+|-)BIAS")
            i = min(cuts)
            tid, val = item[:i], item[i:]
            if val in ("-inf", "-false") or val.lstrip("+-") == "false":
                b = float("-inf")
            else:
                b = float(val)
            out.append((int(tid), b))
        return tuple(out)

    def torch_dtype(self):
        return torch_dtype(self.dtype)


def torch_dtype(name: str):
    """The torch dtype a ``--dtype`` name stands for (one of ``DTYPES``)."""
    import torch

    table = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float32": torch.float32, "f32": torch.float32,
             "float16": torch.float16, "f16": torch.float16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r} (choose from {sorted(table)})")
    return table[name]


def read_config_file(path: str | Path) -> dict[str, Any]:
    """Parse a JSON (``.json``) or TOML (``.toml``) config file to a dict."""
    p = Path(path)
    if not p.is_file():  # ValueError keeps entry points on the exit-2 path
        raise ValueError(f"config file not found: {p}")
    text = p.read_text()
    if p.suffix == ".toml":
        return tomllib.loads(text)
    if p.suffix == ".json":
        return json.loads(text)
    raise ValueError(f"config file must be .json or .toml, got {p.suffix!r}")


def config_from_args(argv: list[str] | None, parser_builder) -> tuple[AppConfig, Any]:
    """Peel ``--config FILE`` off ``argv``, then parse the whole flag set
    with every config-backed flag's default suppressed: the flags given
    override the file and env layers, the others fall through to them.
    Returns ``(config, namespace)``; flags that are not config keys (e.g.
    ``--prompt``) keep their argparse defaults in the namespace."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    known, _ = pre.parse_known_args(argv)

    ap = parser_builder()
    ap.add_argument("--config", default=None, metavar="FILE",
                    help="JSON/TOML config file (flags override it)")
    fields = set(AppConfig.field_names())
    for action in ap._actions:
        if action.dest in fields:
            action.default = argparse.SUPPRESS
            action.required = False
    args = ap.parse_args(argv)
    overrides = {k: getattr(args, k) for k in fields if hasattr(args, k)}
    return AppConfig.load(known.config, overrides=overrides), args
