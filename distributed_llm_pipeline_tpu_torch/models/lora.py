"""LoRA adapters merged at load (llama.cpp ``--lora`` / ``--lora-scaled``).

A copy of ``distributed_llm_pipeline_tpu/models/lora.py`` over the port's
own GGUF reader and writer and its flat parameter state. An adapter is a
GGUF file (``general.type = "adapter"``, ``adapter.type = "lora"``,
``adapter.lora.alpha`` f32) whose tensors pair each base weight with
low-rank factors named ``<base tensor name>.lora_a`` / ``.lora_b``. The
merged weight is ``W + scale * (alpha / r) * (B @ A)`` with ``A [r, in]``
and ``B [out, r]`` in the GGUF's (out, in) orientation, which is also the
port's, so the delta applies untransposed.

The merge runs on the host in numpy, as the reference's does: the delta is
``(B @ A) * eff`` in f32, added to the weight's f32 values and cast back to
the load dtype, before any packing, factorization or device placement. The
merged weights are then bit-equal to the reference's, the serving graph is
the base model's, and ``--quant`` packs the merged weights. Swapping
adapters takes an engine reload (``/models/load``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..gguf import GGUFReader
from .config import ModelConfig

# adapter base-tensor name -> the layer's parameter leaf (None: not adaptable)
_LAYER_KEYS = {
    "attn_q": "wq", "attn_k": "wk", "attn_v": "wv", "attn_output": "wo",
    "ffn_gate": "w_gate", "ffn_up": "w_up", "ffn_down": "w_down",
    "attn_norm": None, "ffn_norm": None,  # norms: LoRA not meaningful
}


class LoRAError(ValueError):
    pass


def parse_lora_arg(spec: str) -> tuple[str, float]:
    """"path" or "path=scale" → (path, scale)."""
    if "=" in spec:
        path, _, s = spec.rpartition("=")
        try:
            return path, float(s)
        except ValueError:
            pass  # '=' was part of the filename
    return spec, 1.0


def read_adapter(path: str | Path):
    """Open and validate an adapter GGUF. Returns (reader, alpha, pairs),
    ``pairs`` mapping each base tensor name to (name_a, name_b)."""
    reader = GGUFReader(path)
    md = reader.metadata
    gtype = md.get("general.type")
    atype = md.get("adapter.type")
    if gtype not in (None, "adapter") or (atype is not None and atype != "lora"):
        reader.close()
        raise LoRAError(f"{path}: not a LoRA adapter GGUF "
                        f"(general.type={gtype!r}, adapter.type={atype!r})")
    alpha = float(md.get("adapter.lora.alpha", 0.0))
    pairs: dict[str, tuple[str, str]] = {}
    for name in reader.tensors:
        if name.endswith(".lora_a"):
            base = name[: -len(".lora_a")]
            b = base + ".lora_b"
            if b not in reader.tensors:
                reader.close()
                raise LoRAError(f"{path}: {name} has no matching .lora_b")
            pairs[base] = (name, b)
        elif not name.endswith(".lora_b"):
            reader.close()
            raise LoRAError(f"{path}: unexpected tensor {name!r} in adapter")
    if not pairs:
        reader.close()
        raise LoRAError(f"{path}: adapter contains no lora_a/lora_b pairs")
    return reader, alpha, pairs


def _delta(reader: GGUFReader, name_a: str, name_b: str, alpha: float,
           scale: float) -> np.ndarray:
    """scale·(alpha/r)·(B @ A) in the (out, in) orientation, f32."""
    a = reader.tensor_f32(name_a)          # [r, in]
    b = reader.tensor_f32(name_b)          # [out, r]
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[1]:
        raise LoRAError(f"{name_a}/{name_b}: rank mismatch "
                        f"{a.shape} x {b.shape}")
    r = a.shape[0]
    eff = scale * (alpha / r if alpha > 0 else 1.0)
    return (b.astype(np.float32) @ a.astype(np.float32)) * eff


def _merge(w: torch.Tensor, d: np.ndarray) -> torch.Tensor:
    """``w`` plus the delta in f32 on the host, cast back to ``w``'s dtype
    (round to nearest even, as the reference's numpy cast)."""
    w32 = w.detach().to("cpu", torch.float32).numpy()
    return torch.from_numpy(w32 + d).to(device=w.device, dtype=w.dtype)


def apply_lora(params: dict, cfg: ModelConfig, adapters: list[tuple[str, float]],
               keep: Callable[[str], bool] | None = None) -> list[str]:
    """Merge adapters into a host-resident dense parameter state in place.

    ``adapters``: [(path, user_scale), ...], applied in order (llama.cpp
    sums several --lora adapters the same way). ``keep`` (a mesh rank's
    filter of ``load_params``) skips the targets the rank does not hold;
    they are checked by name and counted all the same. Returns summary lines
    for the engine's load log. Raises :class:`LoRAError` for an adapter
    that targets a tensor the model does not have, or a quantized pack,
    which cannot absorb a dense delta."""
    from ..ops.quant_matmul import QuantPack

    keep = keep or (lambda key: True)
    lines = []
    for path, scale in adapters:
        reader, alpha, pairs = read_adapter(path)
        try:
            n_applied = 0
            for base, (na, nb) in sorted(pairs.items()):
                d = _delta(reader, na, nb, alpha, scale)   # (out, in)
                if base == "output.weight":
                    if "lm_head" not in params and keep("lm_head"):
                        raise LoRAError(
                            f"{path}: adapter targets output.weight but the "
                            f"model ties embeddings (no lm_head)")
                    key, held = "lm_head", keep("lm_head")
                else:
                    parts = base.split(".")
                    if (len(parts) != 4 or parts[0] != "blk"
                            or parts[3] != "weight"
                            or _LAYER_KEYS.get(parts[2]) is None):
                        raise LoRAError(
                            f"{path}: unsupported adapter target {base!r}")
                    idx = int(parts[1])
                    if idx >= cfg.n_layers:
                        raise LoRAError(f"{path}: {base} targets layer {idx} "
                                        f"but the model has {cfg.n_layers}")
                    key = f"layers.{idx}.{_LAYER_KEYS[parts[2]]}"
                    held = keep(f"layers.{idx}.")
                if not held:
                    n_applied += 1
                    continue
                w = params.get(key)
                if w is None:
                    raise LoRAError(f"{path}: model has no tensor for {base}")
                if isinstance(w, QuantPack):
                    raise LoRAError(
                        "LoRA merges into dense weights; --quant native "
                        "keeps them packed — drop one of the two")
                # the texts name shapes in the reference's (in, out) layout
                if d.shape != tuple(w.shape):
                    raise LoRAError(f"{path}: {base} delta {d.shape[::-1]} "
                                    f"!= weight {tuple(w.shape)[::-1]}")
                params[key] = _merge(w, d)
                n_applied += 1
            lines.append(
                f"lora adapter {Path(path).name}: merged {n_applied} tensors "
                f"(alpha={alpha:g}, scale={scale:g})")
        finally:
            reader.close()
    return lines


def write_lora_gguf(path: str | Path, alpha: float,
                    tensors: dict[str, tuple[np.ndarray, np.ndarray]]) -> Path:
    """Write an adapter GGUF (llama.cpp's layout): ``tensors`` maps each
    base tensor name to (A [r, in], B [out, r])."""
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter(path)
    w.add("general.type", "adapter")
    w.add("adapter.type", "lora")
    w.add("adapter.lora.alpha", float(alpha))
    for base, (a, b) in tensors.items():
        w.add_tensor(base + ".lora_a", np.asarray(a, np.float32))
        w.add_tensor(base + ".lora_b", np.asarray(b, np.float32))
    return w.write()
