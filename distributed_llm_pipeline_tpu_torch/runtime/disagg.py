"""The KV handoff wire format: one prefilled or mid-decode row as bytes.

The part of ``distributed_llm_pipeline_tpu/runtime/disagg.py`` the
scheduler's preemption needs. A row's KV in the pool's own representation
(dense, ``q8_0`` codes and scales, or latents), its token ids, the
last-position logits, the representation label, the optional prompt text
and any ``x_``-prefixed extras, all in one in-memory npz: the engine's KV
file (``runtime/engine._kv_npz_arrays``) plus the handoff keys. The bytes
are the reference's, so a payload written by either package loads in the
other. The disaggregation roles, the handoff registry and the routes that
move payloads between replicas are not ported yet.

The preemption tier swaps a victim's sampling state out as extras: the
next input token (``x_tok``), the penalty window (``x_recent``) and the
row's ``torch.Generator`` state (``x_rng``, absent for a greedy row); the
reference's rows carry a threefry key (``x_keys``) instead.
"""

from __future__ import annotations

import hashlib
import io

import numpy as np
import torch

from .engine import _KV_DTYPES, _KV_NAMES, _kv_from_npz, _kv_npz_arrays


def kv_mode_label(kv_quant: str | None, kv_mode: str) -> str:
    """The wire label of a pool representation: dense / q8_0 / latent /
    latent_q8_0."""
    if kv_mode == "latent":
        return "latent_q8_0" if kv_quant else "latent"
    return kv_quant or "dense"


def _logits_host(logits) -> tuple[np.ndarray, str]:
    """Logits as the payload stores them: a 2-byte float as its uint16 bits
    under its dtype name, any other dtype as itself."""
    if isinstance(logits, torch.Tensor):
        t = logits.detach().contiguous().cpu()
        if t.element_size() == 2 and t.is_floating_point():
            return t.view(torch.int16).numpy().view(np.uint16), _KV_NAMES[t.dtype]
        a = t.numpy()
    else:
        a = np.asarray(logits)
    return a, str(a.dtype)


def save_handoff_bytes(ids: list[int], cache, length: int, logits,
                       kv_mode: str = "dense",
                       text: str | None = None,
                       extras: dict | None = None) -> bytes:
    """Serialize a row (KV + ids + last-position logits) to the in-memory
    npz payload. ``cache`` is a row-shaped KVCache in the pool's own
    representation; only ``length`` sequence positions are stored.
    ``logits`` is a tensor or an array. ``extras`` (name -> array) ride
    under ``x_``-prefixed keys; the shape check ignores them."""
    arrays = _kv_npz_arrays(ids, cache, length)
    lg, ldtype = _logits_host(logits)
    arrays["logits"] = lg
    arrays["ldtype"] = np.bytes_(ldtype)
    arrays["kv_mode"] = np.bytes_(kv_mode)
    if text is not None:
        arrays["text"] = np.bytes_(text.encode("utf-8", "replace"))
    for name, arr in (extras or {}).items():
        arrays[f"x_{name}"] = np.asarray(arr)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def handoff_extras(data: bytes) -> dict:
    """The ``x_``-prefixed extras a payload carries, by name without the
    prefix (empty for an ordinary prefill handoff)."""
    out = {}
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        for name in z.files:
            if name.startswith("x_"):
                out[name[2:]] = np.array(z[name])
    return out


def load_handoff_bytes(data: bytes, template, max_len: int):
    """Deserialize a payload into ``template`` (the adopting pool's
    ``row_cache()``). Returns ``(cache, ids, logits, text)``, the logits a
    CPU tensor of their stored dtype, or None when the payload does not
    match this pool's representation (model, context, kv_mode or
    quantization: the KV file's shape check)."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        res = _kv_from_npz(z, template, max_len)
        if res is None:
            return None
        cache, ids = res
        ldtype = z["ldtype"].item().decode()
        lg = np.array(z["logits"])
        if lg.dtype == np.uint16 and ldtype in _KV_DTYPES:
            logits = torch.from_numpy(lg.view(np.int16)).view(_KV_DTYPES[ldtype])
        else:
            logits = torch.from_numpy(lg.astype(np.dtype(ldtype), copy=False))
        text = None
        if "text" in z.files:
            text = bytes(z["text"].item()).decode("utf-8", "replace")
    return cache, ids, logits, text


def handoff_mode(data: bytes) -> str | None:
    """The representation label a payload was written under, read without
    the template check (so a refusal can name what it refused); None for
    undecodable bytes."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            if "kv_mode" in z.files:
                return bytes(z["kv_mode"].item()).decode("ascii", "replace")
    except Exception:   # an unreadable payload is simply unlabeled
        pass
    return None


def handoff_digest(data: bytes) -> str:
    """Content digest of a payload (``X-DLP-KV-Digest``): the adopting
    side refuses a mismatch and prefills locally instead."""
    return hashlib.sha256(data).hexdigest()


class HandoffDigestError(ValueError):
    """Payload bytes do not match their content digest (a corrupt
    transfer): HTTP 422."""
