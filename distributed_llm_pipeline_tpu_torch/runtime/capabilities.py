"""The serving-feature opt-ins of this slice and the one rule that combines
them: a copy of the part of ``distributed_llm_pipeline_tpu/runtime/
capabilities.py`` the single-device paged path needs, under the reference's
names.

- ``env_kv_latent`` (``DLP_KV_LATENT=1``) and ``fused_requested``
  (``DLP_FUSED_DECODE=1``) are the only readers of their env variables.
- The reference's ``latent-kv`` rule: the fused decode kernel reads per-head
  K/V, so a latent pool decodes unfused. ``Engine.resolve_fused_decode``
  applies it; the reference's first-match lattice comes with the slices
  that have more than one rule.
- ``DEGRADE_REASONS`` is the closed vocabulary of the reasons this slice
  emits: ``latent-kv`` and the per-config families of
  ``ops/fused_decode.fused_supported``; ``check_reason`` holds a reason to
  it.
"""

from __future__ import annotations

import os

DEGRADE_REASONS = (
    # combination reason: fused decode over a latent pool
    "latent-kv",
    # per-config ops/fused_decode.fused_supported families
    "norm-type", "no-pre-norms", "norm-offset", "qk-norm", "attn-bias",
    "sandwich-norms", "rope-style", "head-dim", "gqa-ragged",
    "weight-pack", "q8_0-align", "vmem",
)


def env_kv_latent() -> bool:
    """Latent-KV opt-in (DLP_KV_LATENT=1)."""
    return os.environ.get("DLP_KV_LATENT", "0") == "1"


def fused_requested() -> bool:
    """Fused decode-step kernel opt-in (DLP_FUSED_DECODE=1)."""
    return os.environ.get("DLP_FUSED_DECODE", "0") == "1"


def reason_family(reason: str) -> str:
    """A degrade reason's family: its prefix before ``:`` (``vmem:40KiB`` →
    ``vmem``)."""
    return reason.split(":", 1)[0]


def check_reason(reason: str) -> str:
    """Raise unless the reason's family is declared in DEGRADE_REASONS."""
    if reason_family(reason) not in DEGRADE_REASONS:
        raise ValueError(f"undeclared capability degrade reason {reason!r}: "
                         "declare its family in runtime/capabilities.DEGRADE_REASONS")
    return reason
