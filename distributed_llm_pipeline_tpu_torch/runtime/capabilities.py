"""The one declared capability lattice: a copy of
``distributed_llm_pipeline_tpu/runtime/capabilities.py`` (the port imports
nothing of the JAX package).

Six composable serving features — paged KV, latent KV, q8_0 KV, the fused
decode-step kernel, the multi-device backends, pool roles — compose through
one declared feature-composition matrix and a single ``resolve()`` entry
point every boot path routes through:

* ``AXES`` names the feature axes and their values; a *cell* is one value
  per axis (``cell_label`` renders it ``layout/repr/decode/backend/role``).
* ``LATTICE`` is an ordered first-match rule list. Resolution applies the
  first matching rule, rewrites the cell (``degrades``) or refuses it
  (``rejected``), and repeats until no rule matches — the fixpoint is the
  *resolved* cell. Every degrade carries a declared ``reason`` and is
  counted on ``capability_degradations_total{axis=,reason=}`` plus a boot
  log line, so no combination is downgraded silently. A feature the
  caller requested *explicitly* (vs an env default) is never silently
  rewritten: a degrade on an explicit axis raises ``CapabilityError``.
* ``DEGRADE_REASONS`` is the closed reason vocabulary. Reason strings on
  ``fused_decode_fallbacks_total{reason=}`` and
  ``capability_degradations_total{reason=}`` must have their family (the
  prefix before ``:``) declared here; ``check_reason`` enforces it.
* ``CAPABILITY_ENVS`` are the env opt-ins that select cells. Their only
  readers are the ``env_*`` helpers below.

The tables are pure literals and the module is stdlib-only, as in the
reference. Where the port serves a cell the lattice supports but has not
ported it yet (latent or q8_0 KV on a mesh), the engine refuses after
resolution with its own text.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

__all__ = [
    "AXES", "LATTICE", "RUNTIME_VOCAB", "PARITY_AXES", "CAPABILITY_ENVS",
    "DEGRADE_REASONS", "REJECT_REASONS", "CapabilityError", "Degradation",
    "Resolution", "resolve", "resolve_boot", "classify", "cell_label",
    "enumerate_cells", "cpu_reachable", "kv_repr_label", "repr_kv_mode",
    "check_reason", "reason_family", "env_kv_latent",
    "env_kv_paged_default", "fused_requested", "env_pool_role",
]

# -- the declared lattice (pure literals: ast.literal_eval-able) ------------

# Axis order is the cell-label order: kv_layout/kv_repr/decode/backend/role.
AXES = {
    "kv_layout": ("dense", "paged"),
    "kv_repr": ("bf16", "q8_0", "latent", "latent_q8_0"),
    "decode": ("unfused", "fused"),
    "backend": ("engine", "paged-slots", "dense-slots", "mesh", "ring"),
    "role": ("both", "prefill", "decode"),
}

# Runtime string vocabularies: a kv_mode / layout / repr literal in the
# runtime or serving layers that is absent here is axis drift (a feature
# value the lattice never declared).
RUNTIME_VOCAB = {
    "kv_mode": ("dense", "latent"),
    "kv_layout": ("dense", "paged"),
    "kv_repr": ("bf16", "q8_0", "latent", "latent_q8_0"),
    "pool_role": ("both", "prefill", "decode"),
}

# Ordered first-match rules. ``when`` lists admissible values per named
# axis (unnamed axes match anything); ``degrades`` rewrites ``axis`` to
# ``to`` and resolution re-runs from the top (each degrade rule's ``when``
# excludes its own ``to`` value, so the fixpoint terminates over the full
# enumeration). No rule constrains ``role`` jointly with kv_repr/decode:
# the role axis is orthogonal by declaration.
LATTICE = (
    # latent KV serves on EVERY backend since TPLA: the
    # mesh/ring engines shard the latent rank axis over tp/sp and psum
    # partial absorbed scores, so the former multichip-dense-kv degrade
    # rules are gone — backend × kv_repr is fully supported.
    # paged KV serves from the paged slot pool only; every other backend
    # keeps its dense cache layout (and the paged backend cannot serve a
    # dense layout — the two rules keep layout and backend consistent).
    {"when": {"backend": ("engine", "dense-slots", "mesh", "ring"),
              "kv_layout": ("paged",)},
     "status": "rejected", "reason": "paged-slots-only"},
    {"when": {"backend": ("paged-slots",), "kv_layout": ("dense",)},
     "status": "rejected", "reason": "paged-backend-mismatch"},
    # the fused decode-step kernel reads block-paged KV: any non-paged
    # backend decodes unfused.
    {"when": {"backend": ("engine", "dense-slots", "mesh", "ring"),
              "decode": ("fused",)},
     "status": "degrades", "axis": "decode", "to": "unfused",
     "reason": "paged-decode-only"},
    # the fused kernel reads per-head K/V rows; the latent pool stores
    # factorized C rows — absorbed decode stays on the unfused path.
    {"when": {"kv_repr": ("latent", "latent_q8_0"), "decode": ("fused",)},
     "status": "degrades", "axis": "decode", "to": "unfused",
     "reason": "latent-kv"},
    # pool roles fork slot-pool behavior (publish/adopt); the
    # single-stream engine has no pool and serves role 'both' only.
    {"when": {"backend": ("engine",), "role": ("prefill", "decode")},
     "status": "rejected", "reason": "role-slot-pools-only"},
)

# Cells that differ only on these axes serve bit-identical greedy output
# (same model, same prompt).
PARITY_AXES = ("kv_layout", "decode", "backend")

# The closed degrade-reason vocabulary: lattice rule reasons plus the
# per-config families ``ops/fused_decode.fused_supported`` returns (the
# part before ``:``); ``check_reason`` holds every reason to it.
DEGRADE_REASONS = (
    # lattice-level (combination) reasons
    "paged-decode-only", "latent-kv",
    # per-config fused_supported families
    "norm-type", "no-pre-norms", "norm-offset", "qk-norm", "attn-bias",
    "sandwich-norms", "rope-style", "head-dim", "gqa-ragged",
    "weight-pack", "q8_0-align", "vmem",
)

REJECT_REASONS = ("paged-slots-only", "paged-backend-mismatch",
                  "role-slot-pools-only")

# Env opt-ins that select lattice cells. The env_* helpers below are the
# ONLY readers; DLP_KV_LATENT_RANK is deliberately absent — it
# tunes a cell, it does not select one.
CAPABILITY_ENVS = ("DLP_KV_LATENT", "DLP_KV_PAGED", "DLP_FUSED_DECODE",
                   "DLP_POOL_ROLE")

# Reject messages, verbatim from the pre-lattice gates so callers and
# tests see bit-identical errors.
REJECT_MESSAGES = {
    "paged-slots-only": (
        "paged slot-KV (kv_paged) requires the single-chip Engine; mesh "
        "slots keep the dense pipeline cache layout"),
    "paged-backend-mismatch": (
        "the paged slot backend serves block-paged KV only; a dense cache "
        "layout keeps the dense-rows slot backend"),
    "role-slot-pools-only": (
        "pool roles fork slot-pool behavior (DLP_POOL_ROLE/--role); the "
        "single-stream engine serves role 'both' only"),
}

# Boot-log lines for counted degradations when a rule wants verbatim
# per-backend wording (keyed (reason, backend)); empty since TPLA
# removed the multichip-dense-kv rules — _degrade_note's generic line
# covers the remaining degrades.
DEGRADE_LOG = {}


# -- env opt-ins (the only readers of CAPABILITY_ENVS) -----------------------


def env_kv_latent() -> bool:
    """Fleet-wide latent-KV opt-in (DLP_KV_LATENT=1)."""
    return os.environ.get("DLP_KV_LATENT", "0") == "1"


def env_kv_paged_default() -> bool:
    """Paged slot-KV default for the single-chip Engine (DLP_KV_PAGED,
    on unless =0)."""
    return os.environ.get("DLP_KV_PAGED", "1") != "0"


def fused_requested() -> bool:
    """Fused decode-step kernel opt-in (DLP_FUSED_DECODE=1)."""
    return os.environ.get("DLP_FUSED_DECODE", "0") == "1"


def env_pool_role() -> str:
    """Pool-role default (DLP_POOL_ROLE, 'both' when unset)."""
    return os.environ.get("DLP_POOL_ROLE", "both")


# -- labels -----------------------------------------------------------------


def kv_repr_label(kv_quant, kv_mode) -> str:
    """The kv_repr axis value for an engine's (kv_quant, kv_mode) pair —
    ``bf16`` is the unquantized dense-per-head representation (the axis
    twin of disagg's ``dense`` pool label)."""
    if kv_mode == "latent":
        return "latent_q8_0" if kv_quant else "latent"
    return "q8_0" if kv_quant else "bf16"


def repr_kv_mode(kv_repr: str) -> str:
    """Engine kv_mode for a kv_repr axis value."""
    return "latent" if kv_repr.startswith("latent") else "dense"


def cell_label(features) -> str:
    """Canonical ``layout/repr/decode/backend/role`` cell name."""
    return "/".join(features[a] for a in AXES)


def reason_family(reason: str) -> str:
    """The declared family of a degrade reason (prefix before ``:`` —
    ``vmem:28MiB`` → ``vmem``)."""
    return reason.split(":", 1)[0]


def check_reason(reason: str) -> str:
    """Enforce the closed reason vocabulary: every degrade reason's family
    must be declared in DEGRADE_REASONS (metrics, logs and docs derive
    from one enum)."""
    if reason_family(reason) not in DEGRADE_REASONS:
        raise ValueError(
            f"undeclared capability degrade reason {reason!r}: declare its "
            f"family in runtime/capabilities.DEGRADE_REASONS")
    return reason


# -- resolution -------------------------------------------------------------


class CapabilityError(NotImplementedError):
    """A requested feature combination the lattice refuses — either a
    ``rejected`` cell, or a degrade on an axis the caller pinned
    explicitly (explicit requests are honored or refused, never silently
    rewritten). Subclasses NotImplementedError so pre-lattice callers
    (explicit kv_mode='latent' on a mesh/ring engine) see the same
    exception type."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


@dataclass(frozen=True)
class Degradation:
    """One counted axis rewrite: ``axis`` went ``frm`` → ``to`` for
    ``reason``; ``note`` is the boot-log line."""

    axis: str
    frm: str
    to: str
    reason: str
    note: str


@dataclass(frozen=True)
class Resolution:
    """The resolved lattice cell: ``features`` after every degrade,
    ``requested`` as asked, and the degradations applied (empty =
    the cell is served exactly as requested)."""

    requested: dict
    features: dict
    degradations: tuple = field(default_factory=tuple)

    @property
    def cell(self) -> str:
        return cell_label(self.features)

    @property
    def status(self) -> str:
        return "degrades" if self.degradations else "supported"


def _rule_matches(rule, features) -> bool:
    return all(features[axis] in allowed
               for axis, allowed in rule["when"].items())


def _first_match(features):
    for rule in LATTICE:
        if _rule_matches(rule, features):
            return rule
    return None


def _validate(features) -> dict:
    feats = dict(features)
    if set(feats) != set(AXES):
        missing = set(AXES) - set(feats)
        extra = set(feats) - set(AXES)
        raise ValueError(f"capability cell must name every axis "
                         f"(missing={sorted(missing)}, "
                         f"unknown={sorted(extra)})")
    for axis, value in feats.items():
        if value not in AXES[axis]:
            raise ValueError(f"unknown {axis} value {value!r} "
                             f"(one of {AXES[axis]})")
    return feats


def _degrade_note(rule, features) -> str:
    note = DEGRADE_LOG.get((rule["reason"], features["backend"]))
    if note is not None:
        return note
    return (f"capability degrade: {rule['axis']} "
            f"{features[rule['axis']]!r} -> {rule['to']!r} on "
            f"{features['backend']} ({rule['reason']})")


def _explicit_message(rule, features) -> str:
    return (f"requested {rule['axis']}={features[rule['axis']]!r} is not "
            f"served on backend {features['backend']!r} "
            f"({rule['reason']}) and the request was explicit — drop it "
            f"or change backends")


def resolve(features, *, explicit=frozenset(), metrics=None) -> Resolution:
    """Resolve a requested cell to the cell actually served.

    First-match fixpoint over LATTICE: ``rejected`` raises
    CapabilityError; ``degrades`` rewrites the axis and re-resolves —
    unless the axis is in ``explicit`` (the caller pinned it), which
    also raises, because explicit requests are never silently rewritten.
    With ``metrics``, every applied degradation increments
    ``capability_degradations_total`` (flat and ``{axis=,reason=}``).
    """
    feats = _validate(features)
    requested = dict(feats)
    explicit = frozenset(explicit)
    degradations = []
    for _ in range(len(LATTICE) + 1):
        rule = _first_match(feats)
        if rule is None:
            break
        if rule["status"] == "rejected":
            raise CapabilityError(REJECT_MESSAGES[rule["reason"]],
                                  rule["reason"])
        axis = rule["axis"]
        if axis in explicit:
            raise CapabilityError(_explicit_message(rule, feats),
                                  rule["reason"])
        degradations.append(Degradation(
            axis=axis, frm=feats[axis], to=rule["to"],
            reason=check_reason(rule["reason"]),
            note=_degrade_note(rule, feats)))
        feats = {**feats, axis: rule["to"]}
    else:  # pragma: no cover - every degrade rule excludes its own target
        raise RuntimeError(f"capability lattice did not converge for "
                           f"{cell_label(requested)}")
    res = Resolution(requested=requested, features=feats,
                     degradations=tuple(degradations))
    if metrics is not None:
        for d in res.degradations:
            metrics.inc("capability_degradations_total")
            metrics.inc("capability_degradations_total",
                        labels={"axis": d.axis,
                                "reason": reason_family(d.reason)})
    return res


def resolve_boot(*, kv_mode, kv_quant, backend, metrics=None):
    """``Engine.__init__``'s entry: env-default the KV mode
    (DLP_KV_LATENT=1), resolve the boot cell on ``backend``, and return
    ``(resolved kv_mode, Resolution)``. An explicit ``kv_mode`` argument
    pins the kv_repr axis (a degrade on it then refuses instead of
    rewriting); env defaults degrade — counted on ``metrics`` and logged
    by the caller via each degradation's ``note``."""
    explicit = frozenset() if kv_mode is None else frozenset({"kv_repr"})
    if kv_mode is None:
        kv_mode = "latent" if env_kv_latent() else "dense"
    res = resolve({"kv_layout": "dense",
                   "kv_repr": kv_repr_label(kv_quant, kv_mode),
                   "decode": "unfused", "backend": backend, "role": "both"},
                  explicit=explicit, metrics=metrics)
    return repr_kv_mode(res.features["kv_repr"]), res


# -- enumeration ------------------------------------------------------------


def enumerate_cells():
    """Every cell in the axis product, in axis-tuple order."""
    import itertools

    names = list(AXES)
    for combo in itertools.product(*(AXES[a] for a in names)):
        yield dict(zip(names, combo))


def classify(features):
    """(status, resolution-or-None, reason-or-None) for one cell, with no
    explicit axes: ``supported`` serves as requested, ``degrades`` serves
    a rewritten cell, ``rejected`` refuses."""
    try:
        res = resolve(features)
    except CapabilityError as e:
        return "rejected", None, e.reason
    if res.degradations:
        return "degrades", res, res.degradations[0].reason
    return "supported", res, None


def cpu_reachable(features) -> bool:
    """Cells the reference's matrix audit can boot and drive on a CPU-only
    host: the single-process backends, plus — since TPLA — the
    mesh/ring latent cells, which boot on the fake-device CPU mesh and
    serve rank-sharded latent KV for real (the remaining mesh/ring dense
    cells are covered by the --trace tier's testbeds). Role-forked pools
    only produce tokens as a prefill→decode PAIR, so the audit drives
    the role axis on the canonical paged/bf16/unfused handoff cell — no
    LATTICE rule names ``role`` together with kv_repr/decode, so the
    declared matrix is covered by the two 1-D sweeps (role × canonical
    repr, repr × role 'both')."""
    if features["backend"] in ("mesh", "ring"):
        return (features["role"] == "both"
                and features["kv_layout"] == "dense"
                and features["decode"] == "unfused"
                and features["kv_repr"] in ("latent", "latent_q8_0"))
    if features["backend"] not in ("engine", "paged-slots", "dense-slots"):
        return False
    if features["role"] != "both":
        return (features["kv_layout"], features["kv_repr"],
                features["decode"]) == ("paged", "bf16", "unfused")
    return True
