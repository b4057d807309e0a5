"""Pipeline + tensor parallel inference, one process per rank.

The counterpart of ``distributed_llm_pipeline_tpu/parallel/pipeline.py`` for
dense attention (dp = 1). The reference compiles one ``shard_map`` program
over the whole mesh; here each rank runs its own part of it:

- **PP**: stage s holds layers [lo, hi) of ``balance.stage_spans`` (even
  counts, or ``plan_stages``'s when pp does not divide the layers). A
  prompt flows through the stages in chunks of ``CHUNK`` tokens: stage s
  computes chunk c, sends its hidden state to stage s + 1 (the reference's
  ``ppermute``) and goes on with chunk c + 1, so the stages overlap even for
  one stream. A rank is its own process, so a stage skips the bubble steps
  the reference computes as junk and parks in its cache's scratch tail.
- **TP**: within a stage, attention heads and FFN columns split over the tp
  ranks (``layer_split``): q/k/v and gate/up are column-parallel, the
  output and down projections row-parallel, and their partial products are
  summed by an all-reduce over the stage's tp group (the reference's
  ``psum``) before the biases and post-norms. Quantized packs split field by
  field along the same axis, so a row split needs packs whose fields keep
  one code per logical row (the byte-code packs of ``byte_codes``).
- The last stage's tp rank 0 sends the hidden rows the head needs to rank
  0 (the reference replicates all outputs with a final ``psum`` over pp),
  which applies the final norm and the head.

Each rank's cache is the reference's local shard: [Lp, B, max_seq + CHUNK,
K/tp, Hd] (Lp the longest stage), the ``+ CHUNK`` scratch tail absorbing the
writes of rows parked at ``max_seq``. Attention is ``attention_any`` over
the local H/tp query and K/tp kv heads, per-row lengths and all. The
latent (TPLA) and MoE stages, OLMo2's full-width QK-norm at tp > 1 and the
int8 cache are not ported to the mesh (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import ModelConfig
from ..models.llama import Block, LlamaModel, Params, rope_freqs, sliding_window_per_layer
from ..ops.flash_attention import attention_any
from ..ops.quant_matmul import QuantPack
from .balance import layer_costs, plan_stages, stage_spans

CHUNK = 16  # prefill sequence-chunk length (buckets are multiples of 16)

# packs whose bytes pair logical rows across the contraction dim: a row
# (contraction) split would cut the pairs
_SUB_BYTE = frozenset({"q4_k", "q5_ks", "q6_k", "q2_ks", "q3_ks"})


def validate_mesh(cfg: ModelConfig, pp: int, tp: int,
                  uneven_stages: bool = False) -> None:
    """Raise ``ValueError`` naming every way the model does not split over
    pp stages of tp ranks (the reference's messages)."""
    problems = []
    if cfg.n_layers % pp and not uneven_stages:
        problems.append(f"n_layers={cfg.n_layers} not divisible by pp={pp} "
                        f"(pass stage_counts for uneven stages)")
    if cfg.n_heads % tp:
        problems.append(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
    if cfg.n_kv_heads % tp:
        problems.append(f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}")
    if cfg.hidden_dim % tp and not cfg.is_moe:
        problems.append(f"hidden_dim={cfg.hidden_dim} not divisible by tp={tp}")
    if cfg.is_moe and cfg.n_experts % tp:
        problems.append(f"n_experts={cfg.n_experts} not divisible by tp={tp}")
    if cfg.is_moe and cfg.shared_expert_dim % tp:
        problems.append(f"shared_expert_dim={cfg.shared_expert_dim} not "
                        f"divisible by tp={tp}")
    if problems:
        raise ValueError("mesh incompatible with model: " + "; ".join(problems))


def check_ported(cfg: ModelConfig, tp: int) -> None:
    """Raise ``NotImplementedError`` on a model the mesh path does not
    serve yet."""
    if cfg.is_moe:
        raise NotImplementedError("MoE expert parallelism on a mesh is not "
                                  "ported yet (ROADMAP.md §1)")
    if cfg.qk_norm_full and tp > 1:
        raise NotImplementedError("OLMo2's full-width QK-norm over tp > 1 (the "
                                  "reference's tp_rms) is not ported yet "
                                  "(ROADMAP.md §1)")


def stage_counts(cfg: ModelConfig, pp: int) -> list[int]:
    """Layers per stage: even when pp divides them, else the balancer's."""
    if cfg.n_layers % pp:
        return plan_stages(layer_costs(cfg), pp)
    return [cfg.n_layers // pp] * pp


def layer_split(cfg: ModelConfig) -> dict[str, str | None]:
    """How each block leaf splits over tp, in the port's (out, in) layout:
    "col" splits the output rows (dim 0: q/k/v, gate/up and their biases),
    "row" the contraction columns (dim 1: the output and down projections);
    a leaf that is not named (norms, the output and down biases, which are
    added once after the all-reduce, per-head QK-norms) is replicated. The
    reference's ``layer_param_specs`` without its latent and MoE leaves."""
    out = {"wq": "col", "wk": "col", "wv": "col", "wo": "row",
           "w_up": "col", "w_down": "row"}
    if cfg.mlp_gated:
        out["w_gate"] = "col"
    if cfg.attn_bias:
        out.update(bq="col", bk="col", bv="col")
    if not cfg.mlp_gated:
        out["b_up"] = "col"
    return out


def _split(t: torch.Tensor, dim: int, tp: int, i: int, what: str) -> torch.Tensor:
    if t.shape[dim] % tp:
        raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does not split "
                         f"over tp={tp}")
    n = t.shape[dim] // tp
    return t.narrow(dim, i * n, n).contiguous()


def shard_leaf(t: torch.Tensor | QuantPack, rule: str | None, tp: int, i: int,
               what: str = "") -> torch.Tensor | QuantPack:
    """tp rank ``i``'s part of one leaf by its ``layer_split`` rule; a pack
    splits each field along the same axis (its fields are [F, ·], dims
    proportional to the dense weight's)."""
    if rule is None or tp == 1:
        return t
    if isinstance(t, QuantPack):
        if rule == "row" and t.kind in _SUB_BYTE:
            raise ValueError(f"{what}: a {t.kind} pack pairs rows across D and "
                             f"cannot split over tp (pack byte codes)")
        dim = 0 if rule == "col" else 1
        return type(t)(**{f: _split(t._buffers[f], dim, tp, i, f"{what}.{f}")
                          for f in t.fields})
    dim = 0 if rule == "col" or t.dim() == 1 else 1
    return _split(t, dim, tp, i, what)


def shard_model_params(params: Params, cfg: ModelConfig, pp: int, tp: int,
                       rank: int, counts: list[int] | None = None) -> Params:
    """One rank's state out of ``params`` (the full flat state, or any part
    of it that holds this rank's stage): its stage's layers renumbered from
    0, each leaf's tp slice (``shard_leaf``); the embedding table on every
    stage-0 rank; the final norm and the head on rank 0 only. Uneven stages
    (``counts``) keep only their own layers: no rank computes the padding
    the reference stacks."""
    validate_mesh(cfg, pp, tp, uneven_stages=counts is not None)
    check_ported(cfg, tp)
    counts = counts or [cfg.n_layers // pp] * pp
    if len(counts) != pp or sum(counts) != cfg.n_layers or min(counts) < 1:
        raise ValueError(f"stage_counts {counts} must have {pp} entries >= 1 "
                         f"summing to {cfg.n_layers}")
    stage, t = divmod(rank, tp)
    lo, hi = stage_spans(counts)[stage]
    rules = layer_split(cfg)
    out: Params = {}
    for key, w in params.items():
        if key.startswith("layers."):
            _, i, leaf = key.split(".", 2)
            if lo <= int(i) < hi:
                out[f"layers.{int(i) - lo}.{leaf}"] = shard_leaf(
                    w, rules.get(leaf), tp, t, key)
        elif rank == 0 or (key == "embed" and stage == 0):
            out[key] = w
    return out


def rank_params(params: Params, cfg: ModelConfig, pp: int, tp: int, rank: int,
                counts: list[int], quant: str | None = None) -> Params:
    """``shard_model_params`` of ``params`` packed with ``quant`` (the
    byte-code K-quant packs at tp > 1), equal to packing the whole state
    first. A leaf is packed after its split where that gives the same pack
    (a split of its output rows, or of its contraction dim at multiples of
    256, where every format's blocks and groups stay whole), so a rank
    packs only its own slice; else it is packed whole, then split. Only
    rank 0 packs a head."""
    from ..models.llama import quantize_params

    if quant is None:
        return shard_model_params(params, cfg, pp, tp, rank, counts)
    rules = layer_split(cfg)

    def whole_first(key: str, w) -> bool:
        return (key.startswith("layers.") and not isinstance(w, QuantPack)
                and rules.get(key.rsplit(".", 1)[1]) == "row"
                and (w.shape[1] // tp) % 256 != 0)

    first = {k: w for k, w in params.items() if whole_first(k, w)}
    rest = {k: w for k, w in params.items() if k not in first}
    embed = None if rank == 0 else rest.pop("embed", None)
    out = quantize_params(shard_model_params(rest, cfg, pp, tp, rank, counts), cfg,
                          quant, byte_codes=tp > 1)
    if embed is not None and rank // tp == 0:
        out["embed"] = embed
    out.update(shard_model_params(quantize_params(first, cfg, quant, byte_codes=tp > 1),
                                  cfg, pp, tp, rank, counts))
    return out


def make_sharded_cache(cfg: ModelConfig, n_layers: int, batch: int, max_seq: int,
                       tp: int, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A rank's K and V buffers: [Lp, B, max_seq + CHUNK, K/tp, Hd] zeros,
    the ``+ CHUNK`` tail the scratch where parked rows write."""
    shape = (n_layers, batch, max_seq + CHUNK, cfg.n_kv_heads // tp, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class StageModel(nn.Module):
    """One rank's part of the model: its stage's blocks over its tp slice
    of the heads and FFN columns (built with the local head and FFN
    counts), the embedding table on stage 0, the final norm and the head on
    rank 0. ``forward_ms`` records M = B·T of each chunk the blocks ran and
    ``head_ms`` the rows of each call of the head (the quantized routes
    follow them)."""

    embed_tokens = LlamaModel.embed_tokens

    def __init__(self, cfg: ModelConfig, params: Params, pp: int, tp: int,
                 rank: int, counts: list[int]):
        super().__init__()
        self.cfg = cfg
        local = cfg.replace(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                            hidden_dim=cfg.hidden_dim // tp)
        for name in ("embed", "out_norm", "out_norm_b", "lm_head"):
            if isinstance(params.get(name), QuantPack):
                self.add_module(name, params[name])
            elif name in params:
                self.register_parameter(name, nn.Parameter(params[name], requires_grad=False))
        lo, hi = stage_spans(counts)[rank // tp]
        windows = sliding_window_per_layer(cfg)
        self.layers = nn.ModuleList(
            Block(local, {k[len(f"layers.{j}."):]: w for k, w in params.items()
                          if k.startswith(f"layers.{j}.")}, windows[lo + j])
            for j in range(hi - lo))
        self.forward_ms: list[int] = []
        self.head_ms: list[int] = []

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """``LlamaModel``'s final norm and head over x [B, T, D]."""
        self.head_ms.append(x.shape[0] * x.shape[1])
        return LlamaModel.lm_logits(self, x)

    def stage_forward(self, x: torch.Tensor, pos: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, comm) -> torch.Tensor:
        """This stage's blocks on one chunk: x [B, Tc, D]; row b's tokens at
        positions pos[b] + [0, Tc), their K/V written there in k, v ([Lp,
        B, S, K/tp, Hd]) before attention reads the rows' windows."""
        B, T, _ = x.shape
        self.forward_ms.append(B * T)
        cols = pos.long()[:, None] + torch.arange(T, device=x.device)
        rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
        cos, sin = rope_freqs(self.cfg, cols)
        # a row parked at max_seq goes on advancing through a decode chunk:
        # its junk writes stay on the scratch tail's last position
        cols = cols.clamp_max(k.shape[2] - 1)
        for j, blk in enumerate(self.layers):
            local = blk.cfg
            q, kn, vn = blk.qkv(x, cos, sin)
            kl, vl = k[j], v[j]
            kl[rows, cols] = kn.to(kl.dtype)
            vl[rows, cols] = vn.to(vl.dtype)
            attn = attention_any(q, kl, vl, pos, local.n_heads // local.n_kv_heads,
                                 scale=local.attn_scale, softcap=local.attn_softcap,
                                 window=blk.window)
            x = blk.ffn(blk.attn_out(x, attn, comm.all_reduce), comm.all_reduce)
        return x


def pipeline_forward(model: StageModel, mesh, comm, k: torch.Tensor, v: torch.Tensor,
                     tokens: np.ndarray, pos0: np.ndarray,
                     last: np.ndarray | None = None) -> torch.Tensor | None:
    """One pipelined forward on every rank of the mesh; each rank calls it
    with the same arguments (its own model, cache and collectives).

    tokens [B, T] (int, host): T ≤ ``CHUNK`` runs as one chunk, longer must
    be a multiple of it. pos0 [B]: each row's first position. last [B]: the
    position whose hidden state each row needs (None: all T). k, v: this
    rank's buffers for the B rows (a view of some rows of a larger cache
    writes into it). Returns the pre-norm hidden states on rank 0 ([B, T, D],
    or [B, 1, D] with ``last``), None elsewhere."""
    B, T = tokens.shape
    Tc = T if T <= CHUNK else CHUNK
    if T % Tc:
        raise ValueError(f"prompt length {T} not a multiple of chunk {Tc}")
    dev, D, dtype = mesh.device, model.cfg.dim, k.dtype
    pos = torch.as_tensor(np.asarray(pos0, np.int64), device=dev)
    toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev) if mesh.stage == 0 else None
    last_stage = mesh.stage == mesh.pp - 1
    outs = []
    for c in range(T // Tc):
        if mesh.stage == 0:
            x = model.embed_tokens(toks[:, c * Tc:(c + 1) * Tc])
        else:
            x = comm.recv((B, Tc, D), dtype, mesh.prev_rank)
        x = model.stage_forward(x, pos + c * Tc, k, v, comm)
        if not last_stage:
            comm.send(x, mesh.next_rank)
        elif mesh.tp_rank == 0:
            outs.append(x)
    rows = 1 if last is not None else T
    if last_stage and mesh.tp_rank == 0:
        h = torch.cat(outs, dim=1)
        if last is not None:
            idx = torch.as_tensor(np.asarray(last, np.int64), device=dev)
            h = torch.gather(h, 1, idx[:, None, None].expand(B, 1, D))
        if mesh.rank == 0:
            return h
        comm.send(h, 0)
        return None
    if mesh.rank == 0:
        return comm.recv((B, rows, D), dtype, mesh.head_rank)
    return None
