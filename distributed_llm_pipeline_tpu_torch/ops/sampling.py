"""Token sampling on the device, with an explicit ``torch.Generator``.

The counterpart of ``distributed_llm_pipeline_tpu/ops/sampling.py``: the
single-stream chain (repeat/presence/frequency penalties, then min-p, top-k,
temperature and top-p) and the per-row chain of batched decode
(``sample_rows``). A draw is the Gumbel-max trick over the filtered
logits, as ``jax.random.categorical`` draws; the generators differ (Philox
here, threefry there), so a seeded stream reproduces within one package only.
Nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits (last axis); ties with the k-th stay."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted distribution
    with cumulative probability >= p (the top token always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < p
    keep[..., 0] = True
    kth = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, float("-inf"))


def apply_min_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep tokens whose probability is >= p × the top token's:
    ``logit >= max_logit + log(p)``."""
    cutoff = logits.amax(dim=-1, keepdim=True) + torch.log(torch.tensor(p))
    return logits.masked_fill(logits < cutoff, float("-inf"))


def apply_penalties(logits: torch.Tensor, recent: torch.Tensor,
                    repeat: float = 1.0, presence: float = 0.0,
                    freq: float = 0.0) -> torch.Tensor:
    """llama.cpp's penalties over a recent-token window ``recent`` [B, W]
    (−1 = padding): the repeat penalty once per token present (positive
    logits divide, negative multiply), then ``logit -= c·freq +
    (c > 0)·presence`` for a token seen c times."""
    V = logits.shape[-1]
    lg = logits.reshape(-1, V)
    rc = recent.expand(lg.shape[0], recent.shape[-1])
    valid = (rc >= 0) & (rc < V)
    counts = torch.zeros(lg.shape, dtype=torch.int32, device=lg.device)
    counts.scatter_add_(1, rc.clamp(0, V - 1).long(), valid.int())
    present = counts > 0
    pen = torch.where(lg > 0, lg / repeat, lg * repeat)
    lg = torch.where(present, pen, lg)
    lg = lg - counts.to(lg.dtype) * freq - present.to(lg.dtype) * presence
    return lg.reshape(logits.shape)


def filtered_logits(logits: torch.Tensor, temperature: float, top_k: int,
                    top_p: float, min_p: float = 0.0) -> torch.Tensor:
    """The min-p / top-k / temperature / top-p chain in f32: the sampling
    distribution is its softmax. Caller guarantees temperature > 0."""
    logits = logits.float()
    if min_p > 0.0:   # relative to the raw distribution's top token
        logits = apply_min_p(logits, min_p)
    if top_k > 0:
        logits = apply_top_k(logits, top_k)
    logits = logits / temperature
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return logits


def _gumbel_argmax(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(logits: torch.Tensor, gen: torch.Generator | None,
           temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
           min_p: float = 0.0) -> torch.Tensor:
    """logits [..., V] → token ids [...] (int64). Temperature 0 is greedy.
    With top-k the chain runs on the k-wide slice ``topk`` returns (already
    sorted), so top-p needs no full-vocab sort; the distribution is the
    softmax of ``filtered_logits``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k <= 0:
        return _gumbel_argmax(filtered_logits(logits, temperature, top_k, top_p,
                                              min_p), gen)
    raw, idx = torch.topk(logits.float(), top_k, dim=-1)
    if min_p > 0.0:   # raw[..., :1] is the global max
        raw = raw.masked_fill(raw < raw[..., :1] + torch.log(torch.tensor(min_p)),
                              float("-inf"))
    vals = raw / temperature
    if top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        keep[..., 0] = True
        vals = vals.masked_fill(~keep, float("-inf"))
    choice = _gumbel_argmax(vals, gen)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def filter_rows(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor, min_p: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-row chain of ``sample_rows`` on one descending full-vocab
    sort: logits [B, V] and per-row parameters [B] → (filtered scaled
    logits in sorted order [B, V], the sort order [B, V]). Order: min-p
    against the raw distribution, temperature, top-k as a rank mask, top-p
    as a prefix-of-cumsum mask; the top token survives any p. The
    distribution is ``softmax(filtered_logits(...))`` of each row's own
    parameters."""
    lg = logits.float()
    B, V = lg.shape
    cutoff = lg.amax(dim=-1, keepdim=True) + torch.log(min_p.float().clamp_min(0))[:, None]
    lg = lg.masked_fill(lg < cutoff, float("-inf"))
    svals, order = torch.sort(lg, dim=-1, descending=True, stable=True)
    ranks = torch.arange(V, device=lg.device)[None, :]
    k = torch.where(top_k > 0, top_k.long(), V)[:, None]
    svals = svals.masked_fill(ranks >= k, float("-inf"))
    scaled = svals / temperature.float().clamp_min(1e-6)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p.float()[:, None]
    keep[:, 0] = True
    return scaled.masked_fill(~keep, float("-inf")), order


def filtered_rows(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor) -> torch.Tensor:
    """``filter_rows`` back in vocabulary order: the filtered per-row logits
    [B, V], whose softmax is each row's sampling distribution."""
    scaled, order = filter_rows(logits, temperature, top_k, top_p, min_p)
    return torch.empty_like(scaled).scatter_(1, order, scaled)


def sample_rows(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor, min_p: torch.Tensor,
                gens: list[torch.Generator | None]) -> torch.Tensor:
    """Per-row sampling for batched decode: logits [B, V] and per-row
    parameter tensors [B] → token ids [B] (int64). Rows with temperature
    ≤ 0 are greedy. Row b draws from its own generator ``gens[b]`` (None
    for a greedy row) and from no other, so a seeded request's stream does
    not depend on the rows it shares the batch with."""
    scaled, order = filter_rows(logits, temperature, top_k, top_p, min_p)
    noise = torch.stack([
        torch.zeros(scaled.shape[-1], device=scaled.device) if g is None
        else -torch.log(-torch.log(torch.rand(
            scaled.shape[-1], generator=g, device=scaled.device).clamp_(
                min=torch.finfo(torch.float32).tiny)))
        for g in gens])
    choice = torch.argmax(scaled + noise, dim=-1)
    choice = torch.where(temperature > 0, choice, 0)    # greedy: sorted-first
    return torch.gather(order, 1, choice[:, None])[:, 0]
