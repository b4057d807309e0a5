"""Cost-model stage balancing: the layer chain cut into contiguous stages.

A copy of ``distributed_llm_pipeline_tpu/parallel/balance.py``'s
``layer_costs``, ``plan_stages`` and ``stage_spans`` (the port imports
nothing of the JAX package). ``plan_stages`` partitions the per-layer costs
into ``n_stages`` contiguous groups minimizing the slowest stage, by dynamic
programming; the mesh engine uses it when ``n_layers % pp != 0``.
"""

from __future__ import annotations

from ..models import ModelConfig


def layer_costs(cfg: ModelConfig, seq_len: int = 1, batch: int = 1) -> list[float]:
    """Per-layer FLOP estimate for one forward step: uniform for a
    homogeneous decoder stack; MoE layers are charged their active-expert
    FFN width."""
    D, H, K, Hd, F = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.hidden_dim)
    t = seq_len * batch
    attn = 2 * t * D * (H + 2 * K) * Hd + 2 * t * D * H * Hd  # qkv + out proj
    if cfg.is_moe:
        ffn = 3 * 2 * t * D * F * max(1, cfg.n_experts_per_tok)
    else:
        ffn = 3 * 2 * t * D * F
    return [float(attn + ffn)] * cfg.n_layers


def plan_stages(costs: list[float], n_stages: int,
                device_speeds: list[float] | None = None) -> list[int]:
    """Contiguous partition of ``costs`` into ``n_stages`` groups minimizing
    the maximum per-stage time (cost/speed). Returns per-stage layer counts
    (every stage gets ≥ 1 layer)."""
    L = len(costs)
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if L < n_stages:
        raise ValueError(f"cannot split {L} layers into {n_stages} stages")
    speeds = device_speeds if device_speeds is not None else [1.0] * n_stages
    if len(speeds) != n_stages:
        raise ValueError(f"need {n_stages} device speeds, got {len(speeds)}")
    if min(speeds) <= 0:
        raise ValueError("device speeds must be positive")

    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def seg(i: int, j: int, s: int) -> float:  # time of layers [i, j) on stage s
        return (prefix[j] - prefix[i]) / speeds[s]

    INF = float("inf")
    # best[s][j] = minimal bottleneck splitting first j layers into s+1 stages
    best = [[INF] * (L + 1) for _ in range(n_stages)]
    cut = [[0] * (L + 1) for _ in range(n_stages)]
    for j in range(1, L + 1):
        best[0][j] = seg(0, j, 0)
    for s in range(1, n_stages):
        for j in range(s + 1, L + 1):
            for i in range(s, j):
                b = max(best[s - 1][i], seg(i, j, s))
                if b < best[s][j]:
                    best[s][j] = b
                    cut[s][j] = i
    counts = []
    j = L
    for s in range(n_stages - 1, 0, -1):
        i = cut[s][j]
        counts.append(j - i)
        j = i
    counts.append(j)
    return counts[::-1]


def stage_spans(counts: list[int]) -> list[tuple[int, int]]:
    """[(first_layer, last_layer_exclusive)] per stage."""
    spans, start = [], 0
    for c in counts:
        spans.append((start, start + c))
        start += c
    return spans
