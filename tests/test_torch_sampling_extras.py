"""The port's typical-p, mirostat v1/v2, logit bias and top-k logprobs
against the JAX package's functions (``ops/sampling.py``), on the same numpy
inputs: typical-p's keep mask identical and the kept logits within 1e-6;
mirostat's kept set identical and μ' within 1e-5 for the same logits, μ and
chosen token; the bias vector identical; the top-k logprobs within 1e-5 with
the same ids. Draws cannot match (Philox here, threefry there), so sampling
is held to the filtered distribution instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_pipeline_tpu.ops import sampling as jax_sampling
from distributed_llm_pipeline_tpu_torch.ops import sampling

TYPICAL_TOL = 1e-6
MU_TOL = 1e-5
LOGPROB_TOL = 1e-5


def _logits(seed: int, shape=(3, 300), masked: int = 0) -> np.ndarray:
    lg = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2.5
    if masked:   # earlier filters' −inf entries
        lg[:, -masked:] = -np.inf
    return lg


@pytest.mark.parametrize("p", [0.2, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("masked", [0, 40])
def test_typical_p_matches_jax(p, masked):
    logits = _logits(int(p * 100) + masked, masked=masked)
    ref = np.asarray(jax_sampling.apply_typical_p(jnp.asarray(logits), p))
    got = sampling.apply_typical_p(torch.from_numpy(logits), p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    keep = ~np.isneginf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=TYPICAL_TOL)


@pytest.mark.parametrize("temperature,top_k,top_p,min_p,typical_p", [
    (0.8, 40, 0.95, 0.0, 0.9), (1.0, 0, 1.0, 0.05, 0.5), (0.7, 0, 0.9, 0.0, 0.3)])
def test_filtered_logits_with_typical_p_match_jax(temperature, top_k, top_p, min_p,
                                                  typical_p):
    logits = _logits(7)
    ref = np.asarray(jax_sampling.filtered_logits(
        jnp.asarray(logits), temperature, top_k, top_p, min_p, typical_p))
    got = sampling.filtered_logits(torch.from_numpy(logits), temperature, top_k,
                                   top_p, min_p, typical_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    keep = ~np.isneginf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=TYPICAL_TOL, atol=TYPICAL_TOL)


@pytest.mark.parametrize("top_k", [0, 6])
def test_typical_p_draws_from_the_filtered_distribution(top_k):
    """``sample`` with typical-p (on the top-k slice when top-k is set)
    draws from softmax(filtered_logits)."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.2, -0.5, -1.0, -3.0, 0.9]])
    want = torch.softmax(sampling.filtered_logits(logits, 0.9, top_k, 0.95, 0.0, 0.6),
                         -1)[0]
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([sampling.sample(logits, gen, 0.9, top_k, 0.95, 0.0, 0.6)
                       for _ in range(4000)])
    freq = torch.bincount(draws, minlength=8).float() / len(draws)
    assert (freq[want == 0] == 0).all() and (want == 0).any()
    torch.testing.assert_close(freq, want, rtol=0, atol=0.03)


def _jax_mirostat(monkeypatch, logits, mu, version, tau, eta, temperature, pick):
    """The JAX package's mirostat step with its categorical draw replaced by
    a fixed choice of sorted position: the top token ("top") or the last
    kept one ("last"), so that the chosen token reveals the kept set's size.
    Returns (token ids, μ')."""
    def categorical(key, vals):
        if pick == "top":
            return jnp.int32(0)
        return (jnp.sum(jnp.isfinite(vals)) - 1).astype(jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    tok, mu2 = jax_sampling.mirostat_step(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(mu),
        version=version, tau=tau, eta=eta, temperature=temperature)
    monkeypatch.undo()
    return np.asarray(tok), np.asarray(mu2)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("pick", ["top", "last"])
@pytest.mark.parametrize("mu0", [3.0, 6.0, 10.0])
def test_mirostat_kept_set_and_mu_match_jax(monkeypatch, version, pick, mu0):
    tau, eta, temperature = 5.0, 0.1, 0.8
    logits = _logits(version * 10 + int(mu0), shape=(3, 512))
    mu = np.asarray([mu0, mu0 - 1.0, mu0 + 1.5], np.float32)
    ref_tok, ref_mu = _jax_mirostat(monkeypatch, logits, mu, version, tau, eta,
                                    temperature, pick)
    order, vals = sampling.mirostat_filter(torch.from_numpy(logits),
                                           torch.from_numpy(mu), version=version,
                                           temperature=temperature)
    kept = torch.isfinite(vals).sum(-1)
    # the reference's chosen sorted position, and from it its kept set: a
    # prefix of the descending order
    ref_pos = torch.tensor([int((order[b] == int(t)).nonzero()) for b, t in
                            enumerate(ref_tok)])
    if pick == "last":
        np.testing.assert_array_equal(ref_pos.numpy(), (kept - 1).numpy())
    else:
        assert (ref_pos == 0).all()
    mu2 = sampling.mirostat_update(vals, ref_pos, torch.from_numpy(mu), tau=tau,
                                   eta=eta)
    np.testing.assert_allclose(mu2.numpy(), ref_mu, rtol=0, atol=MU_TOL)


@pytest.mark.parametrize("version", [1, 2])
def test_mirostat_step_draws_from_the_kept_set(version):
    logits = torch.from_numpy(_logits(3, shape=(1, 256)))
    mu = sampling.mirostat_init(5.0)
    assert mu.tolist() == [10.0]
    order, vals = sampling.mirostat_filter(logits, mu, version=version)
    kept = set(order[0, torch.isfinite(vals[0])].tolist())
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        tok, mu2 = sampling.mirostat_step(logits, gen, mu, version=version, tau=5.0,
                                          eta=0.1)
        assert int(tok) in kept
        pos = (order[0] == tok).nonzero()[0]
        torch.testing.assert_close(mu2, sampling.mirostat_update(
            vals, pos, mu, tau=5.0, eta=0.1))


def test_bias_vector_matches_jax():
    pairs = ((5, 1.5), (7, float("-inf")), (5, -0.25), (-1, 3.0), (99, 2.0),
             (0, 1e9))
    ref = np.asarray(jax_sampling.bias_vector(pairs, 64))
    got = sampling.bias_vector(pairs, 64).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 5, 20])
def test_topk_logprobs_match_jax(k):
    logits = _logits(11 + k, shape=(4, 384))
    sampled = np.asarray([3, 100, 383, 0], np.int32)
    r_lp, r_v, r_i = (np.asarray(x) for x in jax_sampling.topk_logprobs(
        jnp.asarray(logits), jnp.asarray(sampled), k))
    g_lp, g_v, g_i = (x.numpy() for x in sampling.topk_logprobs(
        torch.from_numpy(logits), torch.from_numpy(sampled).long(), k))
    np.testing.assert_allclose(g_lp, r_lp, rtol=0, atol=LOGPROB_TOL)
    np.testing.assert_allclose(g_v, r_v, rtol=0, atol=LOGPROB_TOL)
    np.testing.assert_array_equal(g_i, r_i)
    for b in range(4):
        got = sampling.lp_payload(int(sampled[b]), g_lp[b], g_v[b], g_i[b], k - 1)
        ref = jax_sampling.lp_payload(int(sampled[b]), r_lp[b], r_v[b], r_i[b], k - 1)
        assert (got["id"], got["top_ids"]) == (ref["id"], ref["top_ids"])
        np.testing.assert_allclose([got["logprob"], *got["top_logprobs"]],
                                   [ref["logprob"], *ref["top_logprobs"]],
                                   rtol=0, atol=LOGPROB_TOL)
