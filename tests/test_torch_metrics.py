"""The port's metrics registry and ``/metrics`` against the JAX package's, on
the CPU.

The same calls on the port's ``Metrics`` and the reference's give the same
Prometheus text and the same JSON snapshot (labelled series, escaping,
empty summaries, bucket histograms, the NaN guard, the reservoir past its
cap); the boot catalog, help texts and bucket bounds are the reference's.
The same request sequence served by the port's ``ChatServer`` and the
reference's, on one stream and on ``parallel=2`` slots, gives the same
series on ``/metrics``, the same counter values and the same histogram
counts; timing values are not compared. The perf monitor's series
(``utils/perf.py``: the step-time rings, the roofline, MFU and bandwidth
gauges) are compared like the others, save two points named below: the
kernel-build counters' labelled series (``LABELLED_APART``) and their help
texts, which the port defines on CUDA library builds, and the slots' step
count (``STEP_SLACK``).
"""

import asyncio
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import distributed_llm_pipeline_tpu.utils.metrics as ref_metrics
from distributed_llm_pipeline_tpu.models import PRESETS, random_params, write_model_gguf
from distributed_llm_pipeline_tpu.runtime import Engine as JaxEngine
from distributed_llm_pipeline_tpu.runtime import GenerationConfig as JaxGen
from distributed_llm_pipeline_tpu.runtime.engine import PRIORITY_CLASSES
from distributed_llm_pipeline_tpu.serving import ChatServer as JaxChatServer
from distributed_llm_pipeline_tpu_torch.runtime import Engine, GenerationConfig
from distributed_llm_pipeline_tpu_torch.serving import ChatServer
from distributed_llm_pipeline_tpu_torch.utils import metrics

from .fixtures import make_spm_vocab, spm_metadata

# the series the port defines differently, compared by family only: the
# kernel-build counters keep the reference's names, but the port counts CUDA
# library builds and loads labelled {entry=<source>} where the reference
# counts XLA compiles labelled by jit entry, so their labelled series differ
# (the flat series are compared)
LABELLED_APART = {"xla_compiles_total", "xla_retraces_total"}
LEFT_OUT: set = set()
REDEFINED_HELP = {"xla_compiles_total", "xla_retraces_total"}
# the slots' device steps are compared within two steps over the whole
# sequence: the reference's first request on a fresh ChatServer(parallel=2)
# records one step fewer than its later identical ones (2 against 3 while
# its first mixed step compiles; the port's three each time), and its
# grammar request one step more (4 against 3, on a fresh server each)
STEP_SLACK = 2


def _calls(m) -> None:
    """One sequence of recording calls, run on either package's Metrics."""
    m.record_request(n_prompt=10, n_gen=5, ttft_ms=20.0, tok_s=100.0)
    m.record_request(n_prompt=3, n_gen=1, ttft_ms=99999.0, tok_s=float("nan"))
    m.inc("requests_finished_total", labels={"model": 'lla"ma\\x\ny', "outcome": "stop"})
    m.inc("kv_swaps_total", 2, labels={"result": "out"})
    m.inc("prefill_tokens_total", 1234567.0)
    m.set_gauge("busy", 0)
    m.set_gauge("kv_pool_shared_ratio", 0.125)
    m.set_gauge("kv_bytes_per_token", 4096, labels={"mode": "q8_0"})
    m.observe("queue_wait_ms", 3.5, labels={"class": "interactive"})
    m.observe("prefill_chunk_tokens", 64)
    m.observe("batch_tok_s", 12.25)
    m.ensure_hist("kv_handoff_ms")
    for v in range(3000):   # past the reservoir's cap: seeded sampling
        m.observe("step_ms", float(v % 97))


def test_the_same_calls_render_the_same_text_and_json():
    ref, port = ref_metrics.Metrics(), metrics.Metrics()
    for m in (ref, port):
        _calls(m)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.render_prometheus(prefix="x") == ref.render_prometheus(prefix="x")
    assert port.snapshot_json() == ref.snapshot_json()


@pytest.mark.parametrize("value", ['plain', 'a"b', "back\\slash", "new\nline", 7, ""])
def test_label_escaping_matches(value):
    assert metrics.escape_label_value(value) == ref_metrics.escape_label_value(value)


def test_histograms_match():
    for cap, seed, n in ((100, 0, 100), (64, 1, 10_000)):
        r, p = ref_metrics.Histogram(cap=cap, seed=seed), metrics.Histogram(cap=cap, seed=seed)
        for v in range(n):
            r.observe(float(v))
            p.observe(float(v))
        assert p.summary() == r.summary()
    r, p = ref_metrics.BucketHistogram((1.0, 5.0, 10.0)), metrics.BucketHistogram((1.0, 5.0, 10.0))
    for v in (0.5, 0.7, 3.0, 7.0, 100.0):
        r.observe(v)
        p.observe(v)
    assert p.cumulative() == r.cumulative() == [(1.0, 2), (5.0, 3), (10.0, 4)]
    assert p.summary() == r.summary()
    assert math.isnan(metrics.Histogram().percentile(50))


def test_the_boot_schema_is_the_reference_s():
    assert metrics.BOOT_COUNTERS == ref_metrics.BOOT_COUNTERS
    assert metrics.BOOT_HISTOGRAMS == ref_metrics.BOOT_HISTOGRAMS
    assert metrics.BOOT_CLASS_HISTOGRAMS == ref_metrics.BOOT_CLASS_HISTOGRAMS
    assert metrics.BOOT_CLASSES == ref_metrics.BOOT_CLASSES == PRIORITY_CLASSES
    assert metrics.BUCKET_BOUNDS == ref_metrics.BUCKET_BOUNDS
    assert {k: v for k, v in metrics.HELP.items() if k not in REDEFINED_HELP} == \
        {k: v for k, v in ref_metrics.HELP.items()
         if not k.startswith("router_") and k not in REDEFINED_HELP}
    assert set(REDEFINED_HELP) <= set(metrics.HELP)
    assert all("CUDA library" in metrics.HELP[k] for k in REDEFINED_HELP)
    ref, port = ref_metrics.Metrics(), metrics.Metrics()
    ref_metrics.preregister_boot_series(ref)
    for _ in range(2):   # idempotent: the engine and the supervisor both call it
        metrics.preregister_boot_series(port)

    def same_help(text, help_table):
        for k in REDEFINED_HELP:
            text = text.replace(help_table[k], "<redefined>")
        return text

    assert same_help(port.render_prometheus(), metrics.HELP) == \
        same_help(ref.render_prometheus(), ref_metrics.HELP)


# -- /metrics after the same traffic -------------------------------------------


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    vocab = make_spm_vocab()
    cfg = PRESETS["tiny"].replace(vocab_size=len(vocab.tokens), max_seq_len=128)
    params = random_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("models") / "metrics.gguf"
    write_model_gguf(path, cfg, jax.tree.map(np.asarray, params),
                     tokenizer_metadata=spm_metadata(vocab))
    return path


LONG = "once upon a time there was a little model " * 3
REQUESTS = [
    ("/chat", {"prompt": LONG, "max_new_tokens": 4, "temperature": 0.0}),
    ("/chat", {"prompt": LONG + "and", "max_new_tokens": 4, "temperature": 0.0}),
    ("/chat", {"prompt": "hi", "max_new_tokens": 3, "temperature": 0.0,
               "priority": "interactive"}),
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 5, "temperature": 0.0}),
    ("/completion", {"prompt": "pick:", "n_predict": 6, "temperature": 0.0,
                     "grammar": 'root ::= "hello" | "world"'}),
    ("/v1/completions", {"prompt": ["a", "b"], "max_tokens": 3, "temperature": 0.0}),
    ("/v1/completions", {"prompt": "x", "max_tokens": 2, "model": "nope"}),
    ("/chat", {"prompt": "hi", "max_new_tokens": 2, "temperature": 0.0,
               "stop": ["q"], "deadline_ms": 60000}),
]


async def _drive(app) -> dict:
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        for route, body in REQUESTS:
            r = await client.post(route, json=body)
            await r.read()
        r = await client.get("/metrics", headers={"Accept": "application/json"})
        snap = await r.json()
        text = await (await client.get("/metrics")).text()
        return {"snap": snap, "text": text}
    finally:
        await client.close()


def _family(key: str) -> str:
    return key.split("{", 1)[0]


def _kept(series: dict) -> dict:
    return {k: v for k, v in series.items() if _family(k) not in LEFT_OUT
            and not (_family(k) in LABELLED_APART and "{" in k)}


@pytest.fixture(scope="module")
def scrapes(gguf_path):
    out = {}
    for slots in (1, 2):
        # fresh engines each round: the counts start at the boot schema
        ref_app = JaxChatServer(JaxEngine(gguf_path, dtype=jnp.float32), JaxGen(),
                                parallel=slots).app
        port_app = ChatServer(Engine(gguf_path, dtype=torch.float32, device="cpu"),
                              GenerationConfig(), parallel=slots).app
        out[slots] = (asyncio.run(_drive(ref_app)), asyncio.run(_drive(port_app)))
    return out


@pytest.mark.parametrize("slots", [1, 2])
def test_metrics_serve_the_reference_series_and_counts(scrapes, slots):
    ref, port = (s["snap"] for s in scrapes[slots])
    for kind in ("counters", "gauges", "histograms", "buckets"):
        assert set(_kept(port.get(kind, {}))) == set(_kept(ref.get(kind, {}))), kind
    assert _kept(port["counters"]) == _kept(ref["counters"])
    for kind in ("histograms", "buckets"):
        for k, v in _kept(ref[kind]).items():
            slack = STEP_SLACK if slots > 1 and _family(k) == "step_ms" else 0
            assert abs(port[kind][k]["count"] - v["count"]) <= slack, (kind, k)
    # the traffic is there: every request that reached an engine finished
    c = port["counters"]
    assert c["requests_total"] >= len(REQUESTS) - 1
    assert c["requests_finished_stop_total"] + c["requests_finished_length_total"] \
        == c["requests_total"] - 2   # the batch's two rows count as requests only


@pytest.mark.parametrize("slots", [1, 2])
def test_prometheus_text_has_the_reference_families(scrapes, slots):
    ref, port = (s["text"] for s in scrapes[slots])

    def families(text):
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE") and _family(ln.split()[2][4:]) not in LEFT_OUT
                and ln.split()[2][4:].removesuffix("_hist") not in LEFT_OUT}

    assert families(port) == families(ref)
    assert "dlp_requests_total" in families(port)
