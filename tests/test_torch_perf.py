"""The port's perf monitor (``utils/perf.py``) against the JAX package's, on
the CPU.

The roofline math (FLOPs a token, the weights-bound ceiling, its share, MFU,
the field family) gives the reference's numbers on the same inputs; the
peaks resolve in the reference's order (env > measured > the device's row >
``assumed``), the H100 rows are the figures ``PERF.md`` bounds every kernel
by, and no v5e figure is left. The same steps recorded on both monitors give
the same rolling-window aggregates, gauges and snapshot; retention prunes the
same profiler runs; the kernel-build counters count builds, loads and
retraces as the port defines them; and an on-demand ``torch.profiler``
window seals after its steps and writes a Chrome trace on the CPU.
"""

import os
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_llm_pipeline_tpu.utils.metrics as ref_metrics
import distributed_llm_pipeline_tpu.utils.perf as ref
import distributed_llm_pipeline_tpu.utils.xplane as ref_xplane
from distributed_llm_pipeline_tpu.models import PRESETS as REF_PRESETS
from distributed_llm_pipeline_tpu_torch.models import PRESETS
from distributed_llm_pipeline_tpu_torch.ops import cuda_build
from distributed_llm_pipeline_tpu_torch.utils import metrics, perf, profile_trace
from distributed_llm_pipeline_tpu_torch.utils.profile_trace import profiler_trace

ROOT = Path(__file__).resolve().parents[1]
PEAK_ENVS = ("DLP_HBM_GBPS", "BENCH_HBM_GBPS", "DLP_PEAK_TFLOPS")


@pytest.fixture(autouse=True)
def _clean_peaks(monkeypatch):
    for env in PEAK_ENVS:
        monkeypatch.delenv(env, raising=False)
    perf.set_measured_hbm_gbps(None)
    ref.set_measured_hbm_gbps(None)
    yield
    perf.set_measured_hbm_gbps(None)
    ref.set_measured_hbm_gbps(None)


@pytest.mark.parametrize("preset", ["tiny", "llama3.2-1b", "llama3-8b", "gemma2-9b",
                                    "mixtral-8x7b"])
def test_flops_per_token_is_the_reference_s(preset):
    if preset not in PRESETS or preset not in REF_PRESETS:
        pytest.skip(f"no preset {preset}")
    assert perf.model_flops_per_token(PRESETS[preset]) == \
        ref.model_flops_per_token(REF_PRESETS[preset])


@pytest.mark.parametrize("tok_s,nbytes,gbps,flops,tflops", [
    (47.0, 2_471_000_000, 3350.0, 2_471_000_000, 989.0),
    (0.5, 1, 50.0, 10, 0.5),
    (1234.5, 987_654_321, 2000.0, 5_000_000, 756.0)])
def test_roofline_math_is_the_reference_s(tok_s, nbytes, gbps, flops, tflops):
    assert perf.roofline_tok_s(nbytes, gbps) == ref.roofline_tok_s(nbytes, gbps)
    assert perf.roofline_pct(tok_s, nbytes, gbps) == ref.roofline_pct(tok_s, nbytes, gbps)
    assert perf.mfu_pct(tok_s, flops, tflops) == ref.mfu_pct(tok_s, flops, tflops)
    for t in (tok_s, 0, None):
        assert perf.roofline_fields("x", t, nbytes, False) == \
            ref.roofline_fields("x", t, nbytes, False)


def test_params_nbytes_counts_resident_bytes():
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": [rng.integers(0, 9, (7,), dtype=np.int8),
                    rng.standard_normal((2, 2)).astype(np.float16)]}
    tensors = {"a": torch.from_numpy(arrays["a"]),
               "b": [torch.from_numpy(x) for x in arrays["b"]]}
    assert perf.params_nbytes(tensors) == ref.params_nbytes(arrays) == 60 + 7 + 8
    # a module's parameters and buffers, a tied tensor once
    m = torch.nn.Linear(4, 3)
    m.register_buffer("codes", torch.zeros(10, dtype=torch.int8))
    m.tied = m.weight
    assert perf.params_nbytes(m) == (12 + 3) * 4 + 10
    assert perf.params_nbytes({"w": m.weight, "again": m.weight}) == 48


def test_peaks_resolve_in_the_reference_order(monkeypatch):
    h100 = "NVIDIA H100 80GB HBM3"
    # no env, no probe: the device's row on the card, assumed on the CPU
    assert perf.hbm_peak_gbps("cpu") == ref.hbm_peak_gbps("cpu") == (50.0, "assumed:cpu")
    assert perf.peak_tflops("cpu") == ref.peak_tflops("cpu") == (0.5, "assumed:cpu")
    assert perf.hbm_peak_gbps("cuda", h100) == (3350.0, f"device:{h100}")
    assert perf.peak_tflops("cuda", h100) == (989.0, f"device:{h100}")
    assert perf.hbm_peak_gbps("cuda", "NVIDIA H100 PCIe") == (2000.0, "device:NVIDIA H100 PCIe")
    assert perf.peak_tflops("cuda", "NVIDIA H100 PCIe") == (756.0, "device:NVIDIA H100 PCIe")
    # a card outside the table is labelled assumed, never given an H100 figure
    assert perf.hbm_peak_gbps("cuda", "NVIDIA A100-SXM4-80GB") == (50.0, "assumed:cuda")
    assert perf.peak_tflops("cuda", "NVIDIA A100-SXM4-80GB") == (0.5, "assumed:cuda")
    # the measured probe wins over the device, an env value over both
    for mod in (perf, ref):
        mod.set_measured_hbm_gbps(2900.0)
    assert perf.hbm_peak_gbps("cuda", h100) == (2900.0, "measured")
    assert perf.hbm_peak_gbps("cpu") == ref.hbm_peak_gbps("cpu") == (2900.0, "measured")
    monkeypatch.setenv("BENCH_HBM_GBPS", "1234")
    assert perf.hbm_peak_gbps("cuda", h100) == ref.hbm_peak_gbps("cpu") == \
        (1234.0, "env:BENCH_HBM_GBPS")
    monkeypatch.setenv("DLP_HBM_GBPS", "3000")
    assert perf.hbm_peak_gbps("cuda", h100) == ref.hbm_peak_gbps("cpu") == \
        (3000.0, "env:DLP_HBM_GBPS")
    monkeypatch.setenv("DLP_PEAK_TFLOPS", "900")
    assert perf.peak_tflops("cuda", h100) == ref.peak_tflops("cpu") == \
        (900.0, "env:DLP_PEAK_TFLOPS")


def test_the_h100_rows_are_perf_md_s_bounds():
    """PERF.md bounds every kernel by 3.35 TB/s and 989 TFLOP/s (bf16): the
    gauges read the same peaks."""
    text = (ROOT / "PERF.md").read_text()
    assert "3.35 TB/s" in text and "989 TFLOP/s" in text
    assert perf.DEVICE_PEAKS["H100 80GB HBM3"] == (3.35 * 1000, 989.0)
    src = (ROOT / "distributed_llm_pipeline_tpu_torch" / "utils" / "perf.py").read_text()
    assert not re.search(r"v5e|\b819\b|\b197\.0\b", src)


def _feed(mon, t_now: float) -> None:
    steps = [("engine", 10.0, dict(rows=1, tokens=8, scan_steps=8, kv_positions=512)),
             ("engine", 12.5, dict(rows=1, tokens=8, scan_steps=8, kv_positions=520)),
             ("paged", 20.0, dict(rows=4, tokens=32, scan_steps=8, kv_positions=2048)),
             ("paged", 25.0, dict(rows=3, tokens=0, scan_steps=1, prefill_tokens=64,
                                  kv_positions=900, kind="mixed")),
             ("paged", 18.0, dict(rows=2, tokens=16, scan_steps=8, kv_positions=700))]
    for i, (backend, ms, kw) in enumerate(steps):
        t_end = t_now - 1.0 + i * 0.01
        mon.record_step(backend, t_end - ms / 1000.0, t_end, **kw)
    # a step past the window: not aggregated, still in the totals
    mon.record_step("engine", t_now - 500.0, t_now - 499.99, rows=1, tokens=8)


def test_step_rings_aggregate_as_the_reference():
    kw = dict(model_bytes=2_471_000_000, flops_per_token=2_471_000_000,
              kv_bytes_per_token=32768, platform="cpu", model="llama")
    got, want = perf.PerfMonitor(**kw), ref.PerfMonitor(**kw)
    t_now = time.monotonic()
    _feed(got, t_now)
    _feed(want, t_now)
    for backend in ("engine", "paged", "mesh"):
        assert got.backend_stats(backend) == want.backend_stats(backend), backend
    g, w = got.snapshot(), want.snapshot()
    assert {k: v for k, v in g.items() if k != "compile"} == \
        {k: v for k, v in w.items() if k != "compile"}
    assert set(g["compile"]) == set(w["compile"])
    assert g["backends"]["paged"]["decode_tok_s_by_occupancy"] == {"2": 888.89, "4": 1600.0}
    gm, wm = metrics.Metrics(), ref_metrics.Metrics()
    got.export_gauges(gm)
    want.export_gauges(wm)
    assert gm.snapshot()["gauges"] == wm.snapshot()["gauges"]


def test_the_step_ring_feeds_the_step_ms_histogram():
    m = metrics.Metrics()
    mon = perf.PerfMonitor(model_bytes=1, flops_per_token=1, metrics_fn=lambda: m,
                           ring_cap=16)
    for i in range(40):
        mon.record_step("paged", 0.0, 0.002 + i * 1e-4, tokens=1)
    assert m.snapshot()["histograms"]['step_ms{backend="paged"}']["count"] == 40
    assert mon.backend_stats("paged") is None   # t_end 0.002 s: outside the window
    assert len(mon._rings["paged"]) == 16 and mon._totals["paged"] == 40


def test_perf_off_is_a_falsy_no_op(monkeypatch):
    monkeypatch.setenv("DLP_PERF", "0")
    for mod in (perf, ref):
        mon = mod.make_perf_monitor(model_bytes=1, flops_per_token=1)
        assert mon is mod.NULL_PERF and not mon
        assert mon.snapshot() == {"enabled": False}
        mon.record_step("engine", 0.0, 1.0)
        with pytest.raises(RuntimeError, match="DLP_PERF=0"):
            mon.arm_profile(1)
    monkeypatch.setenv("DLP_PERF", "1")
    assert isinstance(perf.make_perf_monitor(model_bytes=1, flops_per_token=1),
                      perf.PerfMonitor)


def test_prune_profile_runs_keeps_the_reference_s_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("DLP_PROFILE_KEEP", "3")
    for name in ("port", "ref"):
        for i in range(6):
            for run in (tmp_path / name / "plugins" / "profile" / f"s{i}",
                        tmp_path / name / f"run-{i}"):
                run.mkdir(parents=True)
                (run / "trace.json").write_text("{}")
                os.utime(run, (1000 + i, 1000 + i))
    got = (profile_trace.prune_profile_runs(str(tmp_path / "port")),
           profile_trace.prune_profile_runs(str(tmp_path / "port"), keep=2, keep_dirs=True))
    want = (ref_xplane.prune_profile_runs(str(tmp_path / "ref")),
            ref_xplane.prune_profile_runs(str(tmp_path / "ref"), keep=2, keep_dirs=True))
    assert got == want == (3, 4)
    for name in ("port", "ref"):
        left = sorted(p.name for p in (tmp_path / name / "plugins" / "profile").iterdir())
        assert left == ["s3", "s4", "s5"]
        assert sorted(p.name for p in (tmp_path / name).glob("run-*")) == ["run-4", "run-5"]


def test_build_counters_count_builds_loads_and_retraces():
    perf.reset_compile_tracking()
    try:
        with perf.compile_entry("slots_decode") as sc:
            assert perf.record_compile("flash_attention") is False       # nvcc
            assert perf.record_compile("flash_attention", load=True) is False
        assert (sc.compiles, sc.retrace) == (2, False)
        assert perf.compile_counts() == {"flash_attention": 2}
        assert perf.retrace_counts() == {}
        m = metrics.Metrics()
        perf.export_compile_counters(m)
        perf.export_compile_counters(m)   # a second scrape adds nothing
        c = m.snapshot()["counters"]
        assert c['xla_compiles_total{entry="flash_attention"}'] == 2
        # a loaded source built again is a retrace, noted on the scope
        with perf.compile_entry("engine_decode") as sc:
            assert perf.record_compile("flash_attention") is True
        assert (sc.compiles, sc.retrace) == (1, True)
        perf.export_compile_counters(m)
        c = m.snapshot()["counters"]
        assert c['xla_compiles_total{entry="flash_attention"}'] == 3
        assert c['xla_retraces_total{entry="flash_attention"}'] == 1
    finally:
        perf.reset_compile_tracking()


def test_cuda_build_counts_and_tables_its_libraries(monkeypatch, tmp_path):
    """``load_library`` counts a load; the static table lists the loaded
    library's kernels from its ptxas report (the build and the dynamic load
    stand in: no nvcc here)."""
    report = ("ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'\n"
              "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
              "ptxas info    : Used 96 registers, 1024 bytes smem, 380 bytes cmem[0]\n")
    built = cuda_build.Built("fake_source", tmp_path / "libfake.so", 0.0, report)

    def fake_build(names):
        cuda_build._built.update({n: built for n in names})
        return {n: built for n in names}

    monkeypatch.setattr(cuda_build, "build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    perf.reset_compile_tracking()
    try:
        assert cuda_build.kernel_static_table() == []
        cuda_build.load_library("fake_source")
        cuda_build.load_library("fake_source")   # cached: no second load
        assert perf.compile_counts() == {"fake_source": 1}
        assert cuda_build.kernel_static_table() == [
            {"library": "fake_source", "function": "_Z6kernelPf", "spill_stores": 8,
             "spill_loads": 4, "registers": 96, "smem": 1024}]
    finally:
        cuda_build._loaded.pop("fake_source", None)
        cuda_build._built.pop("fake_source", None)
        perf.reset_compile_tracking()


def test_an_on_demand_window_profiles_the_next_steps(tmp_path):
    mon = perf.PerfMonitor(model_bytes=1, flops_per_token=1)
    run = mon.arm_profile(2, base_dir=str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already armed"):
            mon.arm_profile(1, base_dir=str(tmp_path))
        x = torch.randn(32, 32)
        for _ in range(3):
            x = x @ x
            mon.record_step("engine", time.monotonic() - 0.001, time.monotonic())
        assert run.wait(5.0) and run.steps_captured == 2
    finally:
        run.finish()
    summary = run.summarize()
    assert summary["steps_captured"] == 2 and summary["top_kernels"] == []
    assert summary["mode"] == "lanes" and summary["devices"]
    assert (Path(run.dir) / "trace.json").is_file()
    # the process's one session is free again, and a per-request session
    # holds it against an on-demand one
    with profiler_trace(str(tmp_path / "req")):
        with pytest.raises(RuntimeError, match="already active"):
            mon.arm_profile(1, base_dir=str(tmp_path))
    assert profile_trace.trace_file(str(tmp_path / "req")) is not None
    run = mon.arm_profile(1, base_dir=str(tmp_path))
    run.finish()
