"""The port's MFU ledger, Prometheus endpoint and ``trace_main --ledger``
against the JAX package's, on the CPU.

The JAX ledger reads XLA's cost analysis; the port's counts the
matmuls and convolutions with ``torch.utils.flop_counter``'s formulas
(held equal to ``FlopCounterMode``) and takes the attention kernels'
operations from their wrappers -- so these tests pin the counts to
closed forms: a train
step's to 6 x tokens x matmul parameters plus K1's and K3's pair
counts, a decode step's to 2 x rows x matmul parameters plus K4's live
pairs.  The ledger's arithmetic (MFU, HBM share, summaries, trace
events) is held to the JAX ledger's on the same counts and wall times;
``prometheus_text`` to the JAX module's text on the same registry; the
``--ledger`` rows to the JAX ``ledger_rows`` of the same trace.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dtf_tpu.cli.trace_main import ledger_rows as jax_ledger_rows
from dtf_tpu.obs.ledger import Ledger as JaxLedger
from dtf_tpu.obs.prom import prometheus_text as jax_prometheus_text
from dtf_tpu.obs.registry import MetricsRegistry as JaxRegistry
from dtf_tpu_torch.cli import lm_main
from dtf_tpu_torch.cli.trace_main import ledger_rows
from dtf_tpu_torch.cli.trace_main import main as trace_main
from dtf_tpu_torch.config import parse_flags
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.obs import ledger as ledger_mod
from dtf_tpu_torch.obs import trace
from dtf_tpu_torch.obs.ledger import Ledger, count_flops
from dtf_tpu_torch.obs.prom import MetricsServer, prometheus_text
from dtf_tpu_torch.obs.registry import MetricsRegistry, default_registry
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.ops import paged_attention as pa
from dtf_tpu_torch.serve import ServeEngine
from dtf_tpu_torch.serve.decode import Decoder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matmul_params(layers, d, ff, vocab):
    """Weights that meet a matmul in the LM: qkv, out, fc1, fc2 per
    layer and the head."""
    return layers * (4 * d * d + 2 * d * ff) + d * vocab


# ---------------------------------------------------------------------------
# peaks
# ---------------------------------------------------------------------------

def test_ledger_peak_table_most_specific_name_first(monkeypatch):
    """The H100 variants' data-sheet peaks by card name, the longest
    key first; the SXM part's are the numbers chip_smoke.py's bounds
    use; an unknown kind has none; the env overrides win."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_peaks", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.delenv("DTF_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("DTF_PEAK_HBM_GBPS", raising=False)
    lookup = ledger_mod._lookup
    sxm = "NVIDIA H100 80GB HBM3"
    assert lookup(ledger_mod.PEAK_BF16_TFLOPS, sxm) * 1e12 == \
        smoke.PEAK_FLOPS["bfloat16"]
    assert lookup(ledger_mod.PEAK_HBM_GBPS, sxm) * 1e9 == \
        smoke.HBM_BYTES_PER_S
    assert lookup(ledger_mod.PEAK_BF16_TFLOPS, "NVIDIA H100 PCIe") == 756.0
    assert lookup(ledger_mod.PEAK_HBM_GBPS, "NVIDIA H100 NVL") == 3900.0
    assert lookup(ledger_mod.PEAK_BF16_TFLOPS, "NVIDIA A100-SXM4") is None
    assert ledger_mod.device_peaks("cpu") == (None, None)
    monkeypatch.setenv("DTF_PEAK_TFLOPS", "0.5")
    monkeypatch.setenv("DTF_PEAK_HBM_GBPS", "10")
    assert ledger_mod.device_peaks("cpu") == (0.5e12, 10e9)


# ---------------------------------------------------------------------------
# the ledger's arithmetic against the JAX ledger's
# ---------------------------------------------------------------------------

def test_ledger_matches_jax_ledger_on_the_same_counts(monkeypatch):
    """register + observe with static counts: every gauge and the
    summary equal the JAX ledger's (env-pinned peaks)."""
    monkeypatch.setenv("DTF_PEAK_TFLOPS", "0.5")
    monkeypatch.setenv("DTF_PEAK_HBM_GBPS", "10")
    reg, jreg = MetricsRegistry(), JaxRegistry()
    led, jled = Ledger(reg), JaxLedger(jreg)
    for lg in (led, jled):
        lg.register("train_step", flops=3.0e9, bytes_accessed=2.0e8)
        for wall in (0.0125, 0.0135, -1.0, float("nan")):
            lg.observe("train_step", wall)
        lg.observe("never_registered", 0.1)
    for name in ("flops", "bytes", "wall_s", "calls", "achieved_tflops",
                 "mfu", "hbm_frac"):
        g = f"ledger_train_step_{name}"
        np.testing.assert_allclose(reg.get(g).value, jreg.get(g).value,
                                   rtol=1e-12)
    s, js = led.summary()["train_step"], jled.summary()["train_step"]
    assert s.keys() == js.keys()
    for k in s:
        np.testing.assert_allclose(s[k], js[k], rtol=1e-12)
    np.testing.assert_allclose(s["mfu"], 3.0e9 / 0.013 / 0.5e12)
    assert reg.get("ledger_never_registered_calls") is None


def test_ledger_per_call_counts_and_unknown_bytes(monkeypatch):
    """Data-dependent work: observe() with each call's own counts gives
    mean counts a call and MFU = summed operations / summed wall; an
    executable with no honest byte count exports no bytes and no HBM
    share; on the CPU (no peak) no MFU either."""
    monkeypatch.setenv("DTF_PEAK_TFLOPS", "1")
    monkeypatch.setenv("DTF_PEAK_HBM_GBPS", "100")
    reg = MetricsRegistry()
    led = Ledger(reg)
    led.register("serve_decode_step", flops=1e9, bytes_accessed=1e8)
    led.observe("serve_decode_step", 0.01, flops=1e9, bytes_accessed=1e8)
    led.observe("serve_decode_step", 0.03, flops=3e9, bytes_accessed=5e8)
    s = led.summary()["serve_decode_step"]
    assert s["flops"] == 2e9 and s["bytes"] == 3e8 and s["count"] == 2
    np.testing.assert_allclose(s["mfu"], 4e9 / 0.04 / 1e12)
    np.testing.assert_allclose(s["hbm_frac"], 6e8 / 0.04 / 100e9)
    led.register("serve_prefill_chunk_c64", flops=5e8)
    led.observe("serve_prefill_chunk_c64", 0.002)
    c = led.summary()["serve_prefill_chunk_c64"]
    assert c["bytes"] is None and c["hbm_frac"] is None and c["mfu"] > 0
    assert reg.get("ledger_serve_prefill_chunk_c64_bytes") is None
    assert reg.get("ledger_serve_prefill_chunk_c64_hbm_frac") is None
    monkeypatch.delenv("DTF_PEAK_TFLOPS")
    monkeypatch.delenv("DTF_PEAK_HBM_GBPS")
    cpu = Ledger(MetricsRegistry(), device="cpu")
    cpu.register("x", flops=1e6, bytes_accessed=1e6)
    cpu.observe("x", 0.5)
    assert cpu.summary()["x"]["mfu"] is None
    assert cpu.registry.get("ledger_x_mfu") is None


# ---------------------------------------------------------------------------
# counting: aten FLOPs plus the kernels' own, the plain versions hidden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_count_flops_takes_kernel_counts_not_plain_versions(causal):
    """K1, K3 and K4 on the CPU: the plain versions' einsums are not
    counted and each wrapper reports the operations its bound uses --
    4 D a pair forward, 10 D a pair for K3, 4 D a live pair for K4."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, d = 2, 24, 2, 16
    q, k, v = (torch.randn(b, s, h, d, generator=gen, requires_grad=True)
               for _ in range(3))
    pairs = s * (s + 1) // 2 if causal else s * s

    def step():
        o = fa.flash_attention(q, k, v, causal=causal, fused_bwd=True)
        o.sum().backward()
        return o

    _, c = count_flops(step)
    assert c.aten == 0
    assert c.kernel == (4 + 10) * b * h * d * pairs
    assert fa.attention_pairs(5, 3, True) == 1 + 2 + 3 * 3
    pool = torch.randn(9, 4, h, d, generator=gen)
    table = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    index = torch.tensor([6, 2], dtype=torch.int32)
    qd = torch.randn(2, 1, h, d, generator=gen)
    for fn in (pa.paged_flash_decode, pa.paged_attention_auto):
        out, c = count_flops(fn, qd, pool, pool, table, index)
        assert c.aten == 0 and c.kernel == 4 * h * d * (7 + 3)
        assert torch.allclose(out, pa.paged_attention(qd, pool, pool, table,
                                                      index), atol=1e-6)
    # outside a count the wrappers report nothing
    assert not ledger_mod.counting()


@pytest.mark.parametrize("model_name", ["resnet20", "lm"])
def test_count_flops_matches_flop_counter_mode(model_name):
    """The ledger's torch-function count of a training step's matmuls
    and convolutions, forward and backward (the stem's input takes no
    gradient), equals FlopCounterMode's aten count of the same step;
    the attention runs through K1/K3's plain versions, which neither
    counts (FlopCounterMode sees their einsums, so the LM's reference
    subtracts them by running the step with attention bound to an
    uncounted stand-in)."""
    from torch.utils.flop_counter import FlopCounterMode

    from dtf_tpu_torch.models import registry, transformer

    torch.manual_seed(0)
    if model_name == "resnet20":
        model, _ = registry.build_model("resnet20", num_classes=10)
        x = torch.randn(2, 8, 8, 3)
    else:
        model = TransformerLM(vocab_size=64, num_layers=2, d_model=32,
                              num_heads=2, d_ff=64, max_seq_len=16)
        x = torch.randint(0, 64, (2, 16))

    def step():
        model.zero_grad()
        out = model(x)
        out.float().square().mean().backward()

    saved = transformer.flash_attention
    # an attention with no matmul of its own: both counters see the
    # same aten work
    transformer.flash_attention = lambda q, k, v, causal: q * 1.0 + k + v
    try:
        _, c = count_flops(step)
        with FlopCounterMode(display=False) as ref:
            step()
    finally:
        transformer.flash_attention = saved
    assert c.kernel == 0
    assert c.aten == ref.get_total_flops() > 0


def test_decoder_registers_decode_and_chunk_counts():
    """The paged Decoder's first call of each executable is counted:
    serve_decode_step = 2 x rows x matmul weights + K4's live pairs,
    serve_prefill_chunk_c8 at start 0 = 2 x 8 x weights + K1's pairs;
    later calls carry their own attention and bytes (last_cost)."""
    dims = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
                d_ff=64, max_seq_len=32)
    model = TransformerLM(**dims).eval()
    led = Ledger(MetricsRegistry(), device="cpu")
    dec = Decoder(model, num_slots=2, max_seq_len=32, kv_page_size=4,
                  ledger=led)
    cache = dec.fresh_cache()
    weights = _matmul_params(2, 32, 64, 64)
    row = np.arange(1, 9, dtype=np.int32)
    dec.prefill_chunk(cache, np.arange(8), row, 0, 7, 0.0)
    c8 = 2 * 8 * weights + 4 * 32 * 2 * (8 * 9 // 2)
    assert led.summary()["serve_prefill_chunk_c8"]["flops"] == c8
    assert dec.compiled_count == 1
    # a continuation chunk: same count outside attention, K4's pairs in
    dec.prefill_chunk(cache, np.arange(8), row, 8, 7, 0.0)
    assert dec.compiled_count == 1
    assert dec.last_cost == (2 * 8 * weights + 4 * 32 * 2 * sum(
        range(9, 17)), None)
    tables = np.stack([row, np.zeros_like(row)])
    index = np.array([16, 0], np.int32)
    dec.decode_step(cache, np.array([3, 0]), index, np.zeros(2), tables)
    decode = 2 * 2 * weights + 4 * 32 * 2 * (17 + 1)
    s = led.summary()["serve_decode_step"]
    assert s["flops"] == decode and dec.compiled_count == 2
    elem = 4
    kv_row = 2 * 2 * 32 * elem
    all_params = sum(p.numel() for p in model.parameters())
    emb = model.embed.weight.numel() + model.pos_embed.numel()
    assert s["bytes"] == ((all_params - emb) * elem + 2 * 2 * 32 * elem
                          + kv_row * (17 + 1 + 2))
    dec.decode_step(cache, np.array([3, 0]), index + 1, np.zeros(2), tables)
    assert dec.last_cost[0] == decode + 2 * 4 * 32 * 2      # both rows +1


def test_train_step_ledger_counts_the_closed_form(tmp_path, monkeypatch):
    """lm_main on the CPU: train_step registered once with 6 x tokens x
    matmul weights + K1's and K3's pair counts, observed per clean log
    window, summarized into the trace (``trace_main --ledger``) and the
    stats; with the env peak, MFU = flops / window step time / peak."""
    monkeypatch.setenv("DTF_PEAK_TFLOPS", "0.5")
    b, s, layers, d, ff, vocab = 4, 32, 4, 256, 1024, 256
    stats = lm_main.main([
        "--use_synthetic_data", "--device", "cpu", "--model",
        "transformer_small", "--seq_len", str(s), "--num_classes",
        str(vocab), "--batch_size", str(b), "--train_steps", "4",
        "--log_steps", "1", "--dtype", "fp32", "--skip_checkpoint",
        "--trace_dir", str(tmp_path)])
    trace.disable()
    pairs = s * (s + 1) // 2
    want = (6 * b * s * _matmul_params(layers, d, ff, vocab)
            + layers * (4 + 10) * b * d * pairs)
    row = stats["ledger"]["train_step"]
    assert row["flops"] == want
    assert row["count"] == len(stats["window_step_s"]) == 3
    np.testing.assert_allclose(
        row["mfu"], want / np.mean(stats["window_step_s"]) / 0.5e12,
        rtol=1e-9)
    reg = default_registry()
    assert reg.get("ledger_train_step_flops").value == want
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    assert [r["exec"] for r in recs if r.get("name") == "ledger_exec"] == [
        "train_step"]
    assert trace_main([str(tmp_path), "--ledger"]) == 0
    rows = ledger_rows(recs)
    assert rows == jax_ledger_rows(recs)
    assert rows[0]["flops"] == want and rows[0]["count"] == 3


def test_train_step_ledger_counts_the_moe_experts(tmp_path, monkeypatch):
    """lm_main with moe_transformer_small on the CPU: train_step's FLOPs
    are 6 x tokens x the weights every token meets (qkv and out in
    every block, fc1 and fc2 in the two dense blocks, the router in the
    two MoE blocks, the head), the attention kernels' pair counts, and
    the experts' two batched products at their capacity shapes -- 12 x
    E x C x d x d_ff a MoE block (forward and both gradients), C =
    round(1.25 x 2 x tokens / E) -- what the card computes, kept slots
    or not."""
    monkeypatch.setenv("DTF_PEAK_TFLOPS", "0.5")
    b, s, layers, d, ff, vocab, e = 4, 32, 4, 256, 1024, 256, 4
    stats = lm_main.main([
        "--use_synthetic_data", "--device", "cpu", "--model",
        "moe_transformer_small", "--seq_len", str(s), "--num_classes",
        str(vocab), "--batch_size", str(b), "--train_steps", "3",
        "--log_steps", "1", "--dtype", "fp32", "--skip_checkpoint",
        "--trace_dir", str(tmp_path)])
    trace.disable()
    n, moe_blocks = b * s, layers // 2
    cap = int(round(1.25 * 2 * n / e))
    weights = (layers * 4 * d * d + (layers - moe_blocks) * 2 * d * ff
               + moe_blocks * d * e + d * vocab)
    pairs = s * (s + 1) // 2
    want = (6 * n * weights + layers * (4 + 10) * b * d * pairs
            + moe_blocks * 12 * e * cap * d * ff)
    assert stats["ledger"]["train_step"]["flops"] == want
    assert default_registry().get("ledger_train_step_flops").value == want


def test_ledger_env_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("DTF_LEDGER", "0")
    stats = lm_main.main([
        "--use_synthetic_data", "--device", "cpu", "--model",
        "transformer_small", "--seq_len", "16", "--num_classes", "128",
        "--batch_size", "2", "--train_steps", "2", "--log_steps", "1",
        "--skip_checkpoint", "--trace_dir", str(tmp_path)])
    trace.disable()
    assert stats["ledger"] == {}
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    assert not any(r.get("name") == "ledger_exec" for r in recs)
    assert trace_main([str(tmp_path), "--ledger"]) == 2


# ---------------------------------------------------------------------------
# trace_main --ledger
# ---------------------------------------------------------------------------

def test_trace_main_ledger_json_machine_readable(tmp_path, capsys):
    """--ledger --json emits the rows as one JSON object, the JAX
    ledger_rows of the same stream; no ledger records exit 2."""
    t = trace.configure(str(tmp_path), rank=0)
    trace.event("ledger_exec", exec="serve_decode_step", flops=1.5e9,
                bytes=2.0e8, peak_tflops=None, peak_hbm_gbps=None)
    trace.event("ledger_summary", exec="serve_decode_step", count=32,
                mean_s=0.011, achieved_tflops=0.136, mfu=None,
                hbm_frac=None)
    t.flush()
    trace.disable()
    assert trace_main([str(tmp_path), "--ledger", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["ledger"]
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    assert rows == jax_ledger_rows(recs)
    assert len(rows) == 1
    row = rows[0]
    assert row["exec"] == "serve_decode_step" and row["rank"] == "0"
    assert row["flops"] == 1.5e9 and row["count"] == 32
    assert row["mean_s"] == 0.011
    assert trace_main([str(tmp_path), "--ledger"]) == 0
    assert "serve_decode_step" in capsys.readouterr().out
    t2 = trace.configure(str(tmp_path / "empty"), rank=0)
    t2.flush()
    trace.disable()
    assert trace_main([str(tmp_path / "empty"), "--ledger",
                       "--json"]) == 2


def test_serve_engine_ledger_reaches_the_trace(tmp_path, monkeypatch):
    """The engine's decode step and chunk lengths land in the trace
    (registration at the first call, a summary at stop) with the mean
    counts a call, which ``--ledger`` rows carry."""
    monkeypatch.setenv("DTF_PEAK_TFLOPS", "0.5")
    model = TransformerLM(vocab_size=64, num_layers=2, d_model=32,
                          num_heads=2, d_ff=64, max_seq_len=32).eval()
    trace.configure(str(tmp_path), rank=0)
    try:
        eng = ServeEngine(model, max_batch=2, max_seq_len=32,
                          max_delay_s=0.0, kv_page_size=4)
        for n in (3, 9):
            eng.generate(np.arange(1, n + 1), max_new_tokens=5)
        eng.stop()
        summary = eng.ledger.summary()
    finally:
        trace.disable()
    recs = trace.read_records(str(tmp_path / "trace_rank0.jsonl"))
    rows = {r["exec"]: r for r in ledger_rows(recs)}
    assert set(rows) == set(summary) == {
        "serve_decode_step", "serve_prefill_chunk_c4",
        "serve_prefill_chunk_c12"}
    dec = rows["serve_decode_step"]
    assert dec["count"] == summary["serve_decode_step"]["count"] >= 6
    assert dec["flops"] == summary["serve_decode_step"]["flops"]
    assert dec["mfu"] > 0 and dec["hbm_frac"] is None
    assert eng.metrics.get("ledger_serve_decode_step_mfu").value > 0


# ---------------------------------------------------------------------------
# Prometheus text and the endpoint
# ---------------------------------------------------------------------------

def test_prometheus_text_matches_jax_module():
    """The same registry contents give the same exposition text."""
    regs = (MetricsRegistry(), JaxRegistry())
    for reg in regs:
        reg.gauge("data_reader_lag_s", unit="s").set(0.25)
        reg.counter("data_reader_respawns").inc(2)
        reg.gauge("serve_bad", unit="x").set(float("inf"))
        h = reg.histogram("step_s", unit="s")
        for v in (0.5, 0.25, 0.75):
            h.observe(v)
    text = prometheus_text(regs[0])
    assert text == jax_prometheus_text(regs[1])
    assert "# TYPE data_reader_lag_s gauge" in text
    assert "data_reader_lag_s 0.25" in text
    assert "serve_bad +Inf" in text
    assert 'step_s{quantile="0.5"} 0.5' in text
    assert "step_s_count 3" in text and text.endswith("\n")


def test_prom_healthz_and_concurrent_scrape():
    """/healthz answers 200 with the health_fn payload (503 on
    ok=False); 8 threads scraping /metrics and /healthz while another
    mutates the registry all get whole responses; the registry is read
    live per request; unknown paths are 404."""
    reg = MetricsRegistry()
    c = reg.counter("scrapes_total", unit="scrapes")
    h = reg.histogram("lat", unit="s")
    state = {"ok": True}
    srv = MetricsServer(0, registry_fn=lambda: reg,
                        health_fn=lambda: {"ok": state["ok"],
                                           "outstanding": c.value})
    base = f"http://127.0.0.1:{srv.port}"
    try:
        stop = threading.Event()

        def mutate():
            i = 0
            while not stop.is_set():
                c.inc()
                h.observe(0.001 * (i % 7))
                i += 1

        mt = threading.Thread(target=mutate, daemon=True)
        mt.start()
        errors = []

        def scrape(n):
            try:
                for _ in range(10):
                    body = urllib.request.urlopen(
                        f"{base}/metrics", timeout=10).read().decode()
                    assert "# TYPE scrapes_total counter" in body
                    assert body.endswith("\n")
                    hz = json.loads(urllib.request.urlopen(
                        f"{base}/healthz", timeout=10).read())
                    assert hz["ok"] is True and "outstanding" in hz
            except Exception as e:  # noqa: BLE001
                errors.append(f"scraper {n}: {e!r}")

        threads = [threading.Thread(target=scrape, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        mt.join(timeout=5)
        assert not errors, errors
        reg.gauge("live_now", unit="x").set(0.5)
        assert "live_now 0.5" in urllib.request.urlopen(
            f"{base}/", timeout=10).read().decode()
        state["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz", timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["ok"] is False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.shutdown()


def test_runner_serves_the_default_registry_on_rank_zero(monkeypatch):
    """--metrics_port on a training run: rank 0 serves the default
    registry (the ledger's train_step gauges) while it trains, and the
    server is shut down at the end."""
    from dtf_tpu_torch.cli import runner
    from dtf_tpu_torch.obs import prom

    started = []

    class Recording(prom.MetricsServer):
        def __init__(self, port, **kw):
            super().__init__(0, **kw)
            started.append(self)
            self.requested = port
            self.closed = False

        def shutdown(self):
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/metrics",
                timeout=10).read().decode()
            self.body = body
            self.closed = True
            super().shutdown()

    monkeypatch.setattr(prom, "MetricsServer", Recording)
    argv = ["--use_synthetic_data", "--device", "cpu", "--model",
            "transformer_small", "--seq_len", "16", "--num_classes", "128",
            "--batch_size", "2", "--train_steps", "3", "--log_steps", "1",
            "--skip_checkpoint", "--metrics_port", "9"]
    cfg = parse_flags(argv, defaults=lm_main.LM_DEFAULTS)
    runner.run(cfg)
    assert len(started) == 1 and started[0].requested == 9
    assert started[0].closed
    assert "# TYPE ledger_train_step_flops gauge" in started[0].body
