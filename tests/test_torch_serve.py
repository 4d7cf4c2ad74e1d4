"""The port's serving engine and entry point, and the port's guards.

Greedy tokens from dtf_tpu_torch's ServeEngine on the CPU equal the JAX
ServeEngine's, token for token, on weights carried across by
``convert.py``, for prompts that cross page and chunk edges.  Sampled
tokens are held to the port's own contract only -- a pure function of
(request seed, position) -- since torch does not reproduce JAX's
threefry bits.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models.transformer import TransformerLM as JaxLM
from dtf_tpu.serve.engine import ServeEngine as JaxEngine
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import serve_main
from dtf_tpu_torch.config import Config, parse_flags
from dtf_tpu_torch.models.transformer import TransformerLM
from dtf_tpu_torch.ops import _build
from dtf_tpu_torch.runtime.device import resolve_device
from dtf_tpu_torch.serve import (Backpressure, PagePool, ServeEngine,
                                 collect_stats)
from dtf_tpu_torch.serve.decode import (position_seed, sample_tokens,
                                        teacher_forced_logits)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, PAGE, CHUNK = 64, 32, 4, 8
DIMS = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=2,
            d_ff=64, max_seq_len=SEQ)
# prompt lengths around the page (4) and chunk (8) edges
PLENS = (1, 3, 4, 5, 8, 9, 13, 17)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxLM(**DIMS)
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((1, SEQ), jnp.int32))["params"]
    tmodel = TransformerLM(**DIMS)
    tmodel.load_state_dict(convert.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    return jmodel, params, tmodel.eval()


def _engine(tmodel, **kw):
    kw = {"max_batch": 3, "max_seq_len": SEQ, "kv_page_size": PAGE,
          "prefill_chunk": CHUNK, "max_delay_s": 0.0, **kw}
    return ServeEngine(tmodel, **kw)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, VOCAB, (n,)).astype(np.int32) for n in PLENS]


def _budget(plen):
    return min(10, SEQ - plen)


@pytest.fixture(scope="module")
def jax_tokens(pair):
    jmodel, params, _ = pair
    eng = JaxEngine(jmodel, params, max_batch=3, max_seq_len=SEQ,
                    kv_page_size=PAGE, prefill_chunk=CHUNK,
                    prefix_sharing=False, max_delay_s=0.0)
    try:
        hs = [eng.submit(p, max_new_tokens=_budget(len(p)))
              for p in _prompts()]
        return [h.result(timeout=300).tokens for h in hs]
    finally:
        eng.stop(drain=False)


def test_engine_greedy_tokens_equal_jax_engine(pair, jax_tokens):
    """Eight prompts through three slots (continuous batching: retire
    and re-admit mid-flight), chunked prefill across page and chunk
    edges: every token equals the JAX engine's."""
    _, _, tmodel = pair
    eng = _engine(tmodel)
    try:
        hs = [eng.submit(p, max_new_tokens=_budget(len(p)))
              for p in _prompts()]
        got = [h.result(timeout=300).tokens for h in hs]
    finally:
        eng.stop(drain=False)
    assert got == jax_tokens
    assert eng.max_concurrent == 3
    stats = collect_stats(eng.completed, eng.shed_count)
    assert stats.num_requests == len(PLENS) and stats.tokens_per_s > 0


def test_engine_greedy_tokens_equal_teacher_forced_argmax(pair):
    """The oracle contract of tests/test_serve.py on the port alone: the
    engine's tokens are the argmax of the teacher-forced logits over
    prompt + generated tokens."""
    _, _, tmodel = pair
    eng = _engine(tmodel, max_batch=2, prefill_chunk=0)
    try:
        prompts = _prompts()[2:6]
        hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        results = [h.result(timeout=300) for h in hs]
    finally:
        eng.stop(drain=False)
    for p, r in zip(prompts, results):
        seq = np.concatenate([p, np.asarray(r.tokens, np.int32)])
        logits = teacher_forced_logits(tmodel, seq[None])[0]
        want = logits[len(p) - 1:len(p) + 5].argmax(-1).tolist()
        assert r.tokens == want


def test_chunk_plan_matches_jax(pair):
    jmodel, params, tmodel = pair
    eng = _engine(tmodel)
    jeng = JaxEngine(jmodel, params, max_batch=1, max_seq_len=SEQ,
                     kv_page_size=PAGE, prefill_chunk=CHUNK,
                     prefix_sharing=False)
    try:
        for plen in (1, 4, 7, 8, 9, 16, 17, 31):
            assert eng._chunk_plan(plen) == jeng._chunk_plan(plen)
        eng.prefill_chunk = jeng.prefill_chunk = 0
        assert eng._chunk_plan(13) == jeng._chunk_plan(13) == [(0, 16)]
    finally:
        eng.stop(drain=False)
        jeng.stop(drain=False)


def test_engine_stream_yields_the_result_tokens(pair):
    _, _, tmodel = pair
    eng = _engine(tmodel)
    try:
        seen = []
        h = eng.submit(np.array([5, 6, 7], np.int32), max_new_tokens=5,
                       on_token=seen.append)
        streamed = list(h.stream(timeout=60))
        assert streamed == h.result(timeout=60).tokens == seen
        assert len(streamed) == 5
    finally:
        eng.stop(drain=False)


def test_engine_eos_stops_early(pair):
    _, _, tmodel = pair
    prompt = np.array([5, 9], np.int32)
    eng = _engine(tmodel, max_batch=1)
    try:
        ref = eng.submit(prompt, max_new_tokens=12).result(timeout=60).tokens
        eos = ref[3]
        expect = ref[:ref.index(eos) + 1]
        assert len(expect) < 12
        got = eng.submit(prompt, max_new_tokens=12,
                         eos_id=eos).result(timeout=60).tokens
        assert got == expect
    finally:
        eng.stop(drain=False)


def test_engine_sheds_under_backpressure(pair):
    _, _, tmodel = pair
    eng = _engine(tmodel, max_batch=1, max_delay_s=0.2, queue_size=2)
    try:
        handles = [eng.submit(np.array([i + 1], np.int32), max_new_tokens=2)
                   for i in range(2)]
        with pytest.raises(Backpressure) as ei:
            for _ in range(50):
                handles.append(eng.submit(np.array([1], np.int32),
                                          max_new_tokens=2))
        assert ei.value.retry_after > 0
        assert eng.shed_count >= 1
        assert eng.metrics.get("serve_shed_total").value == eng.shed_count
        for h in handles:
            assert len(h.result(timeout=60).tokens) == 2
    finally:
        eng.stop(drain=False)


def test_engine_rejects_oversized_requests(pair):
    _, _, tmodel = pair
    eng = _engine(tmodel, kv_pool_pages=5)          # 4 usable pages
    try:
        with pytest.raises(ValueError, match="oversized"):
            eng.submit(np.arange(SEQ, dtype=np.int32), max_new_tokens=1)
        with pytest.raises(ValueError, match="page pool"):
            eng.submit(np.arange(10, dtype=np.int32), max_new_tokens=10)
        with pytest.raises(ValueError, match="empty"):
            eng.submit(np.array([], np.int32))
        assert len(eng.submit([1], max_new_tokens=2).result(60).tokens) == 2
    finally:
        eng.stop(drain=False)


def test_page_admission_waits_fifo(pair):
    """The head of the queue waits for pages; a small request behind a
    starved big one does not slip past it.  Sharing off: the prompts
    share a head (a hit would shrink the big one's need), and full
    reclamation is then exactly used_pages == 0 (the registry keeps
    prompt pages on purpose)."""
    _, _, tmodel = pair
    eng = _engine(tmodel, max_batch=2, kv_pool_pages=9,   # 8 usable
                  prefix_sharing=False)
    try:
        a = eng.submit(np.arange(1, 13, dtype=np.int32), max_new_tokens=8)
        big = eng.submit(np.arange(1, 21, dtype=np.int32), max_new_tokens=8)
        small = eng.submit(np.array([3], np.int32), max_new_tokens=2)
        for h in (a, big, small):
            h.result(timeout=120)
        assert big.request.admit_time >= a.request.finish_time
        assert small.request.admit_time >= big.request.admit_time
        assert eng.pool.high_water <= 8 and eng.pool.used_pages == 0
    finally:
        eng.stop(drain=False)


def test_page_pool_scratch_page_and_double_free():
    pool = PagePool(4)
    got = pool.alloc(3)
    assert sorted(got) == [1, 2, 3] and pool.alloc(1) is None
    pool.free(got[:1])
    with pytest.raises(ValueError, match="double free"):
        pool.free(got[:1])
    assert pool.used_pages == 2 and pool.high_water == 3
    with pytest.raises(ValueError, match="scratch"):
        PagePool(1)


def test_engine_refuses_unported_modes(pair, jax_tokens):
    """Prefix sharing (the default) and the contiguous cache, refused
    until they were ported, now serve -- the contiguous engine token for
    token as the JAX paged engine; what stays refused is a chunk that is
    no page multiple and a pool or chunk size without pages."""
    _, _, tmodel = pair
    eng = ServeEngine(tmodel, max_seq_len=SEQ, max_delay_s=0.0,
                      kv_page_size=PAGE)
    assert eng.prefix_sharing and eng.registry is not None
    eng.stop(drain=False)
    eng = ServeEngine(tmodel, max_batch=3, max_seq_len=SEQ, max_delay_s=0.0,
                      kv_page_size=0)
    try:
        assert eng.pool is None and not eng.prefix_sharing
        hs = [eng.submit(p, max_new_tokens=_budget(len(p)))
              for p in _prompts()]
        assert [h.result(timeout=300).tokens for h in hs] == jax_tokens
    finally:
        eng.stop(drain=False)
    with pytest.raises(ValueError, match="multiple"):
        ServeEngine(tmodel, kv_page_size=4, prefill_chunk=6)
    with pytest.raises(ValueError, match="paged cache"):
        ServeEngine(tmodel, kv_page_size=0, prefill_chunk=8)
    with pytest.raises(ValueError, match="paged cache"):
        ServeEngine(tmodel, kv_page_size=0, kv_pool_pages=9)


# ---------------------------------------------------------------------------
# sampling: a pure function of (request seed, position)
# ---------------------------------------------------------------------------

def test_sampler_is_a_function_of_seed_and_position():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    temps, seeds, pos = [1.0, 0.0, 0.7], [11, 11, 12], [4, 4, 9]
    a = sample_tokens(logits, temps, seeds, pos)
    b = sample_tokens(logits.clone(), temps, seeds, pos)
    assert torch.equal(a, b)
    assert a[1] == logits[1].argmax()               # temperature 0: greedy
    draws = {int(sample_tokens(logits[:1], [1.0], [11], [p])[0])
             for p in range(40)}
    assert len(draws) > 5                           # positions differ
    assert position_seed(11, 4) == position_seed(11, 4)
    assert position_seed(11, 4) != position_seed(11, 5)
    assert position_seed(11, 4) != position_seed(12, 4)


def test_engine_sampled_requests_replay_exactly(pair):
    _, _, tmodel = pair
    eng = _engine(tmodel, max_batch=2)
    try:
        runs = [eng.submit([3, 4], max_new_tokens=8, temperature=1.0,
                           rng_seed=77).result(60).tokens for _ in range(2)]
        other = eng.submit([3, 4], max_new_tokens=8, temperature=1.0,
                           rng_seed=78).result(60).tokens
        greedy = eng.submit([3, 4], max_new_tokens=8).result(60).tokens
    finally:
        eng.stop(drain=False)
    assert runs[0] == runs[1]
    assert all(0 <= t < VOCAB for t in runs[0] + other)
    assert other != runs[0] and greedy != runs[0]


# ---------------------------------------------------------------------------
# entry point, flags, devices
# ---------------------------------------------------------------------------

def test_serve_main_cpu_random_init_demo(tmp_path):
    blog = str(tmp_path / "blog")
    out = serve_main.main([
        "--serve_random_init", "--device", "cpu", "--model",
        "transformer_small", "--num_classes", "64", "--serve_max_seq_len",
        "32", "--serve_requests", "3", "--serve_max_new_tokens", "4",
        "--serve_prompt_len", "12", "--serve_max_batch", "2",
        "--kv_page_size", "4", "--serve_prefill_chunk", "8",
        "--benchmark_log_dir", blog])
    assert out["device"] == "cpu"
    assert out["requests"] == 3 and out["shed"] == 0
    assert out["new_tokens"] == out["streamed_tokens"] == 12
    assert out["tokens_per_second"] > 0 and out["decode_steps"] > 0
    names = [json.loads(line)["name"]
             for line in open(os.path.join(blog, "metric.log"))]
    assert "serve_tokens_per_second" in names
    assert "serve_latency_p99" in names
    info = json.load(open(os.path.join(blog, "benchmark_run.log")))
    assert info["machine_config"]["platform"] == "cpu"


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    """Asked for CUDA on a machine without it, every entry point raises;
    none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    args = ["--serve_random_init", "--model", "transformer_small",
            "--serve_requests", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main.main(args)                           # default: cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main.main(args + ["--device", "cuda"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_parse_flags_and_validation():
    cfg = parse_flags(["--model", "transformer_tpu", "--dtype=bf16",
                       "--serve_max_batch", "4", "--serve_prefill_chunk",
                       "none", "--device", "cpu"])
    assert (cfg.model, cfg.dtype, cfg.serve_max_batch) == \
        ("transformer_tpu", "bf16", 4)
    assert cfg.serve_prefill_chunk is None
    assert cfg.compute_dtype == torch.bfloat16
    assert parse_flags([]).device == "cuda"
    with pytest.raises(ValueError, match="tensor parallelism.*not ported"):
        parse_flags(["--serve_tp", "2"])
    with pytest.raises(ValueError, match="dtype"):
        Config(dtype="fp16")
    with pytest.raises(ValueError, match="multiple"):
        Config(kv_page_size=16, serve_prefill_chunk=24)
    # the contiguous cache and prefix sharing parse (ported), under the
    # JAX package's rule: no pool or chunk size without pages
    assert Config(kv_page_size=0).kv_page_size == 0
    with pytest.raises(ValueError, match="paged cache"):
        Config(kv_page_size=0, kv_pool_pages=8)
    assert parse_flags(["--serve_prefix_sharing"]).serve_prefix_sharing
    assert not parse_flags(["--serve_prefix_sharing",
                            "false"]).serve_prefix_sharing
    with pytest.raises(ValueError, match="unknown flag"):
        parse_flags(["--no_such_flag", "1"])


def test_serve_main_needs_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="no weights"):
        serve_main.main(["--device", "cpu", "--model", "transformer_small",
                         "--model_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# guards: the port and the smoke script import nothing of JAX
# ---------------------------------------------------------------------------

def _port_files(repo=REPO):
    """chip_smoke.py and the package's .py files, less the kernels'
    build directory: nvcc output and whatever else lands there is no
    part of the checkout (.gitignore)."""
    pkg = os.path.join(repo, "dtf_tpu_torch")
    build = os.path.join(pkg, os.path.basename(_build.BUILD_DIR))
    out = [os.path.join(repo, "chip_smoke.py")]
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if os.path.join(root, d) != build]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "dtf_tpu")


def _jax_imports(files, repo=REPO):
    """{path relative to ``repo``: the forbidden modules it imports}."""
    found = {}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad = [m for m in mods if _forbidden(m)]
            if bad:
                found.setdefault(os.path.relpath(path, repo), []).extend(bad)
    return found


def test_port_imports_nothing_of_jax_ast():
    files = _port_files()
    assert len(files) > 20
    assert not _jax_imports(files)


def test_jax_scan_skips_the_build_directory(tmp_path):
    """A .py file importing jax under the kernels' build directory of a
    copy of the package is not scanned; the same file elsewhere in the
    package is."""
    pkg = tmp_path / "dtf_tpu_torch"
    shutil.copytree(os.path.join(REPO, "dtf_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    build = pkg / os.path.basename(_build.BUILD_DIR)
    build.mkdir()
    for where in (build, pkg / "ops"):
        (where / "probe_with_jax.py").write_text("import jax\n")
    found = _jax_imports(_port_files(str(tmp_path)), str(tmp_path))
    assert found == {os.path.join("dtf_tpu_torch", "ops",
                                  "probe_with_jax.py"): ["jax"]}


def test_port_import_loads_no_jax_module():
    code = ("import dtf_tpu_torch.cli.serve_main, sys; "
            "import dtf_tpu_torch.cli.lm_main; "
            "import dtf_tpu_torch.cli.cifar_main; "
            "import dtf_tpu_torch.cli.imagenet_main; "
            "import dtf_tpu_torch.data.cifar, dtf_tpu_torch.convert; "
            "import dtf_tpu_torch.testing.integration; "
            "import dtf_tpu_torch.runtime.mesh, dtf_tpu_torch.cli.launch; "
            "import dtf_tpu_torch.parallel.collectives; "
            "import dtf_tpu_torch.chaos, dtf_tpu_torch.train.checkpoint; "
            "import dtf_tpu_torch.cli.trace_main; "
            "import dtf_tpu_torch.obs.ledger, dtf_tpu_torch.obs.prom; "
            "bad = [m for m in sys.modules if m in ('jax', 'dtf_tpu') or "
            "m.startswith(('jax.', 'flax', 'dtf_tpu.'))]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """No CUDA: the smoke script exits non-zero and prints no result;
    alone in a directory, without the package, it fails the same way."""
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != REPO:
            with open(os.path.join(REPO, "chip_smoke.py")) as src, \
                    open(script, "w") as dst:
                dst.write(src.read())
        t0 = time.time()
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
        assert time.time() - t0 < 60
