"""The served forward's build cache (``znicz_torch/serving/aot_cache.py``,
its hooks in ``_build.py``, ``ModelRunner.enable_aot_cache`` /
``warm_proof`` and the frontend's boot), against the reference's
``tests/test_aot_cache.py`` and its ``family_key``:

  - the cache unit: a library stored and loaded back runs; another
    toolchain misses cleanly; a tampered key, a truncated file, a
    library that does not load and one that lacks a C function are each
    refused, counted and removed, and so are a cut image and one that is
    no library.  A small shared library built with the
    system ``cc`` stands in for a kernel library;
  - the builder's cycle on the CPU: with the cache armed, a library it
    holds is loaded without a build; a refused entry is built again
    (by a stand-in compiler that runs ``cc``), stored over, and the next
    process's boot hits;
  - ``family_key``'s structural fields are the reference's on the same
    workflow, and new weights do not change it;
  - the warm proof in jit and cache mode on a CPU runner, and a runner
    whose warmup asked for cached libraries proving ``cache_hit``;
  - a second boot of the generation family from the cache: nothing
    built, the family entered again, the same tokens;
  - a server that refuses readiness on a failed proof, the heartbeat's
    warm keys, and ``--serve --aot-cache``.
"""

import ctypes
import hashlib
import os
import pathlib
import pickle
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_planner import SAMPLE, jax_workflow, tiny_layers

REPO = pathlib.Path(__file__).resolve().parent.parent
CC = shutil.which("cc") or shutil.which("gcc")
needs_cc = pytest.mark.skipif(CC is None, reason="no C compiler here")

FAMILY = {"units": {"fc": {"weights": [[4, 3], "float32"]}},
          "sample_shape": [3], "dtype": "float32", "mesh": None,
          "donate": False, "torch": "t", "cuda": None, "nvcc": "",
          "device": "cpu", "capability": None}
ENTRY = {"kind": "kernel_library", "library": "stub", "source": "0",
         "flags": ""}


def _cc_library(path, symbols, value=42):
    """A shared library exporting ``int f(void)`` for each symbol."""
    src = pathlib.Path(str(path) + ".c")
    src.write_text("".join(f"int {s}(void) {{ return {value}; }}\n"
                           for s in symbols))
    subprocess.run([CC, "-shared", "-fPIC", "-o", str(path), str(src)],
                   check=True)
    return str(path)


@needs_cc
def test_cache_unit_roundtrip_version_change_and_refusals(tmp_path):
    from znicz_torch.serving.aot_cache import ExecutableCache

    lib = _cc_library(tmp_path / "libstub.so", ["foo", "bar"])
    cache = ExecutableCache(str(tmp_path / "aot"), FAMILY)
    assert cache.store_library(ENTRY, lib)
    assert cache.holds(ENTRY) and cache.counts["stores"] == 1
    target = str(tmp_path / "installed.so")
    assert cache.load_library(ENTRY, target, ["foo", "bar"])
    assert ctypes.CDLL(target).foo() == 42
    # another toolchain: another file name, a clean miss
    other = ExecutableCache(str(tmp_path / "aot"),
                            dict(FAMILY, torch="other"))
    assert not other.load_library(ENTRY, str(tmp_path / "o.so"), ["foo"])
    assert other.counts["refusals"] == 0
    # a library that lacks a C function is refused and removed
    assert not cache.load_library(ENTRY, target, ["foo", "missing"])
    assert cache.counts["refusals"] == 1 and not cache.holds(ENTRY)
    assert not os.path.exists(target)
    # a tampered key
    cache.store_library(ENTRY, lib)
    path = cache.path(ENTRY)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    blob["key"]["entry"] = dict(ENTRY, library="other")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    assert not cache.load_library(ENTRY, target, ["foo"])
    assert cache.counts["refusals"] == 2 and not cache.holds(ENTRY)
    # a truncated file
    cache.store_library(ENTRY, lib)
    data = pathlib.Path(cache.path(ENTRY)).read_bytes()
    pathlib.Path(cache.path(ENTRY)).write_bytes(data[:len(data) // 2])
    assert not cache.load_library(ENTRY, target, ["foo"])
    assert cache.counts["refusals"] == 3
    # a whole pickle around a cut library image (its digest is the whole
    # image's), and around an image that is no library at all
    image = pathlib.Path(lib).read_bytes()
    with open(cache.path(ENTRY), "wb") as f:
        pickle.dump({"key": cache._key(ENTRY),
                     "payload": image[:len(image) // 3],
                     "sha256": hashlib.sha256(image).hexdigest()}, f)
    assert not cache.load_library(ENTRY, target, ["foo"])
    assert cache.counts["refusals"] == 4
    junk = b"not a library" * 64
    with open(cache.path(ENTRY), "wb") as f:
        pickle.dump({"key": cache._key(ENTRY), "payload": junk,
                     "sha256": hashlib.sha256(junk).hexdigest()}, f)
    assert not cache.load_library(ENTRY, target, ["foo"])
    assert cache.counts["refusals"] == 5
    assert cache.stats()["directory"] == str(tmp_path / "aot")


@pytest.fixture
def builder(tmp_path, monkeypatch):
    """``_build`` on a fresh state: an empty build directory, no library
    loaded, and a stand-in ``nvcc`` that builds each library's C
    functions as stubs with ``cc``."""
    from znicz_torch import _build

    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!" + sys.executable + "\n"
        "import subprocess, sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "syms = open(sys.argv[-1] + '.syms').read().split()\n"
        "src = out + '.c'\n"
        "open(src, 'w').write(''.join('int %s(void) { return 7; }\\n' % s "
        "for s in syms))\n"
        f"subprocess.run([{CC!r}, '-shared', '-fPIC', '-o', out, src], "
        "check=True)\n")
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, source in _build.SOURCES.items():
        (csrc / source).write_text(f"// {name}\n")
        (csrc / (source + ".syms")).write_text(
            " ".join(_build.library_symbols(name)))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "origins", {})
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "nvcc_runs", 0)
    monkeypatch.setattr(_build, "_library_cache", None)
    yield _build
    _build.set_library_cache(None)


def _run(builder, name):
    """Library ``name`` asked for through the builder, and its first C
    function called (the stubs take no arguments)."""
    builder.entry(name)
    fn = next(iter(builder.SIGNATURES[name]))
    return getattr(ctypes.CDLL(str(builder._target(name))), fn)()


def _fresh_process(builder, tmp_path, tag):
    """What a new process sees: nothing loaded, an empty build dir."""
    builder._libs.clear()
    builder.origins.clear()
    builder.nvcc_runs = 0
    builder.BUILD_DIR = tmp_path / f"kernels-{tag}"


@needs_cc
def test_the_builder_loads_refuses_rebuilds_and_heals(builder, tmp_path):
    from znicz_torch.serving.aot_cache import ExecutableCache

    cache = ExecutableCache(str(tmp_path / "aot"), FAMILY)
    builder.set_library_cache(cache)
    # cold: built (one nvcc, only the library asked for) and stored
    assert _run(builder, "lrn") == 7
    assert builder.nvcc_runs == 1 and builder.origins == {"lrn": "nvcc"}
    assert set(builder._libs) == {"lrn"}
    assert cache.holds(builder.library_entry("lrn"))
    # warm: a new process loads it from the cache, no nvcc
    _fresh_process(builder, tmp_path, "warm")
    assert _run(builder, "lrn") == 7
    assert builder.nvcc_runs == 0 and builder.origins == {"lrn": "cache"}
    # a truncated entry: refused, rebuilt, stored over ...
    path = cache.path(builder.library_entry("lrn"))
    data = pathlib.Path(path).read_bytes()
    pathlib.Path(path).write_bytes(data[:100])
    _fresh_process(builder, tmp_path, "refused")
    assert _run(builder, "lrn") == 7
    assert cache.counts["refusals"] == 1
    assert builder.nvcc_runs == 1 and builder.origins == {"lrn": "nvcc"}
    # ... and the next boot hits again
    _fresh_process(builder, tmp_path, "healed")
    assert _run(builder, "lrn") == 7
    assert builder.nvcc_runs == 0 and builder.origins == {"lrn": "cache"}
    # without a cache the builder builds every missing library at once
    builder.set_library_cache(None)
    _fresh_process(builder, tmp_path, "plain")
    builder.entry("bias_relu")
    assert builder.nvcc_runs == len(builder.SOURCES)


@needs_cc
def test_a_runner_counts_cached_libraries_and_proves_cache_hit(
        builder, tmp_path):
    """The CPU forward launches no kernel; the libraries a card's warmup
    would ask for are asked for by hand between the runner's marks."""
    from znicz_torch.serving.batcher import BucketLadder
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.standard_workflow import StandardWorkflow

    ladder = BucketLadder(4)
    cold = ModelRunner(StandardWorkflow(tiny_layers(), SAMPLE,
                                        device="cpu"), capture=False)
    cold.enable_aot_cache(str(tmp_path / "aot"))
    before = dict(builder.touched)
    cold.warmup(ladder)
    for name in ("fused_block", "bias_relu"):
        builder.entry(name)
    cold._settle_kernels(before)
    assert cold.kernels == {"fused_block": "nvcc", "bias_relu": "nvcc"}
    assert cold.warm_source == "compiled"
    proof = cold.warm_proof(len(ladder.buckets()))
    assert proof["ok"] and proof["mode"] == "aot"
    assert proof["nvcc_runs"] == 2 and proof["cache_misses"] == 2
    _fresh_process(builder, tmp_path, "warm")
    warm = ModelRunner(StandardWorkflow(tiny_layers(), SAMPLE,
                                        device="cpu"), capture=False)
    warm.enable_aot_cache(str(tmp_path / "aot"))
    before = dict(builder.touched)
    warm.warmup(ladder)
    for name in ("fused_block", "bias_relu"):
        builder.entry(name)
    warm._settle_kernels(before)
    proof = warm.warm_proof(len(ladder.buckets()))
    assert proof["ok"] and proof["nvcc_runs"] == 0
    assert proof["warm_source"] == "cache_hit"
    assert proof["cache_hits"] == 2 and proof["cache_misses"] == 0
    assert warm.stats()["kernels"] == {"fused_block": "cache",
                                       "bias_relu": "cache"}


def test_family_key_structure_matches_the_reference(tmp_path):
    from test_torch_serving_swap import _second
    from znicz_torch.serving.aot_cache import family_key
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax
    from znicz_tpu.parallel.fused import FusedTrainer
    from znicz_tpu.serving import aot_cache as jaot
    from znicz_tpu.serving.model import ModelRunner as JRunner

    jwf = jax_workflow(tiny_layers())
    tree = {n: {k: np.asarray(v) for k, v in leaves.items()}
            for n, leaves in FusedTrainer(jwf).extract_params().items()}
    twf = params_from_jax(tree, StandardWorkflow(tiny_layers(), SAMPLE,
                                                 device="cpu"))
    runner = ModelRunner(twf, capture=False)
    got, want = family_key(runner), jaot.family_key(JRunner(jwf))
    for field in ("units", "sample_shape", "dtype", "mesh", "donate"):
        assert got[field] == want[field], field
    assert {"torch", "cuda", "nvcc", "device", "capability"} <= set(got)
    other = ModelRunner(params_from_jax(_second(tree), StandardWorkflow(
        tiny_layers(), SAMPLE, device="cpu")), capture=False)
    assert family_key(other) == got


def test_warm_proof_jit_and_cache_modes_on_a_cpu_runner(tmp_path):
    from znicz_torch.serving.batcher import BucketLadder
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.standard_workflow import StandardWorkflow

    ladder = BucketLadder(8)
    n = len(ladder.buckets())
    jit = ModelRunner(StandardWorkflow(tiny_layers(), SAMPLE, device="cpu"))
    assert jit.warm_source is None
    jit.warmup(ladder)
    proof = jit.warm_proof(n)
    assert proof["ok"] and proof["mode"] == "jit"
    assert proof["compiles"] == proof["graph_cache_size"] == n
    assert not jit.warm_proof(n + 1)["ok"]
    assert jit.warm_source == "compiled" and not jit.aot_enabled
    aot = ModelRunner(StandardWorkflow(tiny_layers(), SAMPLE, device="cpu"))
    with pytest.raises(ValueError, match="explicit directory"):
        aot.enable_aot_cache()
    try:
        assert aot.enable_aot_cache(str(tmp_path / "aot"))
        aot.warmup(ladder)
        proof = aot.warm_proof(n)
        assert proof["ok"] and proof["mode"] == "aot"
        assert proof["kernels"] == {} and aot.stats()["aot_enabled"]
        # a rung captured under traffic breaks the proof
        aot.infer(np.zeros((3,) + SAMPLE, np.float32))
        assert not aot.warm_proof(n)["ok"]
    finally:
        _disarm()


def test_generation_family_roundtrip_and_parity(tmp_path):
    """The generation family (prefill and decode a (batch rung, page
    rung), the copy) on a second boot from the same cache: no library
    built, the family entered again in full (a graph cannot be written to
    disk: ``compiles == executables()``, the proof holds), and the same
    tokens bit for bit, across a page-rung step (1 -> 2 pages) and a copy
    (the reference's case, whose second boot loads its executables)."""
    from test_torch_serving_seq import VOCAB, _charlm_wf
    from znicz_torch import _build
    from znicz_torch.serving.model import ModelRunner

    def boot():
        r = ModelRunner(_charlm_wf(32))
        assert r.enable_aot_cache(str(tmp_path / "aot"))
        g = r.enable_generation(page_size=8, num_pages=8, slots=2,
                                prefill_chunk=8, prefix_cache=False,
                                prefill_rungs=[1], decode_rungs=[1])
        runs = _build.nvcc_runs
        assert g.warmup() == g.executables()
        return g, _build.nvcc_runs - runs

    def drive(g):
        rng = np.random.default_rng(17)
        prompt = rng.integers(1, VOCAB, size=5).astype(np.uint8)
        pages = [g.alloc_page()]
        x = np.zeros((1, 8), np.uint8)
        x[0, :5] = prompt
        tok, _, logits, _ = g.prefill(x, [0], [5], [pages], [0.0], [0], [0])
        toks, rows = [int(tok[0])], [logits]
        t = 5
        for _ in range(6):                      # crosses a page boundary
            if t % g.page_size == 0:
                pages.append(g.alloc_page())
            tok, _, logits, _ = g.decode([pages], [toks[-1]], [t], [0.0],
                                         [0], [0])
            toks.append(int(tok[0]))
            rows.append(logits)
            t += 1
        dst = g.alloc_page()                    # the copy executable too
        g.copy_page(pages[0], dst)
        g.release_pages(pages + [dst])
        return toks, rows

    try:
        cold, _ = boot()
        fam = cold.executables()
        assert fam == (1 + 1) * len(cold.page_rungs) + 1
        ref, ref_rows = drive(cold)
        assert cold.runner.compiles == fam
        warm, built = boot()
        toks, rows = drive(warm)
        assert toks == ref
        for a, b in zip(rows, ref_rows):
            np.testing.assert_array_equal(a, b)
        proof = warm.runner.warm_proof(fam)
        assert built == 0 and proof["ok"] and proof["mode"] == "aot"
        assert warm.runner.compiles == fam == warm.graph_cache_size()
        assert warm.pages_active() == 0 and warm.pages_leaked() == 0
    finally:
        _disarm()


def _disarm():
    """A runner arms the cache for its whole process: disarm it."""
    from znicz_torch import _build

    _build.set_library_cache(None)


@pytest.fixture
def aot_config(tmp_path):
    from znicz_torch.core.config import root

    root.common.serving.aot_cache.enabled = True
    root.common.serving.aot_cache.dir = str(tmp_path / "aot")
    try:
        yield tmp_path / "aot"
    finally:
        root.common.serving.aot_cache.enabled = False
        root.common.serving.aot_cache.dir = ""
        _disarm()


def test_server_refuses_readiness_on_a_failed_proof(aot_config,
                                                   monkeypatch):
    from znicz_torch.serving import InferenceServer
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.standard_workflow import StandardWorkflow

    real = ModelRunner.warm_proof
    monkeypatch.setattr(ModelRunner, "warm_proof",
                        lambda self, n: dict(real(self, n), ok=False))
    srv = InferenceServer(StandardWorkflow(tiny_layers(), SAMPLE,
                                           device="cpu"), max_batch=4)
    with pytest.raises(RuntimeError, match="AOT warmup proof failed"):
        srv.start()
    assert not srv.ready()
    assert srv.runner.aot_enabled
    srv.stop()


def test_heartbeat_carries_the_warm_keys(aot_config):
    from znicz_torch.serving import InferenceServer
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_tpu.serving import InferenceServer as JServer

    srv = InferenceServer(StandardWorkflow(tiny_layers(), SAMPLE,
                                           device="cpu"),
                          max_batch=4).start()
    try:
        beat = srv.heartbeat_payload()
        assert (beat["warm_source"], beat["warm_hits"],
                beat["warm_misses"]) == ("compiled", 0, 0)
        report = srv.stats()["warm_report"]
        assert report["ok"] and report["mode"] == "aot"
        assert aot_config.is_dir()
        jsrv = JServer(jax_workflow(tiny_layers()), max_batch=4,
                       warmup=False)
        assert set(srv._heartbeat_base()) == set(jsrv._heartbeat_base())
        assert "origin" in beat and set(beat) - set(
            jsrv._heartbeat_base()) <= {"origin", "spans", "events",
                                        "metrics"}
    finally:
        srv.stop()


def test_cli_serves_with_the_aot_cache(tmp_path):
    from znicz_torch.serving import InferenceClient

    cmd = [sys.executable, "-m", "znicz_torch", "mnist", "--serve",
           "tcp://127.0.0.1:*", "--device", "cpu", "--aot-cache",
           str(tmp_path / "aot"), "root.common.serving.max_requests=1",
           "root.mnist.loader.n_train=120", "root.mnist.loader.n_valid=60"]
    proc = subprocess.Popen(cmd, cwd=tmp_path, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        line = proc.stdout.readline()
        m = re.search(r"at (tcp://127\.0\.0\.1:\d+)", line)
        assert m, line
        cli = InferenceClient(m.group(1), timeout=120.0)
        try:
            rep = cli.infer(np.zeros((1, 784), np.float32))
            assert rep.shape == (1, 10)
        finally:
            cli.close()
        assert proc.wait(timeout=120) == 0
        assert (tmp_path / "aot").is_dir()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
