"""Variable-length serving on the 2-D (rows x seq) bucket ladder
(``znicz_torch/serving/``) on the CPU, the cases of the reference's
``tests/test_serving_seq.py`` (its web panel aside: telemetry, ROADMAP
A.9) and cross-package ones:

  - the ladder's geometry and refusals;
  - the batcher: only requests of one seq rung coalesce, the drain
    reaches past other rungs, per-bucket cell accounting, the readable
    oversized refusal, fairness kept — and the same submit script gives
    the reference batcher's batches and counts;
  - the runner: one family entry a (rows, seq) bucket at warmup, none
    after; a request's rows a bit-exact function of its own rows and
    length within a bucket; the causal pad tail invisible; the reference
    ``ModelRunner`` and the port's on the same carried-across charlm
    weights and the same padded bucket agree to ``CROSS_TOL`` (1e-5);
  - the service end to end, and the refusal of non-causal attention;
  - a chaos soak (``slow``, as the reference's).
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from test_torch_layers import sample_config

VOCAB = 32
#: the two packages' runners on one bucket
CROSS_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small models: the suite's workers
    share the cores, and many threads a worker only spin against each
    other (alone, one thread runs these tests as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(seq_len):
    return {"loader__n_train": 64, "loader__n_valid": 16,
            "loader__n_test": 0, "loader__seq_len": seq_len,
            "loader__minibatch_size": 16, "model__vocab": VOCAB,
            "model__embed": 32, "model__heads": 2, "model__ffn": 64}


def _charlm_wf(seq_len=32):
    """The port's reduced charlm on the CPU, from seed 1013."""
    from znicz_torch.core import prng
    from znicz_torch.samples.charlm import CharLMWorkflow

    with sample_config("charlm", **_cfg(seq_len)):
        prng.reset(1013)
        return CharLMWorkflow(device="cpu")


def _ref_charlm_wf(seq_len=32):
    from znicz_tpu.core import prng
    from znicz_tpu.samples.charlm import CharLMWorkflow

    with sample_config("charlm", **_cfg(seq_len)):
        prng.reset(1013)
        wf = CharLMWorkflow()
        wf.initialize(device=None)
        return wf


# -- ladder geometry ----------------------------------------------------------


def test_bucket_ladder_2d():
    from znicz_torch.serving.batcher import BucketLadder

    lad = BucketLadder(8, max_len=64)
    assert lad.rungs == [1, 2, 4, 8]
    assert lad.seq_rungs == [1, 2, 4, 8, 16, 32, 64]
    assert lad.seq_bucket_for(1) == 1
    assert lad.seq_bucket_for(9) == 16
    assert lad.seq_bucket_for(64) == 64
    assert len(lad.buckets()) == 4 * 7
    assert lad.bucket_key(4, 16) == "4x16"
    assert lad.bucket_key(4) == 4
    with pytest.raises(ValueError, match="top seq rung"):
        lad.seq_bucket_for(65)
    lad2 = BucketLadder(8, max_len=64, seq_rungs=(8, 64))
    assert lad2.seq_rungs == [8, 64]
    with pytest.raises(ValueError, match="end"):
        BucketLadder(8, max_len=64, seq_rungs=(8, 32))
    with pytest.raises(ValueError, match="max_len"):
        BucketLadder(8, seq_rungs=(8, 64))
    lad1 = BucketLadder(8)
    assert lad1.seq_rungs is None
    assert lad1.buckets() == [1, 2, 4, 8]
    with pytest.raises(ValueError, match="no seq axis"):
        lad1.seq_bucket_for(3)
    # dp snaps the rows only
    assert BucketLadder(8, dp=2, max_len=4).buckets() == [
        (r, s) for r in (2, 4, 8) for s in (1, 2, 4)]


# -- batcher: seq-rung coalescing + pad accounting ----------------------------


def _req(n, L, client=None, pkg="znicz_torch"):
    import importlib

    mod = importlib.import_module(f"{pkg}.serving.batcher")
    return mod.Request(np.ones((n, L), np.uint8), n, client=client,
                       seq_len=L)


def _batcher(max_batch, max_len, pkg="znicz_torch"):
    import importlib

    mod = importlib.import_module(f"{pkg}.serving.batcher")
    return mod.DynamicBatcher(max_batch=max_batch, max_delay_ms=1.0,
                              ladder=mod.BucketLadder(max_batch,
                                                      max_len=max_len))


def test_batcher_coalesces_same_seq_rung_only():
    """Only same-rung requests share a batch, and the drain reaches past
    a request of another rung instead of fragmenting the stream."""
    b = _batcher(8, 64)
    for n, L in ((2, 5), (1, 20), (2, 7), (1, 60), (2, 8)):
        assert b.submit(_req(n, L)) is None
    assert [r.seq_len for r in b.next_batch(timeout=0.5)] == [5, 7, 8]
    assert [r.seq_len for r in b.next_batch(timeout=0.5)] == [20]
    assert [r.seq_len for r in b.next_batch(timeout=0.5)] == [60]
    hits = {k: v for k, v in b.bucket_hits.items() if v}
    assert hits == {"8x8": 1, "1x32": 1, "1x64": 1}
    assert b.pad_ratio()["8x8"] == round((64 - 40) / 40, 4)
    assert b.real_cells == 40 + 20 + 60
    assert b.padded_cells == (64 - 40) + (32 - 20) + (64 - 60)
    st = b.stats()
    assert st["seq_rungs"] == [1, 2, 4, 8, 16, 32, 64]
    assert st["real_cells"] == 120


def test_batcher_seq_oversize_refused_readably():
    b = _batcher(8, 64)
    reason = b.submit(_req(1, 65))
    assert reason is not None and reason.policy == "oversized"
    assert reason.scope == "client"
    assert "65" in str(reason)
    assert b.oversized == 1


def test_batcher_seq_fairness_preserved():
    b = _batcher(4, 64)
    for _ in range(3):
        assert b.submit(_req(1, 8, client="a")) is None
    assert b.submit(_req(1, 50, client="b")) is None
    assert [r.seq_len for r in b.next_batch(timeout=0.5)] == [8, 8, 8]
    assert [r.seq_len for r in b.next_batch(timeout=0.5)] == [50]


def test_batcher_matches_the_reference_on_a_mixed_stream():
    """The same seeded mixed-length, two-client script through both
    packages' batchers: the same batches in the same order and the same
    cell accounting."""
    rng = np.random.default_rng(23)
    script = [(int(rng.integers(1, 4)), int(rng.integers(1, 65)),
               "ab"[int(rng.integers(0, 2))]) for _ in range(40)]
    out = {}
    for pkg in ("znicz_torch", "znicz_tpu"):
        b = _batcher(8, 64, pkg)
        for i, (n, L, client) in enumerate(script):
            r = _req(n, L, client, pkg)
            r.req_id = i
            assert b.submit(r) is None
        b.close()
        batches = []
        while True:
            batch = b.next_batch(timeout=0.0)
            if batch is None:
                break
            batches.append([r.req_id for r in batch])
        st = b.stats()
        out[pkg] = (batches, {k: st[k] for k in (
            "batches", "batched_rows", "padded_rows", "real_cells",
            "padded_cells", "pad_ratio", "seq_rungs")},
            {k: v for k, v in b.bucket_hits.items() if v})
    assert out["znicz_torch"] == out["znicz_tpu"]


# -- runner: 2-D warmup + masked 0-ULP parity ---------------------------------


def test_runner_2d_warmup_and_masked_parity():
    """Every (rows, seq) bucket enters the family once at warmup; within a
    bucket a request's rows are a bit-exact function of its own rows and
    length, whatever its neighbours and the pad cells hold."""
    from znicz_torch.serving.batcher import BucketLadder
    from znicz_torch.serving.model import ModelRunner

    runner = ModelRunner(_charlm_wf(32))
    lad = BucketLadder(4, max_len=32, seq_rungs=(8, 32))
    assert runner.warmup(lad) == len(lad.buckets()) == 3 * 2
    assert runner.graph_cache_size() == 6
    c0 = runner.compiles
    rng = np.random.default_rng(11)
    probe = rng.integers(1, VOCAB, size=(2, 5)).astype(np.uint8)

    def run_bucket(neighbor, pad_value):
        x = np.full((4, 8), pad_value, np.uint8)
        x[:2, :5] = probe
        x[2:2 + neighbor.shape[0], :neighbor.shape[1]] = neighbor
        return runner.infer(x)[:2, :5]

    base = run_bucket(rng.integers(1, VOCAB, size=(2, 7)).astype(np.uint8),
                      0)
    for trial in range(3):
        neighbor = rng.integers(1, VOCAB, size=(2, 6 + trial)
                                ).astype(np.uint8)
        np.testing.assert_array_equal(
            base, run_bucket(neighbor, (VOCAB - 1) if trial else 0))
    assert runner.compiles == c0


def test_runner_causal_pad_tail_invisible():
    """A request padded to a longer seq rung answers its real positions
    within a band of the exact-length compute (another shape: a band,
    not bits)."""
    from znicz_torch.serving.model import ModelRunner

    runner = ModelRunner(_charlm_wf(32))
    rng = np.random.default_rng(13)
    x = rng.integers(1, VOCAB, size=(1, 8)).astype(np.uint8)
    exact = runner.infer(x)[:, :8]
    padded = np.zeros((1, 32), np.uint8)
    padded[:, :8] = x
    np.testing.assert_allclose(runner.infer(padded)[:, :8], exact,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bucket", [(1, 1), (4, 8), (2, 32)])
def test_runner_matches_the_reference_runner(bucket):
    """The reference's ModelRunner and the port's, on the reference's
    weights carried across (``params_from_jax``) and the same padded
    bucket of ids: the logits to ``CROSS_TOL``."""
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.weights import params_from_jax
    from znicz_tpu.serving.model import ModelRunner as JRunner

    jwf = _ref_charlm_wf(32)
    twf = _charlm_wf(32)
    rng = np.random.default_rng(29)
    tree = {f.name: {k: (np.array(a.map_read())
                         + 0.05 * rng.normal(size=a.shape)).astype(
                             np.float32)
                     for k, a in f.params().items()}
            for f in jwf.forwards}
    for f in jwf.forwards:
        for k, a in f.params().items():
            a.mem = tree[f.name][k].copy()
    params_from_jax(tree, twf)
    rows, seq = bucket
    x = np.zeros((rows, seq), np.uint8)
    x[:, :max(1, seq - 3)] = rng.integers(
        1, VOCAB, size=(rows, max(1, seq - 3)))
    want = np.asarray(JRunner(jwf).infer(x))
    got = ModelRunner(twf).infer(x)
    assert got.shape == want.shape == (rows, seq, VOCAB)
    np.testing.assert_allclose(got, want, **CROSS_TOL)


# -- e2e service --------------------------------------------------------------


@contextlib.contextmanager
def _service(seq_len=32, **kw):
    from znicz_torch.serving import InferenceClient, InferenceServer

    srv = InferenceServer(_charlm_wf(seq_len), max_batch=4,
                          max_delay_ms=2.0, **kw).start()
    cli = InferenceClient(srv.endpoint, timeout=60)
    try:
        yield srv, cli
    finally:
        cli.close()
        srv.stop()


def test_e2e_seq_service_mixed_lengths():
    """A mixed-length stream end to end: each reply ``(n, len, vocab)``,
    no family entry after the warmup, the cell accounting in the stats, an
    over-long request refused and the service still up."""
    from znicz_torch.serving.client import InferenceError

    with _service() as (srv, cli):
        lad = srv.batcher.ladder
        assert lad.seq_rungs == [1, 2, 4, 8, 16, 32]
        warm = srv.runner.compiles
        assert warm == len(lad.buckets()) == srv.runner.graph_cache_size()
        assert srv.warm_report["ok"]
        rng = np.random.default_rng(17)
        for L in (1, 4, 9, 17, 32, 2, 31):
            y = cli.infer(rng.integers(1, VOCAB, size=(2, L)
                                       ).astype(np.uint8))
            assert y.shape == (2, L, VOCAB), (L, y.shape)
        y = cli.infer(rng.integers(1, VOCAB, size=(7,)).astype(np.uint8))
        assert y.shape == (1, 7, VOCAB)
        assert srv.runner.compiles == warm
        stats = srv.batcher.stats()
        assert stats["seq_rungs"] == lad.seq_rungs
        assert stats["real_cells"] > 0 and stats["pad_ratio"]
        with pytest.raises(InferenceError, match="oversized|seq"):
            cli.result(cli.submit(rng.integers(1, VOCAB, size=(1, 33)
                                               ).astype(np.uint8)))
        assert cli.infer(rng.integers(1, VOCAB, size=(1, 3)
                                      ).astype(np.uint8)).shape \
            == (1, 3, VOCAB)


def test_seq_service_replies_equal_the_padded_bucket():
    """A reply is its rows of the runner's forward of the bucket it was
    padded to, bit for bit, and changing its pad tokens changes no bit."""
    with _service() as (srv, cli):
        rng = np.random.default_rng(31)
        x = rng.integers(1, VOCAB, size=(1, 11)).astype(np.uint8)
        got = cli.infer(x)
        xb = np.zeros((1, 16), np.uint8)
        xb[:, :11] = x
        np.testing.assert_array_equal(got, srv.runner.infer(xb)[:, :11])
        xb[:, 11:] = VOCAB - 1
        np.testing.assert_array_equal(got, srv.runner.infer(xb)[:, :11])


def test_seq_serving_refuses_non_causal_attention():
    from znicz_torch.serving import InferenceServer

    wf = _charlm_wf(32)
    next(f for f in wf.forwards if f.name == "mha").causal = False
    with pytest.raises(ValueError, match="causal"):
        InferenceServer(wf, warmup=False)


def test_seq_serving_refuses_a_window_past_the_trained_length():
    from znicz_torch.core.config import root
    from znicz_torch.serving import InferenceServer

    root.common.serving.seq.max_len = 64
    try:
        with pytest.raises(ValueError, match="trained sequence length 32"):
            InferenceServer(_charlm_wf(32), warmup=False)
    finally:
        del root.common.serving.seq.max_len


@pytest.mark.slow
def test_seq_chaos_soak():
    """A mixed-length stream through a ChaosProxy (drop, corrupt,
    duplicate, delay): every request answered, as its own bucket computes
    it to ``CROSS_TOL`` (a delayed request may share a rows rung with
    others, and a CPU product's blocking follows the rows), no family
    entry after the warmup."""
    from znicz_torch.parallel.chaos import ChaosProxy, FaultSchedule
    from znicz_torch.serving import InferenceClient, InferenceServer

    srv = InferenceServer(_charlm_wf(32), max_batch=4,
                          max_delay_ms=2.0).start()
    schedule = FaultSchedule(seed=77, drop=0.08, corrupt=0.05,
                             duplicate=0.08, delay=0.05,
                             delay_s=(0.005, 0.03))
    proxy = ChaosProxy("tcp://127.0.0.1:*", srv.endpoint, schedule).start()
    cli = InferenceClient(proxy.front_endpoint, timeout=120,
                          resend_after_s=0.5, breaker_failures=0)
    rng = np.random.default_rng(19)
    try:
        warm = srv.runner.compiles
        want = {}
        for _ in range(60):
            L = int(rng.integers(1, 33))
            x = rng.integers(1, VOCAB, size=(1, L)).astype(np.uint8)
            want[cli.submit(x)] = x
        got = {}
        deadline = time.time() + 90
        while len(got) < len(want) and time.time() < deadline:
            for rep in cli.collect(0.05):
                if rep.get("ok"):
                    got[rep["req_id"]] = rep["y"]
        assert len(got) == len(want)
        lad = srv.batcher.ladder
        for rid, x in want.items():
            L = x.shape[1]
            xb = np.zeros((lad.bucket_for(1), lad.seq_bucket_for(L)),
                          np.uint8)
            xb[:1, :L] = x
            np.testing.assert_allclose(got[rid],
                                       srv.runner.infer(xb)[:1, :L],
                                       **CROSS_TOL)
        assert srv.runner.compiles == warm
    finally:
        cli.close()
        proxy.stop()
        srv.stop()
