"""The port's serving path against the JAX reference on the CPU.

A tiny AlexNet-shaped net (test_torch_planner.tiny_layers) is built in
both packages; the reference's parameters are carried into the port with
``params_from_jax``, and the port's ``ModelRunner.infer`` logits must
match the reference ``ModelRunner.infer`` with the fused knobs on, off,
and with ``pallas_lrn`` (the reference runs its Pallas kernels in
interpret mode here).  Tolerance rtol 1e-4, atol 1e-5: the two libraries'
convolutions and matrix products sum in different orders.

Then the port's own serving machinery: concurrent submits answered with
their own rows, pad rows never leaving the server, refusals at the
bounds, and the batcher draining as the reference's does."""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from test_torch_planner import SAMPLE, jax_workflow, knobs, tiny_layers

LOGIT_TOL = {"rtol": 1e-4, "atol": 1e-5}


@pytest.fixture(scope="module")
def reference():
    """(reference workflow, its params tree as numpy)."""
    from znicz_tpu.parallel.fused import FusedTrainer

    wf = jax_workflow(tiny_layers())
    tree = {name: {k: np.asarray(v) for k, v in leaves.items()}
            for name, leaves in FusedTrainer(wf).extract_params().items()}
    return wf, tree


def _port(tree):
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax

    return params_from_jax(
        tree, StandardWorkflow(tiny_layers(), SAMPLE, device="cpu"))


def _batch(n, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n,) + SAMPLE).astype(np.float32)


@pytest.mark.parametrize("config", [
    {}, {"fused_elementwise": True, "fused_tail": True},
    {"pallas_lrn": True, "fused_tail": True}],
    ids=["knobs_off", "fused", "pallas_lrn"])
def test_model_runner_matches_reference(reference, config):
    from znicz_torch.serving.model import ModelRunner
    from znicz_tpu.serving.model import ModelRunner as JRunner

    wf, tree = reference
    x = _batch(5)
    with knobs(**config):
        want = JRunner(wf).infer(x)
        got = ModelRunner(_port(tree)).infer(x)
    assert got.shape == want.shape == (5, 10)
    assert np.isfinite(got).all() and np.std(got) > 0
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_params_from_jax_checks_names_and_shapes(reference):
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax

    _, tree = reference
    twf = _port(tree)
    for f in twf.forwards:
        if f.has_weights:
            np.testing.assert_array_equal(f.weights.numpy(),
                                          tree[f.name]["weights"])
    fresh = StandardWorkflow(tiny_layers(), SAMPLE, device="cpu")
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in tree.items()
                         if k != "fwd_softmax_14"}, fresh)
    bad = dict(tree, fwd_softmax_14={
        "weights": tree["fwd_softmax_14"]["weights"][:, :-1],
        "bias": tree["fwd_softmax_14"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, fresh)


def test_server_answers_concurrent_submits_with_their_own_rows(reference):
    """4 threads x 6 requests of 1-5 rows through max_batch 8: every reply
    holds exactly its own rows of ``ModelRunner.infer`` (the forward is
    row-independent; only the batch size a CPU convolution sees changes
    its summation blocking, hence rtol 1e-5, atol 1e-6) and no pad row."""
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer

    _, tree = reference
    rng = np.random.default_rng(9)
    xs = [_batch(int(n), seed=100 + i)
          for i, n in enumerate(rng.integers(1, 6, size=24))]
    futures = [Future() for _ in xs]
    with knobs(fused_elementwise=True, fused_tail=True):
        srv = InferenceServer(_port(tree), max_batch=8, max_delay_ms=20.0,
                              queue_bound=256).start()
        try:
            def client(t):
                for i in range(t, len(xs), 4):
                    assert srv.submit(Request(xs[i], xs[i].shape[0],
                                              reply_to=futures[i],
                                              req_id=i)) is None

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
                assert not t.is_alive()
            replies = [f.result(timeout=60) for f in futures]
        finally:
            srv.stop()
        assert srv.error is None
        for i, (x, rep) in enumerate(zip(xs, replies)):
            assert rep["ok"] and rep["req_id"] == i and rep["gen"] == 1
            assert rep["y"].shape == (x.shape[0], 10)
            np.testing.assert_allclose(rep["y"], srv.runner.infer(x),
                                       rtol=1e-5, atol=1e-6)
    st = srv.stats()
    assert st["served"] == len(xs)
    assert st["batcher"]["batched_rows"] == sum(x.shape[0] for x in xs)
    assert st["batcher"]["padded_rows"] > 0          # padding did happen
    assert st["p50_ms"] is not None


def test_server_refuses_at_the_bounds(reference):
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer

    _, tree = reference
    srv = InferenceServer(_port(tree), max_batch=4, queue_bound=5,
                          warmup=False)                  # never started
    assert srv.submit(Request(_batch(4), 4)) is None
    fut = Future()
    refusal = srv.submit(Request(_batch(2), 2, reply_to=fut, req_id="x"))
    assert refusal is not None and refusal.policy == "shed"
    rep = fut.result(timeout=1)
    assert rep == {"ok": False, "req_id": "x", "policy": "shed",
                   "error": str(refusal)}
    assert srv.submit(Request(_batch(5), 5)).policy == "oversized"
    got = []
    srv.submit(Request(_batch(2), 2, reply_to=got.append))
    assert got[0]["policy"] == "shed"
    srv.stop()
    assert srv.submit(Request(_batch(1), 1)).policy == "draining"
    assert srv.stats()["rejected"] == 4


def test_batcher_coalesces_like_the_reference():
    """The same submissions drain into the same batches in both
    packages: FIFO, never split, closed at max_batch."""
    from znicz_torch.serving import batcher as tb
    from znicz_tpu.serving import batcher as jb

    assert tb.BucketLadder(32).rungs == jb.BucketLadder(32).rungs
    assert tb.BucketLadder(24).rungs == jb.BucketLadder(24).rungs
    with pytest.raises(ValueError):
        tb.BucketLadder(8, rungs=[1, 4])
    sizes = (3, 2, 2, 4, 1, 8, 5, 3)
    out = []
    for mod in (jb, tb):
        b = mod.DynamicBatcher(max_batch=8, max_delay_ms=1.0,
                               queue_bound=100)
        for n in sizes:
            assert b.submit(mod.Request(np.zeros((n, 2)), n)) is None
        b.close()
        batches = []
        while True:
            batch = b.next_batch(timeout=0.1)
            if batch is None:
                break
            batches.append([r.n for r in batch])
        out.append(batches)
    assert out[0] == out[1] == [[3, 2, 2], [4, 1], [8], [5, 3]]


def test_model_runner_decodes_uint8_and_pads(reference):
    from znicz_torch.serving.model import ModelRunner

    _, tree = reference
    wf = _port(tree)
    runner = ModelRunner(wf)
    x = _batch(3)
    padded = runner.pad(x, 4)
    assert padded.shape == (4,) + SAMPLE and not padded[3].any()
    np.testing.assert_array_equal(runner.infer(padded)[:3], runner.infer(x))
    u8 = np.random.default_rng(1).integers(0, 256, size=(2,) + SAMPLE,
                                           dtype=np.uint8)
    wf.dtype, wf.scale, wf.shift = np.dtype(np.uint8), 1 / 255.0, -0.5
    r8 = ModelRunner(wf)
    want = runner.infer(u8.astype(np.float32) * np.float32(1 / 255.0)
                        + np.float32(-0.5))
    np.testing.assert_allclose(r8.infer(u8), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(TypeError):
        r8.stage(torch.zeros((1,) + SAMPLE))
