"""The served forward as a family of rungs (``serving/model.py``) on the
CPU, where the family is the set of rung shapes entered (a CUDA graph a
rung on the card; ``chip_smoke.py --only graphs`` holds the replays to
the eager dispatches there):

  - after ``warmup`` ``compiles == len(ladder.rungs) ==
    graph_cache_size()``, and mixed-size traffic adds none (the
    counterpart of ``tests/test_serving.py``'s zero-recompiles test), in
    the runner and behind ``InferenceServer``;
  - the tensor ``infer_staged`` returns is not changed by a later
    dispatch of the same rung;
  - ``swap`` enters a new family (a rung each), ``rollback`` enters none
    and serves the kept family again; a family displaced twice, or
    dropped by a rollback, is freed; a failed swap frees its family;
  - ``capture=True`` on a CPU device raises, naming the device;
  - the served logits of the 67x67 AlexNet probe against the reference's
    ``ModelRunner`` at every rung, within ``LOGIT_TOL`` (float32
    rounding: the two libraries sum in other orders).
"""

import numpy as np
import pytest
import torch

from test_torch_planner import jax_workflow, knobs

LOGIT_TOL = {"rtol": 1e-4, "atol": 1e-5}
ALEXNET = (67, 67, 3)
MNIST_LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100}},
                {"type": "softmax", "->": {"output_sample_shape": 10}}]


def _mnist():
    from znicz_torch.core import prng
    from znicz_torch.standard_workflow import StandardWorkflow

    prng.reset(1013)
    return StandardWorkflow(MNIST_LAYERS, (784,), device="cpu")


def _rows(n, seed=3):
    return np.random.default_rng(seed).normal(size=(n, 784)).astype(
        np.float32)


def _snapshot(tmp_path, runner, scale, name):
    from znicz_torch.snapshotter import write_host_pickle

    tree = {m: {k: (scale * t.numpy() + 0.01).astype(np.float32)
                for k, t in leaves.items()}
            for m, leaves in runner._active.tree.items()}
    path = str(tmp_path / name)
    write_host_pickle(path, {"units": tree, "velocities": {}, "epoch": 2})
    return path


def test_warmup_enters_the_ladder_then_traffic_adds_nothing():
    from znicz_torch.serving import BucketLadder, ModelRunner

    runner = ModelRunner(_mnist())
    assert runner.capture is False            # a CPU device: no graphs
    ladder = BucketLadder(8)
    n = runner.warmup(ladder)
    assert n == len(ladder.rungs) == runner.compiles == 4
    assert runner.graph_cache_size() == n
    for rows in (1, 3, 7, 8, 2, 5, 4, 6):
        runner.infer(np.zeros((ladder.bucket_for(rows), 784), np.float32))
    assert runner.compiles == n == runner.graph_cache_size()
    st = runner.stats()
    assert (st["compiles"], st["graph_cache_size"], st["capture"]) == \
        (n, n, False)
    # another engine routing is another key: the first dispatch under it
    # enters it
    with knobs(fused_tail=True):
        runner.infer(np.zeros((8, 784), np.float32))
    assert runner.compiles == n + 1


def test_server_warms_every_rung_and_mixed_traffic_adds_none():
    from concurrent.futures import Future

    from znicz_torch.serving import InferenceServer, Request

    srv = InferenceServer(_mnist(), max_batch=16, max_delay_ms=1.0,
                          queue_bound=256).start()
    try:
        rungs = len(srv.batcher.ladder.rungs)
        assert srv.runner.compiles == rungs == srv.runner.graph_cache_size()
        futs = []
        for i, n in enumerate((1, 5, 16, 3, 9, 2, 7, 12)):
            fut = Future()
            srv.submit(Request(_rows(n, seed=i), n, reply_to=fut, req_id=i))
            futs.append(fut)
        assert all(f.result(60)["ok"] for f in futs)
        st = srv.stats()
        assert st["compiles"] == rungs == st["graph_cache_size"]
    finally:
        srv.stop()


def test_a_result_is_not_changed_by_a_later_dispatch():
    from znicz_torch.serving import ModelRunner

    runner = ModelRunner(_mnist())
    a, b = _rows(4, seed=1), _rows(4, seed=2)
    y1, gen = runner.infer_staged(runner.stage(a))
    keep = y1.clone()
    y2, _ = runner.infer_staged(runner.stage(b))
    assert gen == 1 and not torch.equal(y1, y2)
    assert torch.equal(y1, keep)


def test_swap_and_rollback_keep_one_family_per_generation(tmp_path):
    from znicz_torch.serving import BucketLadder, ModelRunner

    runner = ModelRunner(_mnist())
    ladder = BucketLadder(4)
    rungs = len(ladder.rungs)
    runner.warmup(ladder)
    x = _rows(4)
    y1 = runner.infer(x)
    fam1 = runner._active.family
    path2 = _snapshot(tmp_path, runner, 1.25, "gen2.pickle.gz")
    path3 = _snapshot(tmp_path, runner, 0.75, "gen3.pickle.gz")

    runner.swap(path2, ladder)              # the warm enters every rung
    assert runner.generation == 2
    assert runner.compiles == 2 * rungs
    assert runner.graph_cache_size() == rungs
    assert runner._previous[0].family is fam1 and len(fam1) == rungs
    fam2 = runner._active.family
    y2 = runner.infer(x)
    assert not np.array_equal(y1, y2)

    assert runner.rollback() == 1           # the kept family, no entry
    assert runner.compiles == 2 * rungs
    assert runner._active.family is fam1
    assert runner.graph_cache_size() == rungs
    assert np.array_equal(runner.infer(x), y1)
    assert len(fam2) == 0                   # dropped by the rollback
    assert runner._previous is None

    runner.swap(path2, ladder)              # generation 3 displaces 1
    runner.swap(path3, ladder)              # generation 4 displaces 3
    assert runner.generation == 4 and runner.compiles == 4 * rungs
    assert len(fam1) == 0                   # displaced twice: freed
    assert len(runner._previous[0].family) == rungs

    # a swap whose warm fails frees the family it entered; the live
    # generation serves on
    live = runner._active.family

    def broken(*_args, **_kw):
        raise RuntimeError("warm failed")

    runner._eager = broken
    with pytest.raises(RuntimeError, match="warm failed"):
        runner.swap(path2, BucketLadder(32))
    del runner._eager
    assert runner.swap_failures == 1 and runner.generation == 4
    assert runner._active.family is live and runner._pending is None
    assert runner.infer(x).shape == (4, 10)


def test_capture_on_the_cpu_raises_naming_the_device():
    from znicz_torch.serving import InferenceServer, ModelRunner

    with pytest.raises(ValueError, match="device is cpu"):
        ModelRunner(_mnist(), capture=True)
    with pytest.raises(ValueError, match="device is cpu"):
        InferenceServer(_mnist(), capture=True, warmup=False)
    assert ModelRunner(_mnist(), capture=False).capture is False


@pytest.fixture(scope="module")
def alexnet_pair():
    """(reference AlexNet workflow at 67x67, 10 classes; the port's twin
    with the reference's parameters)."""
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax
    from znicz_tpu.parallel.fused import FusedTrainer
    from znicz_tpu.samples.alexnet import make_layers

    layers = make_layers(10)
    jwf = jax_workflow(layers, sample_shape=ALEXNET, n=4)
    tree = {name: {k: np.asarray(v) for k, v in leaves.items()}
            for name, leaves in FusedTrainer(jwf).extract_params().items()}
    return jwf, params_from_jax(tree, StandardWorkflow(layers, ALEXNET,
                                                       device="cpu"))


@pytest.mark.parametrize("config", [
    {}, {"fused_elementwise": True, "fused_tail": True}],
    ids=["knobs_off", "fused"])
def test_alexnet_rungs_served_as_the_reference(alexnet_pair, config):
    from znicz_torch.serving import BucketLadder, ModelRunner
    from znicz_tpu.serving.model import ModelRunner as JRunner

    jwf, twf = alexnet_pair
    ladder = BucketLadder(4)
    x = np.random.default_rng(12).normal(size=(4,) + ALEXNET).astype(
        np.float32)
    with knobs(**config):
        runner = ModelRunner(twf)
        assert runner.warmup(ladder) == len(ladder.rungs)
        jrunner = JRunner(jwf)
        for rung in ladder.rungs:
            got = runner.infer(x[:rung])
            want = jrunner.infer(x[:rung])
            assert got.shape == want.shape == (rung, 10)
            assert np.isfinite(got).all() and np.std(got) > 0
            np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert runner.compiles == len(ladder.rungs)
