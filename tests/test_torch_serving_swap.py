"""The served snapshot load, swap and rollback on the CPU (after
``tests/test_serving.py``'s swap tests), on the tiny AlexNet-shaped net
of ``test_torch_planner``:

  - ``ModelRunner(wf, snapshot=path)`` serves the snapshot: the
    reference's ``ModelRunner`` loading the same file gives its logits
    within ``LOGIT_TOL``;
  - ``InferenceServer.swap_async`` under a client that submits all the
    while: every reply equals the forward of the generation stamped on
    it, both generations answer, and ``stats()`` shows the new one;
  - ``rollback`` serves the old generation's bits and stamp again, once;
  - a second swap while one runs, and a snapshot that does not cover the
    model, each raise, count a failure and leave the live generation
    serving.
"""

import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from test_torch_planner import SAMPLE, jax_workflow, tiny_layers
from test_torch_serving import LOGIT_TOL, _batch, _port, reference  # noqa

#: a reply against its stamped generation's forward: batch compositions
#: differ, so the sums may round differently; every row's logits of the
#: two generations lie much further apart (checked)
REPLY_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _snapshot(path, tree):
    """Write ``{"units": tree}`` as a host-format snapshot."""
    from znicz_torch.snapshotter import write_host_pickle

    write_host_pickle(str(path), {"units": tree, "velocities": {},
                                  "epoch": 3})
    return str(path)


def _second(tree):
    """Another parameter tree of the same shapes."""
    rng = np.random.default_rng(11)
    return {name: {k: (0.5 * a + 0.01 * rng.normal(size=a.shape))
                   .astype(np.float32) for k, a in leaves.items()}
            for name, leaves in tree.items()}


def _fresh():
    from znicz_torch.standard_workflow import StandardWorkflow

    return StandardWorkflow(tiny_layers(), SAMPLE, device="cpu")


def test_runner_serves_a_snapshot_like_the_reference(reference, tmp_path):
    """A port snapshot of the reference's parameters: the port's runner
    booted from it (over fresh random weights) and the reference's
    runner booted from the same file give the same logits."""
    from znicz_torch.serving.model import ModelRunner
    from znicz_tpu.serving.model import ModelRunner as JRunner

    jwf, tree = reference
    path = _snapshot(tmp_path / "ref.pickle.gz", tree)
    runner = ModelRunner(_fresh(), snapshot=path)
    assert runner.snapshot_path == path and runner.generation == 1
    x = _batch(6)
    got = runner.infer(x)
    want = JRunner(jax_workflow(tiny_layers()), snapshot=path).infer(x)
    assert np.std(got) > 0
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(got, JRunner(jwf).infer(x), **LOGIT_TOL)


def test_swap_under_traffic_never_mixes_generations(reference, tmp_path):
    """A client thread submits one- to three-row requests while the
    server swaps to another snapshot: every reply is its stamped
    generation's forward, both generations answered, none after the
    flip came from the old one, and the server reports generation 2."""
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer
    from znicz_torch.serving.model import ModelRunner

    _, tree = reference
    tree2 = _second(tree)
    path = _snapshot(tmp_path / "gen2.pickle.gz", tree2)
    rows = _batch(64, seed=5)
    want = {1: ModelRunner(_port(tree)).infer(rows),
            2: ModelRunner(_port(tree2)).infer(rows)}
    assert np.abs(want[1] - want[2]).max(axis=1).min() > 1e-3
    srv = InferenceServer(_port(tree), max_batch=8, max_delay_ms=1.0,
                          queue_bound=256).start()
    replies, stop = [], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            if i >= 16:                     # at most 16 in flight
                replies[i - 16][2].result(30)
            lo, n = i % 60, 1 + i % 3
            fut = Future()
            srv.submit(Request(rows[lo:lo + n], n, reply_to=fut,
                               req_id=f"r{i}"))
            replies.append((lo, n, fut))
            i += 1

    t = threading.Thread(target=client)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # threads interleave more often
    try:
        t.start()
        time.sleep(0.2)
        swap = srv.swap_async(path)
        swap.join(60)
        assert not swap.is_alive()
        time.sleep(0.2)
    finally:
        stop.set()
        t.join(60)
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    outs = [(lo, n, fut.result(30)) for lo, n, fut in replies]
    srv.stop()
    assert all(r["ok"] for _, _, r in outs), \
        [r for _, _, r in outs if not r["ok"]][:2]
    gens = [r["gen"] for _, _, r in outs]
    assert set(gens) == {1, 2}
    first2 = gens.index(2)
    assert all(g == 2 for g in gens[first2:])
    for lo, n, r in outs:
        np.testing.assert_allclose(r["y"], want[r["gen"]][lo:lo + n],
                                   **REPLY_TOL)
    st = srv.stats()
    assert st["generation"] == 2 and st["swapping"] is False
    assert st["swaps"] == 1 and st["swap_failures"] == 0
    assert st["snapshot_path"] == path


def test_rollback_is_bit_exact_and_once(reference, tmp_path):
    """After a swap, ``rollback`` serves the displaced tuple: the old
    bits and stamp, no disk read (the file is gone); a second rollback
    raises.  A new swap takes a fresh generation id."""
    from znicz_torch.serving.model import ModelRunner

    _, tree = reference
    runner = ModelRunner(_port(tree))
    x = _batch(4)
    before = runner.infer(x)
    path = _snapshot(tmp_path / "gen2.pickle.gz", _second(tree))
    meta = runner.swap(path)
    assert meta["epoch"] == 3 and "units" not in meta
    assert runner.generation == 2
    assert not np.array_equal(runner.infer(x), before)
    (tmp_path / "gen2.pickle.gz").unlink()
    assert runner.rollback() == 1
    assert runner.generation == 1 and runner.snapshot_path == ""
    assert np.array_equal(runner.infer(x), before)
    with pytest.raises(RuntimeError, match="no previous generation"):
        runner.rollback()
    runner.swap(_snapshot(tmp_path / "again.pickle.gz", _second(tree)))
    assert runner.generation == 3
    assert runner.stats()["rollbacks"] == 1
    # the modules keep their own parameters whatever generation serves
    for f in runner.workflow.forwards:
        if f.has_weights:
            np.testing.assert_array_equal(f.weights.detach().numpy(),
                                          tree[f.name]["weights"])


def test_failed_swaps_leave_the_live_generation(reference, tmp_path,
                                                monkeypatch):
    """A swap started while another loads raises at once (the runner and
    the server's ``swap_async``), and a snapshot without one weighted
    forward raises from the runner and is logged and counted by the
    server; each leaves generation 1 serving the same bits."""
    from znicz_torch import snapshotter
    from znicz_torch.serving.frontend import InferenceServer

    _, tree = reference
    srv = InferenceServer(_port(tree), max_batch=4).start()
    runner = srv.runner
    x = _batch(3)
    before = runner.infer(x)
    path = _snapshot(tmp_path / "gen2.pickle.gz", _second(tree))
    entered, release = threading.Event(), threading.Event()
    load = snapshotter.Snapshotter.load

    def slow_load(p):
        entered.set()
        release.wait(30)
        return load(p)

    monkeypatch.setattr(snapshotter.Snapshotter, "load",
                        staticmethod(slow_load))
    slow = srv.swap_async(path)
    assert entered.wait(30) and runner.swapping
    with pytest.raises(RuntimeError, match="already in progress"):
        runner.swap(path)
    with pytest.raises(RuntimeError, match="already in progress"):
        srv.swap_async(path)
    assert runner.generation == 1
    release.set()
    slow.join(30)
    assert not slow.is_alive()
    monkeypatch.setattr(snapshotter.Snapshotter, "load", staticmethod(load))
    assert runner.generation == 2 and runner.stats()["swap_failures"] == 1
    assert runner.rollback() == 1
    partial = {name: leaves for name, leaves in _second(tree).items()
               if name != next(iter(tree))}
    bad = _snapshot(tmp_path / "partial.pickle.gz", partial)
    with pytest.raises(ValueError, match="snapshot has no params"):
        runner.swap(bad)
    failing = srv.swap_async(bad)
    failing.join(30)
    assert not failing.is_alive()
    st = srv.stats()
    assert st["generation"] == 1 and st["swap_failures"] == 3
    assert st["swaps"] == 1 and not st["swapping"]
    assert np.array_equal(runner.infer(x), before)
    srv.stop()
    assert srv.error is None
    assert torch.equal(torch.from_numpy(runner.infer(x)),
                       torch.from_numpy(before))
