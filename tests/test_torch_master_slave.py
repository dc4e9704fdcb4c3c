"""The port's master/slave star (``znicz_torch/server.py``,
``client.py``, ``network_common.py``'s digest and handshake,
``distributable.py``, ``loader/zmq_loader.py``, the star harnesses of
``parallel/chaos.py`` and ``python -m znicz_torch --master/--slave``)
against the reference's ``tests/test_master_slave.py``, the star cases
of ``tests/test_chaos.py`` and ``tests/test_elastic.py``, and the
reference's own master and slave:

  - each reference case but the ``web_status`` panels (ROADMAP A.9), on
    the port's reduced MNIST: two slaves train into the reference's band,
    a dead slave's job is re-queued and done once, stale, quarantined,
    malformed and unregistered updates never touch the weights, the
    handshake refuses another protocol or graph, segments, the epoch
    tail, the reconnect state machine, eviction, the adaptive timeout,
    staleness and its weighting, the quorum, the resume file, a master
    killed and resumed under its slaves, and the CLI;
  - the gate: the two packages' digests are equal, a port slave trains
    against the reference's master and a reference slave against the
    port's, and one slave without prefetch leaves the master's weights
    within ``PAIR_RTOL`` of the reference pairing's after the same jobs.

Every socket binds ``tcp://127.0.0.1:*``; tests wait by polling state
with generous budgets, never on a wall-clock bound."""

import contextlib
import os
import pathlib
import pickle
import re
import subprocess
import sys
import threading
import time
import unittest.mock as mock

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the master's weights after one slave's jobs, against the reference
#: pairing's (float32 rounding through the unit engines' steps)
PAIR_RTOL, PAIR_ATOL = 2e-4, 2e-6
#: a generous budget for anything a test waits for (s)
BUDGET = 120.0
#: the reference suite's fault mix and seed
CHAOS = dict(drop=0.06, corrupt=0.06, duplicate=0.05, delay=0.08,
             delay_s=(0.02, 0.25))
SEED = 5


def _wait(pred, what, budget=BUDGET):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < budget, f"never {what}"
        time.sleep(0.02)


@contextlib.contextmanager
def _restored(keys):
    """``keys`` (dotted paths) in both config trees put back on exit.  A
    key that was unset is deleted again: put back as None it would read
    as off (``job_prefetch``) in every later test of the process."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    unset = object()
    saved = [(tree, k, tree.get_by_path(k, unset))
             for tree in (troot, jroot) for k in keys]
    try:
        yield
    finally:
        for tree, k, v in saved:
            if v is unset:
                head, _, leaf = k.rpartition(".")
                node = tree.get_by_path(head)
                if node is not None:
                    delattr(node, leaf)
            else:
                tree.set_by_path(k, v)


@pytest.fixture(autouse=True)
def _mnist_config():
    """The reduced MNIST of the reference's tests in both config trees,
    put back after each test; the star's engine knobs too."""
    import znicz_torch.samples.mnist  # noqa: F401  (its defaults)
    import znicz_tpu.samples.mnist  # noqa: F401

    with _restored(("mnist.loader.n_train", "mnist.loader.n_valid",
                    "mnist.loader.minibatch_size",
                    "mnist.decision.max_epochs", "common.dirs.snapshots",
                    "common.engine.job_prefetch", "common.engine.mode",
                    "common.engine.train_shard")):
        yield


def test_an_unset_knob_is_unset_again():
    """ROADMAP C.12: the config fixture deletes a knob that was unset
    before the test (put back as None, ``job_prefetch`` would turn the
    reference client's prefetch off in every later test of the
    worker)."""
    from znicz_tpu.core.config import root as jroot

    eng = jroot.common.engine
    if "job_prefetch" in eng:
        delattr(eng, "job_prefetch")
    with _restored(("common.engine.job_prefetch",)):
        eng.job_prefetch = False
    assert "job_prefetch" not in eng
    assert bool(eng.get("job_prefetch", True))


def _configure(tree, tmp_path, max_epochs, n_train):
    tree.mnist.loader.n_train = n_train
    tree.mnist.loader.n_valid = 60
    tree.mnist.loader.minibatch_size = 60
    tree.mnist.decision.max_epochs = max_epochs
    tree.common.dirs.snapshots = str(tmp_path)


def _make_workflow(tmp_path, max_epochs=3, n_train=300):
    """The port's reduced MNIST on the CPU after ``prng.reset(1013)``."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import mnist

    _configure(root, tmp_path, max_epochs, n_train)
    prng.reset(1013)
    return mnist.MnistWorkflow(device="cpu")


def _jax_workflow(tmp_path, max_epochs=3, n_train=300):
    """The reference's reduced MNIST, the same config."""
    from znicz_tpu.core import prng
    from znicz_tpu.core.config import root
    from znicz_tpu.samples import mnist

    _configure(root, tmp_path, max_epochs, n_train)
    prng.reset(1013)
    wf = mnist.MnistWorkflow()
    wf.initialize(device=None)
    return wf


def _handshake_fields(workflow):
    from znicz_torch.network_common import handshake_request

    msg = handshake_request(workflow)
    del msg["cmd"]
    return msg


def _params(wf):
    from znicz_torch.weights import params_to_numpy

    return params_to_numpy(wf)


def _shapes(wf):
    return {n: {k: a.shape for k, a in layer.items()}
            for n, layer in _params(wf).items()}


def _delta(shapes, value=1e-4):
    return {n: {k: np.full(s, value, np.float32) for k, s in layer.items()}
            for n, layer in shapes.items()}


def _assert_params(wf, want):
    got = _params(wf)
    for n, layer in want.items():
        for k, v in layer.items():
            np.testing.assert_allclose(got[n][k], v, rtol=1e-5)


def _run_slaves(slaves, **run_kw):
    errors = []

    def worker(s):
        try:
            s.run(**run_kw)
        except BaseException as e:          # surface a thread's crash
            errors.append((s.slave_id, repr(e)))
            raise

    threads = [threading.Thread(target=worker, args=(s,), daemon=True)
               for s in slaves]
    for t in threads:
        t.start()
    return threads, errors


def _join(threads, errors):
    for t in threads:
        t.join(timeout=BUDGET)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


def _dead_endpoint():
    """An address nothing listens on: a wildcard bind, resolved, closed."""
    import zmq

    sock = zmq.Context.instance().socket(zmq.REP)
    sock.bind("tcp://127.0.0.1:*")
    ep = sock.getsockopt(zmq.LAST_ENDPOINT).decode()
    sock.close(0)
    return ep


# -- training through the star ----------------------------------------------------


def test_master_slave_trains(tmp_path):
    from znicz_torch.client import Client
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m"), job_timeout=60.0).start()
    assert re.fullmatch(r"tcp://127\.0\.0\.1:\d+", server.endpoint)
    slaves = [Client(_make_workflow(tmp_path / f"s{i}"),
                     endpoint=server.endpoint, slave_id=f"slave{i}")
              for i in range(2)]
    threads, errors = _run_slaves(slaves)
    assert server.join(BUDGET)
    _join(threads, errors)
    dec = server.workflow.decision
    assert bool(dec.complete)
    # asynchronous: epochs are attributed best-effort; count jobs instead
    assert server.jobs_done >= 3 * 6 - len(slaves)
    assert server.jobs_by_slave.get("slave0", 0) > 0
    assert server.jobs_by_slave.get("slave1", 0) > 0
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert server.jobs_ledger()["balanced"]
    valid = dec.epoch_metrics[1]
    assert valid is not None and valid["err_pct"] < 70.0, valid


@pytest.mark.parametrize("fused", [False, True], ids=["unit", "fused"])
def test_slave_death_requeues_job_and_training_completes(tmp_path, fused):
    """A slave that takes a job and dies: the master re-queues it after
    the job timeout, and a slave joining after the death finishes the
    training; the dead slave's job is done exactly once (by another)."""
    from znicz_torch.client import Client, FusedClient
    from znicz_torch.parallel.chaos import take_job_and_die
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m"), job_timeout=1.0,
                    segment_steps=3 if fused else None).start()
    doomed = take_job_and_die(server.endpoint, server.workflow, "doomed")
    assert doomed is not None and doomed in server._inflight
    cls = FusedClient if fused else Client
    healthy = cls(_make_workflow(tmp_path / "s"), endpoint=server.endpoint,
                  slave_id="healthy")
    healthy.run()
    assert server.join(BUDGET)
    dec = server.workflow.decision
    assert bool(dec.complete)
    assert server.jobs_requeued >= 1
    assert doomed not in server._inflight
    assert server.jobs_by_slave.get("healthy", 0) > 0
    assert server.jobs_by_slave.get("doomed", 0) == 0
    assert server.jobs_ledger()["balanced"]
    valid = dec.epoch_metrics[1]
    assert valid is not None and valid["err_pct"] < 70.0, valid


def test_fused_slaves_train_to_quality_band(tmp_path):
    """Two ``FusedClient`` slaves (a job: a segment of up to 3
    minibatches on ``FusedTrainer``) train into the unit slaves' band,
    with fewer jobs than minibatches and the confusion carried by the
    segment's first minibatch."""
    from znicz_torch.client import FusedClient
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m"), job_timeout=60.0,
                    segment_steps=3).start()
    slaves = [FusedClient(_make_workflow(tmp_path / f"s{i}"),
                          endpoint=server.endpoint, slave_id=f"fslave{i}")
              for i in range(2)]
    assert slaves[0].engine_name() == "fused"
    threads, errors = _run_slaves(slaves)
    assert server.join(BUDGET)
    _join(threads, errors)
    dec = server.workflow.decision
    assert bool(dec.complete)
    assert server.jobs_by_slave.get("fslave0", 0) > 0
    assert server.jobs_by_slave.get("fslave1", 0) > 0
    assert server.jobs_done < 3 * 6 + 3 * 2
    valid = dec.epoch_metrics[1]
    assert valid is not None and valid["err_pct"] < 70.0, valid
    conf = valid.get("confusion")
    assert conf is not None and int(conf.sum()) > 0


# -- the master's books, driven by hand -------------------------------------------


def test_stale_update_dropped_deterministic(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, job_timeout=0.0)            # reap at once
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    time.sleep(0.01)
    server._reap_lost_jobs()
    assert server.jobs_requeued == 1
    before = _params(wf)
    poisoned = {n: {k: np.full_like(v, 1e6) for k, v in layer.items()}
                for n, layer in before.items()}
    late = server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                           "deltas": poisoned, "metrics": {"loss": 0.0}})
    assert late == {"ok": False, "stale": True}
    assert server.stale_updates == 1
    for n, layer in _params(wf).items():
        for k, v in layer.items():
            np.testing.assert_array_equal(v, before[n][k])


def test_midrun_joiner_receives_current_weights(tmp_path):
    import torch

    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    first = next(f for f in wf.forwards if f.has_weights)
    with torch.no_grad():
        first.weights.add_(0.125)
    current = first.weights.detach().numpy().copy()
    assert server._handle({"cmd": "register", "id": "late",
                           **_handshake_fields(wf)})["ok"]
    rep = server._handle({"cmd": "job", "id": "late"})
    np.testing.assert_array_equal(
        np.asarray(rep["params"][first.name]["weights"]), current)


def test_handshake_version_mismatch_refused(tmp_path):
    from znicz_torch.network_common import workflow_digest
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    rep = server._handle({"cmd": "register", "id": "old", "version": 999,
                          "workflow_digest": workflow_digest(wf)})
    assert rep["ok"] is False and "version mismatch" in rep["error"]
    assert "old" not in server.slaves
    rep = server._handle({"cmd": "register", "id": "v2", "version": 2,
                          "workflow_digest": workflow_digest(wf)})
    assert "v3 multipart" in rep["error"]
    assert server._handle({"cmd": "register", "id": "new",
                           **_handshake_fields(wf)})["ok"]


def test_handshake_digest_mismatch_refused_client_side(tmp_path):
    """A slave of another graph raises a clean error instead of training
    against weights it does not share."""
    from znicz_torch import network_common
    from znicz_torch.client import Client
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m")).start()
    try:
        client = Client(_make_workflow(tmp_path / "s"),
                        endpoint=server.endpoint, slave_id="misconfigured")
        bad = {"cmd": "register",
               "version": network_common.PROTOCOL_VERSION,
               "workflow_digest": "deadbeefdeadbeef"}
        with mock.patch.object(network_common, "handshake_request",
                               return_value=bad):
            with pytest.raises(RuntimeError, match="digest mismatch"):
                client.run()
        assert "misconfigured" not in server.registered
    finally:
        server.stop()
        assert server.join(BUDGET)


def test_workflow_digest_semantics(tmp_path):
    """Identical replicas match across host paths; a live learning-rate
    change does not move the digest; another configured rate, a
    structural flag or a parameter shape does."""
    import torch

    from znicz_torch.core.config import root
    from znicz_torch.network_common import workflow_digest

    a = _make_workflow(tmp_path / "a")
    b = _make_workflow(tmp_path / "b")
    root.common.dirs.snapshots = "/somewhere/else/entirely"
    assert workflow_digest(a) == workflow_digest(b)
    gd = b.gd_units[0]
    old_lr = gd.learning_rate
    gd.learning_rate = old_lr * 2
    assert workflow_digest(a) == workflow_digest(b)
    gd.learning_rate = old_lr
    old_cfg = root.mnist.learning_rate
    try:
        root.mnist.learning_rate = old_cfg * 2
        c = _make_workflow(tmp_path / "c")
        assert workflow_digest(a) != workflow_digest(c)
    finally:
        root.mnist.learning_rate = old_cfg
    f = b.forwards[0]
    f.weights_transposed = not f.weights_transposed
    assert workflow_digest(a) != workflow_digest(b)
    f.weights_transposed = not f.weights_transposed
    assert workflow_digest(a) == workflow_digest(b)
    w = a.forwards[0].weights
    a.forwards[0].weights = torch.nn.Parameter(
        torch.zeros((w.shape[0] + 1, w.shape[1])), requires_grad=False)
    assert workflow_digest(a) != workflow_digest(b)


@pytest.mark.parametrize("sample", ["mnist", "cifar", "alexnet"])
def test_digest_equals_the_reference(sample, tmp_path):
    """The handshake's contract across packages: the port's digest of a
    sample is the reference's for the same config, byte for byte."""
    from test_torch_layers import jax_sample, port_sample, sample_config
    from znicz_torch.network_common import workflow_digest
    from znicz_tpu.network_common import workflow_digest as jdigest

    if sample == "alexnet":
        from znicz_torch.core import prng
        from znicz_torch.samples.alexnet import training_workflow
        from znicz_tpu.core import prng as jprng
        from znicz_tpu.samples.alexnet import AlexNetWorkflow

        with sample_config("alexnet", loader__image_size=67,
                           loader__n_train=24, loader__n_valid=8,
                           loader__minibatch_size=8, loader__n_classes=10):
            jprng.reset(1013)
            jwf = AlexNetWorkflow()
            jwf.initialize(device=None)
            prng.reset(1013)
            twf = training_workflow(device="cpu")
    else:
        small = {"loader__n_train": 20, "loader__n_valid": 10,
                 "loader__minibatch_size": 10}
        with sample_config(sample, **small):
            jwf = jax_sample(sample, tmp_path)
            twf = port_sample(sample, tmp_path)
    assert workflow_digest(twf) == jdigest(jwf)


def test_unregistered_slave_gets_no_jobs_or_updates(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    rep = server._handle({"cmd": "job", "id": "ghost"})
    assert rep["ok"] is False and "not registered" in rep["error"]
    assert rep["unregistered"] is True
    rep = server._handle({"cmd": "update", "id": "ghost", "job_id": 1,
                          "deltas": {}, "metrics": {}})
    assert rep["ok"] is False and "not registered" in rep["error"]
    server._handle({"cmd": "register", "id": "old", "version": 0,
                    "config_digest": "x"})
    rep = server._handle({"cmd": "job", "id": "old"})
    assert rep["ok"] is False and "not registered" in rep["error"]


def test_segment_max_bad_replies_drops_after_requeues(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, segment_steps=3)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    rep = server._handle({"cmd": "job", "id": "s1"})
    while "minibatches" not in rep["job"]:
        server._handle({"cmd": "update", "id": "s1",
                        "job_id": rep["job_id"], "deltas": None,
                        "metrics": {"loss": 1.0, "n_err": 0}})
        rep = server._handle({"cmd": "job", "id": "s1"})
    seg_idx = np.array(rep["job"]["minibatches"][0]["indices"])
    for attempt in range(server.MAX_BAD_REPLIES):
        bad = server._handle({"cmd": "update", "id": "s1",
                              "job_id": rep["job_id"], "deltas": None,
                              "metrics": [{"loss": 1.0}]})
        assert bad["ok"] is False and "metrics length" in bad["error"]
        if attempt < server.MAX_BAD_REPLIES - 1:
            assert server._pending
            rep = server._handle({"cmd": "job", "id": "s1"})
            np.testing.assert_array_equal(
                np.array(rep["job"]["minibatches"][0]["indices"]), seg_idx)
        else:
            assert not server._pending
    assert server.bad_updates == server.MAX_BAD_REPLIES
    job = server._handle({"cmd": "job", "id": "s1"}).get("job")
    assert job is not None
    nxt = (job["minibatches"][0]["indices"] if "minibatches" in job
           else job["indices"])
    assert not np.array_equal(np.array(nxt), seg_idx)


def test_tail_reissued_when_tail_slave_dies(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    wf.decision.max_epochs = 1
    server = Server(wf, job_timeout=0.2)
    for sid in ("s1", "s2"):
        assert server._handle({"cmd": "register", "id": sid,
                               **_handshake_fields(wf)})["ok"]
    rep = server._handle({"cmd": "job", "id": "s1"})
    while not rep["job"].get("last_minibatch"):
        server._handle({"cmd": "update", "id": "s1",
                        "job_id": rep["job_id"], "deltas": None,
                        "metrics": {"loss": 1.0, "n_err": 0}})
        rep = server._handle({"cmd": "job", "id": "s1"})
    tail_jid = rep["job_id"]
    assert server._handle({"cmd": "job", "id": "s2"}) == {"wait": True}
    _wait(lambda: time.time() - server._inflight[tail_jid][1] > 0.2,
          "the tail past its job timeout")
    rep = server._handle({"cmd": "job", "id": "s2"})
    assert rep["job"].get("last_minibatch"), rep
    assert rep["job_id"] != tail_jid
    assert server.jobs_requeued >= 1
    up = server._handle({"cmd": "update", "id": "s2",
                         "job_id": rep["job_id"], "deltas": None,
                         "metrics": {"loss": 1.0, "n_err": 0}})
    assert up["ok"] is True
    assert bool(wf.decision.complete)
    assert server._handle({"cmd": "job", "id": "s2"}) == {"done": True}


def test_quarantine_nonfinite_delta_never_applied(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    before = _params(wf)
    poisoned = {n: {k: np.full_like(v, np.nan) for k, v in layer.items()}
                for n, layer in before.items()}
    rep = server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                          "deltas": poisoned,
                          "metrics": {"loss": 0.0, "n_err": 0}})
    assert rep["ok"] is False and rep.get("quarantined")
    assert "non-finite" in rep["error"]
    assert server.quarantined_updates == 1
    assert len(server._pending) == 1
    _assert_params(wf, before)


def test_quarantine_norm_exploded_bounded_retry(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    shapes = _shapes(wf)
    server = Server(wf)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    server._delta_norms.extend([1.0, 1.1, 0.9, 1.0, 1.05])

    def update(jid, scale):
        return server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                               "deltas": _delta(shapes, scale),
                               "metrics": {"loss": 1.0, "n_err": 0}})

    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    for attempt in range(server.MAX_BAD_REPLIES):
        rep = update(jid, 1e6)
        assert rep["ok"] is False and rep.get("quarantined"), rep
        assert "median" in rep["error"]
        if attempt < server.MAX_BAD_REPLIES - 1:
            assert server._pending
            jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
        else:
            assert not server._pending
    assert server.quarantined_updates == server.MAX_BAD_REPLIES
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    assert update(jid, 1e-4)["ok"] is True
    assert server.jobs_done == 1


def test_malformed_update_payloads_never_lose_the_job(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    first = next(f for f in wf.forwards if f.has_weights)
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    rep = server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                          "deltas": None, "metrics": [{"loss": 1.0}]})
    assert rep["ok"] is False and "not a dict" in rep["error"]
    assert server.bad_updates == 1 and len(server._pending) == 1
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    rep = server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                          "deltas": {first.name:
                                     {"weights": [[1.0], [2.0, 3.0]]}},
                          "metrics": {"loss": 1.0, "n_err": 0}})
    assert rep["ok"] is False and rep.get("quarantined"), rep
    assert "undecodable delta payload" in rep["error"]
    assert len(server._pending) == 1
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    rep = server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                          "deltas": {first.name: {"weights": np.zeros(
                              (2, 2), np.float32)}},
                          "metrics": {"loss": 1.0, "n_err": 0}})
    assert rep["ok"] is False and rep.get("quarantined"), rep
    assert "shape" in rep["error"]
    assert server.quarantined_updates == 2
    assert not server._pending
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    rep = server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                          "deltas": None,
                          "metrics": {"loss": 1.0, "n_err": 0}})
    assert rep["ok"] is True and server.jobs_done == 1


def test_bad_frame_refused_not_fatal(tmp_path):
    """Garbage and a pickle that is no request are refused in v2 framing
    and counted; the next well-formed request is served."""
    import zmq

    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf).start()
    sock = zmq.Context.instance().socket(zmq.REQ)
    sock.setsockopt(zmq.RCVTIMEO, 30_000)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(server.endpoint)
    try:
        sock.send(b"\x00 definitely not a pickle")
        rep = pickle.loads(sock.recv())
        assert rep["ok"] is False and rep.get("bad_frame")
        sock.send(pickle.dumps([1, 2, 3]))
        rep = pickle.loads(sock.recv())
        assert rep["ok"] is False and rep.get("bad_frame")
        assert server.bad_frames == 2
        sock.send(pickle.dumps({"cmd": "register", "id": "s1",
                                **_handshake_fields(wf)}))
        assert pickle.loads(sock.recv())["ok"]
    finally:
        sock.close(0)
        server.stop()
    assert server.join(BUDGET)


def _scripted_router(script):
    """A ROUTER on a wildcard port answering by ``script(req)`` (None:
    swallow) until it returns "stop"; (thread, endpoint, requests seen)."""
    import zmq

    from znicz_torch.parallel import wire

    ready, seen, box = threading.Event(), [], {}

    def loop():
        router = zmq.Context.instance().socket(zmq.ROUTER)
        router.setsockopt(zmq.RCVTIMEO, 60_000)
        router.setsockopt(zmq.LINGER, 0)
        router.bind("tcp://127.0.0.1:*")
        box["ep"] = router.getsockopt(zmq.LAST_ENDPOINT).decode()
        ready.set()
        try:
            while True:
                envelope, payload = wire.split_envelope(
                    router.recv_multipart())
                req, _ = wire.decode_message(payload)
                seen.append(req["cmd"])
                rep = script(req)
                if rep == "stop":
                    return
                if rep is not None:
                    router.send_multipart(envelope + [pickle.dumps(rep)])
                    if rep.get("done"):
                        return
        finally:
            router.close(0)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    ready.wait()
    return t, box["ep"], seen


def test_client_reconnects_with_fresh_socket_after_timeout(tmp_path):
    """After a swallowed reply the slave drops the socket, backs off,
    connects a fresh one and registers again before asking for work."""
    from znicz_torch.client import Client

    state = {"ignored": False}

    def script(req):
        if req["cmd"] == "job" and not state["ignored"]:
            state["ignored"] = True
            return None
        if req["cmd"] == "register":
            return {"ok": True, "version": req["version"],
                    "class_lengths": [0, 60, 300]}
        return {"done": True}

    thread, ep, seen = _scripted_router(script)
    client = Client(_make_workflow(tmp_path / "s"), endpoint=ep,
                    slave_id="efsm")
    done = client.run(recv_timeout=0.5, max_reconnects=5,
                      backoff_base=0.05, backoff_cap=0.2)
    thread.join(timeout=BUDGET)
    assert not thread.is_alive()
    assert done == 0 and client.reconnects == 1
    assert seen == ["register", "job", "register", "job"]


def test_client_gives_up_cleanly_when_master_gone(tmp_path):
    from znicz_torch.client import Client

    def script(req):
        if req["cmd"] == "register":
            return {"ok": True, "version": req["version"],
                    "class_lengths": [0, 60, 300], "done": True}
        return "stop"

    thread, ep, _ = _scripted_router(script)
    client = Client(_make_workflow(tmp_path / "s"), endpoint=ep,
                    slave_id="orphan")
    done = client.run(recv_timeout=0.3, max_reconnects=2,
                      backoff_base=0.02, backoff_cap=0.05)
    thread.join(timeout=BUDGET)
    assert done == 0 and client.reconnects == 2


def test_slave_clean_error_when_no_master(tmp_path):
    from znicz_torch.client import Client

    client = Client(_make_workflow(tmp_path / "s"),
                    endpoint=_dead_endpoint())
    with pytest.raises(ConnectionError, match="no master answered"):
        client.run(recv_timeout=0.5)


def test_dead_slave_evicted_and_reregisters(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, slave_ttl=0.1)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    jid = server._handle({"cmd": "job", "id": "s1"})["job_id"]
    server._handle({"cmd": "update", "id": "s1", "job_id": jid,
                    "deltas": None, "metrics": {"loss": 1.0, "n_err": 0}})
    _wait(lambda: time.time() - server.slaves["s1"] > 0.1,
          "the slave silent past its TTL")
    server._evict_dead_slaves()
    assert "s1" not in server.slaves and "s1" not in server.registered
    assert "s1" in server.dead_slaves
    assert server.jobs_by_slave["s1"] == 1
    assert server.preemptions_ridden == 1
    rep = server._handle({"cmd": "job", "id": "s1"})
    assert rep["ok"] is False and rep.get("unregistered")
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    assert server.reregistrations == 1
    assert "s1" not in server.dead_slaves


def test_adaptive_job_timeout(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, job_timeout=30.0)
    assert server.effective_job_timeout() == 30.0
    server._durations.extend([0.1] * 8)
    assert abs(server.effective_job_timeout() - 1.8) < 1e-9
    server._durations.extend([10.0] * 24)
    assert server.effective_job_timeout() == 30.0
    fast = Server(wf, job_timeout=0.0)
    fast._durations.extend([0.01] * 8)
    assert fast.effective_job_timeout() == 0.0


# -- elastic: staleness, quorum, the resume file -----------------------------------


def test_staleness_boundary_star_and_weighting(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    shapes = _shapes(wf)
    server = Server(wf, staleness_bound=1)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    reps = [server._handle({"cmd": "job", "id": "s1"}) for _ in range(3)]
    assert all(r["step"] == 0 for r in reps)

    def update(rep, **extra):
        return server._handle({"cmd": "update", "id": "s1",
                               "job_id": rep["job_id"], "step": rep["step"],
                               "deltas": _delta(shapes),
                               "metrics": {"loss": 1.0, "n_err": 0},
                               **extra})

    assert update(reps[0])["ok"] is True
    assert update(reps[1])["ok"] is True
    assert server.apply_step == 2 and server.stale_refused == 0
    before = _params(wf)
    rep = update(reps[2])
    assert rep["ok"] is False and rep.get("stale_refused")
    assert rep["staleness"] == 2 and server.stale_refused == 1
    assert server.apply_step == 2
    _assert_params(wf, before)
    assert len(server._pending) == 1
    assert "_bad_replies" not in server._pending[0]
    redis = server._handle({"cmd": "job", "id": "s1"})
    assert redis["job"] == reps[2]["job"] and redis["step"] == 2
    assert update(redis)["ok"] is True
    assert server.jobs_ledger() == {
        "dispatched": 4, "jobs_done": 3, "jobs_requeued": 0,
        "bad_updates": 0, "quarantined_updates": 0, "stale_refused": 1,
        "in_flight": 0, "balanced": True}
    assert server.staleness_summary()["s1"]["max"] == 2
    for _ in range(server.MAX_BAD_REPLIES):
        j = server._handle({"cmd": "job", "id": "s1"})
        rep = server._handle({"cmd": "update", "id": "s1",
                              "job_id": j["job_id"], "step": 0,
                              "deltas": _delta(shapes),
                              "metrics": {"loss": 1.0, "n_err": 0}})
        assert rep["ok"] is False and rep.get("stale_refused")
    assert server.stale_refused == 1 + server.MAX_BAD_REPLIES
    assert not server._pending and server.jobs_ledger()["balanced"]
    # the weighted apply, 1 / (1 + s), on a fresh master
    wf = _make_workflow(tmp_path / "m2")
    server2 = Server(wf, staleness_weight=True)
    assert server2._handle({"cmd": "register", "id": "s1",
                            **_handshake_fields(wf)})["ok"]
    j1 = server2._handle({"cmd": "job", "id": "s1"})
    j2 = server2._handle({"cmd": "job", "id": "s1"})
    d = _delta(shapes, 2e-4)

    def up(j, step):
        return server2._handle({"cmd": "update", "id": "s1",
                                "job_id": j["job_id"], "step": step,
                                "deltas": d,
                                "metrics": {"loss": 1.0, "n_err": 0}})

    assert up(j1, j1["step"])["ok"] and server2.weighted_applies == 0
    mid = _params(wf)
    assert up(j2, j2["step"])["ok"] and server2.weighted_applies == 1
    _assert_params(wf, {n: {k: mid[n][k] + d[n][k] / 2.0 for k in layer}
                        for n, layer in d.items()})
    j3 = server2._handle({"cmd": "job", "id": "s1"})
    assert up(j3, "garbage")["ok"] is True
    assert server2.jobs_ledger()["balanced"]


def test_quorum_gate_waits_below_min_slaves(tmp_path):
    """Below ``min_slaves`` job requests wait (degraded); a relay's
    ``leaves`` report counts through the tree and lifts the gate, and the
    re-plan of its join names it."""
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, min_slaves=2)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    assert server._handle({"cmd": "job", "id": "s1"}) == {
        "wait": True, "degraded": True, "members": 1, "min_slaves": 2}
    assert server.degraded() and not server.quorum_met()
    assert server.tree_plan is None
    assert server._handle({"cmd": "register", "id": "r1", "relay": True,
                           "bind": "tcp://127.0.0.1:9",
                           **_handshake_fields(wf)})["ok"]
    assert server.member_count() == 1           # no leaves reported yet
    rep = server._handle({"cmd": "job", "id": "r1", "count": 2,
                          "leaves": 1})
    assert "jobs" in rep                        # 1 direct + 1 leaf = 2
    assert server.member_count() == 2 and not server.degraded()
    assert server.tree_plan["relays"][0]["id"] == "r1"
    assert server.tree_plan["relays"][0]["bind"] == "tcp://127.0.0.1:9"
    assert server.replans == 1


def test_elastic_counters_resume_roundtrip(tmp_path):
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, staleness_bound=2, staleness_weight=True)
    server.stale_refused = 3
    server.weighted_applies = 5
    server.preemptions_ridden = 4
    server._apply_step = 17
    path = str(tmp_path / "resume.pickle")
    server.save_resume(path)
    assert server.resume_saves == 1
    server2 = Server(_make_workflow(tmp_path / "m2"), resume_path=path)
    assert server2.resumed
    assert (server2.stale_refused, server2.weighted_applies,
            server2.preemptions_ridden, server2.apply_step) == (3, 5, 4, 17)


def test_slave_kill_and_master_crash_resume(tmp_path):
    """A slave dies mid-job and the master is killed mid-epoch: the
    restarted master restores its resume file, the slaves ride the
    outage out through reconnects and register again, and training
    completes in the band; the file is removed once training is done."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.chaos import MasterHarness, take_job_and_die

    resume = str(tmp_path / "master_resume.pickle.gz")
    harness = MasterHarness(lambda: _make_workflow(tmp_path / "m"),
                            "tcp://127.0.0.1:*", resume,
                            snapshot_every_s=0.25, linger=5.0,
                            job_timeout=8.0)
    server1 = harness.start()
    assert not server1.resumed
    slaves = [Client(_make_workflow(tmp_path / f"s{i}"),
                     endpoint=harness.endpoint, slave_id=f"phoenix{i}")
              for i in range(2)]
    threads, errors = _run_slaves(slaves, recv_timeout=1.0,
                                  max_reconnects=60, backoff_base=0.05,
                                  backoff_cap=0.3)
    assert take_job_and_die(harness.endpoint, harness.workflow,
                            "doomed") is not None
    _wait(lambda: server1.jobs_done >= 3, "three jobs done")
    saves = server1.resume_saves
    _wait(lambda: server1.resume_saves > saves, "a save after them")
    harness.kill()
    assert os.path.exists(resume)
    # dark past the slaves' recv_timeout, so the outage takes the
    # timeout -> fresh socket -> backoff path
    _wait(lambda: sum(s.reconnects for s in slaves) >= 1,
          "a slave reconnecting")
    server2 = harness.start()
    assert server2.resumed and server2.jobs_done >= 3
    assert harness.wait(timeout=BUDGET)
    _join(threads, errors)
    dec = harness.workflow.decision
    assert bool(dec.complete)
    valid = dec.epoch_metrics[1]
    assert valid is not None and valid["err_pct"] < 70.0, valid
    assert server2.reregistrations >= 1
    assert server2.jobs_by_slave.get("doomed", 0) == 0
    assert server2.jobs_done == sum(server2.jobs_by_slave.values())
    assert not os.path.exists(resume)


@pytest.mark.slow
def test_chaos_soak_matches_fault_free(tmp_path):
    """Frame chaos through the proxy, a mid-job slave death and a master
    kill and resume, against a fault-free run: the faults cost work, not
    the band."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.chaos import (ChaosProxy, FaultSchedule,
                                            MasterHarness, take_job_and_die)
    from znicz_torch.server import Server

    ref = Server(_make_workflow(tmp_path / "ref_m", max_epochs=4),
                 job_timeout=60.0).start()
    refs = [Client(_make_workflow(tmp_path / f"ref_s{i}", max_epochs=4),
                   endpoint=ref.endpoint, slave_id=f"ref{i}")
            for i in range(2)]
    threads, errors = _run_slaves(refs)
    assert ref.join(300)
    _join(threads, errors)
    ref_err = ref.workflow.decision.epoch_metrics[1]["err_pct"]
    resume = str(tmp_path / "soak_resume.pickle.gz")
    harness = MasterHarness(
        lambda: _make_workflow(tmp_path / "m", max_epochs=4),
        "tcp://127.0.0.1:*", resume, snapshot_every_s=0.25, linger=8.0,
        job_timeout=6.0)
    server1 = harness.start()
    proxy = ChaosProxy("tcp://127.0.0.1:*", harness.endpoint,
                       FaultSchedule(SEED, **CHAOS)).start()
    slaves = [Client(_make_workflow(tmp_path / f"s{i}", max_epochs=4),
                     endpoint=proxy.front_endpoint, slave_id=f"soak{i}")
              for i in range(2)]
    threads, errors = _run_slaves(slaves, recv_timeout=1.0,
                                  max_reconnects=80, backoff_base=0.05,
                                  backoff_cap=0.4, connect_retries=80)
    try:
        take_job_and_die(proxy.front_endpoint, harness.workflow, "doomed")
        _wait(lambda: server1.jobs_done >= 4, "four jobs done")
        saves = server1.resume_saves
        _wait(lambda: server1.resume_saves > saves, "a save after them")
        harness.kill()
        server2 = harness.start()
        assert server2.resumed
        assert harness.wait(timeout=300)
        _join(threads, errors)
    finally:
        proxy.stop()
    dec = harness.workflow.decision
    assert bool(dec.complete)
    assert abs(dec.epoch_metrics[1]["err_pct"] - ref_err) < 25.0
    assert server2.jobs_done == sum(server2.jobs_by_slave.values())
    assert sum(s.reconnects for s in slaves) >= 1


# -- across packages ---------------------------------------------------------------


def _jax_server_endpoint(server):
    """The reference master's resolved address once it is bound."""
    import zmq

    _wait(lambda: server._socket is not None, "the reference master bound")
    return server._socket.getsockopt(zmq.LAST_ENDPOINT).decode()


def test_port_slave_trains_against_the_reference_master(tmp_path):
    from znicz_torch.client import Client
    from znicz_tpu.server import Server as JServer

    server = JServer(_jax_workflow(tmp_path / "m", max_epochs=2),
                     endpoint="tcp://127.0.0.1:*", job_timeout=60.0)
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    client = Client(_make_workflow(tmp_path / "s", max_epochs=2),
                    endpoint=_jax_server_endpoint(server), slave_id="t0")
    assert client.run() == server.jobs_done
    thread.join(BUDGET)
    assert not thread.is_alive()
    dec = server.workflow.decision
    assert bool(dec.complete) and server.jobs_by_slave == {
        "t0": server.jobs_done}
    assert dec.epoch_metrics[1]["err_pct"] < 70.0


def test_reference_slave_trains_against_the_port_master(tmp_path):
    from znicz_torch.server import Server
    from znicz_tpu.client import Client as JClient

    server = Server(_make_workflow(tmp_path / "m", max_epochs=2),
                    job_timeout=60.0).start()
    client = JClient(_jax_workflow(tmp_path / "s", max_epochs=2),
                     endpoint=server.endpoint, slave_id="j0")
    assert client.run() == server.jobs_done
    assert server.join(BUDGET)
    dec = server.workflow.decision
    assert bool(dec.complete) and server.jobs_by_slave == {
        "j0": server.jobs_done}
    assert dec.epoch_metrics[1]["err_pct"] < 70.0


def test_one_slave_master_tree_matches_the_reference_pairing(tmp_path):
    """One slave without prefetch runs the job stream in order: the port
    pairing's master weights after the whole run lie within
    ``PAIR_RTOL`` of the reference pairing's, job for job."""
    from test_torch_layers import jax_params
    from znicz_torch.client import Client
    from znicz_torch.core.config import root as troot
    from znicz_torch.server import Server
    from znicz_tpu.client import Client as JClient
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.server import Server as JServer

    for tree in (troot, jroot):
        tree.common.engine.job_prefetch = False
    jserver = JServer(_jax_workflow(tmp_path / "jm", max_epochs=1),
                      endpoint="tcp://127.0.0.1:*", job_timeout=60.0)
    thread = threading.Thread(target=jserver.serve, daemon=True)
    thread.start()
    JClient(_jax_workflow(tmp_path / "js", max_epochs=1),
            endpoint=_jax_server_endpoint(jserver), slave_id="j").run()
    thread.join(BUDGET)
    tserver = Server(_make_workflow(tmp_path / "tm", max_epochs=1),
                     job_timeout=60.0).start()
    Client(_make_workflow(tmp_path / "ts", max_epochs=1),
           endpoint=tserver.endpoint, slave_id="t").run()
    assert tserver.join(BUDGET)
    assert tserver.jobs_done == jserver.jobs_done > 0
    want, got = jax_params(jserver.workflow), _params(tserver.workflow)
    start = _params(_make_workflow(tmp_path / "fresh", max_epochs=1))
    for name, leaves in want.items():
        for k, v in leaves.items():
            assert not np.array_equal(start[name][k], v)
            np.testing.assert_allclose(got[name][k], v, rtol=PAIR_RTOL,
                                       atol=PAIR_ATOL,
                                       err_msg=f"{name}.{k}")


# -- the rest: distributable, the ZMQ loader, the CLI ------------------------------


def test_distributable_payloads_roundtrip(tmp_path):
    """A module's payload is a float32 host copy of its parameters, and
    a GD unit's its momentum; applying one writes the live tensors."""
    a = _make_workflow(tmp_path / "a")
    b = _make_workflow(tmp_path / "b")
    f = a.forwards[0]
    data = f.generate_data_for_slave()
    assert set(data) == {"weights", "bias"}
    data["weights"] += 1.0
    assert not np.array_equal(f.weights.detach().numpy(), data["weights"])
    b.forwards[0].apply_data_from_master(data)
    np.testing.assert_array_equal(b.forwards[0].weights.detach().numpy(),
                                  data["weights"])
    assert a.forwards[1].generate_data_for_master().keys() == {"weights",
                                                               "bias"}
    gd = a.gd_units[0]
    gd.init_velocities()
    assert set(gd.generate_data_for_slave()) == {"weights", "bias"}


def test_scheduled_hypers_rows_match_the_reference():
    from znicz_torch.client import scheduled_hypers_rows
    from znicz_tpu.client import scheduled_hypers_rows as jrows

    base = {"fc": np.arange(8, dtype=np.float32) / 10.0}
    mbs = [{"hypers": {"fc": (0.5, 0.25)}}, {}, {"hypers": {"fc": (1, 2)}}]
    got, want = scheduled_hypers_rows(base, mbs), jrows(base, mbs)
    np.testing.assert_array_equal(got["fc"], want["fc"])


def test_zmq_loader_pulls_minibatches_from_a_feeder():
    import zmq

    from znicz_torch.core.workflow import Workflow
    from znicz_torch.loader.zmq_loader import ZeroMQLoader

    ldr = ZeroMQLoader(Workflow(), name="zmq", recv_timeout=30.0)
    ldr.initialize(device="cpu")
    assert re.fullmatch(r"tcp://127\.0\.0\.1:\d+", ldr.endpoint)
    push = zmq.Context.instance().socket(zmq.PUSH)
    push.setsockopt(zmq.LINGER, 0)
    push.connect(ldr.endpoint)
    try:
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        push.send(pickle.dumps({"data": x, "labels": np.arange(3),
                                "class": 1, "class_lengths": [0, 3, 3]}))
        push.send(pickle.dumps({"data": x[:2], "size": 2, "last": True}))
        push.send(pickle.dumps({"end": True}))
        ldr.run()
        np.testing.assert_array_equal(ldr.minibatch_data.map_read(), x)
        assert (ldr.minibatch_class, ldr.minibatch_size) == (1, 3)
        assert ldr.class_lengths == [0, 3, 3] and not ldr.last_minibatch
        ldr.run()
        assert ldr.minibatch_size == 2 and ldr.last_minibatch
        assert ldr.epoch_ended and ldr.class_ended
        ldr.run()
        assert ldr.finished and ldr.epoch_number == 1
    finally:
        push.close(0)
        ldr.stop()
    quiet = ZeroMQLoader(Workflow(), name="quiet", recv_timeout=0.2)
    quiet.initialize(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="feeder process dead"):
            quiet.run()
    finally:
        quiet.stop()


def test_meshed_fused_slave_waits_for_a7(tmp_path):
    """The meshed slave builds (two gloo ranks on the CPU, one a process)
    and advertises its shape: the handshake carries ``{"data": 2,
    "model": 1}`` with the digest of a single-device slave, and a master
    that takes rank 0's register records it in ``slave_meshes``.  The
    meshed slave's training is ``test_torch_meshed_slave.py``'s."""
    from test_torch_meshed_slave import _mnist_master_start, spawn

    from znicz_torch.network_common import handshake_request
    from znicz_torch.server import Server

    wf = _mnist_master_start(tmp_path)
    ranks = spawn(tmp_path, (2, 1), "tcp://127.0.0.1:1", "pod",
                  build_only=True)
    want = {"data": 2, "model": 1}
    for r in ranks:
        assert r["mesh_shape"] == want and r["handshake"]["mesh"] == want
        assert r["handshake"]["workflow_digest"] == handshake_request(
            wf)["workflow_digest"]
    server = Server(wf)
    assert server._handle(dict(ranks[0]["handshake"], id="pod"))["ok"]
    assert server.slave_meshes == {"pod": want}


MNIST_TINY = ["root.mnist.loader.n_train=300", "root.mnist.loader.n_valid=60",
              "root.mnist.loader.minibatch_size=60",
              "root.mnist.decision.max_epochs=2"]


@pytest.mark.parametrize("argv", [
    ["mnist", "--master", "--slave", "tcp://127.0.0.1:1"],
    ["mnist", "--master-resume", "f.pkl", "--slave", "tcp://127.0.0.1:1"],
    ["mnist", "--serve", "--master"],
    ["mnist", "--serve", "--slave", "tcp://127.0.0.1:1"],
    ["--balance", "--master"],
    ["mnist", "--aot-cache"]])
def test_cli_role_exclusions_exit_2(argv):
    from znicz_torch.__main__ import main

    assert main(argv) == 2


def test_cli_master_and_slave_train(tmp_path):
    """``--master`` prints its resolved endpoint; a ``--slave`` process
    pointed there trains the run; both exit 0, and the master's last
    line carries the run's finals."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    over = MNIST_TINY + [f"root.common.dirs.snapshots={tmp_path}"]
    log = open(tmp_path / "master.log", "w")
    master = subprocess.Popen(
        [sys.executable, "-m", "znicz_torch", "mnist", "--device", "cpu",
         *over, "--master"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=log, text=True)
    slave = None
    try:
        line = master.stdout.readline()
        m = re.search(r"master serving \S+ at (tcp://127\.0\.0\.1:\d+)", line)
        assert m, line
        slave = subprocess.run(
            [sys.executable, "-m", "znicz_torch", "mnist", "--device",
             "cpu", *over, "--slave", m.group(1)], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=600)
        assert slave.returncode == 0, slave.stderr[-3000:]
        out, _ = master.communicate(timeout=600)
        assert master.returncode == 0
        import json

        last = json.loads(out.strip().splitlines()[-1])
        assert last["epochs"] == 2 and last["valid_err_pct"] < 70.0
        assert last["train_steps"] > 0
    finally:
        log.close()
        if master.poll() is None:
            master.kill()
            master.wait()
