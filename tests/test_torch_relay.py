"""The port's relay tree (``znicz_torch/parallel/relay.py``, the Server's
tree parts, the slave's fallback and rehome, ``RelayHarness`` and
``SubtreePreempter``, ``--relay`` and ``--plan-tree``) against the
reference's ``tests/test_relay.py`` (every case the star's file did not
take) and the tree cases of ``tests/test_elastic.py``, and against the
reference's own relay, master and slaves:

  - the planner and the ``--relay`` spec equal the reference's; batched
    job fetches; LR schedules evaluated at dispatch and applied by the
    slaves; a contribution through a relay hop byte for byte; refusals
    at the edge and the master's books per contributor (quarantine,
    malformed metrics, staleness, a resent flush); child eviction; a
    one-level tree trains and accounts per leaf; a dead relay's children
    fall back upstream, an orphan follows ``rehome``, a relay re-homes
    one rung up; the re-planner; the preemption timetable; the soaks
    (``slow``, as in the reference); the ``web_status`` panels are left
    out (ROADMAP A.9);
  - across packages: the port's flush is the reference relay's byte for
    byte on the float32 and int8 wires, a port relay trains between the
    reference's master and slaves and the reference's relay between the
    port's, and one slave through a port relay leaves the master's tree
    within ``PAIR_RTOL`` of the reference's star pairing.

Every socket binds ``tcp://127.0.0.1:*``; tests wait by polling state
with generous budgets, never on a wall-clock bound."""

import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_master_slave import (BUDGET, PAIR_ATOL, PAIR_RTOL, REPO,
                                     _assert_params, _delta,
                                     _handshake_fields, _jax_server_endpoint,
                                     _jax_workflow, _join, _make_workflow,
                                     _mnist_config, _params, _run_slaves,
                                     _shapes, _wait)

assert _mnist_config                    # the autouse config fixture

ANY = "tcp://127.0.0.1:*"
_UNSET = object()


@pytest.fixture(autouse=True)
def _tree_knobs():
    """The engine knobs the CLI and the tests set, in both config trees,
    put back after each test (an unset one deleted again)."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    keys = ("tree_fanout", "relay_flush_s", "relay_child_ttl",
            "elastic_rehome", "staleness_bound", "min_slaves")
    saved = [(tree, k, tree.common.engine.get(k, _UNSET))
             for tree in (troot, jroot) for k in keys]
    try:
        yield
    finally:
        for tree, k, v in saved:
            if v is _UNSET:
                if k in tree.common.engine:
                    delattr(tree.common.engine, k)
            else:
                setattr(tree.common.engine, k, v)


#: the reference's fast-failing slave knobs of its tree tests
FAST = dict(recv_timeout=0.75, max_reconnects=2, backoff_base=0.05,
            backoff_cap=0.2)
PATIENT = dict(recv_timeout=1.0, max_reconnects=60, backoff_base=0.05,
               backoff_cap=0.3, connect_retries=60)


def _white_box(pkg="torch", n_children=3, fanout=3, **kwargs):
    """A relay used without sockets: credentials already validated, and
    enough registered children that the test's buffered messages never
    cross the flush threshold (there is no upstream to flush into)."""
    if pkg == "torch":
        from znicz_torch.parallel.relay import Relay
    else:
        from znicz_tpu.parallel.relay import Relay

    kwargs.setdefault("flush_s", 999.0)
    relay = Relay("tcp://127.0.0.1:1", "tcp://127.0.0.1:2",
                  relay_id="wb-relay", fanout=fanout, **kwargs)
    relay._cred = (3, "cafebabecafebabe")
    now = time.time()
    for i in range(n_children):
        relay._children[f"s{i}"] = now
    return relay


def _register_relay(server, wf, rid="r", bind="tcp://127.0.0.1:9"):
    return server._handle({"cmd": "register", "id": rid, "relay": True,
                           "bind": bind, **_handshake_fields(wf)})


def _attach_lr_schedule(wf, gamma=0.5):
    from znicz_torch.lr_adjust import ExpPolicy, LearningRateAdjust

    adj = LearningRateAdjust(wf, name="lr_adjust")
    for gd in wf.gd_units:
        adj.add_gd(gd, ExpPolicy(gamma=gamma))
    return adj


def _jax_relay_endpoint(relay):
    """The reference relay's resolved address once it is bound."""
    import zmq

    _wait(lambda: relay._transport is not None, "the reference relay bound")
    sock = relay._transport._entries[0].sock
    return sock.getsockopt(zmq.LAST_ENDPOINT).decode()


# -- the planner, the spec, the CLI ------------------------------------------------


def test_plan_tree_and_relay_spec_equal_the_reference(capsys):
    from znicz_torch.__main__ import main
    from znicz_torch.parallel.relay import parse_relay_spec, plan_tree
    from znicz_tpu import launcher
    from znicz_tpu.parallel import relay as jrelay

    master = "tcp://127.0.0.1:5570"
    for n in (1, 2, 3, 4, 5, 8, 9, 17, 64):
        for fanout in (2, 3, 4):
            assert plan_tree(n, fanout, master, base_port=17000) == \
                jrelay.plan_tree(n, fanout, master, base_port=17000)
    p = plan_tree(8, 2, master)
    assert p["levels"] == 2 and len(p["relays"]) == 6
    assert [r["upstream"] for r in p["relays"][:2]] == [master] * 2
    assert plan_tree(1, 2, master) == {
        "relays": [], "slave_endpoints": [master], "levels": 0}
    for spec in ("tcp://h:5570", "tcp://h:5570:5599",
                 "tcp://h:5570:tcp://*:9", "tcp://10.0.0.2:1:tcp://h:2"):
        assert parse_relay_spec(spec) == jrelay.parse_relay_spec(spec)
    with pytest.raises(ValueError, match="--relay spec"):
        parse_relay_spec("not-an-endpoint")
    with pytest.raises(ValueError, match="fanout"):
        plan_tree(4, 1, master)
    # --plan-tree prints the reference launcher's document
    argv = ["--plan-tree", "5", "--tree-fanout", "2", "--master",
            "tcp://h:5570"]
    capsys.readouterr()
    assert launcher.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv) == 0
    assert json.loads(capsys.readouterr().out) == want
    assert want["relay_args"][0] == "tcp://h:5570:tcp://127.0.0.1:15700"
    for argv in (["--relay", "tcp://h:5570", "--master"],
                 ["--relay", "tcp://h:5570", "--slave", "tcp://h:1"],
                 ["--relay", "tcp://h:5570", "--serve"],
                 ["--relay", "tcp://h:5570", "--balance"],
                 ["--relay", "not-an-endpoint"],
                 ["--relay", "tcp://h:5570", "mnist"],
                 ["--plan-tree", "4", "--tree-fanout", "1"],
                 ["--plan-tree", "4", "--master", "tcp://127.0.0.1:*"]):
        assert main(argv) == 2, argv


def test_job_batch_request(tmp_path):
    """``{"cmd": "job", "count": k}`` returns up to k jobs under one
    params broadcast; a count-less request keeps the flat reply."""
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    assert _register_relay(server, wf, "r1")["ok"]
    assert "r1" in server.relays
    rep = server._handle({"cmd": "job", "id": "r1", "count": 3})
    assert "jobs" in rep and "params" in rep and len(rep["jobs"]) == 3
    assert len(server._inflight) == 3
    assert len({e["job_id"] for e in rep["jobs"]}) == 3
    for e in rep["jobs"]:
        assert "job" in e and "trace_id" in e and "train" in e
        assert "params" not in e
    flat = server._handle({"cmd": "job", "id": "r1"})
    assert "job" in flat and "params" in flat and "jobs" not in flat


# -- LR schedules under master and slaves -------------------------------------------


def test_lr_schedule_evaluated_at_dispatch(tmp_path):
    """The master stamps each TRAIN minibatch with its scheduled (lr,
    lr_bias): minibatch k at pol(base, k - 1); eval minibatches carry no
    stamp and do not advance the clock, which a resume keeps."""
    from znicz_torch.loader.base import TRAIN
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    _attach_lr_schedule(wf, gamma=0.5)
    gd = wf.gd_units[0]
    base = float(gd.learning_rate)
    server = Server(wf)
    assert server._handle({"cmd": "register", "id": "s1",
                           **_handshake_fields(wf)})["ok"]
    seen = []
    for _ in range(8):
        rep = server._handle({"cmd": "job", "id": "s1"})
        job = rep["job"]
        if job["class"] == TRAIN:
            seen.append(job["hypers"][gd.forward.name][0])
        else:
            assert "hypers" not in job
        server._handle({"cmd": "update", "id": "s1",
                        "job_id": rep["job_id"], "deltas": None,
                        "metrics": {"loss": 1.0, "n_err": 0}})
    assert seen == pytest.approx(
        [base] + [base * 0.5 ** k for k in range(len(seen) - 1)])
    assert server._lr_iteration == len(seen)
    path = str(tmp_path / "resume.pickle")
    server.save_resume(path)
    server2 = Server(_make_workflow(tmp_path / "m2"), resume_path=path)
    assert server2._lr_iteration == server._lr_iteration


def test_scheduled_hypers_rows_and_unit_slave_application(tmp_path):
    """The fused rows take exactly (lr, lr_bias) a step from the stamp,
    and the unit slave writes the stamped rates into its GD units before
    they run."""
    from znicz_torch.client import Client, scheduled_hypers_rows
    from znicz_torch.loader.base import TRAIN

    base = {"fc1": tuple(np.float32(v) for v in
                         (0.1, 0.2, 0.0, 0.0, 0.0, 0.9, 0.9, 0.0))}
    rows = scheduled_hypers_rows(base, [{"hypers": {"fc1": (0.05, 0.07)}},
                                        {}])
    assert rows["fc1"].shape == (2, 8)
    assert rows["fc1"][0, :2].tolist() == [np.float32(0.05),
                                          np.float32(0.07)]
    np.testing.assert_array_equal(rows["fc1"][0, 2:],
                                  np.asarray(base["fc1"][2:], np.float32))
    np.testing.assert_array_equal(rows["fc1"][1],
                                  np.asarray(base["fc1"], np.float32))
    wf = _make_workflow(tmp_path / "s")
    client = Client(wf, slave_id="lr-unit")
    gd = wf.gd_units[0]
    client._run_one({"indices": np.zeros(60, np.int32), "size": 60,
                     "class": TRAIN,
                     "hypers": {gd.forward.name: (0.0125, 0.025)}},
                    train=True)
    assert gd.learning_rate == pytest.approx(0.0125)
    assert gd.learning_rate_bias == pytest.approx(0.025)


def test_lr_schedule_advances_end_to_end(tmp_path):
    """One unit slave through the sockets: after 2 epochs under an exp
    schedule its GD units hold the master's last scheduled rate."""
    from znicz_torch.client import Client
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m", max_epochs=2)
    _attach_lr_schedule(wf, gamma=0.9)
    base = float(wf.gd_units[0].learning_rate)
    server = Server(wf, job_timeout=60.0).start()
    slave = Client(_make_workflow(tmp_path / "s", max_epochs=2),
                   endpoint=server.endpoint, slave_id="lr-slave")
    slave.run()
    assert server.join(BUDGET) and bool(wf.decision.complete)
    # 2 epochs x 5 TRAIN minibatches: the last dispatched at pol(base, 8)
    assert server._lr_iteration == 10
    assert slave.workflow.gd_units[0].learning_rate == \
        pytest.approx(base * 0.9 ** 8)


# -- a contribution through the relay hop ---------------------------------------------


def _deltas(seed=17):
    rng = np.random.default_rng(seed)
    return {"fc1": {"weights": rng.normal(0, 0.01, (32, 16)).astype(
        np.float32), "bias": rng.normal(0, 0.01, 16).astype(np.float32)}}


def test_codec_byte_identity_through_relay_hop():
    """float32 wire: one contribution leaves the flush as the same tensor
    bytes, and the flush encodes the same twice (a resend sends the same
    bytes); int8: two relays fed alike flush the same bytes, the sum
    within one quantization step."""
    from znicz_torch.parallel import wire

    deltas = _deltas()
    relay = _white_box(wire_dtype="float32")
    assert relay._child_update({"cmd": "update", "id": "s0", "job_id": 7,
                                "deltas": deltas,
                                "metrics": {"loss": 1.0}}, "s0")["ok"]
    entries, summed = list(relay._buffer), dict(relay._sum)
    flush1, _ = wire.encode_message(relay._flush_message(entries, summed))
    flush2, _ = wire.encode_message(relay._flush_message(entries, summed))
    assert [bytes(f) for f in flush1] == [bytes(f) for f in flush2]
    child, _ = wire.encode_message({"cmd": "update", "id": "s0",
                                    "job_id": 7, "deltas": deltas,
                                    "metrics": {"loss": 1.0}})
    assert [bytes(f) for f in flush1[1:]] == [bytes(f) for f in child[1:]]
    dec, _ = wire.decode_message(flush1)
    np.testing.assert_array_equal(dec["deltas"]["fc1"]["weights"],
                                  deltas["fc1"]["weights"])
    assert dec["contributors"][0]["job_id"] == 7
    assert dec["contributors"][0]["delta"] is True
    flushes = []
    for _ in range(2):
        r = _white_box(wire_dtype="int8")
        for jid, sid in ((1, "s0"), (2, "s1")):
            assert r._child_update({"cmd": "update", "id": sid,
                                    "job_id": jid, "deltas": deltas,
                                    "metrics": {"loss": 1.0}}, sid)["ok"]
        frames, _ = wire.encode_message(
            r._flush_message(list(r._buffer), dict(r._sum)))
        flushes.append([bytes(f) for f in frames])
    assert flushes[0] == flushes[1]
    dec, _ = wire.decode_message(flushes[0])
    want = 2.0 * deltas["fc1"]["weights"]
    scale = float(np.max(np.abs(want))) / 127.0
    assert float(np.max(np.abs(dec["deltas"]["fc1"]["weights"] - want))) \
        <= scale + 1e-7


@pytest.mark.parametrize("wire_dtype", ["float32", "int8"])
def test_flush_bytes_equal_the_reference(wire_dtype):
    """The port's flush of the same child updates under the same relay id
    is the reference relay's, byte for byte, over two flush windows (the
    int8 relay's error-feedback residuals carry into the second)."""
    from znicz_torch.parallel import wire
    from znicz_tpu.parallel import wire as jwire

    got, want = [], []
    for pkg, codec, out in (("torch", wire, got), ("jax", jwire, want)):
        relay = _white_box(pkg, n_children=5, fanout=5,
                           wire_dtype=wire_dtype)
        for window in range(2):
            for i, sid in enumerate(("s0", "s1", "s2")):
                rep = relay._child_update(
                    {"cmd": "update", "id": sid, "job_id": 10 * window + i,
                     "trace_id": f"t-{window}-{i}", "step": window,
                     "deltas": _deltas(window * 3 + i),
                     "metrics": {"loss": 0.5 + i, "n_err": i}}, sid)
                assert rep["ok"]
            relay._buffer.append({"id": "e", "job_id": 99,
                                  "metrics": {"loss": 2.0}})
            assert len(relay._buffer) == 4 and relay.flushes == 0
            frames, _ = codec.encode_message(relay._flush_message(
                list(relay._buffer), dict(relay._sum)))
            out.append([bytes(f) for f in frames])
            relay._buffer, relay._buffer_msgs = [], 0
            relay._sum, relay._sum_t0 = {}, None
    assert got == want


# -- refusals at the edge, the master's books per contributor ------------------------


def test_edge_quarantine_and_master_requeue(tmp_path):
    """A poisoned child is refused at the relay (the sum stays clean) and
    the refusal rides the manifest: the master counts it quarantined,
    re-queues its job, applies the healthy sibling's delta and credits
    the leaf; an exploded sum re-queues every contributor; a stale
    contributor is dropped; a resent flush lands once."""
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    assert _register_relay(server, wf, "wb-relay")["ok"]
    rep = server._handle({"cmd": "job", "id": "wb-relay", "count": 2})
    jid_a, jid_b = (e["job_id"] for e in rep["jobs"])
    relay = _white_box()
    shapes = _shapes(wf)
    poisoned = _delta(shapes, np.nan)
    healthy = _delta(shapes, 1e-4)
    rep = relay._child_update({"cmd": "update", "id": "s0",
                               "job_id": jid_a, "deltas": poisoned,
                               "metrics": {"loss": 1.0}}, "s0")
    assert rep["ok"] is False and rep.get("quarantined")
    assert "non-finite" in rep["error"] and relay.refusals == 1
    assert not relay._sum
    assert relay._child_update({"cmd": "update", "id": "s1",
                                "job_id": jid_b, "deltas": healthy,
                                "metrics": {"loss": 1.0, "n_err": 0}},
                               "s1")["ok"] is True
    before = _params(wf)
    up = server._handle(dict(
        relay._flush_message(list(relay._buffer), dict(relay._sum)),
        cmd="update", id="wb-relay"))
    assert up["ok"] is True
    assert up["outcomes"] == {jid_a: "quarantined", jid_b: "ok"}
    assert (server.quarantined_updates, server.aggregated_updates,
            server.jobs_done) == (1, 1, 1)
    assert len(server._pending) == 1 and server.jobs_by_slave == {"s1": 1}
    _assert_params(wf, {n: {k: before[n][k] + healthy[n][k] for k in layer}
                        for n, layer in before.items()})
    # an exploded sum: neither contributor's input may land
    server._delta_norms.extend([1e-4] * 5)
    rep = server._handle({"cmd": "job", "id": "wb-relay", "count": 2})
    jids = [e["job_id"] for e in rep["jobs"]]
    before = _params(wf)
    up = server._handle({
        "cmd": "update", "id": "wb-relay", "deltas": _delta(shapes, 1e5),
        "contributors": [{"id": f"s{i}", "job_id": jids[i], "delta": True,
                          "metrics": {"loss": 1.0, "n_err": 0}}
                         for i in range(2)]})
    assert up["ok"] is False and up.get("quarantined")
    assert server.quarantined_updates == 3 and len(server._pending) == 2
    for n, layer in _params(wf).items():
        for k, v in layer.items():
            np.testing.assert_array_equal(v, before[n][k])
    up = server._handle({
        "cmd": "update", "id": "wb-relay", "deltas": None,
        "contributors": [{"id": "s0", "job_id": 99999,
                          "metrics": {"loss": 1.0, "n_err": 0}}]})
    assert up["ok"] is True and up["outcomes"][99999] == "stale"
    assert server.stale_updates == 1
    # a resend of the same flush: every contributor stale, nothing lands
    server._delta_norms.clear()
    rep = server._handle({"cmd": "job", "id": "wb-relay"})
    flush = {"cmd": "update", "id": "wb-relay", "deltas": healthy,
             "contributors": [{"id": "s0", "job_id": rep["job_id"],
                               "delta": True,
                               "metrics": {"loss": 1.0, "n_err": 0}}]}
    assert server._handle(dict(flush))["ok"] is True
    after = _params(wf)
    resent = server._handle(dict(flush))
    assert resent["ok"] is True
    assert resent["outcomes"][rep["job_id"]] == "stale"
    for n, layer in _params(wf).items():
        for k, v in layer.items():
            np.testing.assert_array_equal(v, after[n][k])
    # a manifest that is not a list of dicts is a bad frame: nothing lost
    n_inflight = len(server._inflight)
    with pytest.raises(ValueError, match="manifest"):
        server._handle({"cmd": "update", "id": "wb-relay",
                        "contributors": "garbage", "deltas": None})
    assert len(server._inflight) == n_inflight


def test_malformed_metrics_aborts_indivisible_aggregate(tmp_path):
    """A contributor with a delta and malformed metrics cannot be refused
    alone (its gradient is in the sum): the whole aggregate is refused,
    the malformed child takes its strike, the sibling is re-queued with
    none, and nothing lands."""
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf)
    assert _register_relay(server, wf)["ok"]
    rep = server._handle({"cmd": "job", "id": "r", "count": 2})
    jid_a, jid_b = (e["job_id"] for e in rep["jobs"])
    before = _params(wf)
    up = server._handle({
        "cmd": "update", "id": "r", "deltas": _delta(_shapes(wf), 2e-4),
        "contributors": [
            {"id": "s0", "job_id": jid_a, "delta": True,
             "metrics": [{"loss": 1.0}]},
            {"id": "s1", "job_id": jid_b, "delta": True,
             "metrics": {"loss": 1.0, "n_err": 0}}]})
    assert up["ok"] is False and "not a dict" in up["error"]
    assert up["outcomes"] == {jid_a: "refused", jid_b: "requeued"}
    assert (server.bad_updates, server.jobs_requeued, server.jobs_done) \
        == (1, 1, 0)
    assert len(server._pending) == 2
    assert [j.get("_bad_replies") for j in server._pending] == [1, None]
    for n, layer in _params(wf).items():
        for k, v in layer.items():
            np.testing.assert_array_equal(v, before[n][k])
    assert server.jobs_ledger()["balanced"]


def test_edge_shape_check_survives_flush_windows_and_spares_evals():
    """(a) shapes learned from the first accepted delta outlive the flush
    window, so a wrong-shaped child arriving first later is refused
    itself; (b) a refused aggregate's delta-less contributors pass; (c)
    an undelivered flush is not counted."""
    good = {"fc": {"w": np.full((4, 3), 1e-3, np.float32)}}
    relay = _white_box()
    assert relay._child_update({"cmd": "update", "id": "s0", "job_id": 1,
                                "deltas": good,
                                "metrics": {"loss": 1.0}}, "s0")["ok"]
    relay._buffer, relay._buffer_msgs = [], 0
    relay._sum, relay._sum_t0 = {}, None
    rep = relay._child_update(
        {"cmd": "update", "id": "s1", "job_id": 2,
         "deltas": {"fc": {"w": np.full((2, 2), 1e-3, np.float32)}},
         "metrics": {"loss": 1.0}}, "s1")
    assert rep["ok"] is False and "shape" in rep["error"]
    assert not relay._sum
    assert relay._child_update({"cmd": "update", "id": "s2", "job_id": 3,
                                "deltas": good,
                                "metrics": {"loss": 1.0}}, "s2")["ok"]
    relay2 = _white_box()
    rep = relay2._child_update({
        "cmd": "update", "id": "low-relay",
        "deltas": {"fc": {"w": np.full((4, 3), np.nan, np.float32)}},
        "contributors": [
            {"id": "a", "job_id": 10, "delta": True,
             "metrics": {"loss": 1.0}},
            {"id": "b", "job_id": 11,
             "metrics": {"loss": 0.5, "n_err": 2}}]}, "low-relay")
    assert rep["ok"] is False and rep.get("quarantined")
    by_jid = {e["job_id"]: e for e in relay2._buffer}
    assert "non-finite" in by_jid[10]["refused"]
    assert "refused" not in by_jid[11]
    assert by_jid[11]["metrics"] == {"loss": 0.5, "n_err": 2}
    assert relay2.refusals == 1 and relay2.contributions == 1
    relay3 = _white_box()
    relay3._stop.set()
    relay3._buffer, relay3._buffer_msgs = [{"id": "x", "job_id": 1}], 1
    relay3._flush()
    assert relay3.flushes == 0


def test_relay_child_ttl_eviction():
    """A child silent past ``child_ttl`` leaves the table (at most one
    sweep a second), and the flush threshold follows the live
    membership."""
    relay = _white_box(n_children=2, fanout=2, child_ttl=0.1)
    relay._children["s0"] = time.time() - 1.0
    relay._evict_children()
    assert set(relay.children) == {"s1"}
    relay._buffer.append({"id": "s1", "job_id": 1})
    relay._buffer_msgs = 1
    assert relay._flush_due()
    relay._children["ghost"] = time.time() - 9.0
    relay._evict_children()
    assert "ghost" in relay.children
    relay._last_evict = 0.0
    relay._evict_children()
    assert "ghost" not in relay.children


def test_knobs_set_the_relay_and_the_master(tmp_path):
    """The four tree knobs are read: ``tree_fanout``, ``relay_flush_s``,
    ``relay_child_ttl`` set a relay's defaults, ``elastic_rehome`` the
    master's."""
    from znicz_torch.core.config import root
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server

    eng = root.common.engine
    eng.tree_fanout, eng.relay_flush_s, eng.relay_child_ttl = 4, 0.5, 7.0
    eng.elastic_rehome = True
    relay = Relay("tcp://127.0.0.1:1", ANY)
    assert (relay.fanout, relay.flush_s, relay.child_ttl) == (4, 0.5, 7.0)
    assert re.fullmatch(r"relay-[0-9a-f]{8}", relay.relay_id)
    assert Server(_make_workflow(tmp_path / "m")).elastic_rehome is True


# -- the tree trains -------------------------------------------------------------------


def test_one_level_tree_trains_and_accounts(tmp_path):
    """2 slaves -> 1 relay -> the master: training completes in the
    band, the master decodes fewer update messages than jobs, and the
    books are kept on the leaf ids."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m"), job_timeout=60.0).start()
    relay = Relay(server.endpoint, ANY, relay_id="t1-relay").start()
    assert re.fullmatch(r"tcp://127\.0\.0\.1:\d+", relay.endpoint)
    slaves = [Client(_make_workflow(tmp_path / f"s{i}"),
                     endpoint=relay.endpoint, slave_id=f"leaf{i}")
              for i in range(2)]
    try:
        threads, errors = _run_slaves(slaves)
        assert server.join(BUDGET)
        _join(threads, errors)
    finally:
        relay.stop()
    dec = server.workflow.decision
    assert bool(dec.complete)
    assert dec.epoch_metrics[1]["err_pct"] < 70.0
    assert server.aggregated_updates >= 1
    assert server.updates_received < server.jobs_done
    assert set(server.jobs_by_slave) == {"leaf0", "leaf1"}
    assert all(n > 0 for n in server.jobs_by_slave.values())
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert server.jobs_ledger()["balanced"]
    assert "t1-relay" in server.relays
    assert server.relay_binds["t1-relay"] == relay.endpoint
    assert server.tree_plan["relays"][0]["id"] == "t1-relay"
    assert relay.flushes >= 1 and relay.contributions >= server.jobs_done
    stats = relay.stats()
    assert {c["id"] for c in stats["children"]} == {"leaf0", "leaf1"}
    assert stats["leaves"] == 2 and stats["complete"]
    assert stats["bytes_in"] > 0 and stats["bytes_out"] > 0


def test_relay_death_children_fall_back_upstream(tmp_path):
    """A relay killed mid-run: its in-flight work comes back through the
    master's reaper, and the children, their budget against the dead
    relay spent, fall back to the upstream it advertised, register there
    and finish the run."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.chaos import RelayHarness
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m"), job_timeout=4.0).start()
    harness = RelayHarness(server.endpoint, ANY, relay_id="doomed-relay")
    harness.start()
    assert harness.endpoint != ANY
    slaves = [Client(_make_workflow(tmp_path / f"s{i}"),
                     endpoint=harness.endpoint, slave_id=f"phx{i}")
              for i in range(2)]
    threads, errors = _run_slaves(slaves, **FAST)
    _wait(lambda: server.jobs_done >= 2, "two jobs done through the relay")
    harness.kill()
    assert harness.kills == 1
    assert server.join(BUDGET)
    _join(threads, errors)
    dec = server.workflow.decision
    assert bool(dec.complete) and dec.epoch_metrics[1]["err_pct"] < 70.0
    for s in slaves:
        assert s.endpoint == server.endpoint and s.reconnects >= 1
    assert set(server.jobs_by_slave) <= {"phx0", "phx1"}
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert server.jobs_ledger()["balanced"]


def test_fused_slaves_through_relay_with_lr_schedule(tmp_path):
    """A FusedClient through a relay under the master's LR schedule:
    segment jobs, the scheduled rows, aggregation and the books
    compose."""
    from znicz_torch.client import FusedClient
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    _attach_lr_schedule(wf, gamma=0.9)
    server = Server(wf, job_timeout=60.0, segment_steps=3).start()
    relay = Relay(server.endpoint, ANY, relay_id="f-relay").start()
    slave = FusedClient(_make_workflow(tmp_path / "s"),
                        endpoint=relay.endpoint, slave_id="fused-leaf")
    try:
        slave.run()
        assert server.join(BUDGET)
    finally:
        relay.stop()
    assert bool(wf.decision.complete)
    assert wf.decision.epoch_metrics[1]["err_pct"] < 70.0
    assert server._lr_iteration == 15
    assert server.aggregated_updates >= 1
    assert server.jobs_by_slave.get("fused-leaf", 0) > 0
    assert server.jobs_done == sum(server.jobs_by_slave.values())


@pytest.mark.slow
def test_two_level_tree_chaos_soak(tmp_path):
    """A two-level tree under a seeded ChaosProxy on the mid relay's
    upstream link, a leaf relay killed and restarted at the same address
    mid-run, 4 slaves: training completes in the band with the books on
    the leaf ids."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.chaos import (ChaosProxy, FaultSchedule,
                                            RelayHarness)
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m", max_epochs=4),
                    job_timeout=6.0).start(linger=8.0)
    proxy = ChaosProxy(ANY, server.endpoint,
                       FaultSchedule(5, drop=0.05, corrupt=0.05,
                                     duplicate=0.04, delay=0.06,
                                     delay_s=(0.02, 0.2))).start()
    mid = Relay(proxy.front_endpoint, ANY, relay_id="soak-mid",
                recv_timeout=1.0, max_reconnects=60).start()
    leaf_a = RelayHarness(mid.endpoint, ANY, relay_id="soak-leaf-a",
                          recv_timeout=2.0, max_reconnects=60)
    leaf_a.start()
    leaf_b = Relay(mid.endpoint, ANY, relay_id="soak-leaf-b",
                   recv_timeout=2.0, max_reconnects=60).start()
    slaves = [Client(_make_workflow(tmp_path / f"s{i}", max_epochs=4),
                     endpoint=(leaf_a.endpoint if i < 2
                               else leaf_b.endpoint),
                     slave_id=f"soak{i}") for i in range(4)]
    try:
        threads, errors = _run_slaves(
            slaves, recv_timeout=1.0, max_reconnects=80, backoff_base=0.05,
            backoff_cap=0.4, connect_retries=80)
        _wait(lambda: server.jobs_done >= 4, "four jobs done")
        leaf_a.restart()
        assert server.join(300)
        _join(threads, errors)
    finally:
        proxy.stop()
        mid.stop()
        leaf_a.kill()
        leaf_b.stop()
    dec = server.workflow.decision
    assert bool(dec.complete) and dec.epoch_metrics[1]["err_pct"] < 70.0
    assert proxy.total_faults() > 0
    assert server.aggregated_updates >= 1
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert set(server.jobs_by_slave) <= {f"soak{i}" for i in range(4)}


# -- elastic: staleness, the quorum, the re-planner, rehoming, preemption ---------------


def test_staleness_boundary_tree_aborts_indivisible_aggregate(tmp_path):
    """Through a manifest: a contributor at the bound applies; one past it
    makes the whole aggregate refused (it re-queues under
    ``stale_refused``, its fresh siblings under ``jobs_requeued``, no
    strike), and the books stay balanced; the staleness windows saw each
    entry's ``step``."""
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    shapes = _shapes(wf)
    server = Server(wf, staleness_bound=1)
    assert _register_relay(server, wf)["ok"]
    rep = server._handle({"cmd": "job", "id": "r", "count": 5})
    jids = [e["job_id"] for e in rep["jobs"]]
    assert all(e["step"] == 0 for e in rep["jobs"])

    def agg(contributors, deltas):
        return server._handle({"cmd": "update", "id": "r", "deltas": deltas,
                               "contributors": contributors})

    m = {"loss": 1.0, "n_err": 0}
    assert agg([{"id": "a", "job_id": jids[0], "delta": True, "step": 0,
                 "metrics": m}], _delta(shapes))["ok"]
    assert server.apply_step == 1
    assert agg([{"id": "b", "job_id": jids[1], "delta": True, "step": 0,
                 "metrics": m}], _delta(shapes))["ok"]
    assert server.apply_step == 2
    before = _params(wf)
    rep = agg([{"id": "c", "job_id": jids[2], "delta": True, "step": 0,
                "metrics": m},
               {"id": "d", "job_id": jids[3], "delta": True, "step": 2,
                "metrics": m},
               {"id": "e", "job_id": jids[4], "metrics": m}],
              _delta(shapes))
    assert rep["ok"] is False and rep.get("stale_refused")
    assert rep["outcomes"] == {jids[2]: "stale_refused",
                               jids[3]: "requeued", jids[4]: "requeued"}
    assert (server.stale_refused, server.jobs_requeued,
            server.apply_step) == (1, 2, 2)
    _assert_params(wf, before)
    assert len(server._pending) == 3
    assert all("_bad_replies" not in j for j in server._pending)
    ledger = server.jobs_ledger()
    assert ledger["balanced"] and ledger["dispatched"] == 5, ledger
    summary = server.staleness_summary()
    assert summary["c"]["max"] == 2 and summary["d"]["max"] == 0


def test_relay_leaves_count_in_the_quorum_past_the_rate_limit(tmp_path):
    """A relay's ``leaves`` report counts in the quorum (a preempted
    subtree shrinks it as soon as the relay reports fewer), and is read
    before the ingress rate limit: a throttled relay's refused request
    still refreshes it."""
    from znicz_torch.core.config import root
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    eng = root.common.engine
    saved = (eng.get("ingress_rate_limit", 0.0),
             eng.get("ingress_rate_burst", 0.0))
    try:
        eng.ingress_rate_limit, eng.ingress_rate_burst = 0.001, 1.0
        server = Server(wf, min_slaves=3)
    finally:
        eng.ingress_rate_limit, eng.ingress_rate_burst = saved
    assert _register_relay(server, wf, "r1")["ok"]
    assert server.member_count() == 0
    rep = server._handle({"cmd": "job", "id": "r1", "count": 2,
                          "leaves": 2})
    assert rep.get("degraded") and server.member_count() == 2
    rep = server._handle({"cmd": "job", "id": "r1", "count": 2,
                          "leaves": 3})
    assert rep.get("rate_limited") and server.member_count() == 3
    assert server.quorum_met() and not server.degraded()
    server._handle({"cmd": "job", "id": "r1", "leaves": "garbage"})
    assert server.member_count() == 3
    assert server.tree_plan["relays"] == [
        {"id": "r1", "bind": "tcp://127.0.0.1:9", "leaves": 0}]


def test_replan_and_orphan_leaf_rehoming(tmp_path):
    """Relay joins and TTL evictions re-plan the tree; with
    ``elastic_rehome`` an orphan leaf registering here is handed a
    recently seen relay's endpoint, round-robin, never a stale one."""
    from znicz_torch.server import Server

    wf = _make_workflow(tmp_path / "m")
    server = Server(wf, elastic_rehome=True, slave_ttl=60.0)
    hs = _handshake_fields(wf)
    b1, b2 = "tcp://127.0.0.1:21001", "tcp://127.0.0.1:21002"
    assert _register_relay(server, wf, "r1", b1)["ok"]
    assert server.replans == 1
    assert _register_relay(server, wf, "r2", b2)["ok"]
    assert server.replans == 2
    assert [r["id"] for r in server.tree_plan["relays"]] == ["r1", "r2"]
    assert _register_relay(server, wf, "r2", b2)["ok"]
    assert server.replans == 2
    rep = server._handle({"cmd": "register", "id": "s1", **hs})
    assert rep["rehome"] in (b1, b2)
    assert "rehome" not in _register_relay(server, wf, "r1", b1)
    server.slaves["r1"] = time.time() - 120
    server._evict_dead_slaves()
    assert "r1" not in server.slaves and server.replans == 3
    assert server.preemptions_ridden >= 1
    assert [r["id"] for r in server.tree_plan["relays"]] == ["r2"]
    assert server._handle({"cmd": "register", "id": "s2",
                           **hs})["rehome"] == b2
    server.slaves["r2"] = time.time() - 11
    assert "rehome" not in server._handle({"cmd": "register", "id": "s3",
                                           **hs})
    path = str(tmp_path / "resume.pickle")
    server.save_resume(path)
    assert Server(_make_workflow(tmp_path / "m2"),
                  resume_path=path).replans == 3


def test_orphan_slave_follows_rehome_to_a_live_relay(tmp_path):
    """A slave that registers at a master with ``elastic_rehome`` while a
    relay lives moves under the relay, keeping the master as its
    fallback; its jobs come back through the relay's manifest."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server

    # the quorum of 2 holds dispatch until the orphan has registered here
    server = Server(_make_workflow(tmp_path / "m"), job_timeout=60.0,
                    elastic_rehome=True, min_slaves=2).start()
    relay = Relay(server.endpoint, ANY, relay_id="home").start()
    anchor = Client(_make_workflow(tmp_path / "a"), endpoint=relay.endpoint,
                    slave_id="anchor")
    orphan = Client(_make_workflow(tmp_path / "o"), endpoint=server.endpoint,
                    slave_id="orphan")
    try:
        threads, errors = _run_slaves([anchor])
        _wait(lambda: "home" in server.relays, "the relay registered")
        threads2, errors2 = _run_slaves([orphan])
        assert server.join(BUDGET)
        _join(threads + threads2, errors + errors2)
    finally:
        relay.stop()
    assert orphan.endpoint == relay.endpoint
    assert orphan._fallback_endpoint == server.endpoint
    assert set(server.jobs_by_slave) <= {"anchor", "orphan"}
    assert server.jobs_by_slave.get("orphan", 0) > 0
    assert server.aggregated_updates == server.updates_received
    assert server.jobs_ledger()["balanced"]


def test_relay_upstream_rehome_heals_tree(tmp_path):
    """A leaf relay whose mid-tier upstream dies re-homes one rung up (the
    upstream the mid relay advertised), registers again, and its subtree
    finishes the run."""
    from znicz_torch.client import Client
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m"), job_timeout=4.0).start()
    mid = Relay(server.endpoint, ANY, relay_id="heal-mid").start()
    leaf = Relay(mid.endpoint, ANY, relay_id="heal-leaf", recv_timeout=0.5,
                 max_reconnects=2).start()
    slave = Client(_make_workflow(tmp_path / "s"), endpoint=leaf.endpoint,
                   slave_id="heal-s0")
    try:
        threads, errors = _run_slaves([slave], **PATIENT)
        _wait(lambda: server.jobs_done >= 2, "two jobs done")
        mid.stop()
        assert server.join(BUDGET)
        _join(threads, errors)
    finally:
        mid.stop()
        leaf.stop()
    assert bool(server.workflow.decision.complete)
    stats = leaf.stats()
    assert stats["upstream"] == server.endpoint and stats["rehomes"] >= 1
    assert server.jobs_by_slave.get("heal-s0", 0) > 0
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert server.jobs_ledger()["balanced"], server.jobs_ledger()


def test_preempt_schedule_and_subtree_preempter():
    """The timetable is a pure function of (seed, target) on its own
    stream (the reference's, seed for seed); the preempter kills before it
    restarts each target, records wall-timed events and the kill
    window."""
    from znicz_torch.parallel.chaos import FaultSchedule, SubtreePreempter
    from znicz_tpu.parallel.chaos import FaultSchedule as JSchedule
    from znicz_tpu.parallel.chaos import SubtreePreempter as JPreempter

    a = FaultSchedule(9, drop=0.1)
    assert [a.decide_preempt(i) for i in range(8)] == \
        [JSchedule(9, drop=0.1).decide_preempt(i) for i in range(8)]
    assert FaultSchedule(10).decide_preempt(0) != a.decide_preempt(0)
    assert a.decisions(16) == FaultSchedule(9, drop=0.1).decisions(16)
    log, lock = [], threading.Lock()

    def act(kind, i):
        with lock:
            log.append((kind, i))

    targets = [(f"t{i}", (lambda i=i: act("kill", i)),
                (lambda i=i: act("restart", i))) for i in range(2)]
    kw = dict(kill_s=(0.01, 0.05), down_s=(0.02, 0.08))
    pre = SubtreePreempter(FaultSchedule(3), targets, **kw)
    assert [t[:3] for t in pre.timetable] == [
        t[:3] for t in JPreempter(JSchedule(3), targets, **kw).timetable]
    assert pre.window() is None
    pre.start()
    assert pre.join(60)
    assert pre.preemptions == 2
    assert sorted(log) == [("kill", 0), ("kill", 1), ("restart", 0),
                           ("restart", 1)]
    for i in range(2):
        assert log.index(("kill", i)) < log.index(("restart", i))
    events = pre.events
    assert len(events) == 4
    lo, hi = pre.window()
    assert lo <= hi
    assert lo == min(t for t, _, act_ in events if act_ == "kill")
    pre.stop()


@pytest.mark.slow
def test_preemption_soak_rides_out_subtree_kill(tmp_path):
    """A seeded SubtreePreempter kills a relay and its two slaves mid-run
    and restarts them: training completes in the band, applies go on
    during the kill window, the re-planner and preemption counters tick,
    and the ledger balances."""
    from znicz_torch.client import Client
    from znicz_torch.core.config import root
    from znicz_torch.parallel.chaos import (FaultSchedule, RelayHarness,
                                            SubtreePreempter)
    from znicz_torch.server import Server

    prev_lr = root.mnist.get("learning_rate")
    root.mnist.learning_rate = 0.03
    try:
        master_wf = _make_workflow(tmp_path / "m", max_epochs=6,
                                   n_train=1200)
        server = Server(master_wf, job_timeout=2.5, slave_ttl=1.0,
                        min_slaves=1, staleness_bound=20,
                        staleness_weight=True).start(linger=6.0)
        harnesses = [RelayHarness(server.endpoint, ANY,
                                  relay_id=f"soak-r{i}", recv_timeout=1.0,
                                  max_reconnects=60, child_ttl=1.5)
                     for i in range(2)]
        for h in harnesses:
            h.start()
        wfs = [_make_workflow(tmp_path / f"s{i}", max_epochs=6,
                              n_train=1200) for i in range(4)]
    finally:
        root.mnist.learning_rate = prev_lr
    homes = [harnesses[i % 2].endpoint for i in range(4)]
    clients = [Client(wfs[i], endpoint=homes[i], slave_id=f"pre{i}")
               for i in range(4)]
    errors, threads = [], {}
    slow = dict(recv_timeout=1.0, max_reconnects=80, backoff_base=0.05,
                backoff_cap=0.4, connect_retries=80)

    def start_slave(i):
        ts, errs = _run_slaves([clients[i]], **slow)
        threads[i] = ts[0]
        errors.append(errs)

    for i in range(4):
        start_slave(i)
    marks = {}

    def kill():
        for i in (0, 2):
            clients[i].preempt()
        for i in (0, 2):
            threads[i].join(timeout=10)
        harnesses[0].kill()
        marks["kill"] = (server.jobs_done, server.aggregated_updates,
                         server.weighted_applies)

    def restart():
        marks["restart"] = (server.jobs_done, server.aggregated_updates,
                            server.weighted_applies)
        harnesses[0].start()
        for i in (0, 2):
            clients[i] = Client(wfs[i], endpoint=homes[i],
                                slave_id=f"pre{i}")
            start_slave(i)

    preempter = SubtreePreempter(FaultSchedule(23),
                                 [("subtree-0", kill, restart)],
                                 kill_s=(0.1, 0.3), down_s=(4.5, 5.5))
    _wait(lambda: server.jobs_done >= 6, "six jobs done")
    preempter.start()
    try:
        assert preempter.join(60)
        assert server.join(300)
        for t in list(threads.values()):
            t.join(timeout=60)
        assert not [e for errs in errors for e in errs], errors
        assert not any(t.is_alive() for t in threads.values())
    finally:
        preempter.stop()
        for h in harnesses:
            h.kill(timeout=5)
    dec = master_wf.decision
    assert bool(dec.complete) and dec.epoch_metrics[1]["err_pct"] < 70.0
    assert preempter.preemptions == 1
    k, r = marks["kill"], marks["restart"]
    assert r[0] > k[0] and (r[1] > k[1] or r[2] > k[2]), (k, r)
    assert server.preemptions_ridden >= 1 and server.replans >= 1
    assert server.reregistrations >= 1 and server.weighted_applies > 0
    ledger = server.jobs_ledger()
    assert ledger["balanced"] and ledger["quarantined_updates"] == 0
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert set(server.jobs_by_slave) <= {f"pre{i}" for i in range(4)}


# -- across packages ----------------------------------------------------------------------


@pytest.mark.parametrize("relay_pkg", ["torch", "jax"],
                         ids=["port_relay_reference_fleet",
                              "reference_relay_port_fleet"])
def test_relay_trains_between_the_other_package(relay_pkg, tmp_path):
    """A port relay between the reference's master and two reference
    slaves trains, and the reference's relay between the port's master
    and two port slaves: the wire, the handshake passed upstream, batched
    fetches and the aggregated update are one protocol."""
    if relay_pkg == "torch":
        from znicz_torch.parallel.relay import Relay
        from znicz_tpu.client import Client
        from znicz_tpu.server import Server

        server = Server(_jax_workflow(tmp_path / "m"), endpoint=ANY,
                        job_timeout=60.0)
        thread = threading.Thread(target=server.serve, daemon=True)
        thread.start()
        relay = Relay(_jax_server_endpoint(server), ANY,
                      relay_id="x-relay").start()
        endpoint = relay.endpoint
        make = _jax_workflow
    else:
        from znicz_torch.client import Client
        from znicz_torch.server import Server
        from znicz_tpu.parallel.relay import Relay

        server = Server(_make_workflow(tmp_path / "m"),
                        job_timeout=60.0).start()
        thread = server._thread
        relay = Relay(server.endpoint, ANY, relay_id="x-relay").start()
        endpoint = _jax_relay_endpoint(relay)
        make = _make_workflow
    slaves = [Client(make(tmp_path / f"s{i}"), endpoint=endpoint,
                     slave_id=f"x{i}") for i in range(2)]
    try:
        threads, errors = _run_slaves(slaves)
        thread.join(BUDGET)
        assert not thread.is_alive()
        _join(threads, errors)
    finally:
        relay.stop()
    dec = server.workflow.decision
    assert bool(dec.complete) and dec.epoch_metrics[1]["err_pct"] < 70.0
    assert server.aggregated_updates >= 1
    assert server.updates_received < server.jobs_done
    assert set(server.jobs_by_slave) == {"x0", "x1"}
    assert server.jobs_done == sum(server.jobs_by_slave.values())
    assert "x-relay" in server.relays


def test_one_slave_through_a_port_relay_matches_the_star_pairing(tmp_path):
    """One slave without prefetch behind a port relay of fanout 1 (a
    job a fetch, a flush an update) runs the job stream in order: the
    master's weights lie within ``PAIR_RTOL`` of the reference's star
    pairing after the same jobs."""
    from test_torch_layers import jax_params
    from znicz_torch.client import Client
    from znicz_torch.core.config import root as troot
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server
    from znicz_tpu.client import Client as JClient
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.server import Server as JServer

    for tree in (troot, jroot):
        tree.common.engine.job_prefetch = False
    jserver = JServer(_jax_workflow(tmp_path / "jm", max_epochs=1),
                      endpoint=ANY, job_timeout=60.0)
    thread = threading.Thread(target=jserver.serve, daemon=True)
    thread.start()
    JClient(_jax_workflow(tmp_path / "js", max_epochs=1),
            endpoint=_jax_server_endpoint(jserver), slave_id="j").run()
    thread.join(BUDGET)
    tserver = Server(_make_workflow(tmp_path / "tm", max_epochs=1),
                     job_timeout=60.0).start()
    relay = Relay(tserver.endpoint, ANY, relay_id="pair", fanout=1).start()
    try:
        Client(_make_workflow(tmp_path / "ts", max_epochs=1),
               endpoint=relay.endpoint, slave_id="t").run()
        assert tserver.join(BUDGET)
    finally:
        relay.stop()
    assert tserver.jobs_done == jserver.jobs_done > 0
    assert tserver.aggregated_updates == tserver.jobs_done
    want, got = jax_params(jserver.workflow), _params(tserver.workflow)
    start = _params(_make_workflow(tmp_path / "fresh", max_epochs=1))
    for name, leaves in want.items():
        for k, v in leaves.items():
            assert not np.array_equal(start[name][k], v)
            np.testing.assert_allclose(got[name][k], v, rtol=PAIR_RTOL,
                                       atol=PAIR_ATOL,
                                       err_msg=f"{name}.{k}")


def test_cli_relay_trains_a_slave(tmp_path):
    """``python -m znicz_torch --relay MASTER:tcp://127.0.0.1:*`` prints
    its resolved endpoint; a slave trains through it, the relay exits 0
    once the master is done, and its last line carries its counters."""
    import os

    from znicz_torch.client import Client
    from znicz_torch.server import Server

    server = Server(_make_workflow(tmp_path / "m", max_epochs=2),
                    job_timeout=60.0).start()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_torch", "--relay",
         f"{server.endpoint}:{ANY}", "--tree-fanout", "3",
         "root.common.engine.relay_flush_s=0.2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"children at (tcp://127\.0\.0\.1:\d+) -> upstream "
                      r"\S+ \(fanout 3,", line)
        assert m, line
        Client(_make_workflow(tmp_path / "s", max_epochs=2),
               endpoint=m.group(1), slave_id="cli-leaf").run()
        assert server.join(BUDGET)
        out, _ = proc.communicate(timeout=BUDGET)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["complete"] and last["flushes"] >= 1
    assert last["fanout"] == 3
    assert server.jobs_by_slave == {"cli-leaf": server.jobs_done}
