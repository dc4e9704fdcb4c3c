"""The port's fleet observability against the reference's on the CPU:
the carriers that move spans, events and registry snapshots between
processes, and the slice's three end-to-end cases.

  - a heartbeat carries ``origin``, the exported spans and the journal's
    fresh events on every beat and the registry's snapshot every
    ``metrics_every_beats``-th, and its base keys are the reference's;
  - a relay buffers its children's piggybacked spans and events, bounded
    and drop-oldest, and forwards them upstream under the leaf's origin;
  - the master spans each request under its job's ``trace_id``, records
    the training SLO and ingests an update's spans, events and forwarded
    payloads into the fleet stores;
  - a reduced AlexNet (67x67) ``InferenceServer`` with ``web_port``:
    ``/metrics`` counts what the server counts, and its spans name each
    request's ``trace_id``;
  - a ``FusedTrainer`` run under ``--profile-dir``'s code path: its
    ``train_steps`` and ``images`` counters equal the reference trainer's
    on the same config, and the trace holds one ``train_step`` range a
    train segment;
  - a balancer with two in-process replicas: one request's ``trace_id``
    stitches across at least three origins, and the fleet endpoints serve
    the merged views;
  - ``WebStatus``'s master, relay and client panels and the master's
    readiness.

Every socket binds ``tcp://127.0.0.1:*`` (the dashboard port 0); waits
poll state with bounded deadlines."""

import contextlib
import json
import re
import time

import numpy as np
import pytest

from test_torch_layers import jax_sample, port_sample, sample_config
from test_torch_planner import SAMPLE, jax_workflow, knobs, tiny_layers
from test_torch_serving_zmq import ALEXNET, _port_twin
from test_torch_telemetry import _get, validate_exposition

#: the longest any state a test waits for may take (s)
BUDGET = 30.0


def _wait(pred, what, budget=BUDGET):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < budget, f"never {what}"
        time.sleep(0.02)


def _sample(text, series):
    """The value of the exposition line ``series`` (name and labels)."""
    m = re.search(rf"^{re.escape(series)} (\S+)$", text, re.M)
    assert m, f"no series {series}"
    return float(m.group(1))


@contextlib.contextmanager
def _serving(**values):
    """``root.common.serving.<key>`` set for the block, then unset."""
    from znicz_torch.core.config import root

    for key, val in values.items():
        root.common.serving.set_by_path(key, val)
    try:
        yield
    finally:
        for key in values:
            head, _, leaf = key.rpartition(".")
            node = root.common.serving.get_by_path(head) if head \
                else root.common.serving
            delattr(node, leaf)


def _tiny_server(**kw):
    from znicz_torch.serving import InferenceServer
    from znicz_torch.standard_workflow import StandardWorkflow

    return InferenceServer(StandardWorkflow(tiny_layers(), SAMPLE,
                                            device="cpu"),
                           max_batch=4, max_delay_ms=1.0, **kw)


# -- the carriers --------------------------------------------------------------


def test_heartbeat_carries_the_fleet_keys_on_their_cadence():
    from znicz_torch import telemetry
    from znicz_tpu.serving import InferenceServer as JServer

    with _serving(**{"obs.metrics_every_beats": 3}):
        srv = _tiny_server(warmup=False, replica_id="hb-r0")
    assert telemetry.identity().startswith("hb-r0@")
    jsrv = JServer(jax_workflow(tiny_layers()), max_batch=4, warmup=False)
    assert set(srv._heartbeat_base()) == set(jsrv._heartbeat_base())
    telemetry.exporter().drain()            # other tests' spans
    telemetry.tracer().add("serving", "reply", time.perf_counter(), 0.001,
                           {"trace_id": "hb-t1"})
    seq = telemetry.emit("heal", "serving", replica="hb-r0")
    beats = [srv.heartbeat_payload() for _ in range(5)]
    assert all(b["origin"] == telemetry.identity() for b in beats)
    assert [("metrics" in b) for b in beats] == [True, False, False, True,
                                                 False]
    assert [s["args"]["trace_id"] for s in beats[0]["spans"]] == ["hb-t1"]
    assert "spans" not in beats[1]
    assert beats[0]["events"][-1]["seq"] == seq
    assert "events" not in beats[1]         # the cursor moved past it
    snap = beats[0]["metrics"]
    json.loads(json.dumps(snap))
    names = {f["name"] for f in snap["families"]}
    assert "znicz_served_total" in names
    # the exemplar window and the SLO are read from the obs subtree
    assert srv._exemplar_cap == 8 and srv._metrics_every == 3
    assert set(srv.slo.objectives()) == {"availability", "latency_p99",
                                         "ttft", "inter_token"}
    assert telemetry.slo_snapshot()["planes"]["serving"] == \
        srv.slo.snapshot()


def test_relay_flush_forwards_leaf_obs_payloads():
    """Spans and events a leaf piggybacked on its update survive the
    relay hop: buffered (bounded) and shipped upstream as ``fwd_obs``
    with the leaf's origin, beside the relay's own."""
    from znicz_torch import telemetry
    from znicz_torch.parallel.relay import Relay

    relay = Relay("tcp://127.0.0.1:1", "tcp://127.0.0.1:2",
                  relay_id="fwd-relay", fanout=3, flush_s=999.0)
    assert telemetry.identity().startswith("fwd-relay@")
    relay._cred = (3, "cafebabecafebabe")
    now = time.time()
    for sid in ("s0", "s1", "s2"):      # the flush threshold is not met
        relay._children[sid] = now
    leaf_spans = [{"cat": "slave", "name": "job", "ts": 1, "dur": 2,
                   "tid": 0, "args": {"trace_id": "T-1"}}]
    leaf_events = [{"kind": "preemption", "plane": "training", "seq": 1,
                    "ts": 0.0, "origin": "slave-7@42"}]
    rep = relay._child_update({"cmd": "update", "id": "s0", "job_id": 1,
                               "trace_id": "T-1", "spans": leaf_spans,
                               "events": leaf_events,
                               "origin": "slave-7@42",
                               "metrics": {"loss": 1.0}}, "s0")
    assert rep["ok"]
    with relay._lock:
        fwd = list(relay._obs_fwd)
    assert fwd == [{"origin": "slave-7@42", "spans": leaf_spans,
                    "events": leaf_events}]
    for i in range(100):
        relay._buffer_child_obs({"spans": [{"cat": "t", "name": f"n{i}",
                                            "ts": 0, "dur": 0, "tid": 0}],
                                 "origin": f"s{i}@1"}, f"s{i}")
    with relay._lock:
        assert len(relay._obs_fwd) == 32
        assert relay._obs_fwd[-1]["origin"] == "s99@1"
    sent = []
    relay._upstream_rpc = lambda frames, one_shot: sent.append(frames) or {
        "ok": True}
    telemetry.tracer().add("relay", "edge", time.perf_counter(), 0.0,
                           {"trace_id": "T-1"})
    relay._flush()
    from znicz_torch.parallel import wire

    msg, _ = wire.decode_message(sent[0])
    assert len(msg["fwd_obs"]) == 32 and msg["contributors"]
    assert msg["origin"] == telemetry.identity()
    assert any(s["args"].get("trace_id") == "T-1" for s in msg["spans"])
    with relay._lock:
        assert relay._obs_fwd == []
    assert relay.flushes == 1 and relay.contributions == 1


def test_master_spans_records_the_slo_and_ingests_updates(tmp_path):
    from test_torch_master_slave import _make_workflow, _restored
    from znicz_torch import telemetry
    from znicz_torch.network_common import handshake_request
    from znicz_torch.parallel import wire
    from znicz_torch.server import Server

    with _restored(("mnist.loader.n_train", "mnist.loader.n_valid",
                    "mnist.loader.minibatch_size",
                    "mnist.decision.max_epochs", "common.dirs.snapshots",
                    "common.engine.obs_slo_apply_progress")):
        from znicz_torch.core.config import root

        root.common.engine.obs_slo_apply_progress = 0.9
        srv = Server(_make_workflow(tmp_path, max_epochs=1, n_train=120))
    assert telemetry.identity().startswith("master@")

    def rpc(msg):
        frames, _ = wire.encode_message(msg)
        rep, _ = wire.decode_message(
            [bytes(f) for f in srv._reply_frames(frames)])
        return rep

    assert rpc(dict(handshake_request(srv.workflow), id="s1"))["ok"]
    job = rpc({"cmd": "job", "id": "s1"})
    tid = job["trace_id"]
    assert tid.startswith(srv._run_tag)
    rep = rpc({"cmd": "update", "id": "s1", "job_id": job["job_id"],
               "trace_id": tid, "step": job.get("step"), "deltas": None,
               "metrics": {}, "origin": "slave-s1@7",
               "spans": [{"cat": "slave", "name": "job", "ts": 1, "dur": 2,
                          "tid": 0, "args": {"trace_id": tid}}],
               "events": [{"kind": "heal", "plane": "training", "seq": 1,
                           "ts": 0.0}],
               "fwd_obs": [{"origin": "leaf@8", "spans": [
                   {"cat": "slave", "name": "job", "ts": 3, "dur": 1,
                    "tid": 0, "args": {"trace_id": tid}}], "events": []},
                   "garbage"]})
    assert rep["ok"]
    handled = [e for e in telemetry.tracer().events()
               if e[0] == "master" and e[1] == "handle:update"
               and e[5] and e[5].get("trace_id") == tid]
    assert handled and handled[0][5]["slave"] == "s1"
    assert {"slave-s1@7", "leaf@8"} <= set(
        telemetry.fleet_trace().trace_origins(tid))
    assert telemetry.fleet_events().cursor("slave-s1@7") == 1
    slo = srv.slo.snapshot()["objectives"]["apply_progress"]
    assert (slo["good"], slo["bad"], slo["target"]) == (1, 0, 0.9)
    assert srv.jobs_done == 1
    text = telemetry.render_prometheus()
    assert 'znicz_jobs_done_total{component="master"} 1' in text
    assert 'znicz_quorum_members{component="master"} 1' in text
    srv.jobs_done = 5                    # a resume writes counters back
    assert srv._m["jobs_done"].value == 5


# -- the slice, end to end -----------------------------------------------------


@pytest.fixture(scope="module")
def alexnet_twin():
    from znicz_tpu.samples.alexnet import make_layers

    layers = make_layers(10)
    jwf = jax_workflow(layers, sample_shape=ALEXNET, n=4)
    twf, _ = _port_twin(jwf, layers, ALEXNET)
    return twf


def test_served_metrics_equal_the_servers_accounting(alexnet_twin):
    """A reduced AlexNet server under ``fused`` with ``web_port`` (the
    launcher's dashboard): after six requests of 1-4 rows, ``/metrics``
    holds the server's, the batcher's and the runner's counts, its reply
    spans carry the requests' trace ids, and the status, health and
    readiness endpoints and the page describe the same service."""
    from znicz_torch import telemetry
    from znicz_torch.__main__ import start_web_status
    from znicz_torch.serving import InferenceClient, InferenceServer

    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(n,) + ALEXNET).astype(np.float32)
          for n in (1, 3, 2, 4, 1, 2)]
    with knobs(fused_elementwise=True, fused_tail=True), \
            _serving(web_port=0):
        srv = InferenceServer(alexnet_twin, max_batch=4, max_delay_ms=1.0,
                              replica_id="obs-67")
        status = start_web_status()
        status.register(alexnet_twin)
        status.register_inference(srv)
        srv.start()
        cli = InferenceClient(srv.endpoint, timeout=60.0,
                              breaker_failures=0, resend_after_s=60.0)
        base = f"http://127.0.0.1:{status.port}"
        try:
            tids = []
            for x in xs:
                rid = cli.submit(x)
                rep = cli.result(rid, timeout=60)
                assert rep["y"].shape == (x.shape[0], 10)
                tids.append(rep["trace_id"])
            text = _get(f"{base}/metrics").decode()
            validate_exposition(text)
            serving = '{component="serving"}'
            assert _sample(text, f"znicz_served_total{serving}") == \
                srv.served == len(xs)
            assert _sample(text, f"znicz_requests_in_total{serving}") == \
                srv.requests_in == len(xs)
            assert _sample(text, f"znicz_rejected_total{serving}") == 0
            assert _sample(
                text, f"znicz_request_latency_seconds_count{serving}") \
                == len(xs)
            b = srv.batcher
            assert _sample(text, 'znicz_batches_total{component="batcher"}'
                           ) == b.batches
            assert _sample(text, 'znicz_batched_rows_total'
                           '{component="batcher"}') == sum(
                               x.shape[0] for x in xs)
            for rung, hits in b.bucket_hits.items():
                assert _sample(text, f'znicz_bucket_hits_total{{bucket='
                               f'"{rung}",component="batcher"}}') == hits
            assert _sample(text, 'znicz_compiles_total{component="model"}'
                           ) == srv.runner.compiles == 3
            assert _sample(text, 'znicz_generation{component="model"}') == 1
            assert _sample(text, 'znicz_jit_cache_size{component="model"}'
                           ) == 3
            replies = [e for e in telemetry.tracer().events()
                       if e[0] == "serving" and e[1] == "reply"
                       and e[5].get("replica") == "obs-67"]
            assert {e[5]["trace_id"] for e in replies} >= set(tids)
            assert all(e[5]["gen"] == 1 and not e[5]["solo"]
                       for e in replies)
            snap = json.loads(_get(f"{base}/status.json"))
            assert snap["serving"]["served"] == len(xs)
            slow = snap["serving"]["slow_requests"]
            assert 1 <= len(slow) <= 8 and {x["trace_id"] for x in slow} \
                <= set(tids)
            assert json.loads(_get(f"{base}/healthz")) == {"ok": True}
            ready = json.loads(_get(f"{base}/readyz"))
            assert ready["ready"] and ready["generation"] == 1
            assert ready["slo"] in ("ok", "warn", "burning")
            page = _get(f"{base}/").decode()
            assert "Serving" in page and "Slowest requests" in page
        finally:
            cli.close()
            srv.stop()
            status.stop()


def test_trainer_counters_equal_the_references(tmp_path):
    """MNIST under the fused trainer in both packages: the port's
    ``train_steps`` and ``images`` (``znicz_train_steps_total`` and
    ``znicz_images_total`` of the ``trainer`` scope) equal the
    reference's; run under ``--profile-dir``'s code path, the trace
    parses and holds one ``train_step#<step>`` range a train segment
    dispatched and a tail update applied."""
    from znicz_torch import telemetry
    from znicz_torch.__main__ import profiled
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    cfg = {"loader__n_train": 150, "loader__n_valid": 30,
           "loader__n_test": 0, "loader__minibatch_size": 30,
           "decision__max_epochs": 2}
    with sample_config("mnist", **cfg):
        jt = JTrainer(jax_sample("mnist", tmp_path))
        jt.run()
        t = FusedTrainer(port_sample("mnist", tmp_path))
        with profiled(str(tmp_path / "prof"), "cpu") as path:
            t.run()
    assert t._m_train_steps.value == jt._m_train_steps.value == 10
    assert t._m_images.value == jt._m_images.value == 300
    assert t._m_step_seconds.count > 0
    text = telemetry.render_prometheus()
    assert _sample(text, 'znicz_train_steps_total{component="trainer"}') \
        == 10
    assert _sample(text, 'znicz_images_total{component="trainer"}') == 300
    events = json.load(open(path))["traceEvents"]
    ranges = sorted(e["name"] for e in events
                    if str(e.get("name", "")).startswith("train_step#")
                    and e.get("cat") == "user_annotation")
    segments = sum(n for (kind, _), n in t.segments.items()
                   if kind == "train")
    # the epochs' tails: the last one's update is skipped (complete)
    assert len(ranges) == segments + 1
    assert ranges[0] == "train_step#0"
    assert telemetry.step_annotation(0) is telemetry.NULL_SPAN


def test_balancer_stitches_a_request_across_three_origins():
    """A balancer with two in-process replicas and the dashboard: one
    request's ``trace_id`` stitches across at least three origins, its
    spans the client's request, the balancer's hop and the replica's
    reply (in one process a drain of the shared exporter may carry them
    under another origin than their own), and the fleet
    endpoints serve the merged views: member series on ``/metrics``,
    the rollup on ``/fleet.json`` (each counter's total the sum over its
    members), ``replica_joined`` on the merged journal and both planes'
    objectives on ``/slo.json``."""
    from znicz_torch import telemetry
    from znicz_torch.serving import InferenceClient, ReplicaBalancer
    from znicz_torch.web_status import WebStatus

    telemetry.set_enabled(True)
    bal = ReplicaBalancer(replica_ttl_s=5.0, heartbeat_s=0.1).start()
    srvs = []
    status = cli = None
    try:
        with _serving(**{"obs.metrics_every_beats": 1}):
            srvs = [_tiny_server(announce=bal.endpoint,
                                 replica_id=f"st-r{i}").start()
                    for i in range(2)]
        cli = InferenceClient(bal.endpoint, timeout=20.0,
                              breaker_failures=0, resend_after_s=20.0)
        status = WebStatus(port=0).start()
        status.register_balancer(bal)
        base = f"http://127.0.0.1:{status.port}"
        _wait(lambda: bal.ready_count() == 2, "two ready replicas")
        x = np.zeros((1,) + SAMPLE, np.float32)
        store = telemetry.fleet_trace()
        tid = None

        def stitched():
            nonlocal tid
            rep = cli.result(cli.submit(x), timeout=20)
            assert rep["lb"] and rep["ok"]
            tid = rep["trace_id"]
            return len(store.trace_origins(tid)) >= 3

        _wait(stitched, "a trace across three origins")
        # the client's span joins at the next drain of the process's
        # exporter (a heartbeat's or the balancer's self-ingest)
        _wait(lambda: any(e.get("cat") == "client"
                          for e in store.chrome_trace(tid)["traceEvents"]),
              "the client's span of the trace")
        chrome = json.loads(_get(
            f"{base}/trace.json?fleet=1&trace_id={tid}"))
        assert len(chrome["fleet"]["origins"]) >= 3
        names = {(e["cat"], e["name"]) for e in chrome["traceEvents"]
                 if e["ph"] == "X"}
        assert {("client", "request"), ("balancer", "request"),
                ("serving", "reply")} <= names
        hop = [e for e in chrome["traceEvents"]
               if e.get("name") == "request" and e["cat"] == "balancer"]
        assert hop[0]["args"]["replica"] in ("st-r0", "st-r1")
        _wait(lambda: telemetry.fleet_metrics().members(),
              "a member's registry snapshot")
        text = _get(f"{base}/metrics").decode()
        validate_exposition(text)
        assert 'member="' in text
        assert re.search(r'^znicz_accepted_total\{component="balancer"\} ',
                         text, re.M)
        roll = json.loads(_get(f"{base}/fleet.json"))
        fams = roll["metrics"]["families"]
        for name, fam in fams.items():
            if fam["kind"] == "counter":
                assert fam["total"] == sum(fam["members"].values()), name
        assert roll["metrics"]["members"]
        ev = json.loads(_get(f"{base}/events.json?fleet=1"))
        joined = {e["replica"] for e in ev["events"]
                  if e["kind"] == "replica_joined"}
        assert {"st-r0", "st-r1"} <= joined
        slo = json.loads(_get(f"{base}/slo.json"))
        assert set(slo["planes"]["serving"]["objectives"]) == {
            "availability", "latency_p99", "ttft", "inter_token"}
        ready = json.loads(_get(f"{base}/readyz"))
        assert ready["ready"] and ready["ready_replicas"] == 2
        assert "Replica fleet" in _get(f"{base}/").decode()
    finally:
        if status is not None:
            status.stop()
        if cli is not None:
            cli.close()
        for s in srvs:
            s.stop()
        bal.stop()


def test_webstatus_panels_of_a_master_a_relay_and_a_client(tmp_path):
    """The master's star and elastic panel, a relay's tree panel and a
    client's breaker row render from the port's components, and
    ``/readyz`` answers the master's quorum when it is the only service
    registered."""
    from test_torch_master_slave import _make_workflow, _restored
    from znicz_torch.parallel.relay import Relay
    from znicz_torch.server import Server
    from znicz_torch.serving import InferenceClient
    from znicz_torch.web_status import WebStatus

    with _restored(("mnist.loader.n_train", "mnist.loader.n_valid",
                    "mnist.loader.minibatch_size",
                    "mnist.decision.max_epochs", "common.dirs.snapshots")):
        wf = _make_workflow(tmp_path, max_epochs=1, n_train=120)
        srv = Server(wf)
    relay = Relay("tcp://127.0.0.1:1", "tcp://127.0.0.1:2",
                  relay_id="panel-relay")
    cli = InferenceClient("tcp://127.0.0.1:1", timeout=1.0)
    status = WebStatus(port=0).start()
    base = f"http://127.0.0.1:{status.port}"
    try:
        status.register(wf)
        status.register_server(srv)
        status.register_relay(relay)
        status.register_inference_client(cli)
        snap = json.loads(_get(f"{base}/status.json"))
        assert snap["master"]["jobs_done"] == 0
        assert snap["master"]["elastic"]["members"] == 0
        assert snap["relays"][0]["id"] == "panel-relay"
        assert snap["serving_client"]["breaker"] == "closed"
        assert snap["workflows"][0]["name"] == wf.name
        ready = json.loads(_get(f"{base}/readyz"))
        assert ready["ready"] and ready["min_slaves"] == srv.min_slaves
        page = _get(f"{base}/").decode()
        for text in ("Master", "Relay panel-relay", "client breaker",
                     "Workflows"):
            assert text in page, text
    finally:
        status.stop()
        cli.close()


def test_a_capture_keeps_its_cublas_workspace_to_itself(monkeypatch):
    """ROADMAP C.16's repair, in order: ``StepGraph.capture`` drops
    PyTorch's cached cuBLAS workspaces before the capture begins (so its
    matmuls take a workspace of the graph's pool) and after it ends (so
    no later eager matmul on the capture stream, by a thread handed the
    same cuBLAS handle, is given the workspace a replay uses).  The race
    itself runs on the card only (``chip_smoke.py`` phase 21,
    ``[fleet:race]``); here the capture is a stand-in that records the
    order of the calls."""
    import torch

    from znicz_torch.parallel.graphs import StepGraph

    calls = []
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: calls.append("clear"), raising=False)

    class FakeGraph:
        def replay(self):
            calls.append("replay")

    class FakeCapture:
        def __init__(self, graph, pool=None, stream=None,
                     capture_error_mode=None):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            calls.append("begin")

        def __exit__(self, *exc):
            calls.append("end")
            return False

    class FakeStream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    cap = StepGraph({}, None, {})
    cap.capture(lambda: calls.append("body") or "out", FakeStream())
    assert calls == ["clear", "begin", "body", "end", "clear"]
    assert cap.outputs == "out"
    cap.replay()
    assert calls[-1] == "replay"
    # a body that raises still leaves no workspace cached for the stream
    calls.clear()

    def boom():
        raise RuntimeError("illegal under capture")

    with pytest.raises(RuntimeError, match="illegal under capture"):
        cap.capture(boom, FakeStream())
    assert calls == ["clear", "begin", "end", "clear"]
