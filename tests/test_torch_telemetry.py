"""The port's telemetry (``znicz_torch/telemetry/``) and ``web_status``
against the reference's (``znicz_tpu/telemetry/``, ``znicz_tpu/
web_status.py``) on the CPU.

  - the same registrations, increments and observations go to both
    packages' registries: the Prometheus text is the same string, the
    ring quantiles the same floats, the latest registration wins in both;
  - the same recorded events give the same Chrome-trace JSON (pids and
    timestamps normalised where a clock is read); the disabled ring is a
    no-op, and the step annotation is a ``torch.profiler`` range only
    while armed;
  - the event journal and the fleet event store, fed the same events
    with an injected clock, give the same seqs, snapshots and ``mseq``;
  - the SLO tracker, fed the same records at injected times, gives the
    same burn rates and states; the fleet metric and trace stores the
    same rollups, merged exposition and stitched traces; the span
    exporter the same drained spans;
  - ``WebStatus``: every endpoint, the structured device error with
    ``torch.cuda`` monkeypatched, and a stalled scraper that never
    wedges the registry.

Every socket binds 127.0.0.1 with port 0; waits are bounded."""

import json
import math
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest


def _pair(name):
    """(port module, reference module) of ``telemetry.<name>``."""
    import importlib

    return (importlib.import_module(f"znicz_torch.telemetry.{name}"),
            importlib.import_module(f"znicz_tpu.telemetry.{name}"))


def _get(url, timeout=10.0, code=200):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            assert r.status == code
            return r.read()
    except urllib.error.HTTPError as exc:
        assert exc.code == code, exc
        return exc.read()


_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE = re.compile(
    rf"^{_NAME}(\{{({_NAME}=\"(\\.|[^\"\\])*\"(,{_NAME}=\"(\\.|[^\"\\])*\")*)?"
    rf"\}})? (-?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?|\+Inf|-Inf|NaN)$")


def validate_exposition(text):
    """Every line a HELP, a TYPE (once a family) or a well-formed sample
    of a typed family; returns the samples."""
    typed = set()
    samples = 0
    for ln in text.rstrip("\n").split("\n"):
        if ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            assert kind in ("counter", "gauge", "summary"), ln
            assert name not in typed, f"TYPE twice: {ln!r}"
            typed.add(name)
            continue
        assert _SAMPLE.match(ln), f"malformed sample line: {ln!r}"
        name = ln.split("{", 1)[0].split(" ", 1)[0]
        base = re.sub(r"_(sum|count)$", "", name)
        assert name in typed or base in typed, f"untyped sample: {ln!r}"
        samples += 1
    return samples


def _feed_registry(mod):
    """One registry of ``mod`` fed a fixed sequence: counters (one set
    back as a resume does), set and sampled gauges (inf, NaN, a broken
    callable, escaped labels), histograms with a wrapped ring and an
    empty one, and a re-registration that wins."""
    reg = mod.MetricsRegistry()
    sc = reg.scope("serving")
    c = sc.counter("served", "answered with a result")
    c.inc()
    c.inc(41)
    sc.counter("rejected", "answered shed").inc(3)
    r = reg.scope("master").counter("jobs_done", "jobs completed")
    r.set(17)
    sc.gauge("queue_depth", "rows queued").set(2.5)
    sc.gauge("best_metric", fn=lambda: float("inf"))
    sc.gauge("broken", fn=lambda: 1 / 0)
    sc.gauge("labeled", 'help with "quotes"', tag='va"l\nue\\x').set(-3)
    h = sc.histogram("request_latency_seconds", "latency", size=8)
    rng = np.random.default_rng(5)
    for v in rng.exponential(0.02, size=21):
        h.observe(v)
    sc.histogram("never_observed_seconds")
    b = sc.histogram("bucket_latency_seconds", "per rung", size=4,
                     bucket="16")
    for v in (0.5, 0.25, 1.0):
        b.observe(v)
    # a rebuilt component: the latest child wins its label set
    again = reg.scope("serving").counter("served", "")
    again.inc(7)
    return reg, h


def test_prometheus_text_matches_the_reference():
    tm, jm = _pair("metrics")
    treg, th = _feed_registry(tm)
    jreg, jh = _feed_registry(jm)
    text = treg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert validate_exposition(text) >= 12
    assert 'znicz_served_total{component="serving"} 7' in text
    assert 'znicz_jobs_done_total{component="master"} 17' in text
    assert "+Inf" in text and "NaN" in text
    assert th.quantiles() == jh.quantiles()
    assert th.count == jh.count == 21 and th.sum == jh.sum
    with pytest.raises(ValueError, match="already registered"):
        treg.scope("serving").gauge("served_total")


@pytest.mark.parametrize("size,n", [(1, 1), (8, 5), (8, 8), (8, 29),
                                    (1024, 300)])
def test_histogram_ring_quantiles_match_the_reference(size, n):
    tm, jm = _pair("metrics")
    th, jh = tm.Histogram("h", size=size), jm.Histogram("h", size=size)
    assert th.quantile(0.5) is None and th.quantiles() == jh.quantiles()
    vals = np.random.default_rng(size + n).normal(size=n)
    for v in vals:
        th.observe(v)
        jh.observe(v)
    assert np.array_equal(th.window(), jh.window())
    assert th.window().size == min(n, size)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert th.count == jh.count == n and th.sum == jh.sum


def test_registry_thread_safety_under_concurrent_increments():
    """Threads incrementing one counter and observing one histogram,
    with a scraper rendering throughout, lose no count."""
    tm, _ = _pair("metrics")
    reg = tm.MetricsRegistry()
    sc = reg.scope("soak")
    c = sc.counter("hits")
    h = sc.histogram("lat_seconds", size=128)
    n_threads, per_thread = 4, 5000
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            reg.render_prometheus()

    def bump():
        for i in range(per_thread):
            c.inc()
            if i % 97 == 0:
                h.observe(i)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    workers = [threading.Thread(target=bump) for _ in range(n_threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    scraper.join(5)
    assert c.value == n_threads * per_thread
    assert h.count == n_threads * len(range(0, per_thread, 97))


def test_registered_property_and_weak_fn():
    """The compatibility layer: an attribute read and written through a
    registry counter, and a gauge that does not pin its owner."""
    import gc

    tm, _ = _pair("metrics")
    reg = tm.MetricsRegistry()

    class Owner:
        jobs = tm.registered_property("jobs", "jobs done")

        def __init__(self):
            self._m = {"jobs": reg.scope("t").counter("jobs")}
            reg.scope("t").gauge("live", fn=tm.weak_fn(self,
                                                       lambda o: 1.0))

    o = Owner()
    o._m["jobs"].inc(3)
    assert o.jobs == 3
    o.jobs = 11                         # a resume restores it
    assert 'znicz_jobs_total{component="t"} 11' in reg.render_prometheus()
    assert 'znicz_live{component="t"} 1' in reg.render_prometheus()
    del o
    gc.collect()
    assert 'znicz_live{component="t"} NaN' in reg.render_prometheus()


def _normalise(chrome):
    """A Chrome trace with the host's pid and the recorded timestamps
    replaced by their order: what differs between two recordings of the
    same events."""
    out = json.loads(json.dumps(chrome))
    for i, ev in enumerate(out["traceEvents"]):
        ev["pid"] = 0
        ev["ts"] = i
        ev["dur"] = 0
    return out


def test_chrome_trace_matches_the_reference():
    tt, jt = _pair("trace")
    rings = [tt.TraceRing(capacity=16), jt.TraceRing(capacity=16)]
    for ring in rings:
        for i in range(40):
            ring.add("serving", f"s{i}", 1000.0 + i * 0.5, 0.25 * (i % 3),
                     {"trace_id": f"t{i}", "rows": i} if i % 4 else None)
    a, b = (ring.chrome_trace() for ring in rings)
    assert a == b                       # same thread, pid and stamps
    assert len(a["traceEvents"]) == 16 and rings[0].recorded == 40
    assert "args" not in a["traceEvents"][0]           # i = 24
    assert a["traceEvents"][1]["args"]["trace_id"] == "t25"
    back = json.loads(json.dumps(a))
    for key in ("name", "cat", "ph", "ts", "dur", "pid", "tid"):
        assert key in back["traceEvents"][0]
    # spans read the clock: equal once the stamps are normalised
    rings = [tt.TraceRing(capacity=8), jt.TraceRing(capacity=8)]
    for ring in rings:
        for i in range(3):
            with ring.span("train", "dispatch", steps=i):
                pass
        ring.instant("train", "mark", epoch=2)
    a, b = (_normalise(ring.chrome_trace()) for ring in rings)
    assert a == b and a["traceEvents"][-1]["name"] == "mark"


def test_disabled_ring_and_the_step_annotation():
    from znicz_torch import telemetry

    tt, _ = _pair("trace")
    ring = tt.TraceRing(capacity=8, enabled=False)
    assert ring.span("c", "n") is tt.NULL_SPAN
    with ring.span("c", "n"):
        pass
    ring.add("c", "n", 0.0, 1.0)
    assert ring.events() == [] and ring.recorded == 0
    assert telemetry.step_annotation(5) is telemetry.NULL_SPAN
    telemetry.set_profile_steps(True)
    try:
        ann = telemetry.step_annotation(5)
        from torch.profiler import record_function

        assert isinstance(ann, record_function)
        assert ann.name == "train_step#5"
        with ann:
            pass
    finally:
        telemetry.set_profile_steps(False)
    assert telemetry.step_annotation(6) is telemetry.NULL_SPAN


def test_event_journal_and_fleet_store_match_the_reference():
    te, je = _pair("events")
    now = [100.0]
    journals = [mod.EventJournal(capacity=8, origin="m@1",
                                 clock=lambda: now[0]) for mod in (te, je)]
    seqs = []
    for i in range(30):
        now[0] = 100.0 + i
        seqs.append([j.emit("failover", "serving", i=i, why=(i, "x"))
                     for j in journals])
    assert seqs == [[i, i] for i in range(1, 31)]
    a, b = (j.snapshot() for j in journals)
    assert a == b and a["dropped"] == 22 and a["last_seq"] == 30
    assert [e["seq"] for e in journals[0].since(0)] == list(range(23, 31))
    assert journals[0].since(27, limit=2) == journals[1].since(27, limit=2)
    stores = [te.FleetEventStore(capacity=6), je.FleetEventStore(capacity=6)]
    batch = journals[0].since(0)
    for store in stores:
        assert store.ingest("a@1", batch[:5]) == 5
        assert store.ingest("a@1", batch) == 3         # a re-delivery
        assert store.ingest("b@2", [{"seq": 1, "kind": "heal"},
                                    {"seq": "x"}, {"seq": 2}]) == 2
        assert store.ingest("b@2", []) == 0
    a, b = (s.snapshot() for s in stores)
    assert a == b and a["last_mseq"] == 10
    assert [e["mseq"] for e in a["events"]] == list(range(5, 11))
    assert stores[0].since(8) == stores[1].since(8)
    assert stores[0].cursor("a@1") == 30


def _slo_feed(mod, now):
    slo = mod.SloTracker("serving", window_fast_s=60.0, window_slow_s=600.0,
                         bucket_s=5.0, clock=lambda: now[0])
    slo.add_objective("availability", target=0.99)
    slo.add_objective("latency_p99", target=0.99, threshold=0.25, unit="s")
    slo.add_objective("ttft", target=0.9, threshold=0.5, unit="s")
    rng = np.random.default_rng(3)
    for i in range(400):
        now[0] = 1000.0 + i * 2.5
        slo.record("availability", ok=(i % 23 != 0), n=1 + i % 3)
        slo.record_latency("latency_p99", float(rng.exponential(0.08)))
        if i > 300:
            slo.record_latency("ttft", 0.9)       # a late burn
    slo.record("unknown", ok=False)               # ignored
    return slo


def test_slo_tracker_matches_the_reference():
    tf, jf = _pair("fleet")
    nows = [[0.0], [0.0]]
    t, j = _slo_feed(tf, nows[0]), _slo_feed(jf, nows[1])
    for when in (1997.5, 2100.0, 2700.0):
        nows[0][0] = nows[1][0] = when
        assert t.snapshot() == j.snapshot()
        for name in ("availability", "latency_p99", "ttft", "unknown"):
            for window in (60.0, 600.0):
                assert t.burn_rate(name, window) == \
                    j.burn_rate(name, window)
    nows[0][0] = nows[1][0] = 1997.5
    snap = t.snapshot()
    assert snap["objectives"]["ttft"]["state"] == "burning"
    assert snap["state"] == "burning"
    # a hand count of the fast window's availability burn
    lo = int((1997.5 - 60.0) / 5.0)
    good = bad = 0
    for i in range(400):
        if int((1000.0 + i * 2.5) / 5.0) > lo:
            n = 1 + i % 3
            if i % 23:
                good += n
            else:
                bad += n
    assert t.burn_rate("availability", 60.0) == pytest.approx(
        (bad / (good + bad)) / 0.01)


def _member_registry(mod, served, lat):
    reg = mod.MetricsRegistry()
    sc = reg.scope("serving")
    sc.counter("served", "answered with a result").inc(served)
    sc.gauge("queue_depth", "rows queued").set(served / 2)
    sc.gauge("gone", fn=lambda: float("nan"))           # dropped
    h = sc.histogram("request_latency_seconds", "latency", size=128)
    for v in lat:
        h.observe(v)
    reg.scope("batcher").counter("batches", "batches closed").inc(served)
    return reg


def test_fleet_metrics_rollup_and_exposition_match_the_reference():
    tf, jf = _pair("fleet")
    tm, jm = _pair("metrics")
    rng = np.random.default_rng(11)
    lats = [rng.exponential(0.01, size=n) for n in (100, 7)]
    out = []
    for fleet, metrics in ((tf, tm), (jf, jm)):
        local = metrics.MetricsRegistry()
        local.scope("balancer").counter("accepted", "accepted").inc(9)
        local.scope("serving").counter("served", "answered").inc(1)
        store = fleet.FleetMetricsStore()
        for origin, served, lat in (("r0@1", 5, lats[0]),
                                    ("r1@1", 8, lats[1])):
            snap = fleet.registry_snapshot(
                _member_registry(metrics, served, lat), window_cap=64)
            json.loads(json.dumps(snap))
            store.update(origin, snap)
        for garbage in (None, 17, "families", [], {"nope": 1}):
            store.update("evil@1", garbage)
        roll = store.rollup()
        for m in roll["members"].values():
            m["age_s"] = 0.0
        out.append((fleet.render_fleet_prometheus(local, store), roll,
                    local.render_prometheus()))
    (text, roll, local), (jtext, jroll, _) = out
    assert text == jtext and roll == jroll
    validate_exposition(text)
    for line in local.splitlines():
        if line and not line.startswith("#"):
            assert line in text, f"local series lost: {line!r}"
    assert re.search(r'^znicz_served_total\{[^}]*member="r1@1"[^}]*\} 8',
                     text, re.M)
    fam = roll["families"]["znicz_served_total"]
    assert fam["total"] == 13.0 and sorted(roll["members"]) == [
        "r0@1", "r1@1"]
    assert roll["families"]["znicz_request_latency_seconds"]["count"] == 107


def test_fleet_trace_store_and_exporter_match_the_reference():
    tf, jf = _pair("fleet")
    tt, jt = _pair("trace")
    out = []
    for fleet, trace in ((tf, tt), (jf, jt)):
        ring = trace.TraceRing(capacity=64)
        exp = fleet.SpanExporter("rep@1", capacity=6)
        exp._offset_us = 1.7e15           # the wall-clock offset, pinned
        ring.add_sink(exp)
        for i in range(5):
            ring.add("serving", "untraced", 10.0 + i, 0.001)
        for i in range(9):
            ring.add("serving", f"s{i}", 20.0 + i, 0.002,
                     {"trace_id": f"t{i % 3}", "rows": i})
        peek = exp.peek_trace("t1", limit=2)
        drained = exp.drain(limit=4)
        store = fleet.FleetTraceStore(capacity=10)
        store.ingest("replica-1@9", drained + exp.drain())
        store.ingest("balancer@9", [
            {"cat": "balancer", "name": "request", "ts": 5, "dur": 9,
             "tid": 1, "args": {"trace_id": "t1"}}, "garbage"])
        store.ingest("client@9", [{"cat": "client", "name": "request",
                                   "ts": 4, "dur": 12, "tid": 2,
                                   "args": {"trace_id": "t1"}}])
        out.append((peek, drained, exp.dropped, exp.offered,
                    store.best_stitched(), store.chrome_trace("t1"),
                    store.chrome_trace(), store.snapshot(),
                    store.trace_origins("t1")))
    assert out[0] == out[1]
    peek, drained, dropped, offered, best, one, whole, snap, origins = out[0]
    assert (dropped, offered) == (3, 9)
    assert [s["name"] for s in drained] == ["s3", "s4", "s5", "s6"]
    assert best[0] == "t1" and len(best[1]) == 3 == len(origins)
    assert one["fleet"]["origins"] == sorted(origins)
    assert snap["traces"] == 3 and snap["spans"] == 8


def test_defaults_identity_and_slo_snapshot_match_the_reference():
    import znicz_tpu.telemetry as jtel
    from znicz_torch import telemetry as ttel

    assert ttel.TELEMETRY_DEFAULTS == jtel.TELEMETRY_DEFAULTS
    tf, _ = _pair("fleet")
    assert tf.process_identity("balancer").startswith("balancer@")
    slo = tf.SloTracker("zz_test_plane", clock=lambda: 50.0)
    slo.add_objective("availability", target=0.5)
    ttel.register_slo(slo)
    assert ttel.slo_snapshot()["planes"]["zz_test_plane"]["state"] == "ok"
    slo.record("availability", False, now=50.0)
    state = ttel.slo_snapshot()
    assert state["planes"]["zz_test_plane"]["state"] == "burning"
    assert state["state"] == "burning"
    # the latest tracker of a plane replaces its predecessor
    ttel.register_slo(tf.SloTracker("zz_test_plane"))
    assert ttel.slo_snapshot()["planes"]["zz_test_plane"]["objectives"] \
        == {}
    assert [t.plane for t in ttel.slo_trackers()].count("zz_test_plane") \
        == 1


# -- WebStatus -------------------------------------------------------------------


def test_webstatus_endpoints():
    """Every endpoint answers with its format: the exposition (the fleet
    superset once a member is known), the local and stitched traces,
    the journals on their cursors, the SLOs, the rollup, the status
    snapshot, liveness and readiness with no service registered, and
    the HTML page."""
    from znicz_torch import telemetry
    from znicz_torch.web_status import WebStatus

    telemetry.scope("endpoint_test").counter("hits").inc(3)
    with telemetry.span("endpoint_test", "probe", trace_id="ep-t1"):
        pass
    seq = telemetry.emit("heal", "serving", replica="ep-r9")
    telemetry.fleet_trace().ingest("ep-origin@1", [
        {"cat": "client", "name": "request", "ts": 1, "dur": 2, "tid": 0,
         "args": {"trace_id": "ep-t1"}}])
    telemetry.drain_own_events()
    status = WebStatus(port=0).start()
    base = f"http://127.0.0.1:{status.port}"
    try:
        text = _get(f"{base}/metrics").decode()
        validate_exposition(text)
        assert 'znicz_hits_total{component="endpoint_test"} 3' in text
        chrome = json.loads(_get(f"{base}/trace.json"))
        assert any(e["cat"] == "endpoint_test"
                   for e in chrome["traceEvents"])
        fleet = json.loads(_get(f"{base}/trace.json?fleet=1&trace_id=ep-t1"))
        assert "ep-origin@1" in fleet["fleet"]["origins"]
        assert all(e["args"]["trace_id"] == "ep-t1"
                   for e in fleet["traceEvents"] if e["ph"] == "X")
        ev = json.loads(_get(f"{base}/events.json?since={seq - 1}"))
        assert ev["events"][0]["seq"] == seq and ev["last_seq"] >= seq
        assert ev["events"][0]["replica"] == "ep-r9"
        assert json.loads(_get(f"{base}/events.json?since=x"))["events"]
        fev = json.loads(_get(f"{base}/events.json?fleet=1&since=0"))
        assert fev["fleet"] is True and any(
            e.get("replica") == "ep-r9" for e in fev["events"])
        slo = json.loads(_get(f"{base}/slo.json"))
        assert set(slo) == {"state", "planes"}
        roll = json.loads(_get(f"{base}/fleet.json"))
        assert set(roll) == {"metrics", "trace", "events", "slo"}
        assert roll["trace"]["traces"] >= 1
        snap = json.loads(_get(f"{base}/status.json"))
        assert "workflows" in snap and "devices" in snap
        assert json.loads(_get(f"{base}/healthz")) == {"ok": True}
        ready = json.loads(_get(f"{base}/readyz", code=503))
        assert ready["ready"] is False and "slo" in ready
        page = _get(f"{base}/").decode()
        for link in ("/metrics", "/trace.json", "/events.json", "/slo.json",
                     "/fleet.json", "/status.json", "/healthz", "/readyz"):
            assert link in page
    finally:
        status.stop()


def test_webstatus_device_error_is_structured(monkeypatch):
    """A failure to enumerate the cards degrades into ``{"error": ...,
    "devices": []}``, never into the CPU in the card's place; with
    enumeration working the list is ``torch.cuda``'s."""
    import torch

    from znicz_torch.web_status import WebStatus

    def boom():
        raise RuntimeError("no card reachable")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    status = WebStatus(port=0).start()
    try:
        assert status.snapshot()["devices"] == {
            "error": "RuntimeError: no card reachable", "devices": []}
        body = json.loads(_get(f"http://127.0.0.1:{status.port}/status.json"))
        assert body["devices"]["error"].startswith("RuntimeError")
        page = _get(f"http://127.0.0.1:{status.port}/").decode()
        assert "unavailable" in page           # the page renders
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert status.snapshot()["devices"]["devices"] == []
        assert "is_available" in status.snapshot()["devices"]["error"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i: f"card{i}")
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda i: (1 << 30, 80 << 30))
        assert status.snapshot()["devices"] == [
            {"index": i, "name": f"card{i}", "mem_free": 1 << 30,
             "mem_total": 80 << 30} for i in range(2)]
        assert "cuda:1 card1" in _get(
            f"http://127.0.0.1:{status.port}/").decode()
    finally:
        status.stop()


def test_stalled_scraper_never_wedges_the_registry():
    """A scraper that connects and never reads leaves no registry lock
    held: increments and a second scrape proceed at once."""
    from znicz_torch import telemetry
    from znicz_torch.web_status import WebStatus

    c = telemetry.scope("stall_test").counter("hits")
    status = WebStatus(port=0).start()
    stalled = socket.create_connection(("127.0.0.1", status.port),
                                       timeout=5)
    try:
        stalled.sendall(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
        t0 = time.perf_counter()
        c.inc(5)                             # must not block
        text = _get(f"http://127.0.0.1:{status.port}/metrics").decode()
        assert time.perf_counter() - t0 < 10
        assert 'znicz_hits_total{component="stall_test"} 5' in text
    finally:
        stalled.close()
        status.stop()


def test_format_value_and_labels_match_the_reference():
    tm, jm = _pair("metrics")
    for v in (0, 1, -7, 2 ** 70, 1.5, 1e-300, 3.0, -0.0, float("inf"),
              float("-inf"), float("nan"), True, np.float32(0.1),
              np.int64(12)):
        assert tm._format_value(v) == jm._format_value(v), v
    labels = {"b": 'x"\\\n', "a": 1}
    assert tm._render_labels(labels, {"q": "0.5"}) == \
        jm._render_labels(labels, {"q": "0.5"})
    assert math.isnan(float(tm._format_value(float("nan"))))
