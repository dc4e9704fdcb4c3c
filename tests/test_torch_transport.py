"""The port's transport core (``znicz_torch/transport/``,
``znicz_torch/network_common.py``) against the reference's on the CPU:
the loop's ROUTER/PULL/DEALER dispatch, ticks and stop over ephemeral
ports; each plane's retry constants; the circuit breaker's transitions
and the admission buckets' decisions on a frozen clock; the ingress fault
hook with a stub schedule; the REQ endpoint's fault model.  Decisions
and delays are compared exactly; no test depends on the wall clock."""

import threading
import time

import numpy as np
import pytest
import zmq

from znicz_torch import network_common as tnc
from znicz_torch import transport as tt
from znicz_torch.parallel import wire as tw
from znicz_tpu import transport as jt


class FrozenClock:
    """A ``time.perf_counter`` that moves only when told to."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FrozenClock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def _serve(loop):
    t = threading.Thread(target=loop.run, kwargs={"poll_ms": 5},
                         daemon=True)
    t.start()
    return t


def _recv(sock, timeout_ms=20_000):
    assert sock.poll(timeout_ms), "no reply"
    return sock.recv_multipart()


def test_loop_routes_router_pull_and_dealer_then_stops():
    """A ROUTER echo, a PULL sink and a DEALER to a second ROUTER on one
    loop: each handler gets its frames, replies route back by envelope,
    ticks run every lap, and a tick's stop() ends run()."""
    loop = tt.TransportLoop("test", instance="a")
    router = loop.bind_router("tcp://127.0.0.1:*")
    endpoint = loop.resolved_endpoint(router)
    assert endpoint.startswith("tcp://127.0.0.1:") \
        and not endpoint.endswith(":*")
    pull = loop.bind_pull(f"inproc://test-pull-{id(loop)}")
    upstream = zmq.Context.instance().socket(zmq.ROUTER)
    upstream.setsockopt(zmq.LINGER, 0)
    up_port = upstream.bind_to_random_port("tcp://127.0.0.1")
    dealer = loop.connect_dealer(f"tcp://127.0.0.1:{up_port}")
    got = {"pull": [], "dealer": [], "ticks": 0}
    stop_after = threading.Event()

    def echo(frames):
        env, payload = tw.split_envelope(frames)
        msg, _ = tw.decode_message(payload)
        router.send_multipart(env + tw.encode_message(
            {"echo": msg["n"], "x": msg["x"] * 2})[0])

    def tick():
        got["ticks"] += 1
        if stop_after.is_set():
            loop.stop()

    loop.register(router, echo, drain=True, priority=10)
    loop.register(pull, lambda f: got["pull"].append(f), drain=True,
                  priority=5)
    loop.register(dealer, lambda f: got["dealer"].append(f), drain=True)
    loop.add_tick(tick)
    thread = _serve(loop)
    client = zmq.Context.instance().socket(zmq.DEALER)
    client.setsockopt(zmq.LINGER, 0)
    client.connect(endpoint)
    push = zmq.Context.instance().socket(zmq.PUSH)
    push.setsockopt(zmq.LINGER, 0)
    push.connect(f"inproc://test-pull-{id(loop)}")
    try:
        for n in range(3):
            client.send_multipart([b""] + tw.encode_message(
                {"n": n, "x": np.full(4, n, np.float32)})[0])
        replies = [tw.decode_message(tw.split_envelope(_recv(client))[1])[0]
                   for _ in range(3)]
        assert sorted(r["echo"] for r in replies) == [0, 1, 2]
        for r in replies:
            np.testing.assert_array_equal(r["x"], np.full(4, 2 * r["echo"]))
        push.send(b"wake")
        # the upstream ROUTER answers the loop's DEALER by its identity
        dealer_send = threading.Event()
        loop.add_tick(lambda: dealer_send.is_set()
                      or (dealer.send(b"hello"), dealer_send.set()))
        ident, body = _recv(upstream)
        assert body == b"hello"
        upstream.send_multipart([ident, b"ack"])
        deadline = time.monotonic() + 20
        while (not got["pull"] or not got["dealer"]) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got["pull"] == [[b"wake"]] and got["dealer"] == [[b"ack"]]
        assert got["ticks"] > 0
        assert loop.messages == 5
    finally:
        stop_after.set()
        thread.join(20)
        assert not thread.is_alive()
        loop.close()
        for s in (client, push, upstream):
            s.close(0)
    assert loop.stopping and loop.fault_counts() == {"drop": 0,
                                                     "corrupt": 0}


def test_bind_conflicts_raise_and_loopback_guard():
    a = zmq.Context.instance().socket(zmq.ROUTER)
    a.setsockopt(zmq.LINGER, 0)
    port = a.bind_to_random_port("tcp://127.0.0.1")
    loop = tt.TransportLoop("test")
    try:
        with pytest.raises(zmq.ZMQError):
            tnc.bind_with_retry(
                zmq.Context.instance().socket(zmq.ROUTER),
                f"tcp://127.0.0.1:{port}", attempts=2, delay_s=0.0)
        with pytest.raises(zmq.ZMQError):
            loop.bind_router(f"tcp://127.0.0.1:{port}")
        assert loop._owned == []              # the failed socket closed
    finally:
        a.close(0)
        loop.close()
    for host in ("127.0.0.1", "localhost", "::1", "0.0.0.0", "10.0.0.1"):
        from znicz_tpu.network_common import is_loopback_host

        assert tnc.is_loopback_host(host) == is_loopback_host(host)


def test_rep_lockstep_and_endpoint_fault_model():
    """An Endpoint's REQ link to a loop's REP socket: an rpc round trip,
    then a dead peer times out (PeerTimeout, the socket reset) and a
    breaker opened by consecutive failures refuses locally."""
    loop = tt.TransportLoop("rep")
    rep = loop.bind_rep("tcp://127.0.0.1:*")
    endpoint = loop.resolved_endpoint(rep)

    def answer(frames):
        msg, _ = tw.decode_message(frames)
        return tw.encode_message({"ok": True, "n": msg["n"] + 1})[0]

    loop.register(rep, answer, reply=True)
    thread = _serve(loop)
    sent, got = [], []
    ep = tt.Endpoint(endpoint, recv_timeout_s=20, count_out=sent.append,
                     count_in=got.append)
    try:
        assert ep.rpc_message({"n": 41}) == {"ok": True, "n": 42}
        assert ep.connected and sent and got
    finally:
        loop.stop()
        thread.join(20)
        loop.close()
        ep.close()
    dead = zmq.Context.instance().socket(zmq.ROUTER)
    dead.setsockopt(zmq.LINGER, 0)
    port = dead.bind_to_random_port("tcp://127.0.0.1")
    breaker = tt.CircuitBreaker(window=4, threshold=2, consecutive=True)
    ep = tt.Endpoint(f"tcp://127.0.0.1:{port}", recv_timeout_s=0.05,
                     retry=tt.RetryPolicy.for_training_client(),
                     breaker=breaker)
    try:
        for _ in range(2):
            with pytest.raises(tt.PeerTimeout):
                ep.rpc_message({"n": 0})
            assert not ep.connected
        assert breaker.state == "open"
        with pytest.raises(tt.CircuitOpenError):
            ep.rpc_message({"n": 0})
        assert ep.spent(9) and not ep.spent(8)
    finally:
        ep.close()
        dead.close(0)


@pytest.mark.parametrize("preset", ["training_client", "relay_upstream",
                                    "breaker"])
def test_retry_policy_constants_equal_the_reference(preset):
    make = {"training_client": lambda m: m.RetryPolicy.for_training_client(
                jitter_key="slave-3"),
            "relay_upstream": lambda m: m.RetryPolicy.for_relay_upstream(
                jitter_key="relay-1"),
            "breaker": lambda m: m.RetryPolicy.for_breaker(0.25, 8.0)}[preset]
    port, ref = make(tt), make(jt)
    for attr in ("base", "cap", "max_attempts", "exp_cap", "jitter"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert [port.delay(n) for n in range(1, 25)] \
        == [ref.delay(n) for n in range(1, 25)]
    assert [port.jittered(n) for n in range(1, 25)] \
        == [ref.jittered(n) for n in range(1, 25)]
    assert [port.spent(n) for n in range(12)] \
        == [ref.spent(n) for n in range(12)]


def _breaker_trace(mod, clock, consecutive):
    """The states and events of a breaker fed one outcome script on the
    frozen clock."""
    events = []
    br = mod.CircuitBreaker(window=6, threshold=3,
                            backoff=mod.RetryPolicy.for_breaker(0.5, 4.0),
                            on_event=events.append, peer="p",
                            consecutive=consecutive)
    script = [True, False, False, True, False, False, False, "admit",
              ("wait", 0.3), "admit", ("wait", 0.3), "probe_fail",
              ("wait", 0.9), "admit", ("wait", 1.2), "probe_ok", False,
              False, True, False, False, False, "admit"]
    trace = []
    token = 0
    for step in script:
        token += 1
        if step == "admit":
            try:
                br.admit()
                trace.append("admitted")
                br.release_probe()
            except mod.CircuitOpenError:
                trace.append("refused")
        elif isinstance(step, tuple):
            clock.now += step[1]
        elif step in ("probe_fail", "probe_ok"):
            try:
                br.admit()
            except mod.CircuitOpenError:
                trace.append("refused")
                continue
            trace.append(("armed", br.arm_probe(token)))
            br.record(token, step == "probe_ok")
        else:
            br.record(token, step)
        trace.append((br.state, br.failure_counts(),
                      round(br.remaining(), 6)))
    return trace, events


@pytest.mark.parametrize("consecutive", [False, True])
def test_circuit_breaker_transitions_equal_the_reference(clock,
                                                         consecutive):
    port = _breaker_trace(tt, clock, consecutive)
    clock.now = 1000.0
    ref = _breaker_trace(jt, clock, consecutive)
    assert port == ref
    assert "open" in port[1] and "probe" in port[1]
    off = tt.CircuitBreaker(threshold=0)
    off.record(1, False)
    off.admit()
    assert not off.enabled and off.state == "closed"


def test_token_bucket_and_admission_table_decide_alike(clock):
    """The same takes, refunds and refills on the frozen clock: the same
    decisions, tokens and table size (the sweep and the eviction
    included)."""
    out = []
    for mod in (tt, jt):
        clock.now = 1000.0
        tb = mod.TokenBucket(rate=100.0, burst=10.0)
        trace = [tb.try_take(10), tb.try_take(1)]
        clock.now += 0.06
        trace += [tb.try_take(4), round(tb.tokens, 9)]
        tb.refund(1000)
        trace += [tb.tokens, tb.is_full(clock.now)]
        table = mod.AdmissionTable(rate=8.0, burst=0.0, max_peers=4)
        for i in range(40):
            peer = f"p{i % 7}"
            trace.append(table.try_take(peer, 1 + i % 3))
            if i % 5 == 0:
                table.refund(peer, 2)
            clock.now += 0.05
            trace.append(len(table))
        trace.append(table.snapshot())
        assert mod.AdmissionTable(0.0).try_take("x", 10 ** 6)
        out.append(trace)
    assert out[0] == out[1]


class StubSchedule:
    """A fault schedule: a scripted ``decide_transport`` and a seed."""

    seed = 77

    def __init__(self, actions):
        self.actions = actions

    def decide_transport(self, i):
        return self.actions[i % len(self.actions)], None


def test_fault_hook_drops_and_corrupts_with_a_stub_schedule():
    """pass / drop / corrupt on a ROUTER: the dropped message never
    reaches the handler, the corrupted one fails to decode (its envelope
    intact, so a refusal routes back), and the mutation is the
    reference's for the same seed."""
    loop = tt.TransportLoop("chaos")
    router = loop.bind_router("tcp://127.0.0.1:*")
    outcomes = []

    def handle(frames):
        env, payload = tw.split_envelope(frames)
        try:
            msg, _ = tw.decode_message(payload)
            outcomes.append(msg["n"])
            router.send_multipart(env + tw.encode_message({"n": msg["n"]})[0])
        except tw.WireError as exc:
            outcomes.append("bad")
            router.send_multipart(env + tw.encode_message(
                tt.bad_frame_reply(exc))[0])

    loop.register(router, handle, drain=True)
    loop.inject_faults(StubSchedule(["pass", "drop", "corrupt"]))
    thread = _serve(loop)
    client = zmq.Context.instance().socket(zmq.DEALER)
    client.setsockopt(zmq.LINGER, 0)
    client.connect(loop.resolved_endpoint(router))
    try:
        replies = []
        for n in range(6):
            client.send_multipart([b""] + tw.encode_message(
                {"n": n, "x": np.arange(6, dtype=np.float32)})[0])
        for _ in range(4):                      # 2 passed + 2 corrupted
            replies.append(tw.decode_message(
                tw.split_envelope(_recv(client))[1])[0])
        assert not client.poll(200)             # the drops never answer
    finally:
        loop.stop()
        thread.join(20)
        loop.close()
        client.close(0)
    assert sorted(map(str, outcomes)) == ["0", "3", "bad", "bad"]
    assert sum(1 for r in replies if r.get("bad_frame")) == 2
    assert loop.fault_counts() == {"drop": 2, "corrupt": 2}
    assert loop.messages == 6
    loop.inject_faults(None)
    frames = [b"id", b""] + [bytes(f) for f in tw.encode_message(
        {"x": np.arange(9.0)})[0]]
    for seed in range(8):
        assert tt.corrupt_message(list(frames), (77, seed, 0xC0DE)) \
            == jt.corrupt_message(list(frames), (77, seed, 0xC0DE))
    assert tt.corrupt_payload(b"") == jt.corrupt_payload(b"") == b"\xff"
    assert tt.bad_frame_reply("x") == jt.bad_frame_reply("x")


def test_deadline_budgets_round_trip():
    assert tt.local_deadline(None) is None
    assert tt.local_deadline("garbage") is None
    assert tt.local_deadline(float("nan")) is None
    assert tt.local_deadline(250.0, now=10.0) == pytest.approx(10.25)
    assert tt.local_deadline(5e6, now=0.0, cap_s=2.0) == 2.0
    assert tt.remaining_ms(None) is None
    assert tt.remaining_ms(10.25, now=10.0) == pytest.approx(250.0)
    for args in ((250.0, 10.0), (5e6, 0.0, 2.0), ("x", 1.0)):
        assert tt.local_deadline(*args) == jt.local_deadline(*args)
