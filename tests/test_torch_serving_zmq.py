"""The port's ZMQ serving plane (``znicz_torch/serving/``: the ROUTER
frontend, admission control and deadlines, the DEALER client, the
``--serve`` CLI) against the reference's on the CPU.

  - the batcher: the same submit script gives the same batches and the
    same refusals (``policy``, ``scope``) in both packages, admission on
    and off, fair queueing on and off, on a frozen clock;
  - end to end: servers of both packages serve the same weights (an
    MNIST-size MLP, and AlexNet at 67x67 under ``fused_elementwise`` +
    ``fused_tail``); each package's client is served by both servers, and
    every reply lies within ``REPLY_RTOL`` (max|d| / max|ref|) of the
    other server's and of ``ModelRunner.infer``: the two libraries sum in
    different orders, and a batch's composition changes a CPU product's
    blocking;
  - every refusal gets the reference's ``policy`` (a compute gate holds a
    batch on the device side where a refusal needs a full queue or a
    spent deadline; deadlines are made strictly past, never raced);
  - robustness and control over the wire, ``max_requests``, the bind
    conflict in ``start()``, the CLI in a subprocess, and ROADMAP C.8:
    every reference serving key is read or refused by name.

Every server binds ``tcp://127.0.0.1:*``; no test bounds a wall time."""

import contextlib
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import zmq

from test_torch_planner import jax_workflow, knobs

REPO = pathlib.Path(__file__).resolve().parent.parent
REPLY_RTOL = 1e-5
MNIST_LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100}},
                {"type": "softmax", "->": {"output_sample_shape": 10}}]
ALEXNET = (67, 67, 3)


def _port_twin(jwf, layers, sample_shape):
    from znicz_torch.parallel.fused import FusedTrainer as TTrainer
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax
    from znicz_tpu.parallel.fused import FusedTrainer

    tree = {name: {k: np.asarray(v) for k, v in leaves.items()}
            for name, leaves in FusedTrainer(jwf).extract_params().items()}
    twf = params_from_jax(tree, StandardWorkflow(layers, sample_shape,
                                                 device="cpu"))
    assert len(TTrainer(twf)._weighted()) == len(tree)
    return twf, tree


@pytest.fixture(scope="module")
def mnist_pair():
    jwf = jax_workflow(MNIST_LAYERS, sample_shape=(784,))
    twf, tree = _port_twin(jwf, MNIST_LAYERS, (784,))
    return jwf, twf, tree


@pytest.fixture(scope="module")
def alexnet_pair():
    from znicz_tpu.samples.alexnet import make_layers

    layers = make_layers(10)
    jwf = jax_workflow(layers, sample_shape=ALEXNET, n=4)
    twf, tree = _port_twin(jwf, layers, ALEXNET)
    return jwf, twf, tree


@contextlib.contextmanager
def _server(mod_name, wf, **kw):
    """A started InferenceServer of ``mod_name`` ("port"/"ref")."""
    if mod_name == "port":
        from znicz_torch.serving import InferenceServer
    else:
        from znicz_tpu.serving import InferenceServer
    srv = InferenceServer(wf, bind="tcp://127.0.0.1:*", **kw).start()
    try:
        yield srv
    finally:
        srv.stop()


def _client(mod_name, endpoint, **kw):
    if mod_name == "port":
        from znicz_torch.serving import InferenceClient
    else:
        from znicz_tpu.serving import InferenceClient
    return InferenceClient(endpoint, **kw)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(shape, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n,) + shape).astype(np.float32) for n in sizes]


# -- the batcher -----------------------------------------------------------------


class FrozenClock:
    def __init__(self):
        self.now = 500.0

    def __call__(self):
        return self.now


def _batcher_script(mod, clock, admission):
    """Submits from three clients interleaved with drains, on the frozen
    clock: the batches (by req_id) and refusals (policy, scope, counters)
    as a comparable trace."""
    b = mod.DynamicBatcher(max_batch=8, max_delay_ms=1.0, queue_bound=24,
                           admission=mod.AdmissionPolicy(**admission))
    trace = []
    rid = 0
    script = [("a", 3), ("a", 2), ("b", 1), ("flood", 4), ("flood", 4),
              ("flood", 4), ("b", 2), "drain", ("c", 8), ("a", 9),
              ("flood", 4), ("flood", 2), ("b", 3), ("c", 1), "drain",
              ("wait", 0.5), ("flood", 4), ("a", 5), ("b", 4), ("c", 3),
              ("flood", 4), ("flood", 4), ("a", 1), "drain", "drain",
              ("b", 0), ("c", 6), "drain", "drain", "drain"]
    for step in script:
        if step == "drain":
            batch = b.next_batch(timeout=0.0, wait_fill=False)
            trace.append(None if batch is None
                         else [(r.req_id, r.client) for r in batch])
        elif step[0] == "wait":
            clock.now += step[1]
        else:
            client, n = step
            rid += 1
            ref = b.submit(mod.Request(np.zeros((max(n, 1), 2)), n,
                                       req_id=rid, client=client))
            trace.append(None if ref is None
                         else (rid, ref.policy, ref.scope, str(ref)))
    b.close()
    while True:
        batch = b.next_batch(timeout=0.0)
        if batch is None:
            break
        trace.append([(r.req_id, r.client) for r in batch])
    st = b.stats()
    trace.append({k: st[k] for k in ("submitted", "shed", "oversized",
                                     "rate_limited", "batches",
                                     "batched_requests", "batched_rows",
                                     "padded_rows", "bucket_hits",
                                     "pad_ratio", "mean_occupancy")})
    adm = st["admission"]
    trace.append({k: adm[k] for k in adm if k != "active_clients"})
    trace.append(b.occupancy())
    return trace


@pytest.mark.parametrize("admission", [
    {"enabled": False},
    {"fair": False},
    {"fair": True, "quantum": 2},
    {"fair": True, "rate_limit": 1e-3, "rate_burst": 9.0,
     "client_queue_bound": 9},
    {"fair": False, "rate_limit": 1e-3, "rate_burst": 12.0},
], ids=["off", "fifo", "fair", "fair_rate_bound", "fifo_rate"])
def test_batcher_batches_and_refuses_as_the_reference(admission,
                                                      monkeypatch):
    """A rate of 1e-3 rows/s refills nothing the script can see (the
    frozen clock moves 0.5 s: 5e-4 rows)."""
    from znicz_torch.serving import batcher as tb
    from znicz_tpu.serving import batcher as jb

    clock = FrozenClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    port = _batcher_script(tb, clock, admission)
    clock.now = 500.0
    ref = _batcher_script(jb, clock, admission)
    assert port == ref
    refusals = {t[1] for t in port if isinstance(t, tuple)}
    assert "oversized" in refusals
    if admission.get("rate_limit"):
        assert "rate_limited" in refusals


def test_refusal_and_policy_objects():
    from znicz_torch.serving import AdmissionPolicy, Refusal, TokenBucket
    from znicz_torch.transport.admission import TokenBucket as TB

    assert TokenBucket is TB
    r = Refusal("rate_limited", "client over its rate limit")
    assert isinstance(r, str) and r.policy == "rate_limited"
    assert r.scope == "service" and str(r) == "client over its rate limit"
    assert Refusal("shed", "x", scope="client").scope == "client"
    p = AdmissionPolicy()
    assert (p.enabled, p.fair, p.rate_limit, p.quantum) == (True, True,
                                                            0.0, 0)


# -- end to end over ZMQ ----------------------------------------------------------


def _cross_serve(jwf, twf, shape, sizes, max_batch, seed):
    """Both servers, each package's client to each: {(server, client):
    [y]} plus both runners' forwards of the same inputs."""
    xs = _inputs(shape, sizes, seed)
    out = {}
    runners = {}
    with _server("port", twf, max_batch=max_batch, max_delay_ms=2.0) as ts, \
            _server("ref", jwf, max_batch=max_batch, max_delay_ms=2.0) as js:
        for srv_name, srv in (("port", ts), ("ref", js)):
            runners[srv_name] = srv.runner
            for cli_name in ("port", "ref"):
                cli = _client(cli_name, srv.endpoint, timeout=120)
                try:
                    # pipelined: every request in flight at once
                    rids = [cli.submit(x) for x in xs]
                    reps = [cli.result(r, timeout=120) for r in rids]
                finally:
                    cli.close()
                assert all(rep["ok"] and rep["gen"] == 1 for rep in reps)
                out[srv_name, cli_name] = [rep["y"] for rep in reps]
        stats = {"port": ts.stats(), "ref": js.stats()}
    infer = {name: [r.infer(x) for x in xs] for name, r in runners.items()}
    return xs, out, infer, stats


def _check_cross(xs, out, infer, n_out):
    worst = 0.0
    for ys in out.values():
        for x, y, want_p, want_j in zip(xs, ys, infer["port"],
                                        infer["ref"]):
            assert y.shape == (x.shape[0], n_out)
            assert np.isfinite(y).all()
            worst = max(worst, _rel(y, want_j), _rel(y, want_p))
    for i in range(len(xs)):
        # the port's server against the reference's, for each client
        for cli in ("port", "ref"):
            worst = max(worst, _rel(out["port", cli][i], out["ref", cli][i]))
    assert worst <= REPLY_RTOL, worst


def test_mnist_size_served_across_packages(mnist_pair):
    jwf, twf, _ = mnist_pair
    xs, out, infer, stats = _cross_serve(jwf, twf, (784,),
                                         (1, 3, 8, 2, 5, 7, 1, 4), 8, 11)
    _check_cross(xs, out, infer, 10)
    assert stats["port"]["served"] == 16
    assert stats["port"]["batcher"]["batched_rows"] == 2 * 31
    assert stats["port"]["bytes_in"] > 2 * 31 * 784 * 4
    assert stats["port"]["p50_ms"] is not None


def test_alexnet_served_across_packages_fused(alexnet_pair):
    jwf, twf, _ = alexnet_pair
    with knobs(fused_elementwise=True, fused_tail=True):
        xs, out, infer, stats = _cross_serve(jwf, twf, ALEXNET,
                                             (1, 3, 2, 4, 1), 4, 12)
    _check_cross(xs, out, infer, 10)
    assert np.std(np.concatenate(infer["port"])) > 0
    assert stats["port"]["served"] == 10 and stats["port"]["bad_frames"] == 0


# -- refusals ---------------------------------------------------------------------


class Gate:
    """Holds the compute thread inside ``runner.infer_staged`` until
    opened, so the batcher's queue and the deadlines can be set up with
    a batch held on the device side."""

    def __init__(self, runner):
        self.held = threading.Event()
        self.open = threading.Event()
        self._infer = runner.infer_staged
        runner.infer_staged = self

    def __call__(self, *args, **kw):
        if not self.open.is_set():
            self.held.set()
            assert self.open.wait(120)
        return self._infer(*args, **kw)


class ShiftedClock:
    """``time.perf_counter`` plus an offset the test moves forward: both
    packages' frontends and batchers read the module's clock, so a jump
    puts a deadline strictly in the past without racing a real one."""

    def __init__(self):
        self.real = time.perf_counter
        self.offset = 0.0

    def __call__(self):
        return self.real() + self.offset


def _raw(endpoint):
    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(endpoint)
    return sock


def _encode(msg):
    from znicz_torch.parallel import wire

    return [b""] + wire.encode_message(msg)[0]


def _receive(sock):
    from znicz_torch.parallel import wire

    assert sock.poll(120_000), "no reply"
    return wire.decode_message(wire.split_envelope(
        sock.recv_multipart())[1])[0]


def _ask(sock, msg):
    sock.send_multipart(_encode(msg))
    return _receive(sock)


def _view(rep):
    """The parts of a reply both packages must agree on."""
    return {k: rep.get(k) for k in ("ok", "rejected", "timed_out", "policy",
                                    "scope", "error", "bad_frame")}


def _refusal_script(mod_name, wf, clock):
    """Every refusal of the serving plane against one package's server
    (max_batch 4, queue_bound 4 rows, a rate of 1e-3 rows/s with a burst
    of 4 rows a client: nothing refills within the test); returns
    {case: reply view}, the server's counters and its admission table."""
    if mod_name == "port":
        from znicz_torch.serving import AdmissionPolicy
    else:
        from znicz_tpu.serving import AdmissionPolicy
    views = {}
    x = np.zeros((2, 784), np.float32)
    with _server(mod_name, wf, max_batch=4, max_delay_ms=1.0,
                 queue_bound=4, request_ttl_s=60.0,
                 admission=AdmissionPolicy(rate_limit=1e-3,
                                           rate_burst=4.0)) as srv:
        sock = _raw(srv.endpoint)
        try:
            views["oversized"] = _ask(sock, {
                "cmd": "infer", "req_id": 1, "client": "good",
                "x": np.zeros((5, 784), np.float32)})
            views["shape"] = _ask(sock, {"cmd": "infer", "req_id": 2,
                                         "x": np.zeros((2, 77), np.float32)})
            views["dtype"] = _ask(sock, {
                "cmd": "infer", "req_id": 3,
                "x": np.zeros((2, 784), np.complex64)})
            views["no_x"] = _ask(sock, {"cmd": "infer", "req_id": 4})
            views["cmd"] = _ask(sock, {"cmd": "bogus", "req_id": 5})
            views["deadline"] = _ask(sock, {"cmd": "infer", "req_id": 6,
                                            "client": "good", "x": x,
                                            "deadline_ms": 0})
            # one client over its rate limit while another is served
            flood = [_ask(sock, {"cmd": "infer", "req_id": 10 + i,
                                 "client": "flood", "x": x})
                     for i in range(4)]
            assert [r["ok"] for r in flood] == [True, True, False, False]
            views["rate_limited"] = flood[2]
            good = _ask(sock, {"cmd": "infer", "req_id": 7,
                               "client": "good", "x": x})
            assert good["ok"] and good["y"].shape == (2, 10)
            # a batch held on the device side: the queue fills, a shed
            gate = Gate(srv.runner)
            sock.send_multipart(_encode({"cmd": "infer", "req_id": 8,
                                         "client": "c1", "x": x,
                                         "deadline_ms": 5000.0}))
            assert gate.held.wait(120)
            sock.send_multipart(_encode({
                "cmd": "infer", "req_id": 9, "client": "c2",
                "x": np.zeros((4, 784), np.float32),
                "deadline_ms": 5000.0}))
            views["shed"] = _ask(sock, {"cmd": "infer", "req_id": 20,
                                        "client": "c3", "x": x[:1]})
            # both deadlines strictly past when the gate opens: 8's result
            # is dropped after its compute, 9 expires before its own
            clock.offset += 10.0
            gate.open.set()
            later = {}
            while len(later) < 2:
                rep = _receive(sock)
                later[rep["req_id"]] = rep
            views["expired_result"] = later[8]
            views["timed_out_assemble"] = later[9]
        finally:
            sock.close(0)
        counters = {k: getattr(srv, k) for k in (
            "requests_in", "served", "timed_out", "rejected",
            "expired_results", "bad_frames")}
        clients = srv.batcher.admission_stats()["clients"]
    return {k: _view(v) for k, v in views.items()}, counters, clients


def test_every_refusal_gets_the_reference_policy(mnist_pair, monkeypatch):
    jwf, twf, _ = mnist_pair
    clock = ShiftedClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    port, port_counts, port_adm = _refusal_script("port", twf, clock)
    ref, ref_counts, ref_adm = _refusal_script("ref", jwf, clock)
    assert port == ref
    assert port_counts == ref_counts
    policies = {case: v["policy"] for case, v in port.items()}
    assert policies == {
        "oversized": "oversized", "shape": None, "dtype": None,
        "no_x": None, "cmd": None, "deadline": "deadline",
        "rate_limited": "rate_limited", "shed": "shed",
        "expired_result": "deadline", "timed_out_assemble": "deadline"}
    assert port["rate_limited"]["scope"] == "client"
    assert port["shed"]["scope"] == "service"
    assert port["oversized"]["scope"] == "client"
    assert "expired before compute" in port["timed_out_assemble"]["error"]
    assert "past the deadline" in port["expired_result"]["error"]
    assert port_counts["expired_results"] == 1
    assert port_adm["flood"]["rate_limited"] == 2
    assert port_adm == ref_adm


# -- robustness and control -------------------------------------------------------


def test_bad_frames_and_control_commands_over_the_wire(mnist_pair,
                                                       tmp_path):
    """A garbage frame is answered (routable, counted) and the next
    request served; ping, stats, swap and rollback over the wire, every
    reply stamped with the generation that computed it."""
    from znicz_torch.parallel import wire
    from znicz_torch.serving import InferenceError
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.snapshotter import write_host_pickle
    from znicz_torch.standard_workflow import StandardWorkflow

    _, twf, tree = mnist_pair
    second = {name: {k: (0.5 * a + 0.01).astype(np.float32)
                     for k, a in leaves.items()}
              for name, leaves in tree.items()}
    path = str(tmp_path / "gen2.pickle.gz")
    write_host_pickle(path, {"units": second, "velocities": {}, "epoch": 2})
    x = _inputs((784,), (3,), 21)[0]
    want = {1: ModelRunner(twf).infer(x), 2: ModelRunner(
        StandardWorkflow(MNIST_LAYERS, (784,), device="cpu"),
        snapshot=path).infer(x)}
    assert _rel(want[1], want[2]) > 1e-2
    with _server("port", twf, max_batch=4, max_delay_ms=1.0) as srv:
        raw = _raw(srv.endpoint)
        cli = _client("port", srv.endpoint, timeout=120)
        try:
            raw.send_multipart([b"\xff garbage \x00"])
            assert raw.poll(120_000)
            rep, _ = wire.decode_message(raw.recv_multipart())
            assert rep["bad_frame"] is True and srv.bad_frames == 1
            assert rep["error"].startswith("bad frame: ")
            raw.send_multipart([b""] + [wire.MAGIC + b"torn"])
            assert raw.poll(120_000)
            rep, _ = wire.decode_message(wire.split_envelope(
                raw.recv_multipart())[1])
            assert rep["bad_frame"] and srv.bad_frames == 2
            y = cli.infer(x)
            assert _rel(y, want[1]) <= REPLY_RTOL
            pong = cli.ping()
            assert pong["pong"] and pong["replica_id"] == srv.replica_id
            st = cli.stats()
            assert st["bad_frames"] == 2 and st["served"] == 1
            assert st["generation"] == 1 and st["ready"]
            with pytest.raises(InferenceError, match="path"):
                cli._command("swap")
            with pytest.raises(InferenceError, match="no previous"):
                cli.rollback()
            ack = cli.swap(path)
            assert ack["swap_started"] and ack["generation"] == 1
            deadline = time.monotonic() + 120
            while cli.stats()["generation"] != 2:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            rep = cli.result(cli.submit(x))
            assert rep["gen"] == 2 and _rel(rep["y"], want[2]) <= REPLY_RTOL
            back = cli.rollback()
            assert back["rolled_back"] and back["generation"] == 1
            rep = cli.result(cli.submit(x))
            assert rep["gen"] == 1 and _rel(rep["y"], want[1]) <= REPLY_RTOL
            st = cli.stats()
            assert (st["swaps"], st["rollbacks"], st["swap_failures"]) \
                == (1, 1, 0)
            assert srv.codec.bytes_out > 0 and cli.bad_replies == 0
        finally:
            cli.close()
            raw.close(0)


def test_max_requests_ends_serve_and_start_raises_a_bind_conflict(
        mnist_pair):
    from znicz_torch.serving import InferenceServer

    _, twf, _ = mnist_pair
    srv = InferenceServer(twf, max_batch=4, max_delay_ms=1.0,
                          max_requests=3).start()
    try:
        with pytest.raises(RuntimeError, match="failed on") as info:
            InferenceServer(twf, bind=srv.endpoint, max_batch=2).start()
        assert isinstance(info.value.__cause__, zmq.ZMQError)
        cli = _client("port", srv.endpoint, timeout=120)
        try:
            for n in (1, 2):
                assert cli.infer(np.zeros((n, 784), np.float32)).shape \
                    == (n, 10)
            with pytest.raises(Exception):
                cli.infer(np.zeros((9, 784), np.float32))   # the third
        finally:
            cli.close()
        srv.join(120)
        assert not srv._thread.is_alive() and not srv.alive()
        assert srv.served + srv.rejected + srv.timed_out == 3
        assert srv.draining and not srv.ready()
    finally:
        srv.stop()


def test_in_process_submit_rides_beside_the_router(mnist_pair):
    """``submit(Request)`` with a Future is answered by the compute thread
    while the same server serves the wire; its reply is the reference
    dict less nothing the caller needs."""
    from concurrent.futures import Future

    from znicz_torch.serving import Request

    _, twf, _ = mnist_pair
    x = _inputs((784,), (3,), 5)[0]
    with _server("port", twf, max_batch=4, max_delay_ms=1.0) as srv:
        fut = Future()
        assert srv.submit(Request(x, 3, reply_to=fut, req_id="in")) is None
        cli = _client("port", srv.endpoint, timeout=120)
        try:
            y = cli.infer(x)
        finally:
            cli.close()
        rep = fut.result(120)
    assert rep["ok"] and rep["req_id"] == "in" and rep["gen"] == 1
    assert _rel(rep["y"], y) <= REPLY_RTOL


# -- the CLI ----------------------------------------------------------------------


MNIST_TINY = ["root.mnist.loader.n_train=120", "root.mnist.loader.n_valid=60",
              "root.mnist.loader.minibatch_size=60"]


def test_cli_serves_until_max_requests(tmp_path):
    from znicz_torch.serving import InferenceClient

    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_torch", "mnist", "--serve",
         "tcp://127.0.0.1:*", "--device", "cpu", "--replica-id", "r-7",
         "root.common.serving.max_requests=2", *MNIST_TINY],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving mnist at tcp://127.0.0.1:"), \
            line + proc.stderr.read()
        endpoint = line.split(" at ")[1].split()[0]
        cli = InferenceClient(endpoint, timeout=120)
        try:
            rep = cli.result(cli.submit(np.zeros((2, 784), np.float32)))
            assert rep["y"].shape == (2, 10) and rep["replica_id"] == "r-7"
            assert cli.infer(np.zeros((784,), np.float32)).shape == (1, 10)
        finally:
            cli.close()
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert '"served": 2' in out.splitlines()[-1]


def test_cli_refuses_a_training_flag_with_serve():
    from znicz_torch.__main__ import main

    assert main(["mnist", "--serve", "--fused", "--device", "cpu"]) == 2


# -- C.8 --------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = val
    return out


def test_every_reference_serving_key_is_read_or_refused():
    """The keys ``serving/frontend.DEFAULTS`` reads (with the reference's
    defaults) and ``UNPORTED_SERVING_KEYS`` refuses are together exactly
    the reference's, flattened."""
    from znicz_torch.core.config import UNPORTED_SERVING_KEYS
    from znicz_torch.serving.frontend import DEFAULTS
    from znicz_tpu.serving.frontend import DEFAULTS as JDEFAULTS

    ref, read = _flat(JDEFAULTS), _flat(DEFAULTS)
    assert set(read) | set(UNPORTED_SERVING_KEYS) == set(ref)
    assert not set(read) & set(UNPORTED_SERVING_KEYS)
    balance = {key for key in ref if key.startswith("balance.")}
    assert len(balance) == 26
    assert set(read) == {"max_batch", "max_delay_ms", "queue_bound",
                         "request_ttl_s", "max_requests",
                         "admission.enabled", "admission.rate_limit",
                         "admission.rate_burst", "admission.fair",
                         "admission.quantum",
                         "admission.client_queue_bound", "mesh.data",
                         "mesh.model", "aot_cache.enabled",
                         "aot_cache.dir", "seq.max_len",
                         "seq.rungs", "web_port"} | balance | {
                             f"obs.{key}" for key in (
                                 "exemplars", "exemplar_window_s",
                                 "metrics_every_beats", "slo_availability",
                                 "slo_p99_ms", "slo_ttft_ms",
                                 "slo_inter_token_ms", "slo_fast_window_s",
                                 "slo_slow_window_s")} | {
                             f"generate.{key}" for key in (
                                 "enabled", "max_new_tokens", "page_size",
                                 "num_pages", "prefill_chunk",
                                 "prefix_cache", "on_device_sampling",
                                 "slots", "decode_tick_ms",
                                 "pending_bound")}
    for key, val in read.items():
        assert val == ref[key], key
    for key, (default, item) in UNPORTED_SERVING_KEYS.items():
        assert default == ref[key], key
        want = {"obs": "A.9", "web_port": "A.9"}[key.split(".")[0]]
        assert item == want, key


@pytest.mark.parametrize("key,value,item", [
    ("admission.rate_limit", 20.0, None),
    # the serving mesh is read since it was ported (under its old id):
    # one process cannot hold a 2-rank mesh, and says how to start one
    pytest.param("mesh.data", 2, None, id="mesh.data-2-A.6"),
    # generation is read since it was ported (under its old id): a server
    # of fixed-shape samples refuses it by the reference's reason
    pytest.param("generate.enabled", True, None,
                 id="generate.enabled-True-A.8"),
    # telemetry's keys are read since it was ported (under their old
    # ids): the exemplar window by the server, the dashboard's port by
    # the launcher
    pytest.param("obs.exemplars", 4, None, id="obs.exemplars-4-A.9"),
    pytest.param("web_port", 8080, None, id="web_port-8080-A.9"),
    # the seq axis is read since sequences were ported (under its old id)
    pytest.param("seq.max_len", 16, None, id="seq.max_len-16-A.8"),
    # the replica fleet's keys are read since the balancer was ported
    # (the first under its old id)
    pytest.param("balance.hedge", False, None, id="balance.hedge-False-A.6"),
    ("balance.hedge_floor_s", 0.2, None),
    ("balance.heartbeat_s", 0.1, None)])
def test_a_refused_serving_key_raises_by_name(mnist_pair, key, value, item):
    from znicz_torch.core.config import root
    from znicz_torch.serving import InferenceServer, ReplicaBalancer

    from znicz_torch.core.config import UNPORTED_SERVING_KEYS
    from znicz_torch.serving.frontend import DEFAULTS

    _, twf, _ = mnist_pair
    default = UNPORTED_SERVING_KEYS[key][0] if item else \
        _flat(DEFAULTS)[key]
    root.common.serving.set_by_path(key, value)
    try:
        if item is None and key.startswith("generate."):
            with pytest.raises(ValueError, match="generation serving rides "
                               "the variable-length plane"):
                InferenceServer(twf, warmup=False)
            return
        if item is None and key.startswith("mesh."):
            with pytest.raises(ValueError, match="distributed_init"):
                InferenceServer(twf, warmup=False)
            return
        if item is None and key.startswith("balance."):
            # read: the server starts, the balancer takes the value
            srv = InferenceServer(twf, warmup=False)
            assert ReplicaBalancer().knobs[key[len("balance."):]] == value
            assert srv.heartbeat_s == (value if key.endswith("heartbeat_s")
                                       else DEFAULTS["balance"]
                                       ["heartbeat_s"])
            return
        if item is None and key.startswith("seq."):
            # read: a 2-D ladder up to max_len
            srv = InferenceServer(twf, warmup=False)
            assert srv.seq_max_len == srv.batcher.ladder.max_len == value
            assert srv.batcher.ladder.seq_rungs[-1] == value
            return
        if item is None and key.startswith("obs."):
            srv = InferenceServer(twf, warmup=False)
            assert srv._exemplar_cap == value
            return
        if item is None and key == "web_port":
            from znicz_torch.__main__ import serving_web_port

            InferenceServer(twf, warmup=False)
            assert serving_web_port() == value
            return
        if item is None:                      # read: the server takes it
            srv = InferenceServer(twf, warmup=False)
            assert srv.batcher.admission.rate_limit == 20.0
            return
        with pytest.raises(NotImplementedError,
                           match=f"root.common.serving.{key}=.*{item}"):
            InferenceServer(twf, warmup=False)
    finally:
        if key.startswith(("seq.", "generate.")):
            # unset: an explicit 0 would force fixed-shape serving on a
            # sequence sample served later in this process, and a left
            # generate key would turn generation on for it
            tree, leaf = key.split(".")
            delattr(getattr(root.common.serving, tree), leaf)
        else:
            root.common.serving.set_by_path(key, default)
