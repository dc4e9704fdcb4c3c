"""The port's serving chaos harness (``znicz_torch/parallel/chaos.py``) on
the CPU, after ``tests/test_chaos.py`` and the chaos tests of
``tests/test_serving.py``:

  - ``FaultSchedule`` decides as the reference's does, bit for bit, for
    several seeds over 2000 indices of every stream (wire, compute,
    transport, preemption, partition windows);
  - ``ChaosProxy`` corrupts exactly one payload frame, never the ROUTER
    envelope;
  - a soak through the proxy (drop, corrupt, duplicate, delay) against a
    port ``InferenceServer``: every request answered once, bit for bit as
    the rung it rode computes it, and every corrupted request counted in
    ``bad_frames``;
  - a ``FloodProcess`` at ten times its rate limit sees only
    ``rate_limited`` refusals and its fair share served, while a paced
    client gets every reply;
  - compute stalls across a swap: one ``decide_compute`` decision a
    dispatch, the swap's warm included, counted in ``stats()["stalls"]``.

Every ZMQ endpoint is ``tcp://127.0.0.1:*``; no test asserts a wall-clock
bound (the waits below are generous limits on progress, not timings).
"""

import threading
import time

import numpy as np
import pytest

SEEDS = (0, 7, 2024, 4242)
N = 2000
#: the reference chaos tests' wire fault mix
CHAOS = dict(drop=0.05, corrupt=0.06, duplicate=0.04, delay=0.05,
             delay_s=(0.01, 0.05))
MNIST_LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100}},
                {"type": "softmax", "->": {"output_sample_shape": 10}}]


def _mnist():
    from znicz_torch.core import prng
    from znicz_torch.standard_workflow import StandardWorkflow

    prng.reset(1013)
    return StandardWorkflow(MNIST_LAYERS, (784,), device="cpu")


def _wait(cond, what, limit_s=120.0):
    """Poll ``cond`` until it holds; fail naming ``what`` after a
    generous ``limit_s`` (a hang guard, not a timing)."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > limit_s:
            raise AssertionError(f"{what} did not happen")
        time.sleep(0.01)


# -- the schedule -------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_schedule_decides_as_the_reference(seed):
    from znicz_torch.parallel.chaos import ACTIONS, FaultSchedule
    from znicz_tpu.parallel.chaos import ACTIONS as JACTIONS
    from znicz_tpu.parallel.chaos import FaultSchedule as JSchedule

    assert ACTIONS == JACTIONS
    kw = dict(CHAOS, stall=0.3, stall_s=(0.005, 0.02),
              partition_s=(0.1, 0.4), partition_gap_s=(0.5, 1.5))
    port, ref = FaultSchedule(seed, **kw), JSchedule(seed, **kw)
    for name in ("decide", "decide_compute", "decide_transport",
                 "decide_preempt"):
        got = [getattr(port, name)(i) for i in range(N)]
        want = [getattr(ref, name)(i) for i in range(N)]
        assert got == want, name
    assert port.decisions(64) == ref.decisions(64)
    for direction in ("req", "rep"):
        assert port.partition_windows(direction, 32) == \
            ref.partition_windows(direction, 32)
        for t in np.linspace(0.0, 20.0, 97):
            assert port.in_partition(direction, float(t)) == \
                ref.in_partition(direction, float(t))
    # every action of the cascade is reached
    kinds = {a for a, _ in port.decisions(N)}
    assert kinds == {"drop", "corrupt", "dup", "delay", "forward"}


def test_fault_schedule_refuses_what_the_reference_refuses():
    from znicz_torch.parallel.chaos import FaultSchedule

    for kw in ({"drop": 0.6, "corrupt": 0.5}, {"stall": 1.5},
               {"partition_s": (0.3, 0.1)},
               {"partition_s": (0.1, 0.2), "partition_gap_s": (0.0, 1.0)}):
        with pytest.raises(ValueError):
            FaultSchedule(1, **kw)


def test_chaos_corruption_is_multipart_aware():
    """One decision covers the whole multipart message; the mutation lands
    on exactly one payload frame (metadata or a tensor frame), never the
    ROUTER envelope; the pick is a pure function of (seed, message); the
    codec detects the damage on whichever frame it lands; and over many
    messages the pick ranges over every payload frame."""
    from znicz_torch.parallel import wire
    from znicz_torch.parallel.chaos import ChaosProxy, FaultSchedule

    proxy = ChaosProxy("tcp://127.0.0.1:*", "tcp://127.0.0.1:1",
                       FaultSchedule(2024, **CHAOS))        # never started
    payload, _ = wire.encode_message(
        {"cmd": "infer", "req_id": 7,
         "x": np.ones((8, 8), np.float32),
         "y": np.zeros((3,), np.float32)})
    payload = [bytes(f) for f in payload]
    envelope = [b"identity", b"\x00\x00\x00\x01", b""]
    frames = envelope + payload
    picks = set()
    for fno in range(60):
        out = proxy._corrupt_one(list(frames), fno)
        assert out == proxy._corrupt_one(list(frames), fno)
        assert out[:len(envelope)] == envelope
        changed = [i for i, (a, b) in enumerate(zip(out, frames)) if a != b]
        assert len(changed) == 1 and changed[0] >= len(envelope), changed
        picks.add(changed[0])
        with pytest.raises(wire.WireError):
            wire.decode_message(out[len(envelope):])
    assert picks == set(range(len(envelope), len(frames))), picks


# -- soaks against the port's server ------------------------------------------


def test_chaos_soak_serving():
    """Three clients through the seeded proxy, faults both ways: every
    request completes once with the bits its rung computes, the server
    never dies, every corrupted request is counted in ``bad_frames``,
    and the proxy's counts add up to its log."""
    from znicz_torch.parallel.chaos import ChaosProxy, FaultSchedule
    from znicz_torch.serving import InferenceClient, InferenceServer

    srv = InferenceServer(_mnist(), max_batch=4, max_delay_ms=2.0,
                          queue_bound=64, request_ttl_s=60.0).start()
    proxy = ChaosProxy("tcp://127.0.0.1:*", srv.endpoint,
                       FaultSchedule(2024, **CHAOS)).start()
    rng = np.random.default_rng(5)
    payloads = [rng.normal(0, 1, (1 + i % 4, 784)).astype(np.float32)
                for i in range(12)]
    got = [None] * len(payloads)
    errs = []

    def worker(wid):
        cli = InferenceClient(proxy.front_endpoint, timeout=60,
                              resend_after_s=0.3, max_resends=100)
        try:
            for i in range(wid, len(payloads), 3):
                got[i] = cli.infer(payloads[i])
        except Exception as exc:        # reported below
            errs.append((wid, exc))
        finally:
            cli.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        assert all(y is not None for y in got)
        ladder = srv.batcher.ladder
        for i, x in enumerate(payloads):
            refs = [srv.runner.infer(srv.runner.pad(x, b))[:len(x)]
                    for b in ladder.rungs if b >= len(x)]
            assert any(np.array_equal(got[i], ref) for ref in refs), i
        c = proxy.counters
        assert len(proxy.log) == sum(n for d in c.values()
                                     for n in d.values())
        assert proxy.total_faults() > 0
        assert srv.bad_frames == c["req"]["corrupt"]
        assert srv.served >= len(payloads)
        assert srv.error is None and srv.alive()
    finally:
        proxy.stop()
        srv.stop()


def test_flood_process_meets_only_its_rate_limit():
    """A flooding subprocess at 10x its rate limit (8-row requests) is
    refused by its own rate limit alone and still gets its fair share; a
    paced client gets every reply meanwhile."""
    from znicz_torch.parallel.chaos import FloodProcess
    from znicz_torch.serving import (AdmissionPolicy, InferenceClient,
                                     InferenceServer)

    rate = 20.0
    srv = InferenceServer(_mnist(), max_batch=8, max_delay_ms=2.0,
                          queue_bound=64,
                          admission=AdmissionPolicy(rate_limit=rate,
                                                    rate_burst=8.0)).start()
    flood = FloodProcess(srv.endpoint, 784, rate, factor=10.0, rows=8)
    cli = InferenceClient(srv.endpoint, timeout=60)
    try:
        flood.start_flood()
        _wait(lambda: srv.batcher.stats()["rate_limited"] > 0,
              "a rate_limited refusal of the flood")
        x = np.zeros((1, 784), np.float32)
        for _ in range(4):
            assert cli.infer(x).shape == (1, 10)
            time.sleep(0.1)               # paced well under its limit
        stats = flood.stop_flood()
        assert stats["refusals"].get("rate_limited", 0) > 0, stats
        assert set(stats["refusals"]) == {"rate_limited"}, stats
        assert stats["accepted"] > 0, stats
        assert stats["accepted"] + stats["refusals"]["rate_limited"] \
            <= stats["sent"]
        adm = cli.stats()["batcher"]["admission"]
        assert adm["clients"]["flooder"]["rate_limited"] > 0
        assert cli.infer(x).shape == (1, 10)
    finally:
        cli.close()
        flood.close()
        srv.stop()


def test_compute_stalls_across_a_swap(tmp_path):
    """Every dispatch takes one ``decide_compute`` decision, the swap's
    warm dispatches too: with ``stall=1.0`` each dispatch after the hook
    is armed stalls once; with ``stall=0.25`` the stalls are exactly the
    schedule's ``stall`` decisions over the dispatches made.  Replies
    keep their stamped generation's bits, and the generations flip once,
    in order."""
    from znicz_torch.parallel.chaos import FaultSchedule
    from znicz_torch.serving import InferenceClient, InferenceServer
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.snapshotter import write_host_pickle

    wf = _mnist()
    srv = InferenceServer(wf, max_batch=4, max_delay_ms=1.0,
                          queue_bound=64).start()
    runner = srv.runner
    rng = np.random.default_rng(31)
    x1 = rng.normal(0, 1, (1, 784)).astype(np.float32)
    tree = {name: {k: (1.25 * t.numpy() + 0.01).astype(np.float32)
                   for k, t in leaves.items()}
            for name, leaves in runner._active.tree.items()}
    path = str(tmp_path / "gen2.pickle.gz")
    write_host_pickle(path, {"units": tree, "velocities": {}, "epoch": 2})
    refs = {1: {b: runner.infer(runner.pad(x1, b))[:1]
                for b in srv.batcher.ladder.rungs}}
    gen2 = ModelRunner(_mnist(), snapshot=path)
    refs[2] = {b: gen2.infer(gen2.pad(x1, b))[:1]
               for b in srv.batcher.ladder.rungs}
    assert not np.array_equal(refs[1][1], refs[2][1])

    schedule = FaultSchedule(99, stall=1.0, stall_s=(0.002, 0.002))
    base_no, base_dispatches = runner._dispatch_no, runner.dispatches
    runner.inject_compute_faults(schedule)
    results, errs, stop = [], [], threading.Event()

    def load():
        cli = InferenceClient(srv.endpoint, timeout=60)
        try:
            while not stop.is_set():
                rep = cli.result(cli.submit(x1))
                results.append((rep["gen"], rep["y"]))
        except Exception as exc:        # reported below
            errs.append(exc)
        finally:
            cli.close()

    loader = threading.Thread(target=load)
    loader.start()
    try:
        _wait(lambda: len(results) >= 3 or errs, "generation-1 replies")
        swap = srv.swap_async(path)
        swap.join(120)
        assert not swap.is_alive()
        n_now = len(results)
        _wait(lambda: len(results) >= n_now + 3 or errs,
              "generation-2 replies")
    finally:
        stop.set()
        loader.join(60)
    assert not loader.is_alive() and not errs, errs
    assert runner.swaps == 1 and runner.generation == 2
    made = runner.dispatches - base_dispatches
    rungs = len(srv.batcher.ladder.rungs)
    assert made >= 6 + rungs                 # traffic and the warm
    assert runner._dispatch_no - base_no == made
    assert runner.stalls == made             # stall=1.0: every dispatch
    assert srv.stats()["stalls"] == made
    gens = [g for g, _ in results]
    assert gens == sorted(gens) and set(gens) == {1, 2}
    for g, y in results:
        assert any(np.array_equal(y, r) for r in refs[g].values()), g

    # a partial schedule: the stalls are exactly its decisions
    runner.inject_compute_faults(
        FaultSchedule(7, stall=0.25, stall_s=(0.001, 0.001)))
    first, before = runner._dispatch_no, runner.stalls
    cli = InferenceClient(srv.endpoint, timeout=60)
    try:
        for _ in range(24):
            assert cli.infer(x1).shape == (1, 10)
    finally:
        cli.close()
    srv.stop()
    want = sum(FaultSchedule(7, stall=0.25).decide_compute(i)[0] == "stall"
               for i in range(first, runner._dispatch_no))
    assert runner.stalls - before == want > 0
