"""The port's replica fleet (``znicz_torch/serving/balancer.py``, the
frontend's ``announce`` heartbeat, the fleet harnesses of
``parallel/chaos.py`` and ``python -m znicz_torch --balance``) against the
reference's ``tests/test_balancer.py`` and the reference's balancer.

  - each reference case but the ``web_status`` panel (ROADMAP A.9),
    against the port's :class:`ScriptedReplica` (the model-free replica
    with ``y = x * scale(generation)``): TTL'd membership and the spread,
    exactly-once failover through a blackhole, hedges racing the tail,
    the canary promote / heal / parity rollback, the p99 rollback, the
    health floor, the per-endpoint and global client breaker, the
    autoscaler to its cap and back to quorum, scale-down never counting a
    healing replica, and the lean chaos soak behind the port's
    ``ChaosProxy`` (the full soak is ``slow``, as the reference's);
  - the wire both ways: a reference ``ScriptedReplica`` behind the port's
    balancer and a port ``ScriptedReplica`` behind the reference's give
    the same replies, ledgers and waves;
  - the hedge delay, the candidate order and the canary verdict of both
    packages on the same member tables;
  - a reduced AlexNet replica on the CPU behind the port's balancer, each
    reply the runner's own forward bit for bit and within ``REPLY_RTOL``
    of the reference's forward of the same weights;
  - a generating charlm replica behind it: a relayed ``generate`` equals
    the direct reply, a streamed one is refused;
  - the CLI: ``--balance`` in front of a ``--serve --announce`` replica,
    and the exit-2 refusals.

Every socket binds ``tcp://127.0.0.1:*``.  Tests wait by polling state
with generous budgets, never by a fixed sleep or a wall-clock bound."""

import collections
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_planner import knobs
from test_torch_serving_zmq import ALEXNET, _port_twin, _rel

REPO = pathlib.Path(__file__).resolve().parent.parent
REPLY_RTOL = 1e-5
X1 = np.arange(4, dtype=np.float32).reshape(1, 4) + 1.0
#: a generous budget for anything a test waits for (s)
BUDGET = 60.0


def _wait(pred, what, budget=BUDGET):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < budget, f"never {what}"
        time.sleep(0.01)


def _pkg(name):
    """(ReplicaBalancer, ScriptedReplica, InferenceClient) of a package."""
    if name == "port":
        from znicz_torch.parallel.chaos import ScriptedReplica
        from znicz_torch.serving import InferenceClient, ReplicaBalancer
    else:
        from znicz_tpu.parallel.chaos import ScriptedReplica
        from znicz_tpu.serving import InferenceClient, ReplicaBalancer
    return ReplicaBalancer, ScriptedReplica, InferenceClient


FLEET_KNOBS = dict(replica_ttl_s=1.0, heartbeat_s=0.25,
                   failover_timeout_s=0.5, failover_tries=4,
                   hedge_floor_s=0.25, canary_requests=6, parity_every=2,
                   canary_timeout_s=20.0)


def _fleet(n=2, snapshots=None, bal_kwargs=None, rep_kwargs=None,
           bal_pkg="port", rep_pkg="port"):
    """A started balancer and n started scripted replicas."""
    Balancer, Scripted, _ = _pkg(bal_pkg)
    kwargs = dict(FLEET_KNOBS, **(bal_kwargs or {}))
    bal = Balancer(**kwargs).start()
    reps = [_pkg(rep_pkg)[1](bal.endpoint, f"r{i}",
                             snapshots=dict(snapshots or {}),
                             **(rep_kwargs or {})).start()
            for i in range(n)]
    _wait(lambda: bal.ready_count() >= n, "a ready fleet")
    return bal, reps


def _client(bal, pkg="port", **kw):
    kw.setdefault("timeout", 10.0)
    kw.setdefault("breaker_failures", 0)
    # balancer failover, not client resends, is under test: resends
    # would mask lost replies
    kw.setdefault("resend_after_s", 30.0)
    return _pkg(pkg)[2](bal.endpoint, **kw)


def _drive_until(cli, pred, what, x=X1, budget=BUDGET):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < budget, f"never {what}"
        for _ in range(4):
            cli.result(cli.submit(x), timeout=BUDGET)


def _teardown(bal, reps, *clis):
    for c in clis:
        c.close()
    bal.stop()
    for r in reps:
        r.kill()


def _wait_beats(bal, n):
    """Wait until ``n`` more heartbeats reached ``bal``: time passes in
    serve-loop ticks (each beat is handled on the loop that ticks)."""
    target = bal.heartbeats + n
    _wait(lambda: bal.heartbeats >= target, f"{n} more heartbeats")


# -- membership and dispatch -----------------------------------------------------


def test_heartbeat_membership_ttl_and_spread():
    bal, reps = _fleet(2)
    cli = _client(bal)
    try:
        for _ in range(16):
            rep = cli.result(cli.submit(X1))
            # the balancer's stamp, the replica's stamp and the generation
            # on every reply (the client breaker and A/B attribution)
            assert rep.get("lb") is True
            assert rep["replica_id"] in ("r0", "r1")
            assert rep["gen"] == 1
            assert np.array_equal(rep["y"], X1)
        # least-loaded over two idle replicas spreads the work
        assert reps[0].served > 0 and reps[1].served > 0
        st = bal.stats()
        assert st["total_replicas"] == 2 and st["ready_replicas"] == 2
        row = st["replicas"][0]
        for key in ("gen", "queue_depth", "in_flight", "last_heartbeat_s",
                    "snapshot_path", "p99_ms_by_bucket"):
            assert key in row
        # TTL eviction: a silent replica leaves the membership
        reps[0].kill()
        _wait(lambda: bal.member_count() == 1, "evicted")
        assert bal.replicas_lost == 1
        # ... and the survivor serves alone
        assert cli.result(cli.submit(X1))["replica_id"] == "r1"
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)


def test_exactly_once_failover_through_a_blackhole():
    """A replica that accepts requests and never answers: the balancer
    re-dispatches the same bytes after its failover timeout, and every
    request is answered exactly once."""
    from znicz_torch.parallel.chaos import ScriptedReplica

    bal, reps = _fleet(2, bal_kwargs={"hedge": False})
    reps[0].kill()
    hole = ScriptedReplica(bal.endpoint, "hole", blackhole=True).start()
    reps[0] = hole
    _wait(lambda: {m["replica_id"] for m in bal.stats()["replicas"]}
          == {"hole", "r1"}, "the hole joined and r0 left")
    cli = _client(bal)
    try:
        rids = [cli.submit(X1) for _ in range(10)]
        got = collections.Counter()
        t0 = time.perf_counter()
        while sum(got.values()) < 10:
            assert time.perf_counter() - t0 < BUDGET, got
            for rep in cli.collect(0.05):
                got[rep["req_id"]] += 1
                assert rep["ok"], rep
        assert sorted(got) == sorted(rids)
        assert max(got.values()) == 1          # exactly once
        assert bal.failovers > 0
        assert hole.swallowed > 0              # the hole really ate some
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)


def test_hedged_retries_race_the_tail():
    """One replica stalls every 2nd request far past the hedge delay: the
    hedge races a second replica, the first reply wins and the stalled
    loser lands late and is deduped (counted, never delivered twice)."""
    from znicz_torch.parallel.chaos import ScriptedReplica

    bal, reps = _fleet(1, bal_kwargs={"hedge_floor_s": 0.1,
                                      "failover_timeout_s": 3.0,
                                      "replica_ttl_s": 3.0},
                       rep_kwargs={"stall_s": 0.7, "stall_every": 2})
    fast = ScriptedReplica(bal.endpoint, "fast").start()
    reps.append(fast)
    _wait(lambda: bal.ready_count() == 2, "two ready")
    cli = _client(bal)
    try:
        for _ in range(20):
            rep = cli.result(cli.submit(X1), timeout=BUDGET)
            assert np.array_equal(rep["y"], X1)
        assert bal.hedges > 0 and bal.hedge_wins > 0
        _wait(lambda: bal.dup_replies_dropped > 0, "a loser deduped")
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)


# -- canary rollover (promote, heal, rollbacks) -----------------------------------


def test_canary_rollover_promote_heal_and_regression_rollback():
    snaps = {"same": 1.0, "diff": 3.0}
    bal, reps = _fleet(3, snapshots=snaps)
    cli = _client(bal)
    try:
        # (1) a healthy wave: the same parameters under a new path, so the
        # parity probes agree, the p99 is in band, the fleet promotes
        rep = cli.result(cli._send({"cmd": "swap", "path": "same"}))
        assert rep["ok"] and rep["swap_started"] and rep["canary"]
        _drive_until(cli, lambda: bal.rollovers == 1, "promoted")
        assert bal.parity_checks > 0 and bal.parity_mismatches == 0
        assert bal.rollover_history[-1]["result"] == "promoted"
        gens = {cli.result(cli.submit(X1))["gen"] for _ in range(6)}
        assert gens == {2}
        assert bal.stats()["fleet_path"] == "same"
        # (2) healing: a restarted replica boots with its boot snapshot
        # and an off-fleet generation; the balancer swaps it onto the
        # promoted path, restoring the generations' lockstep
        reps[0].kill()
        reps[0].restart()
        _drive_until(cli, lambda: bal.heals >= 1
                     and bal.member_count() == 3 and all(
                         m["gen"] == 2 and m["snapshot_path"] == "same"
                         for m in bal.stats()["replicas"]), "healed")
        assert bal.heals == 1                  # debounced: exactly one
        # (3) a forced regression: other parameters under an
        # expect-parity swap, so the probes mismatch and the wave rolls
        # back; the losing generation's record is kept
        rep = cli.result(cli._send({"cmd": "swap", "path": "diff"}))
        assert rep["ok"]
        _drive_until(cli, lambda: bal.rollbacks == 1, "rolled back")
        record = bal.rollover_history[-1]
        assert record["result"] == "rolled_back"
        assert "parity" in record["reason"]
        assert record["parity_mismatches"] >= 1
        assert record["old_gen"] == 2 and record["new_gen"] == 3
        # the fleet serves the old generation bit for bit, its stamp too
        for _ in range(6):
            rep = cli.result(cli.submit(X1))
            assert rep["gen"] == 2
            assert np.array_equal(rep["y"], X1)
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)


def test_canary_p99_regression_rolls_back():
    """The other trigger: a new generation whose answers agree but arrive
    slow (every reply stalled 0.35 s): with hedging off and the failover
    timeout above the stall, the canary's p99 leaves the
    ``canary_p99_mult`` band and the wave rolls back, both p99s kept."""
    snaps = {"slow": {"scale": 1.0, "stall_s": 0.35}}
    bal, reps = _fleet(3, snapshots=snaps,
                       bal_kwargs={"hedge": False,
                                   "failover_timeout_s": 2.0,
                                   "canary_requests": 5,
                                   "canary_p99_mult": 3.0,
                                   "parity_every": 1000})
    cli = _client(bal, timeout=15.0)
    try:
        rep = cli.result(cli._send({"cmd": "swap", "path": "slow",
                                    "parity": False}))
        assert rep["ok"]
        _drive_until(cli, lambda: bal.rollbacks == 1, "rolled back")
        record = bal.rollover_history[-1]
        assert record["result"] == "rolled_back"
        assert "p99" in record["reason"]
        assert record["canary_p99_ms"] > 3.0 * record["old_p99_ms"]
        gens = {cli.result(cli.submit(X1))["gen"] for _ in range(4)}
        assert gens == {1}                     # the stamp restored too
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)


def test_rollover_refused_below_health_floor():
    """No ready replica, or no path, refuses the wave readably."""
    from znicz_torch.serving import InferenceError, ReplicaBalancer

    bal = ReplicaBalancer().start()
    cli = _client(bal)
    try:
        with pytest.raises(InferenceError, match="no ready replicas"):
            cli.result(cli._send({"cmd": "swap", "path": "x"}))
        with pytest.raises(InferenceError, match="needs a snapshot"):
            cli.result(cli._send({"cmd": "swap"}))
    finally:
        cli.close()
        bal.stop()


def test_a_draining_replicas_refusal_is_retried_on_another():
    """A replica stopped between the balancer's dispatch and the request's
    arrival answers a service-scoped ``draining`` refusal: the balancer
    retries the same bytes on another replica (ROADMAP C.10), so every
    request is answered once and the ledger balances."""
    from znicz_torch.parallel.chaos import ScriptedReplica

    bal, reps = _fleet(1, bal_kwargs={"hedge": False})
    sick = ScriptedReplica(bal.endpoint, "sick",
                           refuse=("draining", "service")).start()
    reps.append(sick)
    _wait(lambda: bal.ready_count() >= 2, "a ready fleet")
    cli = _client(bal)
    try:
        for _ in range(16):
            rep = cli.result(cli.submit(X1), timeout=BUDGET)
            assert np.array_equal(rep["y"], X1) and rep["replica_id"] == "r0"
        assert bal.sheds_retried >= 1
        ledger = bal.ledger()
        assert ledger["balanced"] and ledger["refused"] == 0, ledger
        assert ledger["replied"] == 16
    finally:
        _teardown(bal, reps, cli)


# -- the per-endpoint client breaker ----------------------------------------------


def test_client_breaker_is_per_endpoint_behind_a_balancer():
    """Service-scoped failures stamped with a replica_id by a balancer's
    reply open that replica's window, never the whole-service breaker."""
    from znicz_torch.serving import InferenceError

    # a 1-replica fleet whose replica sheds service-scoped, with one try
    # so the shed is forwarded, not retried
    bal, reps = _fleet(1, bal_kwargs={"failover_tries": 1, "hedge": False},
                       rep_kwargs={"refuse": ("shed", "service")})
    cli = _client(bal, breaker_failures=3, breaker_window=6)
    try:
        for _ in range(5):
            with pytest.raises(InferenceError):
                cli.result(cli.submit(X1))
        assert cli.breaker_state == "closed"
        assert cli.breaker_state_for("r0") == "open"
        assert cli.replica_breaker_opens == 1
        assert cli.replica_breakers()["r0"]["failures"] >= 3
        cli.submit(X1)                         # no CircuitOpenError
    finally:
        _teardown(bal, reps, cli)


def test_client_breaker_still_global_against_a_direct_runner():
    """The same stamped refusals without the balancer's ``lb`` stamp (a
    replica served directly) feed the whole-service breaker."""
    from znicz_torch.parallel.chaos import ScriptedReplica
    from znicz_torch.serving import (CircuitOpenError, InferenceClient,
                                     InferenceError, ReplicaBalancer)

    bal = ReplicaBalancer().start()            # a heartbeat sink
    sick = ScriptedReplica(bal.endpoint, "sick",
                           refuse=("shed", "service")).start()
    cli = InferenceClient(sick.endpoint, timeout=5.0, breaker_failures=3,
                          breaker_window=6, resend_after_s=30.0)
    try:
        opened = False
        for _ in range(8):
            try:
                cli.result(cli.submit(X1))
            except InferenceError:
                continue
            except CircuitOpenError:
                opened = True
                break
        assert opened or cli.breaker_state == "open"
        assert cli.breaker_opens >= 1
        assert cli.replica_breakers() == {}    # per-endpoint untouched
    finally:
        cli.close()
        sick.kill()
        bal.stop()


# -- the autoscaler ---------------------------------------------------------------


def test_autoscaler_spawns_to_cap_and_drains_back_to_quorum():
    """A forced high band spawns through the FleetScaler up to
    ``autoscale_max`` (pending-spawn reservations stop over-spawn at the
    cap); a forced low band drains-then-retires back to, and never below,
    the ``min_replicas`` quorum, traffic served and the ledger balanced
    throughout."""
    from znicz_torch.parallel.chaos import FleetScaler, ScriptedReplica

    bal, reps = _fleet(2, bal_kwargs=dict(min_replicas=2))
    scaler = FleetScaler(lambda i: ScriptedReplica(bal.endpoint, f"s{i}"))
    for r in reps:
        scaler.adopt(r)
    cli = _client(bal)
    try:
        # high_load < 0 makes every evaluation high: a deterministic ramp
        bal.enable_autoscale(
            scaler.spawn, scaler.retire, autoscale_max=4,
            autoscale_high_load=-1.0, autoscale_low_load=-2.0,
            autoscale_up_after=2, autoscale_down_after=2,
            autoscale_eval_s=0.05, autoscale_cooldown_s=0.05,
            autoscale_drain_timeout_s=5.0)
        _wait(lambda: bal.member_count() == 4, "scaled to the cap")
        assert bal.scale_ups >= 2
        st = bal.stats()["autoscale"]
        assert st["enabled"] and st["max"] == 4
        # at the cap: many evaluations later no spawn piled up past it
        _wait_beats(bal, 40)
        assert bal.member_count() == 4
        assert scaler.counts["spawned"] == 2
        for _ in range(8):
            assert cli.result(cli.submit(X1))["lb"] is True
        # a forced low band: drain-then-retire to the quorum.  A retired
        # replica's last heartbeat can race its kill and re-add it; the
        # cooldown above the 1.0 s TTL lets the TTL evict it before the
        # next decision
        bal.enable_autoscale(
            scaler.spawn, scaler.retire, autoscale_max=4,
            autoscale_high_load=1e9, autoscale_low_load=1e9,
            autoscale_cooldown_s=1.5)
        _wait(lambda: bal.scale_downs == 2 and bal.member_count() == 2,
              "drained to the quorum")
        _wait_beats(bal, 40)
        assert bal.member_count() == 2         # the quorum floor holds
        assert bal.scale_downs == 2
        assert scaler.counts["retired"] == 2
        assert not bal.stats()["autoscale"]["retiring"]
        assert cli.result(cli.submit(X1))["lb"] is True
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)
        scaler.stop_all()


def test_scale_down_never_counts_a_healing_replica_as_capacity():
    """A replica mid-heal serves stale parameters and is about to swap:
    it must not count as servable capacity, or an idle band retires the
    last healthy replica while the heal is in flight.  With one of two
    replicas healing, the scale-down gate sees one servable replica and
    (min_replicas=1) does not act through many low evaluations; once the
    heal clears, the same band drains exactly one.  The retire disarms
    the autoscaler, so the retired replica's last heartbeat cannot make
    a second decision (the reference's version of this test can)."""
    from znicz_torch.parallel.chaos import FleetScaler, ScriptedReplica

    bal, reps = _fleet(2, bal_kwargs=dict(min_replicas=1))
    scaler = FleetScaler(lambda i: ScriptedReplica(bal.endpoint, f"s{i}"))
    for r in reps:
        scaler.adopt(r)
    cli = _client(bal)

    def retire_once(replica_id):
        scaler.retire(replica_id)
        with bal._lock:                 # the serve thread, in its tick
            bal.knobs["autoscale"] = False

    try:
        with bal._lock:                 # r1 enters its heal window
            bal._healing["r1"] = time.perf_counter()
        bal.enable_autoscale(
            scaler.spawn, retire_once,
            autoscale_high_load=1e9, autoscale_low_load=1e9,
            autoscale_down_after=1, autoscale_eval_s=0.01,
            autoscale_cooldown_s=0.2)
        # twenty low evaluations in a row, none of them acting
        _wait(lambda: bal._scale_streak["low"] >= 20, "20 low evaluations")
        assert bal.scale_downs == 0 and bal.member_count() == 2
        st = bal.stats()
        assert st["autoscale"]["servable"] == 1
        rows = {r["replica_id"]: r for r in st["replicas"]}
        assert rows["r1"]["healing"] and not rows["r0"]["healing"]
        with bal._lock:                 # the heal lands: r1 on the fleet
            bal._healing.pop("r1")
        _wait(lambda: not bal.knobs["autoscale"], "a retire")
        _wait(lambda: bal.member_count() == 1, "one member left")
        assert bal.scale_downs == 1 and scaler.counts["retired"] == 1
        assert cli.result(cli.submit(X1))["lb"] is True
        assert bal.ledger()["balanced"]
    finally:
        _teardown(bal, reps, cli)
        scaler.stop_all()


# -- the chaos soak ---------------------------------------------------------------


def _run_soak(n_requests, kills, swap):
    from znicz_torch.parallel.chaos import ChaosProxy, FaultSchedule
    from znicz_torch.serving import InferenceClient

    bal, reps = _fleet(2, snapshots={"v2": 1.0},
                       bal_kwargs={"failover_timeout_s": 0.8,
                                   "replica_ttl_s": 1.5,
                                   "canary_requests": 4})
    schedule = FaultSchedule(seed=4242, drop=0.05, corrupt=0.05,
                             duplicate=0.05, delay=0.08,
                             delay_s=(0.02, 0.1))
    proxy = ChaosProxy("tcp://127.0.0.1:*", bal.endpoint, schedule).start()
    cli = InferenceClient(proxy.front_endpoint, timeout=20.0,
                          resend_after_s=0.5, max_resends=30,
                          breaker_failures=0)
    answered = {}
    try:
        swapped = False
        for i in range(n_requests):
            rid = cli.submit(X1)
            rep = cli.result(rid, timeout=BUDGET)
            assert rid not in answered      # client-visible exactly-once
            answered[rid] = rep
            assert np.array_equal(rep["y"], X1), (i, rep)
            if kills and i == n_requests // 3:
                reps[0].kill()
            if kills and i == 2 * n_requests // 3:
                reps[0].restart()
            if swap and not swapped and i == n_requests // 2:
                try:
                    cli.result(cli._send({"cmd": "swap", "path": "v2"}),
                               timeout=15)
                except Exception:
                    pass                    # the reply lost to chaos: the
                    # wave still runs on the balancer
                swapped = True
        assert len(answered) == n_requests
        assert bal.codec.bad_frames == proxy.counters["req"]["corrupt"]
        assert bal.ledger()["balanced"]
    finally:
        proxy.stop()
        _teardown(bal, reps, cli)


def test_chaos_soak_lean():
    """Proxy corruption, drops, duplicates and delays, and one kill and
    restart."""
    _run_soak(n_requests=50, kills=True, swap=False)


@pytest.mark.slow
def test_chaos_soak_full():
    """More traffic, a kill and restart racing hedges, and a rollover wave
    mid-chaos."""
    _run_soak(n_requests=150, kills=True, swap=True)


# -- the wire both ways -----------------------------------------------------------


def _interop(bal_pkg, rep_pkg):
    """One fleet script: two scripted replicas of ``rep_pkg`` behind a
    ``bal_pkg`` balancer; eight requests, a promoted wave to the same
    scale, four more requests, then a parity-breaking wave rolled back
    and four more.  Returns what both packages must agree on."""
    bal, reps = _fleet(2, snapshots={"same": 1.0, "diff": 2.0},
                       bal_pkg=bal_pkg, rep_pkg=rep_pkg)
    cli = _client(bal, pkg=bal_pkg)
    seen = []

    def serve(n):
        for k in range(n):
            x = X1 * (k + 1)
            rep = cli.result(cli.submit(x), timeout=BUDGET)
            assert rep["ok"] and rep["lb"] is True, rep
            assert rep["replica_id"] in ("r0", "r1")
            seen.append((rep["gen"], rep["y"].tobytes()))
    try:
        serve(8)
        for path, count in (("same", "rollovers"), ("diff", "rollbacks")):
            rep = cli.result(cli._send({"cmd": "swap", "path": path}))
            assert rep["ok"] and rep["canary"] == ["r0"], rep
            _drive_until(cli, lambda: getattr(bal, count) == 1, count)
            serve(4)
        ledger = bal.ledger()
        waves = [(r["result"], r["path"], r["old_gen"], r["new_gen"],
                  r["canary"]) for r in bal.rollover_history]
        assert ledger["balanced"] and ledger["in_flight"] == 0
        return seen, waves, ledger["refused"], bal.stats()["fleet_path"]
    finally:
        _teardown(bal, reps, cli)


def test_the_wire_both_ways():
    """A reference ScriptedReplica announcing into the port's balancer
    and a port ScriptedReplica announcing into the reference's give the
    same replies (bit for bit, with their generations), the same waves
    and the same refusals; each ledger balances."""
    port_bal = _interop("port", "ref")
    ref_bal = _interop("ref", "port")
    assert port_bal == ref_bal
    seen, waves, refused, fleet_path = port_bal
    assert [g for g, _ in seen] == [1] * 8 + [2] * 4 + [2] * 4
    assert [w[0] for w in waves] == ["promoted", "rolled_back"]
    assert refused == 0 and fleet_path == "same"


# -- the pure parts against the reference's ---------------------------------------


def _bare_pair(**knobs_):
    """An unstarted balancer of each package with the same knobs."""
    from znicz_torch.serving import ReplicaBalancer as TB
    from znicz_tpu.serving import ReplicaBalancer as JB

    return TB(**knobs_), JB(**knobs_)


@pytest.mark.parametrize("n,scale,knobs_", [
    (0, 0.01, {}), (19, 0.5, {}), (20, 0.001, {}), (300, 0.02, {}),
    (64, 5.0, {}), (64, 0.2, {"hedge_p99_mult": 3.0, "hedge_cap_s": 0.5}),
    (512, 0.03, {"hedge_floor_s": 0.001})])
def test_hedge_delay_matches_the_reference(n, scale, knobs_):
    rng = np.random.default_rng(n)
    lat = list(rng.exponential(scale, n))
    t, j = _bare_pair(**knobs_)
    t._lat, j._lat = list(lat), list(lat)
    assert t._hedge_delay() == j._hedge_delay()


def _member(endpoint, ready=True, queue_depth=0, devices=1, path="p1"):
    return {"endpoint": endpoint, "last_seen": 0.0, "ready": ready, "gen": 1,
            "queue_depth": queue_depth, "swapping": False, "draining": False,
            "snapshot_path": path, "device_count": devices, "mesh": None,
            "p99_ms_by_bucket": {}, "warm_source": None, "warm_hits": 0,
            "warm_misses": 0, "boot_s": None}


MEMBER_TABLES = {
    "idle": ({"a": _member("e0"), "b": _member("e1"), "c": _member("e2")},
             {}, {}),
    "loads": ({"a": _member("e0", queue_depth=5), "b": _member("e1"),
               "c": _member("e2", queue_depth=1)}, {"b": 2, "c": 1}, {}),
    "devices": ({"a": _member("e0", queue_depth=8, devices=8),
                 "b": _member("e1", queue_depth=2), "c": _member(
                     "e2", ready=False)}, {"a": 8}, {}),
    "exclude": ({"a": _member("e0"), "b": _member("e1"),
                 "c": _member("e2")}, {"a": 1}, {"exclude": {"c"}}),
    "stale": ({"a": _member("e0", path="old"), "b": _member("e1"),
               "c": _member("e2", path="old")}, {}, {"fleet": "p1"}),
    "all_stale": ({"a": _member("e0", path="old"),
                   "b": _member("e1", path="old", queue_depth=3)}, {},
                  {"fleet": "p1"}),
    "retiring": ({"a": _member("e0"), "b": _member("e1")}, {},
                 {"retiring": {"a": 0.0}}),
}


@pytest.mark.parametrize("table", sorted(MEMBER_TABLES))
def test_candidate_order_matches_the_reference(table):
    members, counts, extra = MEMBER_TABLES[table]
    t, j = _bare_pair()
    for bal in (t, j):
        bal._members = {k: dict(v) for k, v in members.items()}
        bal._dispatch_counts = dict(counts)
        bal._fleet_path = extra.get("fleet")
        bal._retiring = dict(extra.get("retiring", {}))
    exclude = extra.get("exclude", ())
    got = [t._candidates(exclude=exclude) for _ in range(5)]
    want = [j._candidates(exclude=exclude) for _ in range(5)]
    assert got == want and got[0]


def _roll(parity=True, mismatches=0, checks=0, canary=("a",), old=("b",),
          lat_new=(), lat_old=()):
    return {"parity": parity, "mismatches": mismatches, "checks": checks,
            "canary": list(canary), "old": list(old),
            "lat_new": list(lat_new), "lat_old": list(lat_old),
            "t_canary": time.perf_counter()}


ROLLS = {
    "parity_broken": (_roll(mismatches=2, checks=3), ("a", "b")),
    "canary_lost": (_roll(), ("b",)),
    "watching": (_roll(lat_new=[0.01] * 3, lat_old=[0.01]), ("a", "b")),
    "clean": (_roll(checks=1, lat_new=[0.01] * 6, lat_old=[0.01] * 6),
              ("a", "b")),
    "no_probe_yet": (_roll(lat_new=[0.01] * 6, lat_old=[0.01] * 6),
                     ("a", "b")),
    "no_parity": (_roll(parity=False, lat_new=[0.01] * 6,
                        lat_old=[0.01] * 6), ("a", "b")),
    "p99_regressed": (_roll(checks=1, lat_new=[0.5] * 6,
                            lat_old=[0.01] * 6), ("a", "b")),
    "no_old_pool": (_roll(old=(), lat_new=[0.5] * 6), ("a",)),
    "no_old_sample": (_roll(checks=1, lat_new=[0.01] * 6), ("a", "b")),
}


@pytest.mark.parametrize("case", sorted(ROLLS))
def test_canary_verdict_matches_the_reference(case):
    roll, live = ROLLS[case]
    t, j = _bare_pair(canary_requests=6, canary_p99_mult=3.0)
    for bal in (t, j):
        bal._members = {r: _member(f"e-{r}") for r in live}
    assert t._canary_verdict(dict(roll)) == j._canary_verdict(dict(roll))


def test_a_starved_canary_rolls_back_in_both():
    roll = _roll(lat_new=[0.01], lat_old=[0.01])
    roll["t_canary"] -= 10.0
    t, j = _bare_pair(canary_requests=6, canary_timeout_s=5.0)
    for bal in (t, j):
        bal._members = {r: _member(f"e-{r}") for r in ("a", "b")}
    verdict = t._canary_verdict(dict(roll))
    assert verdict == j._canary_verdict(dict(roll))
    assert verdict[0] is False and "starved" in verdict[1]


# -- C.9: parity probes ride one rung ----------------------------------------------


def test_solo_requests_close_their_own_batch_at_their_rung():
    """A solo request (a parity-sampled primary or its probe) is a batch
    alone, at the smallest rung that holds its rows, and never joins
    another's; the batcher records the rung it used."""
    from znicz_torch.serving.batcher import (AdmissionPolicy,
                                             DynamicBatcher, Request)

    for fair in (False, True):
        b = DynamicBatcher(max_batch=16, max_delay_ms=0.0,
                           admission=AdmissionPolicy(fair=fair))
        ladder = b.ladder
        plan = [(1, 2, False, "a"), (2, 3, True, "b"), (3, 1, False, "a"),
                (4, 5, True, "b"), (5, 2, False, "c"), (6, 6, False, "a")]
        for rid, n, solo, client in plan:
            assert b.submit(Request(np.zeros((n, 4), np.float32), n,
                                    req_id=rid, client=client,
                                    solo=solo)) is None
        batches = []
        while b.queue_depth:
            batches.append([r.req_id for r in
                            b.next_batch(timeout=0.0, wait_fill=False)])
        solos = {rid for rid, _, solo, _ in plan if solo}
        for batch in batches:
            assert not (set(batch) & solos) or len(batch) == 1, batches
        assert sorted(sum(batches, [])) == [1, 2, 3, 4, 5, 6]
        assert list(b.solo_rungs) == [(2, 3, ladder.bucket_for(3)),
                                      (4, 5, ladder.bucket_for(5))]
        assert b.stats()["solo_batches"] == 2


def _in_flight(cli, x, n=8):
    """``n`` requests in flight at once; their replies."""
    return [cli.result(r, timeout=BUDGET)
            for r in [cli.submit(x) for _ in range(n)]]


def test_parity_probes_are_served_solo_and_judge_a_wave(tmp_path):
    """Two CPU replicas of the tiny AlexNet-shaped net behind the
    balancer, 8 requests in flight throughout: with ``parity: true`` a
    wave of unchanged weights under a new path promotes (every probe and
    its primary served alone, each at ``bucket_for`` its rows, as the
    replicas' batchers record), and a wave of changed weights is rolled
    back for reply parity."""
    from test_torch_serving_swap import _fresh, _second, _snapshot
    from znicz_torch.serving import (InferenceClient, InferenceServer,
                                     ReplicaBalancer)
    from znicz_torch.weights import params_to_numpy

    tree = params_to_numpy(_fresh())
    boot = _snapshot(tmp_path / "boot.pickle.gz", tree)
    same = _snapshot(tmp_path / "same.pickle.gz", tree)
    diff = _snapshot(tmp_path / "diff.pickle.gz", _second(tree))
    bal = ReplicaBalancer(**dict(FLEET_KNOBS, parity_every=1,
                                 canary_requests=8)).start()
    reps = [InferenceServer(_fresh(), snapshot=boot, max_batch=8,
                            max_delay_ms=2.0, announce=bal.endpoint,
                            replica_id=f"r{i}").start() for i in range(2)]
    cli = _client(bal)
    x = np.random.default_rng(5).normal(
        size=(2,) + tuple(reps[0].runner.sample_shape)).astype(np.float32)
    try:
        _wait(lambda: bal.ready_count() == 2, "a ready fleet")
        _in_flight(cli, x)
        rep = cli.result(cli._send({"cmd": "swap", "path": same,
                                    "parity": True}))
        assert rep["ok"] and rep["swap_started"]
        t0 = time.perf_counter()
        while bal.rollovers < 1:
            assert time.perf_counter() - t0 < BUDGET, "never promoted"
            assert bal.rollbacks == 0, bal.rollover_history
            _in_flight(cli, x)
        record = bal.rollover_history[-1]
        assert record["result"] == "promoted", record
        assert bal.parity_checks > 0 and bal.parity_mismatches == 0
        solo = [s for r in reps for s in r.batcher.solo_rungs]
        assert len(solo) >= 2 * bal.parity_checks
        for r in reps:
            for _, rows, rung in r.batcher.solo_rungs:
                assert rung == r.batcher.ladder.bucket_for(rows)
        rep = cli.result(cli._send({"cmd": "swap", "path": diff,
                                    "parity": True}))
        assert rep["ok"]
        t0 = time.perf_counter()
        while bal.rollbacks < 1:
            assert time.perf_counter() - t0 < BUDGET, "never rolled back"
            _in_flight(cli, x)
        record = bal.rollover_history[-1]
        assert record["result"] == "rolled_back"
        assert "parity" in record["reason"], record
        assert record["parity_mismatches"] >= 1
        assert bal.ledger()["balanced"]
    finally:
        cli.close()
        bal.stop()
        for r in reps:
            r.stop()


# -- a real replica on the CPU ----------------------------------------------------


@pytest.fixture(scope="module")
def alexnet_pair():
    from test_torch_planner import jax_workflow
    from znicz_tpu.samples.alexnet import make_layers

    layers = make_layers(10)
    jwf = jax_workflow(layers, sample_shape=ALEXNET, n=4)
    twf, _ = _port_twin(jwf, layers, ALEXNET)
    return jwf, twf


def test_real_cpu_alexnet_replica_through_the_balancer(alexnet_pair):
    """A reduced AlexNet ``InferenceServer`` on the CPU announces into the
    port's balancer: its heartbeats register it with the reference's
    keys, its per-rung p99 rides them, and every reply through the
    balancer is the runner's own forward of that batch bit for bit and
    within ``REPLY_RTOL`` of the reference's forward of the same
    weights.  Control commands stay the replica's."""
    from znicz_torch.serving import (InferenceClient, InferenceError,
                                     InferenceServer, ReplicaBalancer)
    from znicz_tpu.serving.model import ModelRunner as JRunner

    jwf, twf = alexnet_pair
    rng = np.random.default_rng(17)
    xs = [rng.normal(size=(n,) + ALEXNET).astype(np.float32)
          for n in (1, 3, 2, 4, 1)]
    with knobs(fused_elementwise=True, fused_tail=True):
        want = [JRunner(jwf).infer(x) for x in xs]
        bal = ReplicaBalancer(replica_ttl_s=30.0).start()
        srv = InferenceServer(twf, max_batch=4, max_delay_ms=1.0,
                              announce=bal.endpoint,
                              replica_id="cpu-0").start()
        cli = InferenceClient(bal.endpoint, timeout=120.0,
                              breaker_failures=0, resend_after_s=120.0)
        try:
            _wait(lambda: bal.ready_count() == 1, "the replica joined")
            ladder = srv.batcher.ladder
            for x, w in zip(xs, want):
                # one request at a time: its batch is its rows padded to
                # their rung, the shape the runner computes below
                rep = cli.result(cli.submit(x), timeout=120)
                assert rep["lb"] is True and rep["replica_id"] == "cpu-0"
                assert rep["gen"] == 1
                n = x.shape[0]
                own = srv.runner.infer(srv.runner.pad(
                    x, ladder.bucket_for(n)))[:n]
                assert np.array_equal(rep["y"], own)
                assert _rel(rep["y"], w) <= REPLY_RTOL
            assert srv.heartbeats_out > 0
            stats = srv.stats()
            assert stats["announce"] == bal.endpoint
            assert stats["heartbeats_out"] == srv.heartbeats_out
            # a beat sent before the last reply carries an older rung
            # set: wait for one sent after it
            _wait(lambda: set(bal.stats()["replicas"][0]
                              ["p99_ms_by_bucket"])
                  == set(srv.p99_ms_by_bucket()),
                  "the latest per-rung p99 on a heartbeat")
            member = bal.stats()["replicas"][0]
            assert member["replica_id"] == "cpu-0"
            assert set(member["p99_ms_by_bucket"]) <= set(ladder.rungs)
            assert set(member["p99_ms_by_bucket"]) == \
                set(stats["p99_ms_by_bucket"])
            assert member["warm_source"] == "compiled"
            assert member["device_count"] == 1
            # the beat carries the reference's base keys and its fleet
            # observability keys (origin always; spans, events and the
            # registry's snapshot when there is something to ship)
            from znicz_tpu.serving import InferenceServer as JServer

            jsrv = JServer(jwf, max_batch=4, warmup=False)
            beat = srv.heartbeat_payload()
            assert set(srv._heartbeat_base()) == set(jsrv._heartbeat_base())
            assert "origin" in beat and set(beat) - set(
                jsrv._heartbeat_base()) <= {"origin", "spans", "events",
                                            "metrics"}
            # rollback is the replica's command (the balancer's waves send
            # it over the data plane); with nothing kept it is refused
            direct = InferenceClient(srv.endpoint, timeout=30.0,
                                     breaker_failures=0)
            try:
                with pytest.raises(InferenceError,
                                   match="no previous generation"):
                    direct.result(direct._send({"cmd": "rollback"}))
            finally:
                direct.close()
            assert bal.ledger()["balanced"]
        finally:
            cli.close()
            srv.stop()
            bal.stop()


def test_generate_through_the_balancer_to_a_generating_replica():
    """A charlm replica on the CPU with generation on, behind the port's
    balancer: a non-streamed ``generate`` through the balancer equals the
    direct reply (tokens and the sampled stream of a seed), and a
    streamed one is refused with the balancer's own message."""
    from test_torch_generate import _generate_config
    from test_torch_serving_seq import VOCAB, _charlm_wf
    from znicz_torch.serving import (InferenceClient, InferenceError,
                                     InferenceServer, ReplicaBalancer)

    bal = ReplicaBalancer(replica_ttl_s=30.0).start()
    with _generate_config():
        srv = InferenceServer(_charlm_wf(32), max_batch=4, max_delay_ms=1.0,
                              warmup=False, announce=bal.endpoint,
                              replica_id="gen-0").start()
    cli = InferenceClient(bal.endpoint, timeout=120.0, breaker_failures=0,
                          resend_after_s=120.0)
    direct = InferenceClient(srv.endpoint, timeout=120.0)
    try:
        _wait(lambda: bal.ready_count() == 1, "the replica joined")
        prompt = np.random.default_rng(3).integers(
            1, VOCAB, size=9).astype(np.uint8)
        for kw in ({}, {"temperature": 0.9, "top_k": 6, "seed": 11}):
            got = cli.generate(prompt, 7, **kw)
            want = direct.generate(prompt, 7, **kw)
            assert got["lb"] is True and got["replica_id"] == "gen-0"
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
        with pytest.raises(InferenceError,
                           match="balancer cannot relay streamed "
                                 "generation"):
            cli.generate(prompt, 3, stream=True)
    finally:
        cli.close()
        direct.close()
        srv.stop()
        bal.stop()


# -- the CLI ----------------------------------------------------------------------


MNIST_TINY = ["root.mnist.loader.n_train=120", "root.mnist.loader.n_valid=60",
              "root.mnist.loader.minibatch_size=60"]


def _spawn(args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "znicz_torch", *args], cwd=str(cwd),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)})


def _end(proc):
    if proc.poll() is None:
        proc.kill()
    return proc.communicate()


def test_cli_balances_a_cpu_replica_until_max_requests(tmp_path):
    """``--balance tcp://127.0.0.1:*`` in front of ``mnist --serve
    --announce --device cpu``: the printed endpoint serves 3 requests
    through the replica, and the balancer exits 0 with its ledger."""
    import json

    from znicz_torch.serving import InferenceClient

    bal = _spawn(["--balance", "tcp://127.0.0.1:*",
                  "root.common.serving.max_requests=3"], tmp_path)
    rep = None
    try:
        line = bal.stdout.readline()
        assert line.startswith("balancing at tcp://127.0.0.1:"), \
            line + _end(bal)[1]
        endpoint = line.split(" at ")[1].split()[0]
        rep = _spawn(["mnist", "--serve", "tcp://127.0.0.1:*", "--device",
                      "cpu", "--announce", endpoint, "--replica-id",
                      "cpu-7", *MNIST_TINY], tmp_path)
        line = rep.stdout.readline()
        assert line.startswith("serving mnist at"), line + _end(rep)[1]
        cli = InferenceClient(endpoint, timeout=120)
        try:
            for n in (2, 1, 3):
                r = cli.result(cli.submit(np.zeros((n, 784), np.float32)))
                assert r["y"].shape == (n, 10)
                assert r["lb"] is True and r["replica_id"] == "cpu-7"
        finally:
            cli.close()
        out, err = bal.communicate(timeout=120)
    finally:
        _end(bal)
        if rep is not None:
            _end(rep)
    assert bal.returncode == 0, err
    last = json.loads(out.splitlines()[-1])
    assert last["ledger"]["balanced"] and last["replied"] == 3
    assert last["heartbeats"] > 0


def test_cli_autoscaler_starts_a_replica_with_spawn_cmd(tmp_path):
    """``--autoscale-max 1 --spawn-cmd`` with a band that is always high:
    the balancer starts one ``--serve --announce`` replica from the
    command (``{announce}`` and ``{replica_id}`` substituted), serves
    through it, and ends the process it started when it exits."""
    import json
    import shlex

    from znicz_torch.serving import InferenceClient

    spawn = " ".join(shlex.quote(a) for a in [
        sys.executable, "-m", "znicz_torch", "mnist", "--serve",
        "tcp://127.0.0.1:*", "--device", "cpu", "--announce", "{announce}",
        "--replica-id", "{replica_id}", *MNIST_TINY])
    bal = _spawn(["--balance", "tcp://127.0.0.1:*", "--autoscale-max", "1",
                  "--spawn-cmd", spawn,
                  "root.common.serving.balance.autoscale_high_load=-1.0",
                  "root.common.serving.balance.autoscale_eval_s=0.05",
                  "root.common.serving.max_requests=2"], tmp_path)
    try:
        line = bal.stdout.readline()
        assert line.startswith("balancing at tcp://127.0.0.1:"), \
            line + _end(bal)[1]
        endpoint = line.split(" at ")[1].split()[0]
        cli = InferenceClient(endpoint, timeout=120, resend_after_s=120)
        try:
            for _ in range(2):
                r = cli.result(cli.submit(np.zeros((1, 784), np.float32)))
                assert r["lb"] is True and r["replica_id"] == "scale-1"
        finally:
            cli.close()
        out, err = bal.communicate(timeout=120)
    finally:
        _end(bal)
    assert bal.returncode == 0, err
    assert "autoscale: spawned scale-1" in out
    last = json.loads(out.splitlines()[-1])
    assert last["scale_ups"] == 1 and last["replied"] == 2


@pytest.mark.parametrize("argv", [
    ["mnist", "--balance", "tcp://127.0.0.1:*"],
    ["--balance", "tcp://127.0.0.1:*", "--serve"],
    ["--balance", "tcp://127.0.0.1:*", "--fused"],
    ["mnist", "--device", "cpu", "--announce", "tcp://127.0.0.1:1"]],
    ids=["workflow", "serve", "fused", "announce-without-serve"])
def test_cli_refusals_exit_2(argv):
    from znicz_torch.__main__ import main

    assert main(argv) == 2
