"""Seeded chaos injection for the serving stack (port of the serving half
of ``znicz_tpu/parallel/chaos.py``).

  - :class:`FaultSchedule`: deterministic fault decisions, each a pure
    function of ``(seed, index)`` on its own salted stream, so two
    schedules with one seed decide alike everywhere, and alike with the
    reference's: wire faults (:meth:`~FaultSchedule.decide`), compute
    stalls (:meth:`~FaultSchedule.decide_compute`, which
    ``ModelRunner.inject_compute_faults`` turns into sleeps before a
    dispatch), the transport loop's ingress hook
    (:meth:`~FaultSchedule.decide_transport`), partition windows and the
    preemption timetable (:meth:`~FaultSchedule.decide_preempt`);
  - :class:`ChaosProxy`: a ZeroMQ ROUTER <-> DEALER proxy between clients
    and a server that drops, delays, duplicates and corrupts whole
    messages by the schedule.  Corruption mutates exactly one payload
    frame (the wire-v3 metadata frame or one tensor frame), never the
    ROUTER envelope, so a refusal still routes back.  Every decision is
    counted by direction (``req`` client -> server, ``rep`` server ->
    client) and logged;
  - :class:`FloodDriver`: one client sending at ``factor`` times its
    per-client rate limit, counting every accepted reply and every
    refusal by the ``policy`` that refused it; :class:`FloodProcess`
    runs it in a separate interpreter (``python -m
    znicz_torch.parallel.chaos --flood ...``);
  - the replica-fleet harnesses: :class:`ReplicaHarness` (kill and restart
    an ``InferenceServer`` behind the balancer), :class:`ScriptedReplica`
    (a model-free replica that speaks the balancer's protocol, with
    scripted stalls, blackholes and refusals) and :class:`FleetScaler`
    (the autoscaler's in-process spawn and retire).

  - the master/slave star's harnesses: :func:`take_job_and_die` (a
    slave that takes one job and vanishes) and :class:`MasterHarness`
    (kill and restart a ``Server`` from its crash-resume file);
  - the relay tree's harnesses: :class:`RelayHarness` (kill and restart
    a ``Relay``) and :class:`SubtreePreempter` (kill and restart whole
    subtrees on the seeded :meth:`~FaultSchedule.decide_preempt`
    timetable).

Everything is CPU-only, in process and seeded.
"""

from __future__ import annotations

import bisect
import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from znicz_torch.transport.core import corrupt_message

#: schedule actions, in cumulative-probability order (``partition`` is the
#: window-based drop-all kind, outside the per-message cascade)
ACTIONS = ("drop", "corrupt", "dup", "delay", "forward", "partition")


class FaultSchedule:
    """Deterministic fault decisions: ``decide(i)`` derives a fresh RNG
    from ``(seed, i)``, so the decision for message *i* depends on the
    seed alone, not on thread timing or the messages before it.

    The wire probabilities are per message and sum to less than 1; the
    rest is forwarded untouched.  ``delay_s`` bounds an injected delay,
    ``stall`` and ``stall_s`` a dispatch's compute stall, ``partition_s``
    and ``partition_gap_s`` the drop-all windows ((0, 0) turns them
    off)."""

    #: salt of the compute-fault stream: adding stalls to a schedule
    #: leaves its wire decisions as they were
    COMPUTE_SALT = 0x57A11
    #: salt of the preemption timetable stream
    PREEMPT_SALT = 0x5B07
    #: salt of the partition window stream
    PARTITION_SALT = 0x9A27
    #: salt of the transport loop's ingress hook: a ChaosProxy with the
    #: same seed keeps its own decisions
    TRANSPORT_SALT = 0x7C04E

    #: directions a partition window stream exists for
    PARTITION_DIRECTIONS = ("req", "rep")

    def __init__(self, seed: int, drop: float = 0.0, corrupt: float = 0.0,
                 duplicate: float = 0.0, delay: float = 0.0,
                 delay_s: Tuple[float, float] = (0.05, 0.2),
                 stall: float = 0.0,
                 stall_s: Tuple[float, float] = (0.02, 0.1),
                 partition_s: Tuple[float, float] = (0.0, 0.0),
                 partition_gap_s: Tuple[float, float] = (0.5, 2.0)):
        total = drop + corrupt + duplicate + delay
        if not 0.0 <= total < 1.0:
            raise ValueError(f"fault probabilities sum to {total}; "
                             "must be in [0, 1)")
        if not 0.0 <= stall <= 1.0:
            raise ValueError(f"stall probability {stall} not in [0, 1]")
        self.seed = int(seed)
        self.drop = float(drop)
        self.corrupt = float(corrupt)
        self.duplicate = float(duplicate)
        self.delay = float(delay)
        self.delay_s = (float(delay_s[0]), float(delay_s[1]))
        self.stall = float(stall)
        self.stall_s = (float(stall_s[0]), float(stall_s[1]))
        self.partition_s = (float(partition_s[0]), float(partition_s[1]))
        self.partition_gap_s = (float(partition_gap_s[0]),
                                float(partition_gap_s[1]))
        if self.partition_s[0] < 0 or \
                self.partition_s[1] < self.partition_s[0]:
            raise ValueError(f"bad partition_s range {partition_s}")
        if self.partition_s[1] > 0 and self.partition_gap_s[0] <= 0:
            raise ValueError("partition_gap_s lower bound must be > 0 "
                             "(back-to-back windows are one window)")
        #: derived partition windows by direction (one schedule may drive
        #: several proxies on different threads)
        self._pwin: Dict[str, List[Tuple[float, float]]] = {}
        self._pwin_lock = threading.Lock()

    def decide(self, frame_no: int) -> Tuple[str, float]:
        """(action, delay seconds) for the ``frame_no``-th message."""
        rng = np.random.default_rng((self.seed, int(frame_no)))
        u = float(rng.random())
        edge = self.drop
        if u < edge:
            return "drop", 0.0
        edge += self.corrupt
        if u < edge:
            return "corrupt", 0.0
        edge += self.duplicate
        if u < edge:
            return "dup", 0.0
        edge += self.delay
        if u < edge:
            lo, hi = self.delay_s
            return "delay", lo + float(rng.random()) * (hi - lo)
        return "forward", 0.0

    def decisions(self, n: int) -> List[Tuple[str, float]]:
        """The first ``n`` decisions."""
        return [self.decide(i) for i in range(n)]

    def decide_compute(self, dispatch_no: int) -> Tuple[str, float]:
        """(action, stall seconds) for the ``dispatch_no``-th model
        dispatch: ``("stall", s)`` or ``("run", 0.0)``."""
        rng = np.random.default_rng(
            (self.seed, int(dispatch_no), self.COMPUTE_SALT))
        u = float(rng.random())
        if u < self.stall:
            lo, hi = self.stall_s
            return "stall", lo + float(rng.random()) * (hi - lo)
        return "run", 0.0

    def decide_transport(self, message_no: int) -> Tuple[str, float]:
        """(action, 0.0) for the ``message_no``-th inbound message of a
        transport loop's ingress hook: ``drop``, ``corrupt`` or
        ``forward`` by the drop and corrupt probabilities (the hook has
        no proxy to duplicate or hold a message, so that mass
        forwards)."""
        rng = np.random.default_rng(
            (self.seed, int(message_no), self.TRANSPORT_SALT))
        u = float(rng.random())
        if u < self.drop:
            return "drop", 0.0
        if u < self.drop + self.corrupt:
            return "corrupt", 0.0
        return "forward", 0.0

    def _derive_window(self, direction: str, k: int,
                       pos: float) -> Tuple[float, float]:
        """Window ``k`` of ``direction`` after the previous window's end
        ``pos``."""
        d = self.PARTITION_DIRECTIONS.index(direction)
        rng = np.random.default_rng(
            (self.seed, int(k), self.PARTITION_SALT, d))
        gap = self.partition_gap_s[0] + float(rng.random()) * (
            self.partition_gap_s[1] - self.partition_gap_s[0])
        dur = self.partition_s[0] + float(rng.random()) * (
            self.partition_s[1] - self.partition_s[0])
        start = pos + gap
        return start, start + dur

    def _windows_through(self, direction: str, t: float,
                         n: int = 0) -> List[Tuple[float, float]]:
        """The window list, extended until it covers relative time ``t``
        and holds at least ``n`` windows."""
        with self._pwin_lock:
            wins = self._pwin.setdefault(direction, [])
            while len(wins) < n or not wins or wins[-1][1] <= t:
                wins.append(self._derive_window(
                    direction, len(wins), wins[-1][1] if wins else 0.0))
            return list(wins)

    def partition_windows(self, direction: str,
                          n: int) -> List[Tuple[float, float]]:
        """The first ``n`` partition windows of ``direction`` as (start,
        end) seconds after the observer's epoch; empty when partitions
        are off."""
        if self.partition_s[1] <= 0:
            return []
        return self._windows_through(direction, -1.0, n=int(n))[:int(n)]

    def in_partition(self, direction: str, t: float) -> bool:
        """Whether ``direction`` is inside a partition window at relative
        time ``t``."""
        if self.partition_s[1] <= 0 or t < 0:
            return False
        wins = self._windows_through(direction, t)
        i = bisect.bisect_right(wins, (t, float("inf"))) - 1
        return i >= 0 and wins[i][0] <= t < wins[i][1]

    def decide_preempt(self, target_no: int,
                       kill_s: Tuple[float, float] = (0.5, 2.0),
                       down_s: Tuple[float, float] = (1.0, 3.0)
                       ) -> Tuple[float, float]:
        """``(kill_at, down)`` seconds for target ``target_no``: when it is
        killed after the driver's start, and how long it stays down."""
        rng = np.random.default_rng(
            (self.seed, int(target_no), self.PREEMPT_SALT))
        kill_at = kill_s[0] + float(rng.random()) * (kill_s[1] - kill_s[0])
        down = down_s[0] + float(rng.random()) * (down_s[1] - down_s[0])
        return float(kill_at), float(down)


class ChaosProxy:
    """Seeded fault-injecting ROUTER <-> DEALER proxy.

    Clients connect to ``front_endpoint`` (a wildcard port resolves once
    bound: :attr:`front_endpoint` then holds the address); the proxy
    relays to the server's ROUTER at ``back_endpoint``.  Messages are
    numbered in arrival order across both directions and each takes one
    :class:`FaultSchedule` decision.  :attr:`counters` and :attr:`log`
    (``(message_no, direction, action)``) record every decision."""

    def __init__(self, front_endpoint: str, back_endpoint: str,
                 schedule: FaultSchedule):
        self.front_endpoint = front_endpoint
        self.back_endpoint = back_endpoint
        self.schedule = schedule
        self._counts = {(d, a): 0 for d in ("req", "rep") for a in ACTIONS}
        self._lock = threading.Lock()
        self.log: List[Tuple[int, str, str]] = []
        self._frame_no = 0
        self._t0: Optional[float] = None    # the partition windows' epoch
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def counters(self) -> Dict[str, Dict[str, int]]:
        """``{direction: {action: count}}``."""
        with self._lock:
            return {d: {a: self._counts[(d, a)] for a in ACTIONS}
                    for d in ("req", "rep")}

    def faults_toward(self, direction: str) -> int:
        """Faults a peer in ``direction``'s receive path sees as a timeout
        or a bad reply: drops either way plus that direction's
        corruptions."""
        c = self.counters
        return c["req"]["drop"] + c["rep"]["drop"] + c[direction]["corrupt"]

    def total_faults(self) -> int:
        return sum(n for d in self.counters.values()
                   for a, n in d.items() if a != "forward")

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ChaosProxy":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chaos-proxy")
        self._thread.start()
        if not self._ready.wait(timeout=10) or self._error is not None:
            raise RuntimeError(f"chaos proxy failed to bind "
                               f"{self.front_endpoint}: {self._error!r}")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- the relay loop -------------------------------------------------------

    def _corrupt_one(self, frames: List[bytes], frame_no: int
                     ) -> List[bytes]:
        """Exactly one payload frame mutated, picked as a pure function of
        (seed, frame_no), never the routing envelope."""
        return corrupt_message(frames,
                               (self.schedule.seed, int(frame_no), 0xC0))

    def _count(self, fno: int, direction: str, action: str) -> None:
        with self._lock:
            self._counts[(direction, action)] += 1
            self.log.append((fno, direction, action))

    def _relay(self, frames: List[bytes], direction: str, out,
               held: list, seq: List[int]) -> None:
        """One message, one decision.  Inside a partition window of its
        direction a message is dropped and counted ``partition`` (its
        index is still consumed)."""
        fno = self._frame_no
        self._frame_no += 1
        if self.schedule.in_partition(direction, time.time() - self._t0):
            self._count(fno, direction, "partition")
            return
        action, delay = self.schedule.decide(fno)
        self._count(fno, direction, action)
        if action == "drop":
            return
        if action == "corrupt":
            out.send_multipart(self._corrupt_one(frames, fno))
        elif action == "dup":
            out.send_multipart(frames)
            out.send_multipart(frames)
        elif action == "delay":
            seq[0] += 1
            heapq.heappush(held, (time.time() + delay, seq[0], out, frames))
        else:
            out.send_multipart(frames)

    def _loop(self) -> None:
        from znicz_torch.transport import TransportLoop

        loop = TransportLoop("chaos_proxy", stop=self._stop,
                             instance=self.front_endpoint)
        held: list = []                 # (release time, seq, socket, frames)
        seq = [0]
        try:
            try:
                front = loop.bind_router(self.front_endpoint)
                self.front_endpoint = loop.resolved_endpoint(front)
                back = loop.connect_dealer(self.back_endpoint)
            except Exception as exc:
                self._error = exc
                self._ready.set()
                return
            loop.register(front, lambda frames: self._relay(
                frames, "req", back, held, seq), drain=True)
            loop.register(back, lambda frames: self._relay(
                frames, "rep", front, held, seq), drain=True)

            def release_due():
                now = time.time()
                while held and held[0][0] <= now:
                    _, _, out, frames = heapq.heappop(held)
                    out.send_multipart(frames)

            def next_timeout_ms() -> int:
                if not held:
                    return 20
                return max(1, min(20, int((held[0][0] - time.time())
                                          * 1000)))

            loop.add_tick(release_due)
            self._t0 = time.time()
            self._ready.set()
            loop.run(timeout_fn=next_timeout_ms)
        finally:
            loop.close()


# -- resource-fault drivers ---------------------------------------------------


class FloodDriver:
    """One client sending at ``factor`` times its per-client rate limit.

    Open-loop arrivals totalling ``rate_rows_per_s * factor`` rows/s on a
    daemon thread; ``x`` may hold several rows a request (the admission
    bucket meters rows).  ``accepted`` counts ok replies, ``refusals``
    the refusal replies by the ``policy`` that refused them.  The client's
    circuit breaker is off: a flood must not back off."""

    def __init__(self, endpoint: str, x, rate_rows_per_s: float,
                 factor: float = 10.0, client_id: str = "flooder",
                 max_in_flight: int = 256):
        self.endpoint = endpoint
        self.x = x
        self.rows = int(x.shape[0]) if getattr(x, "ndim", 1) > 1 else 1
        self.rate = float(rate_rows_per_s) * float(factor)
        self.client_id = client_id
        self.max_in_flight = int(max_in_flight)
        self.accepted = 0
        self.refusals: Dict[str, int] = {}
        self.sent = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def outcomes(self) -> int:
        return self.accepted + sum(self.refusals.values())

    def start(self) -> "FloodDriver":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chaos-flood")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        from znicz_torch.serving.client import InferenceClient

        cli = InferenceClient(self.endpoint, timeout=60.0,
                              resend_after_s=5.0, max_resends=100,
                              client_id=self.client_id, breaker_failures=0)
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                # send every request that is due, not one a lap: the
                # offered rate must reach factor x the limit
                while (time.perf_counter() - t0
                       >= (self.sent * self.rows) / self.rate
                       and cli.in_flight < self.max_in_flight
                       and not self._stop.is_set()):
                    cli.submit(self.x)
                    self.sent += 1
                for rep in cli.collect(0.002):
                    if rep.get("ok"):
                        self.accepted += 1
                    else:
                        pol = rep.get("policy", "error")
                        self.refusals[pol] = self.refusals.get(pol, 0) + 1
        except Exception:       # the flood's boundary: a dying flood is quiet
            pass
        finally:
            cli.close()


class FloodProcess:
    """:class:`FloodDriver` in a separate interpreter, which shares no
    interpreter lock with the service or its other clients.  The child
    is ``python -m znicz_torch.parallel.chaos --flood ...``; flood windows
    are toggled over its stdin (``start``/``stop``), each ``stop``
    answering the window's accounting (sent, accepted, refusals by
    policy) as one JSON line.  ``sample_dim`` is an int (a flat sample)
    or a shape tuple; the rows are zeros."""

    def __init__(self, endpoint: str, sample_dim, rate_rows_per_s: float,
                 factor: float = 10.0, client_id: str = "flooder",
                 max_in_flight: int = 32, rows: int = 1):
        import os
        import subprocess
        import sys

        shape = ([int(sample_dim)] if np.ndim(sample_dim) == 0
                 else [int(d) for d in sample_dim])
        # the child imports this package from where this process did
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root, os.environ.get("PYTHONPATH", "")]))
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "znicz_torch.parallel.chaos", "--flood",
             endpoint, "x".join(map(str, shape)),
             str(float(rate_rows_per_s)), str(float(factor)), client_id,
             str(int(max_in_flight)), str(int(rows))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1, env=env)
        line = self._proc.stdout.readline().strip()
        if line != "ready":
            self._proc.kill()
            self._proc.wait()
            raise RuntimeError(f"flood child failed to come up: {line!r}")

    def start_flood(self) -> None:
        self._proc.stdin.write("start\n")
        self._proc.stdin.flush()

    def stop_flood(self) -> Dict:
        """Stop the current flood window; returns its accounting."""
        import json

        self._proc.stdin.write("stop\n")
        self._proc.stdin.flush()
        return json.loads(self._proc.stdout.readline())

    def close(self) -> None:
        try:
            self._proc.stdin.write("quit\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, ValueError):
            pass
        try:
            self._proc.wait(timeout=30)
        except Exception:
            self._proc.kill()
            self._proc.wait()
            raise


# -- replica-fleet harnesses --------------------------------------------------


class ReplicaHarness:
    """Kill/restart harness for a serving replica behind the balancer:
    ``make_server`` builds a fresh ``InferenceServer`` each (re)start.  At
    the same bind, the balancer's data DEALER reconnects into the
    restarted replica; at a wildcard bind the restarted replica announces
    a new endpoint and the balancer follows it.  ``kill()`` is a replica
    crash as the balancer sees it: its heartbeats stop, and the retained
    previous generation dies with it; the restarted replica announces its
    boot snapshot and the balancer heals it back onto the fleet path."""

    def __init__(self, make_server):
        self.make_server = make_server
        self.server = None
        self.kills = 0

    def start(self):
        self.server = self.make_server()
        return self.server.start()

    def kill(self) -> None:
        self.server.stop()
        self.kills += 1

    def restart(self):
        """A fresh replica at the bind ``make_server`` gives."""
        return self.start()


class ScriptedReplica:
    """Model-free fake replica: speaks the replica side of the balancer
    protocol (a ROUTER bind for data traffic, DEALER heartbeats with
    readiness, queue depth and p99) with a scripted forward ``y = x *
    scale`` instead of a model, so fleet failover, hedging and rollback
    tests pay no warmup.  numpy and zmq only.

    ``snapshots`` maps swap paths to the scale each "generation" computes
    with, or to a dict ``{"scale": s, "stall_s": t}`` for a generation
    that is also slow (the scripted p99-regression canary); ``swap`` to an
    unknown path is refused like a broken snapshot, and ``rollback``
    restores the kept previous (scale, stall, generation, path) as
    ``ModelRunner.rollback`` does.  Faults: ``stall_every``/``stall_s``
    sleeps before every Nth reply (the tail the hedger races),
    ``blackhole`` accepts requests and never answers (the failover path),
    ``refuse`` answers every infer with that ``(policy, scope)`` refusal.
    ``kill()`` stops the thread mid-everything; ``restart()`` comes back
    at the same bind with boot state (generation 1, the boot scale and
    path): a restarted process remembers nothing, which is what the
    balancer's healing is for.  The scripted state is lock-guarded: tests
    read counters while the serve thread mutates them."""

    def __init__(self, announce: str, replica_id: str,
                 bind: str = "tcp://127.0.0.1:*",
                 snapshots: Optional[Dict[str, float]] = None,
                 boot_path: str = "boot", boot_scale: float = 1.0,
                 heartbeat_s: float = 0.05, stall_s: float = 0.0,
                 stall_every: int = 0, blackhole: bool = False,
                 refuse: Optional[Tuple[str, str]] = None):
        self.announce = announce
        self.replica_id = replica_id
        self.bind = bind
        self.endpoint: Optional[str] = None
        self.snapshots = dict(snapshots or {})
        self.boot_path = boot_path
        self.boot_scale = float(boot_scale)
        self.heartbeat_s = float(heartbeat_s)
        self.stall_s = float(stall_s)
        self.stall_every = int(stall_every)
        self.blackhole = blackhole
        self.refuse = refuse
        self._lock = threading.Lock()
        self._reset_state()
        self.served = 0
        self.swallowed = 0                  # blackholed requests
        self.kills = 0
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reset_state(self) -> None:
        """Boot state: what a restarted process remembers (nothing)."""
        self.gen = 1
        self._hwm = 1
        self.scale = self.boot_scale
        self.gen_stall_s = 0.0
        self.path = self.boot_path
        self._previous: Optional[Tuple[float, float, int, str]] = None

    def start(self) -> "ScriptedReplica":
        self._stop = threading.Event()
        self._ready.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"fake-{self.replica_id}")
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError(f"scripted replica {self.replica_id} "
                               f"failed to bind {self.bind}")
        return self

    def kill(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._lock:
            self.kills += 1

    def restart(self) -> "ScriptedReplica":
        """Back at the same bind with boot state (a fresh process)."""
        if self._thread is not None:
            self.kill()
        with self._lock:
            self._reset_state()
        self.bind = self.endpoint or self.bind
        return self.start()

    def _heartbeat(self) -> Dict:
        with self._lock:
            return {"cmd": "heartbeat", "replica_id": self.replica_id,
                    "endpoint": self.endpoint, "ready": True,
                    "draining": False, "swapping": False,
                    "gen": self.gen, "snapshot_path": self.path,
                    "queue_depth": 0, "served": self.served,
                    # a scripted replica has no executables: its boot is
                    # instant, as the fleet autoscale tests want
                    "warm_source": "scripted", "warm_hits": 0,
                    "warm_misses": 0, "boot_s": 0.0,
                    "p99_ms_by_bucket": {}}

    def _answer(self, req: Dict) -> Optional[Dict]:
        """One scripted reply (None: swallow it), state under the lock."""
        cmd = req.get("cmd")
        rid = req.get("req_id")
        base = {"req_id": rid, "replica_id": self.replica_id}
        if cmd == "ping":
            return dict(base, ok=True, pong=True)
        if cmd == "swap":
            path = req.get("path")
            with self._lock:
                if path not in self.snapshots:
                    return dict(base, ok=False,
                                error=f"unknown snapshot {path!r}")
                val = self.snapshots[path]
                if not isinstance(val, dict):
                    val = {"scale": float(val)}
                self._previous = (self.scale, self.gen_stall_s,
                                  self.gen, self.path)
                self._hwm += 1
                self.gen = self._hwm
                self.scale = float(val.get("scale", 1.0))
                self.gen_stall_s = float(val.get("stall_s", 0.0))
                self.path = path
                return dict(base, ok=True, swap_started=True,
                            generation=self.gen)
        if cmd == "rollback":
            with self._lock:
                if self._previous is None:
                    return dict(base, ok=False,
                                error="no previous generation retained")
                (self.scale, self.gen_stall_s, self.gen,
                 self.path) = self._previous
                self._previous = None
                return dict(base, ok=True, rolled_back=True,
                            generation=self.gen)
        if cmd != "infer":
            return dict(base, ok=False, error=f"unknown cmd {cmd!r}")
        with self._lock:
            self.served += 1
            n = self.served
            scale, gen = self.scale, self.gen
        if self.refuse is not None:
            policy, scope = self.refuse
            return dict(base, ok=False, rejected=True, policy=policy,
                        scope=scope, error=f"scripted {policy} refusal")
        if self.blackhole:
            with self._lock:
                self.swallowed += 1
            return None
        if self.stall_every and n % self.stall_every == 0:
            time.sleep(self.stall_s)
        if self.gen_stall_s:
            time.sleep(self.gen_stall_s)    # a slow generation (the
            # scripted p99-regression canary)
        x = np.asarray(req.get("x"), np.float32)
        return dict(base, ok=True, gen=gen,
                    y=(x * np.float32(scale)).astype(np.float32))

    def _loop(self) -> None:
        from znicz_torch.parallel import wire
        from znicz_torch.transport import TransportLoop, bad_frame_reply

        loop = TransportLoop("scripted_replica", stop=self._stop,
                             instance=self.replica_id)
        next_hb = [0.0]
        try:
            sock = loop.bind_router(self.bind)
            with self._lock:
                self.endpoint = loop.resolved_endpoint(sock)
            hb = loop.connect_dealer(self.announce)

            def on_data(raw: List[bytes]) -> None:
                envelope, payload = wire.split_envelope(raw)
                try:
                    req, _ = wire.decode_message(payload or raw)
                except wire.WireError as exc:
                    bad, _ = wire.encode_message(dict(
                        bad_frame_reply(exc),
                        replica_id=self.replica_id, error=str(exc)))
                    sock.send_multipart(list(envelope) + bad)
                    return
                rep = self._answer(req)
                if rep is None:
                    return                  # blackholed
                out, _ = wire.encode_message(rep)
                sock.send_multipart(list(envelope) + out, copy=False)

            def beat() -> None:
                now = time.time()
                if now >= next_hb[0]:
                    next_hb[0] = now + self.heartbeat_s
                    frames, _ = wire.encode_message(self._heartbeat())
                    hb.send_multipart([b""] + frames)

            loop.register(sock, on_data, drain=True)
            loop.register(hb, lambda _frames: None,  # acks discarded
                          drain=True)
            loop.add_tick(beat)
            beat()                          # the first heartbeat, pre-poll
            self._ready.set()
            loop.run(poll_ms=5)
        finally:
            loop.close()


class FleetScaler:
    """In-process spawn/retire harness for the balancer's autoscaler:
    ``factory(i)`` builds a startable replica (a :class:`ScriptedReplica`,
    or an ``InferenceServer`` harness) for fleet index ``i``.  ``spawn()``
    boots the next index on a daemon thread (the balancer calls it outside
    its lock, and a model replica's warmup must not stall the caller
    either); ``retire(replica_id)`` kills the matching handle.  Replicas
    started elsewhere join through :meth:`adopt`, so the autoscaler can
    retire the initial fleet too."""

    def __init__(self, factory):
        import logging

        self.factory = factory
        self.log = logging.getLogger("znicz_torch.chaos")
        self._lock = threading.Lock()
        self._handles: Dict[str, object] = {}
        self._next = 0
        self._n = {"spawned": 0, "retired": 0, "spawn_failures": 0}

    def adopt(self, replica) -> None:
        """Track an already-running replica (the pre-autoscale fleet)."""
        with self._lock:
            self._handles[replica.replica_id] = replica

    def spawn(self) -> None:
        with self._lock:
            i = self._next
            self._next += 1

        def boot() -> None:
            try:
                rep = self.factory(i)
                rep.start()
                with self._lock:
                    self._handles[rep.replica_id] = rep
                    self._n["spawned"] += 1
            except Exception:
                with self._lock:
                    self._n["spawn_failures"] += 1
                self.log.exception("fleet scaler: spawn %d failed", i)

        threading.Thread(target=boot, daemon=True,
                         name=f"fleet-spawn-{i}").start()

    def retire(self, replica_id: str) -> None:
        with self._lock:
            rep = self._handles.pop(replica_id, None)
        if rep is None:
            self.log.warning("fleet scaler: retire(%s) — no handle "
                             "(already gone?)", replica_id)
            return
        rep.kill()
        with self._lock:
            self._n["retired"] += 1

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._handles)

    @property
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)

    def stop_all(self) -> None:
        """Teardown: kill every tracked replica."""
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
        for rep in handles:
            try:
                rep.kill()
            except Exception:           # a teardown race: keep going
                self.log.exception("fleet scaler: kill failed")


def take_job_and_die(endpoint: str, workflow, slave_id: str = "doomed",
                     timeout_ms: int = 10_000,
                     attempts: int = 40) -> Optional[int]:
    """The mid-job slave death: register, take one job, vanish without
    replying.  Returns the job id the master now holds in flight (the
    reaper must bring it back), or None if training already ended.  It
    rides transport faults as a slave does (a fresh socket and a new
    register after a timeout, a corrupted reply or a ``bad_frame``
    refusal), at most ``attempts`` cycles."""
    from znicz_torch.network_common import handshake_request
    from znicz_torch.transport import Endpoint, TransportFault

    ep = Endpoint(endpoint, recv_timeout_s=timeout_ms / 1000.0)
    last: Optional[BaseException] = None

    def rpc(msg: dict) -> dict:
        return ep.rpc_message(dict(msg, id=slave_id))

    try:
        for _ in range(attempts):
            try:
                rep = rpc(handshake_request(workflow))
                if rep.get("bad_frame"):
                    ep.reset()
                    continue
                if not rep.get("ok"):
                    raise RuntimeError(
                        f"registration refused: {rep.get('error')}")
                while True:
                    rep = rpc({"cmd": "job"})
                    if "job" in rep:
                        return rep["job_id"]
                    if rep.get("done"):
                        return None
                    if rep.get("unregistered"):
                        ep.reset()
                        break
                    time.sleep(0.05)
            except TransportFault as exc:
                last = exc
    finally:
        ep.close()              # died mid-job, the update never sent
    raise RuntimeError(
        f"doomed slave never reached a job through the chaos ({attempts} "
        f"attempts; last fault: {last!r})")


class MasterHarness:
    """Kill and restart the master of the star.  :meth:`start` builds a
    fresh workflow and ``Server`` (restored from ``resume_path`` when the
    file exists, as a restarted ``--master-resume`` process is) and serves
    it on a thread; :meth:`kill` is a crash: serving stops at the next
    tick with no final snapshot.  ``endpoint`` may use a wildcard port:
    the first start resolves it and every restart binds the same
    address."""

    def __init__(self, make_workflow, endpoint: str, resume_path: str,
                 snapshot_every_s: float = 0.3, linger: float = 3.0,
                 **server_kwargs):
        self.make_workflow = make_workflow
        self.endpoint = endpoint
        self.resume_path = resume_path
        self.snapshot_every_s = snapshot_every_s
        self.linger = linger
        self.server_kwargs = server_kwargs
        self.server = None
        self.workflow = None
        self.kills = 0

    def start(self):
        from znicz_torch.server import Server

        self.workflow = self.make_workflow()
        self.server = Server(self.workflow, endpoint=self.endpoint,
                             resume_path=self.resume_path,
                             snapshot_every_s=self.snapshot_every_s,
                             **self.server_kwargs).start(linger=self.linger)
        self.endpoint = self.server.endpoint
        return self.server

    def kill(self, timeout: float = 30.0) -> None:
        """A master crash mid-epoch (no final snapshot)."""
        self.server.stop()
        if not self.server.join(timeout):
            raise RuntimeError("master thread did not stop")
        self.kills += 1

    def wait(self, timeout: float = 120.0) -> bool:
        """Join the serving thread; True once it exited."""
        return self.server.join(timeout)


class SubtreePreempter:
    """Kill and restart whole subtrees of the relay tree on a seeded
    timetable.  Each target is ``(name, kill_fn, restart_fn)``, typically
    closures over a :class:`RelayHarness` and ``Client.preempt()`` calls
    for its slaves; target i is killed ``decide_preempt(i)[0]`` seconds
    after :meth:`start` and restarted after its ``down`` seconds.  Every
    executed action is recorded with its wall time, so a check can hold
    progress counters to the kill window (:meth:`window`).  The recorded
    state is read under a lock while the timetable's thread writes it."""

    def __init__(self, schedule: FaultSchedule, targets,
                 kill_s: Tuple[float, float] = (0.5, 2.0),
                 down_s: Tuple[float, float] = (1.0, 3.0)):
        self.schedule = schedule
        self.targets = list(targets)
        self.timetable: List[tuple] = []    # (at_s, idx, action, fn, name)
        for i, (name, kill_fn, restart_fn) in enumerate(self.targets):
            kill_at, down = schedule.decide_preempt(i, kill_s, down_s)
            self.timetable.append((kill_at, i, "kill", kill_fn, name))
            self.timetable.append((kill_at + down, i, "restart",
                                   restart_fn, name))
        self.timetable.sort(key=lambda t: (t[0], t[1], t[2]))
        self._lock = threading.Lock()
        self._events: List[Tuple[float, str, str]] = []  # (wall, name, act)
        self._preempted = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def events(self) -> List[Tuple[float, str, str]]:
        with self._lock:
            return list(self._events)

    @property
    def preemptions(self) -> int:
        with self._lock:
            return self._preempted

    def window(self) -> Optional[Tuple[float, float]]:
        """(first kill, last restart) wall times of what has run so far
        (the last restart is now while a target is down); None before the
        first kill."""
        with self._lock:
            kills = [t for t, _, a in self._events if a == "kill"]
            rests = [t for t, _, a in self._events if a == "restart"]
        if not kills:
            return None
        return min(kills), max(rests) if rests else time.time()

    def start(self) -> "SubtreePreempter":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chaos-preempter")
        self._thread.start()
        return self

    def join(self, timeout: float = 120.0) -> bool:
        """Wait for the whole timetable; True once it ran."""
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        t0 = time.time()
        for at, _, action, fn, name in self.timetable:
            while time.time() - t0 < at:
                if self._stop.wait(min(0.02, max(0.001,
                                                 at - (time.time() - t0)))):
                    return
            if self._stop.is_set():
                return
            fn()
            with self._lock:
                self._events.append((time.time(), name, action))
                if action == "kill":
                    self._preempted += 1


class RelayHarness:
    """Kill and restart a relay of the tree.  :meth:`start` builds a fresh
    ``Relay`` and serves it on a thread; :meth:`kill` stops it mid-run:
    its queued jobs and buffered contributions are lost, as a crashed
    relay's are; the master's reaper brings the jobs back, and the
    children either ride out a :meth:`restart` at the same address or
    fall back to the relay's advertised upstream once their budget is
    spent.  ``bind`` may use a wildcard port: the first start resolves
    it and every restart binds the same address."""

    def __init__(self, upstream: str, bind: str, **relay_kwargs):
        self.upstream = upstream
        self.bind = bind
        self.relay_kwargs = relay_kwargs
        self.relay = None
        self.kills = 0

    @property
    def endpoint(self) -> str:
        """The address the children dial (resolved once started)."""
        return self.bind

    def start(self):
        from znicz_torch.parallel.relay import Relay

        self.relay = Relay(self.upstream, self.bind,
                           **self.relay_kwargs).start()
        self.bind = self.relay.endpoint
        return self.relay

    def kill(self, timeout: float = 30.0) -> None:
        """A relay crash: its buffered state dies with it."""
        self.relay.stop(timeout)
        self.kills += 1

    def restart(self):
        """A fresh relay at the same address (the children reconnect into
        it and register again)."""
        self.kill()
        return self.start()


def _flood_main(argv: List[str]) -> None:
    """The child half of :class:`FloodProcess`: a stdin/stdout command
    loop around :class:`FloodDriver`."""
    import json
    import sys

    endpoint, shape, rate, factor, client_id, mif, rows = argv
    x = np.zeros((int(rows),) + tuple(int(d) for d in shape.split("x")),
                 np.float32)
    print("ready", flush=True)
    driver: Optional[FloodDriver] = None
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "start" and driver is None:
            driver = FloodDriver(endpoint, x, float(rate),
                                 factor=float(factor), client_id=client_id,
                                 max_in_flight=int(mif)).start()
        elif cmd == "stop" and driver is not None:
            driver.stop()
            print(json.dumps({"sent": driver.sent,
                              "accepted": driver.accepted,
                              "refusals": driver.refusals}), flush=True)
            driver = None
        elif cmd == "quit":
            break
    if driver is not None:
        driver.stop()


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "--flood":
        _flood_main(sys.argv[2:])
