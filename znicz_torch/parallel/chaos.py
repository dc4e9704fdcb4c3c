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
    znicz_torch.parallel.chaos --flood ...``).

The fleet and training-plane harnesses of the reference's module
(replica, scaler, relay, master and preemption drivers) are not here.
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
