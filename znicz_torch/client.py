"""The slave of the asynchronous parameter server (port of
``znicz_tpu/client.py``): pull a job from the master, compute it on the
local replica of the workflow (each slave owns its dataset; the master
ships minibatch indices and the parameters), push back the weight deltas
and the metrics.  ``server.py`` describes the protocol.

Fault tolerance: a transport fault does not end the slave.  :meth:`run`
is a reconnect state machine on the transport ``Endpoint``: a timed-out
REQ socket is dropped, the next attempt connects a fresh one after a
capped exponential backoff jittered per slave, and the slave registers
again before any job traffic, so it rides out lost frames, garbage
replies and a master restart (``--master-resume``).  One circuit breaker
(``slave_breaker_failures``) makes attempts against a dead master fail
locally; a job whose ``deadline_ms`` budget is spent is dropped
uncomputed (the master re-queues it).

Wire v3: deltas leave quantized to ``root.common.engine.wire_dtype``
(bf16/int8 with per-tensor scales) through a ``wire.DeltaEncoder`` whose
residuals feed each error into the next delta; a pending update is kept
as its encoded frames, so a resend after a reconnect sends the same
bytes.  A :class:`_JobPrefetcher` fetches job N+1 on a second socket
while job N computes (``job_prefetch``).

Two slaves: :class:`Client` runs a job on the unit engine (the forward
units, the evaluator and the GD chain, one minibatch at a time);
:class:`FusedClient` runs it on ``FusedTrainer`` (a segment of k
minibatches as k captured steps on the card).  The master cannot tell
them apart but by speed.

The tree (``parallel/relay.py``): a slave may work for a relay, which
speaks the master's protocol.  A relay's register reply names its own
upstream, which the slave keeps as its fallback: once its reconnect
budget against a dead relay is spent, it switches there and registers
again.  A master with ``elastic_rehome`` may answer a register with a
``rehome`` endpoint (a live relay); the slave moves there and keeps the
endpoint it left as its fallback.

A meshed slave (``FusedClient`` under ``train_shard``) is one slave made
of a group of processes, one a rank (``parallel/mesh.py``): rank 0 talks
to the master and the others follow (:meth:`FusedClient.run`).  For each
job rank 0 broadcasts a header (the job and whether it trains) and the
master's parameters; every rank steps on its own rows, and rank 0 forms
the delta from the leaves gathered whole.  When the master says done, or
rank 0 gives up, every rank leaves at once.  Its handshake carries the
mesh's shape.

Telemetry: the counters are the ``slave`` scope's registry counters,
read through attributes of the same names; each job is a ``slave/job``
span carrying the job's ``trace_id``.  The client names itself
``slave-<id>`` in the fleet, and each update carries a bounded batch of
its exported spans and fresh journal events (:meth:`Client._obs_payload`)
to the master, or to a relay, which forwards them upstream.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from znicz_torch import telemetry
from znicz_torch.telemetry.metrics import registered_property
import torch

from znicz_torch.core.config import root
from znicz_torch.parallel.fused import FusedUnsupportedError
from znicz_torch.transport import (BadReply, CircuitBreaker,
                                   CircuitOpenError, Endpoint, PeerTimeout,
                                   RetryPolicy, local_deadline)

log = logging.getLogger("znicz_torch.slave")


def scheduled_hypers_rows(base_hypers: Dict, mbs: List[dict]) -> Dict:
    """Per-step hyperparameter rows of a fused job under a schedule the
    master evaluates: the slave's own constant rows (the digest makes them
    the master's), with (lr, lr_bias) — columns 0 and 1 — overwritten by
    the values the master stamped on each TRAIN minibatch."""
    rows = []
    for mb in mbs:
        row = {name: np.array(t, np.float32)
               for name, t in base_hypers.items()}
        for name, pair in (mb.get("hypers") or {}).items():
            if name in row:
                row[name][0] = np.float32(pair[0])
                row[name][1] = np.float32(pair[1])
        rows.append(row)
    return {name: np.stack([r[name] for r in rows]) for name in rows[0]}


class _JobPrefetcher:
    """While job N computes, this thread asks for job N+1 on its own REQ
    socket (sockets are not thread-safe), so the fetch overlaps the
    compute.  At most one fetch is outstanding: :meth:`request` arms it,
    :meth:`take` collects the reply (or None).  A fault on this socket
    leaves the main loop's state machine alone: its own ``Endpoint``
    drops the socket, the prefetch counters tick, and the main socket
    fetches the job itself.  It shares the client's breaker.

    Job N+1 is issued while update N is still local, so its parameters
    miss this slave's last delta: one step of staleness.  A strictly
    sequential single-slave run needs ``job_prefetch`` off."""

    #: how long :meth:`take` waits for a fetch in flight before the main
    #: socket takes over
    TAKE_GRACE_S = 0.25

    def __init__(self, client: "Client", make_endpoint,
                 recv_timeout: float):
        self._client = client
        self._ep: Endpoint = make_endpoint()
        self._recv_timeout = float(recv_timeout)
        self._want = threading.Event()
        self._ready = threading.Event()
        self._slot: Optional[dict] = None
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"job-prefetch-{client.slave_id}")
        self._thread.start()

    def request(self) -> None:
        """Arm one fetch; a no-op while one is pending or unconsumed."""
        if self._want.is_set() or self._ready.is_set():
            return
        self._slot = None
        self._want.set()

    def pending(self) -> bool:
        return self._want.is_set() or self._ready.is_set()

    def take(self) -> Optional[dict]:
        """The fetched reply, or None (nothing armed, the fetch failed,
        or it is still in flight past the grace).  A fetch that lands
        after a miss stays in the slot for the next take."""
        if not self.pending():
            return None
        if not self._ready.wait(min(self.TAKE_GRACE_S, self._recv_timeout)):
            return None
        rep, self._slot = self._slot, None
        self._ready.clear()
        return rep

    def stop(self) -> None:
        self._stop = True
        self._want.set()
        self._thread.join(self._recv_timeout + 5.0)

    def _loop(self) -> None:
        from znicz_torch.parallel import wire

        try:
            while not self._stop:
                self._want.wait()
                if self._stop:
                    break
                rep = None
                try:
                    frames, _ = wire.encode_message(
                        {"cmd": "job", "prefetch": True,
                         "id": self._client.slave_id})
                    rep = self._ep.rpc(frames)
                    # the deadline budget burns from receipt
                    rep["_received_at"] = time.monotonic()
                except CircuitOpenError:
                    pass
                except PeerTimeout:
                    self._client._inc("prefetch_reconnects")
                except BadReply:
                    self._client._inc("prefetch_bad_replies")
                    self._client._inc("prefetch_reconnects")
                except Exception:
                    log.warning("%s: prefetch fetch failed",
                                self._client.slave_id, exc_info=True)
                    self._client._inc("prefetch_reconnects")
                    self._ep.reset()
                finally:
                    self._slot = rep
                    self._want.clear()
                    self._ready.set()
        finally:
            self._ep.close()


class Client:
    """A unit-engine slave of ``workflow`` (a ``StandardWorkflow`` or a
    sample's graph with ``forward_units``, ``evaluator`` and
    ``gd_units``)."""

    #: slave counters: name -> meaning (the reference's)
    COUNTERS = {
        "jobs_done": "jobs completed",
        "reconnects": "fresh-socket retries (main loop)",
        "bad_replies": "undecodable replies",
        "prefetch_hits": "jobs consumed from the prefetcher",
        "prefetch_reconnects": "fresh-socket retries (prefetcher)",
        "prefetch_bad_replies": "undecodable replies (prefetcher)",
        "jobs_expired": "jobs dropped uncomputed: deadline budget spent",
        "breaker_opens": "circuit breaker transitions to open",
        "breaker_short_circuits": "attempts refused locally: breaker "
                                  "open (no socket, no recv timeout)",
    }

    def __init__(self, workflow, endpoint: str = "tcp://127.0.0.1:5570",
                 slave_id: Optional[str] = None):
        self.workflow = workflow
        self.endpoint = endpoint
        self.slave_id = slave_id or uuid.uuid4().hex[:8]
        self._lock = threading.Lock()
        _sc = telemetry.scope("slave")
        self._m = {name: _sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        self._tracer = telemetry.tracer()
        # this slave's fleet identity and span exporter: its spans and
        # journal events ride its updates upstream
        telemetry.set_identity(f"slave-{self.slave_id}")
        self._exporter = telemetry.exporter()
        self._obs_ev_seq = 0            # the journal's piggyback cursor
        self.wire_dtype = "float32"     # from the config in run()
        self._delta_encoder = None
        #: a simulated preemption: run() exits at its next loop top with
        #: the pending update and the job in flight lost
        self._preempt = threading.Event()
        #: the run's breaker, shared with the prefetcher
        self._breaker: Optional[CircuitBreaker] = None
        #: seconds each computed job took (compute only), in order
        self.job_seconds: List[float] = []
        #: the upstream a relay advertised in its register reply (the
        #: master advertises none): where the slave goes once its
        #: reconnect budget against the relay is spent
        self._fallback_endpoint: Optional[str] = None

    def _inc(self, name: str, n: int = 1) -> None:
        self._m[name].inc(n)

    def _obs_payload(self) -> Dict:
        """The fleet observability piggyback of one update: a bounded
        batch of this slave's exported spans and its fresh journal
        events, under its fleet origin; empty when there is nothing to
        ship."""
        out: Dict = {}
        spans = self._exporter.drain(telemetry.span_export_batch())
        if spans:
            out["spans"] = spans
        ev = telemetry.journal().since(
            self._obs_ev_seq, limit=telemetry.span_export_batch())
        if ev:
            self._obs_ev_seq = ev[-1]["seq"]
            out["events"] = ev
        if out:
            out["origin"] = telemetry.identity()
        return out

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        """The run's shared breaker (None before run())."""
        return self._breaker

    @property
    def mesh_shape(self):
        """``{"data": dp, "model": mp}`` of a meshed slave (the register
        handshake carries it), else None."""
        return None

    def preempt(self) -> None:
        """The preemption kill switch: the slave vanishes at its next
        loop top; the master's reaper recovers its job."""
        self._preempt.set()

    def _rpc(self, ep: Endpoint, msg: dict) -> dict:
        from znicz_torch.parallel import wire

        msg["id"] = self.slave_id
        frames, _ = wire.encode_message(msg)
        return ep.rpc(frames)

    def _apply_params(self, params: Dict) -> None:
        for f in self.workflow.forwards:
            if f.has_weights and f.name in params:
                f.apply_data_from_master(params[f.name])

    def _deltas_since(self, before: Dict) -> Dict:
        from znicz_torch.nn_units import params_of

        out = {}
        for f in self.workflow.forwards:
            if not f.has_weights:
                continue
            out[f.name] = {
                k: t.detach().float().cpu().numpy() - before[f.name][k]
                for k, t in params_of(f).items()}
        return out

    def _run_minibatch(self, job: dict, train: bool):
        """One job's compute: a segment job loops its minibatches and
        returns a metrics list, a single job one metrics dict."""
        if "minibatches" in job:
            return [self._run_one(mb, train) for mb in job["minibatches"]]
        return self._run_one(job, train)

    def _run_one(self, job: dict, train: bool) -> Dict:
        from znicz_torch.memory import Array

        wf = self.workflow
        loader = wf.loader
        # the master's assignment into the local loader
        loader.minibatch_indices = np.asarray(job["indices"],
                                              np.int32).copy()
        loader.minibatch_size = int(job["size"])
        loader.minibatch_class = int(job["class"])
        loader.fill_minibatch()
        for f in wf.forward_units:
            f.run()
        ev = wf.evaluator
        ev.run()
        metrics = {"loss": float(ev.loss)}
        if hasattr(ev, "n_err"):
            metrics["n_err"] = int(ev.n_err)
            conf = getattr(ev, "confusion_matrix", None)
            if isinstance(conf, Array) and conf:
                metrics["confusion"] = np.array(conf.map_read())
        if train:
            # the master's scheduled rates before the GD chain
            sched = job.get("hypers") or {}
            for gd in wf.gd_units:
                pair = sched.get(gd.forward.name)
                if pair:
                    gd.learning_rate = float(pair[0])
                    gd.learning_rate_bias = float(pair[1])
            wf.decision.gd_skip.set(False)
            for gd in wf.gd_units:
                gd.run()
        return metrics

    def engine_name(self) -> str:
        return "unit"

    def run(self, poll_sleep: float = 0.05, recv_timeout: float = 15.0,
            max_reconnects: Optional[int] = None,
            backoff_base: Optional[float] = None,
            backoff_cap: Optional[float] = None,
            connect_retries: int = 1) -> int:
        """Work until the master says done; returns the jobs done.

        A timeout or an undecodable reply drops the socket, backs off
        (``backoff_base`` doubling to ``backoff_cap``, jittered per
        slave) and registers again on a fresh one; a pending update
        survives and is re-sent (the master drops it as stale if the job
        was re-queued).  ``max_reconnects`` consecutive failures end the
        run; ``connect_retries`` bounds only the first contact, so a
        slave pointed at nothing fails fast with ``ConnectionError``.
        Defaults: ``slave_reconnects``, ``slave_backoff_base``,
        ``slave_backoff_cap``."""
        from znicz_torch.core.config import check_engine_knobs
        from znicz_torch.network_common import handshake_request
        from znicz_torch.parallel import wire

        check_engine_knobs()
        eng = root.common.engine
        if max_reconnects is None:
            max_reconnects = int(eng.get("slave_reconnects", 8))
        if backoff_base is None:
            backoff_base = float(eng.get("slave_backoff_base", 0.25))
        if backoff_cap is None:
            backoff_cap = float(eng.get("slave_backoff_cap", 5.0))
        breaker_failures = int(eng.get("slave_breaker_failures", 4))
        self.wire_dtype = wire.canonical_wire_dtype(
            eng.get("wire_dtype", "float32"))
        self._delta_encoder = wire.DeltaEncoder(self.wire_dtype)
        prefetch_on = bool(eng.get("job_prefetch", True))

        def brk_event(name: str) -> None:
            counter = {"open": "breaker_opens",
                       "short_circuit": "breaker_short_circuits"}.get(name)
            if counter is not None:
                self._inc(counter)

        # one breaker for both sockets; consecutive failures open it, so
        # a survivable fault rate keeps training
        self._breaker = CircuitBreaker(
            window=max(2 * breaker_failures, 1),
            threshold=breaker_failures, on_event=brk_event,
            backoff=RetryPolicy(backoff_base, backoff_cap, jitter=False),
            peer=self.endpoint, consecutive=True)

        def make_endpoint() -> Endpoint:
            return Endpoint(
                self.endpoint, recv_timeout_s=recv_timeout,
                retry=RetryPolicy.for_training_client(
                    backoff_base, backoff_cap, max_reconnects,
                    jitter_key=f"{self.slave_id}/backoff"),
                breaker=self._breaker)

        ep = make_endpoint()
        registered = False
        ever_registered = False
        failures = 0                    # consecutive transport failures
        refusals = 0                    # consecutive bad_frame replies
        refusal_cap = max(3, max_reconnects)
        update_frames: Optional[list] = None
        prefetcher: Optional[_JobPrefetcher] = None

        def refused() -> bool:
            """A bad_frame reply: the master lives but never decoded our
            frame.  Retry, bounded; True when the cap is spent."""
            nonlocal refusals
            refusals += 1
            if refusals <= refusal_cap:
                time.sleep(poll_sleep)
                return False
            if not ever_registered:
                raise RuntimeError(
                    f"master at {self.endpoint} refused {refusals} "
                    "consecutive frames (bad_frame) — giving up")
            log.warning("%s: master refused %d consecutive frames — "
                        "giving up", self.slave_id, refusals)
            return True

        def retire_prefetcher() -> None:
            """Stop the prefetcher, whose socket dials the endpoint being
            left; the next real job starts a new one."""
            nonlocal prefetcher
            if prefetcher is not None:
                prefetcher.stop()
                prefetcher = None

        def reconnect(exc) -> bool:
            """Backoff before a fresh socket; False when the budget is
            spent and there is no fallback to switch to."""
            nonlocal registered, failures
            if isinstance(exc, BadReply):
                self._inc("bad_replies")
            failures += 1
            if not ever_registered:
                if failures >= connect_retries:
                    raise ConnectionError(
                        f"no master answered at {self.endpoint} within "
                        f"{recv_timeout:g}s — is the master running "
                        f"(python -m znicz_torch <sample> --master)?") \
                        from None
            elif failures > max_reconnects:
                fallback = self._fallback_endpoint
                if not fallback or fallback == self.endpoint:
                    log.warning("%s: giving up after %d consecutive "
                                "reconnects (master gone for good?)",
                                self.slave_id, failures - 1)
                    return False
                # the relay is gone: its advertised upstream, one hop a
                # spent budget; the next register records that peer's
                # advertisement
                log.warning("%s: relay at %s gone after %d consecutive "
                            "reconnects — falling back to its upstream %s",
                            self.slave_id, self.endpoint, failures - 1,
                            fallback)
                self.endpoint = ep.endpoint = fallback
                self._fallback_endpoint = None
                retire_prefetcher()
                failures = 1
            self._inc("reconnects")
            registered = False
            ep.backoff(failures)
            return True

        def short_circuit() -> None:
            """The breaker refused locally: pace on its probe window
            without spending the reconnect budget."""
            ep.breaker_wait(cap_s=backoff_cap)

        try:
            while True:
                if self._preempt.is_set():
                    break
                if not registered:
                    try:
                        rep = self._rpc(ep, handshake_request(
                            self.workflow, mesh=self.mesh_shape))
                    except CircuitOpenError:
                        short_circuit()
                        continue
                    except (PeerTimeout, BadReply) as exc:
                        if not reconnect(exc):
                            break
                        continue
                    failures = 0
                    if rep.get("bad_frame"):
                        if refused():
                            break
                        continue
                    refusals = 0
                    if not rep.get("ok"):
                        raise RuntimeError(f"master refused registration: "
                                           f"{rep.get('error')}")
                    self._fallback_endpoint = rep.get("upstream")
                    registered = ever_registered = True
                    rehome = rep.get("rehome")
                    if rehome and rehome != self.endpoint:
                        # the master re-homed this orphan behind a live
                        # relay; the endpoint left is the fallback, so a
                        # dead target costs one more backoff window
                        log.info("%s: master re-homed us to %s",
                                 self.slave_id, rehome)
                        self._fallback_endpoint = self.endpoint
                        self.endpoint = rehome
                        registered = False
                        ep.reset()
                        ep.endpoint = rehome
                        retire_prefetcher()
                    continue
                if update_frames is not None:
                    try:
                        rep = ep.rpc(update_frames)
                    except CircuitOpenError:
                        short_circuit()
                        continue
                    except (PeerTimeout, BadReply) as exc:
                        if not reconnect(exc):
                            break
                        continue        # register again, then re-send
                    failures = 0
                    if rep.get("bad_frame"):
                        if refused():
                            break
                        continue
                    refusals = 0
                    if rep.get("unregistered"):
                        registered = False
                        continue
                    if rep.get("quarantined"):
                        log.warning("%s: master quarantined our delta: %s",
                                    self.slave_id, rep.get("error"))
                    if rep.get("stale_refused"):
                        log.info("%s: master refused our delta as stale: "
                                 "%s", self.slave_id, rep.get("error"))
                    update_frames = None
                    self._inc("jobs_done")
                    continue
                # the next job: the prefetcher's fetch first
                rep = None
                if prefetcher is not None:
                    rep = prefetcher.take()
                    if rep is not None:
                        failures = 0
                        if "job" in rep:
                            self._inc("prefetch_hits")
                if rep is None:
                    try:
                        rep = self._rpc(ep, {"cmd": "job"})
                        rep["_received_at"] = time.monotonic()
                    except CircuitOpenError:
                        short_circuit()
                        continue
                    except (PeerTimeout, BadReply) as exc:
                        if not reconnect(exc):
                            break
                        continue
                    failures = 0
                if rep.get("bad_frame"):
                    if refused():
                        break
                    continue
                refusals = 0
                if rep.get("done"):
                    break
                if rep.get("unregistered"):
                    registered = False
                    continue
                if "job" not in rep:
                    time.sleep(poll_sleep)
                    continue
                job, params = rep["job"], rep["params"]
                if prefetch_on and prefetcher is None:
                    # started at the first real job: a refused run spawns
                    # no thread
                    prefetcher = _JobPrefetcher(self, make_endpoint,
                                                recv_timeout)
                if prefetcher is not None:
                    prefetcher.request()
                deadline = local_deadline(rep.get("deadline_ms"),
                                          now=rep.get("_received_at"))
                if deadline is not None and time.monotonic() > deadline:
                    self._inc("jobs_expired")
                    log.info("%s: job %s expired before compute (budget "
                             "%.0fms) — dropped, master re-queues it",
                             self.slave_id, rep.get("job_id"),
                             rep.get("deadline_ms"))
                    continue
                self._apply_params(params)
                before = {name: {k: np.asarray(v, np.float32)
                                 for k, v in layer.items()}
                          for name, layer in params.items()}
                train = bool(rep.get("train"))
                t0 = time.perf_counter()
                # a span correlated to the master's job by trace_id
                with self._tracer.span(
                        "slave", "job", job_id=rep.get("job_id"),
                        trace_id=rep.get("trace_id"), train=train):
                    metrics = self._run_minibatch(job, train)
                    deltas = self._deltas_since(before) if train else None
                self.job_seconds.append(time.perf_counter() - t0)
                update_frames, _ = wire.encode_message(
                    {"cmd": "update", "id": self.slave_id,
                     "job_id": rep["job_id"],
                     "trace_id": rep.get("trace_id"),
                     "step": rep.get("step"),
                     "deltas": self._delta_encoder.encode(deltas),
                     "metrics": metrics,
                     **self._obs_payload()})
        finally:
            if prefetcher is not None:
                prefetcher.stop()
            ep.close()
        return self.jobs_done


class FusedStagingUnsupportedError(FusedUnsupportedError):
    """A ``FusedClient`` needs a device-resident loader."""


class FusedClient(Client):
    """A slave that runs its jobs on ``FusedTrainer``: a segment job's k
    minibatches are k steps of one segment on the local device (captured
    graphs on the card), with one host-to-device copy of the master's
    parameters and one copy of the deltas back.  The protocol is the
    unit slave's; the slave's velocities persist across jobs, as the
    unit slave's GD units' do.  Slaves of one process take the device in
    turns (:attr:`TURNS`): their steps warm up and capture on the one
    capture stream a device has (``parallel/graphs.capture_stream``),
    which holds one capture at a time.

    Under ``root.common.engine.train_shard`` the trainer runs on
    ``parallel.mesh.train_mesh_from_config()``, and the slave is a group
    of ranks: every rank builds its workflow and a ``FusedClient`` and
    calls :meth:`run` (module docstring)."""

    #: held while a job's steps run
    TURNS = threading.Lock()

    def __init__(self, workflow, endpoint: str = "tcp://127.0.0.1:5570",
                 slave_id: Optional[str] = None):
        super().__init__(workflow, endpoint=endpoint, slave_id=slave_id)
        from znicz_torch.parallel.fused import FusedTrainer
        from znicz_torch.parallel.mesh import train_mesh_from_config

        # built now, so a graph the fused trainer refuses raises here,
        # where the caller can take the unit Client
        self._trainer = FusedTrainer(workflow, mesh=train_mesh_from_config())
        if self._trainer.staging:
            raise FusedStagingUnsupportedError(
                "FusedClient needs a device-resident loader (host-staged "
                "streaming slaves are not supported)")
        #: rank 0 of a mesh: the job's parameters until they are broadcast
        self._mesh_params: Optional[Dict] = None
        #: the ranks left together after a failed job (no stop to send)
        self._left = False
        #: a meshed slave's host seconds a job: the parameters' broadcast,
        #: and (train jobs) the gather of the split leaves
        self.mesh_seconds: Dict[str, List[float]] = {"broadcast": [],
                                                     "gather": []}

    def engine_name(self) -> str:
        return "fused"

    @property
    def mesh_shape(self):
        return self._trainer.mesh_shape

    @property
    def rank(self) -> int:
        """This process's rank in the slave's group (0 off a mesh)."""
        from znicz_torch.parallel.mesh import process_index

        return 0 if self._trainer.mesh is None else process_index()

    def run(self, *args, **kwargs) -> int:
        """:meth:`Client.run`.  On a mesh, rank 0 runs it and the other
        ranks follow rank 0's jobs until it stops; they return the jobs
        they stepped.  When rank 0's run ends, or raises, every rank
        leaves (a rank 0 failure raises on every rank)."""
        if self._trainer.mesh is None:
            return super().run(*args, **kwargs)
        if self.rank != 0:
            return self._follow()
        try:
            done = super().run(*args, **kwargs)
        except BaseException as exc:
            self._release(exc)
            raise
        self._release(None)
        return done

    # -- the meshed slave ----------------------------------------------------------

    def _release(self, error: Optional[BaseException]) -> None:
        """Rank 0: tell the other ranks to leave (with rank 0's error)."""
        from znicz_torch.parallel.mesh import agree

        if not self._left:
            self._left = True
            agree(("stop", None if error is None else repr(error)))

    def _follow(self) -> int:
        """A rank other than 0: step on rank 0's jobs until it stops."""
        from znicz_torch.parallel.mesh import agree

        while True:
            head = agree(None)
            if head[0] == "stop":
                if head[1] is not None:
                    raise RuntimeError(f"rank 0 of the meshed slave failed: "
                                       f"{head[1]}")
                return self.jobs_done
            _, job, train = head
            self._mesh_job(job, train, None)
            if train:
                self._whole_params()
            self._inc("jobs_done")

    def _leaves(self) -> list:
        """(module, key, whole shape) of every parameter leaf, in order."""
        from znicz_torch.network_common import whole_shape
        from znicz_torch.nn_units import params_of

        return [(f, k, whole_shape(f, k, t))
                for f in self.workflow.forwards if f.has_weights
                for k, t in params_of(f).items()]

    def _mesh_job(self, job: dict, train: bool, params: Optional[Dict]):
        """Every rank: rank 0's ``params`` (None elsewhere) broadcast as
        one float32 buffer, this rank's part of each leaf written to its
        module, the job's steps on this rank's rows; a failure on any rank
        raises on every rank (``mesh.raise_anywhere``)."""
        import torch.distributed as dist

        from znicz_torch.nn_units import params_of
        from znicz_torch.parallel import mesh as mesh_mod

        leaves = self._leaves()
        t0 = time.perf_counter()
        # gloo broadcasts host tensors; NCCL device ones
        dev = ("cpu" if dist.get_backend() == "gloo"
               else self._trainer.device)
        if params is not None:
            flat = torch.from_numpy(np.concatenate(
                [np.asarray(params[f.name][k], np.float32).ravel()
                 for f, k, _ in leaves])).to(dev)
        else:
            flat = torch.empty(sum(int(np.prod(s)) for _, _, s in leaves),
                               dtype=torch.float32, device=dev)
        mesh_mod._collective(lambda: dist.broadcast(flat, 0), flat, None)
        self.mesh_seconds["broadcast"].append(time.perf_counter() - t0)
        error, out = None, None
        try:
            off = 0
            with torch.no_grad():
                for f, k, shape in leaves:
                    n = int(np.prod(shape))
                    whole = flat[off:off + n].view(shape)
                    off += n
                    place = mesh_mod.placement_of(f)
                    part = whole if place is None else place.local(k, whole)
                    t = params_of(f)[k]
                    t.copy_(part.to(t.device, t.dtype))
            del flat
            with self.TURNS:
                out = self._run_job(job, train)
        except BaseException as exc:
            error = exc
        try:
            mesh_mod.raise_anywhere(error, "a meshed slave's job")
        except BaseException:
            self._left = True           # every rank raises: none waits
            raise
        return out

    def _whole_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every rank: the live parameters with each column-sharded leaf
        gathered whole over ``model`` (``snapshotter._whole``'s rule; a
        collective on each model line)."""
        from znicz_torch.nn_units import params_of
        from znicz_torch.parallel import mesh as mesh_mod

        t0 = time.perf_counter()
        out = {}
        for f in self.workflow.forwards:
            if not f.has_weights:
                continue
            place = mesh_mod.placement_of(f)
            out[f.name] = {k: t.detach() if place is None
                           else place.full(k, t.detach())
                           for k, t in params_of(f).items()}
        self.mesh_seconds["gather"].append(time.perf_counter() - t0)
        return out

    # -- the job -------------------------------------------------------------------

    def _apply_params(self, params: Dict) -> None:
        if self._trainer.mesh is None:
            super()._apply_params(params)
        else:
            self._mesh_params = params      # broadcast with the job

    def _deltas_since(self, before: Dict) -> Dict:
        if self._trainer.mesh is None:
            return super()._deltas_since(before)
        return {name: {k: t.float().cpu().numpy() - before[name][k]
                       for k, t in leaves.items()}
                for name, leaves in self._whole_params().items()}

    def _run_minibatch(self, job: dict, train: bool):
        if self._trainer.mesh is None:
            with self.TURNS:
                return self._run_job(job, train)
        from znicz_torch.parallel.mesh import agree

        agree(("job", job, bool(train)))
        params, self._mesh_params = self._mesh_params, None
        return self._mesh_job(job, train, params)

    def _run_job(self, job: dict, train: bool):
        t = self._trainer
        mbs = job["minibatches"] if "minibatches" in job else [job]
        k = len(mbs)
        sizes = [int(mb["size"]) for mb in mbs]
        t._init_velocities()
        inputs = t._resident_inputs(
            [{"idx": np.asarray(mb["indices"], np.int64)} for mb in mbs])
        if not train:
            losses, n_errs, conf = t._segment("eval", inputs, sizes)
        else:
            rows = (scheduled_hypers_rows(t.hypers(), mbs)
                    if any("hypers" in mb for mb in mbs)
                    else t.tiled_hypers(k))
            losses, n_errs, conf = t._segment(
                "train", inputs, sizes, step0=t.steps_done,
                hyp_rows=t._hyper_matrix(rows))
            t.steps_done += k
            t.stats["train_steps"] += k
        # a rank's metrics are its rows' (no-op off a mesh)
        losses, n_errs, conf = t._sum_over_data(losses, n_errs, conf)
        vals = torch.stack([losses.double(), n_errs.double()]).cpu().numpy()
        conf = conf.cpu().numpy() if conf is not None else None
        metrics = []
        for i in range(k):
            m = {"loss": float(vals[0, i])}
            if t.loss_kind == "softmax":
                m["n_err"] = int(vals[1, i])
                if i == 0 and t.compute_confusion and conf is not None \
                        and conf.size > 1:
                    # the segment's summed confusion rides the first
                    # minibatch (the Decision skips None)
                    m["confusion"] = conf
            metrics.append(m)
        return metrics if "minibatches" in job else metrics[0]


for _name, _help in Client.COUNTERS.items():
    setattr(Client, _name, registered_property(_name, _help))
del _name, _help
