"""The master of the asynchronous parameter server (port of the star of
``znicz_tpu/server.py``).

The reference keeps veles' only distribution strategy beside its SPMD
path: an **asynchronous master/slave parameter server over ZeroMQ** for
fleets that cannot join a mesh.

  - slaves REQ jobs; the master REPs minibatch index assignments and the
    current parameters (``generate_data_for_slave`` of each weighted
    module).  Each slave owns a copy of the dataset;
  - slaves push back weight DELTAS and the evaluator's metrics; the
    master applies them as they arrive, with no barrier;
  - membership is elastic: a lost job is re-queued after the job
    timeout, a silent slave is evicted after ``slave_ttl``.

The REP socket speaks wire v3 (``parallel/wire.py``): one pickled
metadata frame and one zero-copy buffer frame a tensor, bf16/int8 deltas
decoded here (quarantine inspects the real deltas), and the params
broadcast optionally compressed (``root.common.engine.wire_compress``).
A peer that still frames v2 gets its reply, the protocol refusal
included, in v2 framing.  Only the metadata frame is pickle (a trusted
cluster, as the reference's wire).

The master's job stream is the reference's:

  - **segments** (``job_segment``): up to that many consecutive non-tail
    TRAIN minibatches make one job, which a ``FusedClient`` runs as one
    segment; eval and epoch-tail jobs stay single;
  - **epoch boundaries are ordered**: the tail is issued once every other
    job of its epoch is back, and the next epoch starts after the tail's
    update is in;
  - **the reaper** re-queues a job in flight past the adaptive timeout
    (``job_timeout_mult`` x the median round trip, capped by
    ``job_timeout``), and **TTL eviction** drops silent slaves;
  - **quarantine**: a delta with a non-finite value, a wrong shape or an
    L2 norm beyond ``quarantine_norm_mult`` x the running median is
    refused and its job re-queued, at most ``MAX_BAD_REPLIES`` times for
    a non-tail job;
  - **staleness**: each job carries the apply counter (``step``); a delta
    more than ``staleness_bound`` applies old is refused and re-queued,
    and ``staleness_weight`` scales a late one by ``1 / (1 + s)``;
  - **the quorum** (``min_slaves``): below it dispatch pauses and job
    requests get ``wait``;
  - **ingress admission**: a slave past ``ingress_rate_limit`` job
    requests a second is answered ``wait``; updates are always taken;
  - **deadlines** (``job_deadline``): every job carries its reap window
    as a ``deadline_ms`` budget, and slaves drop expired jobs uncomputed;
  - **LR schedules**: a workflow's ``lr_adjust`` bindings are evaluated
    at dispatch, and each TRAIN minibatch carries its (lr, lr_bias);
  - **crash-resume** (``resume_path``, ``master_snapshot_s``): the whole
    training state, outstanding jobs included, written periodically and
    restored by a Server built while the file exists.

Deliberate differences from the reference:

  - the counters (``COUNTERS``, the reference's names and help) are
    plain integers under the server's lock, read and written through
    properties of the same names; there is no telemetry registry,
    staleness histograms are bounded windows, and the training SLO is
    left out (its ``obs_slo_*`` knobs wait for ROADMAP A.9);
  - each ``telemetry.emit`` is a ``logging`` record under the same event
    name (logger ``znicz_torch.master``);
  - the default bind is ``tcp://127.0.0.1:*``: the port is chosen when
    the socket binds, and :attr:`Server.endpoint` is the resolved
    address once :meth:`Server.start` returns.

The relay tree (``parallel/relay.py``) rides the same protocol: a relay
registers as one member marked ``relay``, reports its subtree's live
leaves on each job request (the quorum counts them), fetches ``count``
jobs under one params broadcast, and sends one aggregated update a flush
(:meth:`Server._handle_aggregated`), whose manifest keeps the books per
leaf.  A relay joining or evicted re-plans the tree (:attr:`tree_plan`);
with ``elastic_rehome`` a leaf that registers here while live relays
exist is handed one of their endpoints (``rehome``).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from znicz_torch.core.config import root
from znicz_torch.loader.base import TRAIN

log = logging.getLogger("znicz_torch.master")

#: staleness observations kept a leaf
STALE_WINDOW = 256


def _engine(key: str, default, override=None):
    if override is not None:
        return override
    return root.common.engine.get(key, default)


def _codec_counter(name: str, doc: str) -> property:
    """A Server attribute kept by its ``wire.Codec``, readable and
    writable under the reference's name (a resume restores it)."""

    def fget(self):
        return getattr(self.codec, name)

    def fset(self, value):
        setattr(self.codec, name, value)

    return property(fget, fset, doc=doc)


class Server:
    """Drive with :meth:`serve` (blocks until the Decision completes and
    the linger ends) or :meth:`start` (serves on a thread and returns once
    bound).  The workflow needs ``loader``, ``forwards`` and ``decision``
    (a ``StandardWorkflow`` or a sample's graph)."""

    #: master counters: name -> meaning (the reference's)
    COUNTERS = {
        "jobs_done": "jobs completed",
        "jobs_requeued": "lost/refused jobs re-queued",
        "stale_updates": "updates dropped: job already reaped/finished",
        "bad_updates": "malformed replies refused+requeued",
        "quarantined_updates": "non-finite / norm-exploded deltas refused",
        "reregistrations": "re-registers (slave reconnects)",
        "resume_saves": "crash-resume snapshots written",
        "updates_received": "update messages seen (any outcome)",
        "update_bytes_in": "wire bytes of update messages",
        "prefetch_hit": "jobs served to prefetch requests",
        "aggregated_updates": "pre-aggregated relay updates accepted",
        "stale_refused": "deltas refused: staleness beyond the bound",
        "weighted_applies": "applies scaled down by staleness",
        "replans": "runtime tree re-plans (relay membership changes)",
        "preemptions_ridden": "members lost mid-run and ridden out",
        "rate_limited_ingress": "job requests answered wait: per-slave "
                                "ingress rate limit",
    }

    #: malformed replies tolerated a job before a non-tail one is dropped
    #: instead of re-queued
    MAX_BAD_REPLIES = 3

    #: reply sentinel: no job right now (an epoch boundary), ask again
    _WAIT = {"wait": True}

    def __init__(self, workflow, endpoint: str = "tcp://127.0.0.1:*",
                 job_timeout: float = 30.0,
                 segment_steps: Optional[int] = None,
                 resume_path: str = "",
                 snapshot_every_s: Optional[float] = None,
                 slave_ttl: Optional[float] = None,
                 min_slaves: Optional[int] = None,
                 staleness_bound: Optional[int] = None,
                 staleness_weight: Optional[bool] = None,
                 elastic_rehome: Optional[bool] = None):
        import uuid

        from znicz_torch.core.config import check_engine_knobs
        from znicz_torch.lr_adjust import LearningRateAdjust
        from znicz_torch.parallel import wire
        from znicz_torch.transport import AdmissionTable

        check_engine_knobs()
        self.workflow = workflow
        self.endpoint = endpoint
        #: the bind asked for (``endpoint`` is resolved when it binds)
        self.bind = endpoint
        self.job_timeout = float(job_timeout)
        #: > 1: a TRAIN job is a segment of up to this many non-tail
        #: minibatches
        self.segment_steps = int(_engine("job_segment", 1, segment_steps))
        self.loader = workflow.loader
        self.decision = workflow.decision
        self.slaves: Dict[str, float] = {}          # id -> last seen
        self.registered: set = set()                # handshake-passed ids
        self.dead_slaves: Dict[str, float] = {}     # evicted id -> last seen
        self._ever_registered: set = set()
        #: ids that registered with ``relay: True``: members that are
        #: relays of the aggregation tree, not leaves
        self.relays: set = set()
        #: meshed slaves' advertised {"data": dp, "model": mp}
        self.slave_meshes: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = dict.fromkeys(self.COUNTERS, 0)
        self._quorum_degraded = False
        #: tags job trace ids, so two masters' ids never collide
        self._run_tag = uuid.uuid4().hex[:6]
        #: compression of the params broadcast ("none"/"zlib"/"lz4");
        #: deltas are quantized by the slaves (``wire_dtype``)
        self.wire_compress = str(_engine("wire_compress", "none"))
        self.codec = wire.Codec(compress=self.wire_compress, owner="master")
        self.jobs_by_slave: Dict[str, int] = {}
        self._pending: List[dict] = []              # re-queued lost jobs
        self._inflight: Dict[int, tuple] = {}       # job_id -> (job, t, sid)
        self._job_seq = 0
        self._hold = None                           # a held-back minibatch
        self._socket = None
        self._transport = None
        #: a FaultSchedule for the transport loop's ingress hook
        self.transport_chaos = None
        self._stop = False
        self._ready = threading.Event()
        self._serve_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        #: silent-slave eviction window (s; <= 0 disables)
        self.slave_ttl = float(_engine("slave_ttl", 60.0, slave_ttl))
        #: observed job round trips: with 5 or more the reap timeout adapts
        self._durations: collections.deque = collections.deque(maxlen=64)
        self.job_timeout_mult = float(_engine("job_timeout_mult", 8.0))
        #: recent accepted-delta L2 norms (the quarantine's median)
        self._delta_norms: collections.deque = collections.deque(maxlen=64)
        self.quarantine_norm_mult = float(
            _engine("quarantine_norm_mult", 25.0))
        self._param_shapes = None
        #: below this many live members dispatch pauses (0: no gate)
        self.min_slaves = int(_engine("min_slaves", 0, min_slaves))
        #: a delta more than this many applies old is refused (0: any)
        self.staleness_bound = int(_engine("staleness_bound", 0,
                                           staleness_bound))
        #: scale a late delta by 1 / (1 + s)
        self.staleness_weight = bool(_engine("staleness_weight", False,
                                             staleness_weight))
        #: hand a leaf that registers here while live relays exist a
        #: relay's endpoint (``rehome``): an orphan goes back under the tree
        self.elastic_rehome = bool(_engine("elastic_rehome", False,
                                           elastic_rehome))
        #: the apply counter, the staleness clock
        self._apply_step = 0
        #: per-slave job-request admission (0: off)
        self._ingress = AdmissionTable(
            rate=float(_engine("ingress_rate_limit", 0.0)),
            burst=float(_engine("ingress_rate_burst", 0.0)))
        #: stamp every job with its reap window as a deadline budget
        self.job_deadline = bool(_engine("job_deadline", True))
        #: relay id -> the subtree leaves it last reported (``leaves``)
        self._relay_leaves: Dict[str, int] = {}
        #: relay id -> the endpoint it serves its children at
        self.relay_binds: Dict[str, str] = {}
        self._tree_plan: Optional[dict] = None
        self._rehome_rr = 0
        #: per-leaf staleness observations: sid -> {"count", "window"}
        self._stale_hist: Dict[str, dict] = {}
        # LR schedules: the master owns the train-iteration clock
        self._lr_bindings = []
        for u in workflow:
            if isinstance(u, LearningRateAdjust):
                self._lr_bindings.extend(u._bindings)
        self._lr_iteration = 0          # TRAIN minibatches dispatched
        #: crash-resume: serve() writes the training state here every
        #: snapshot_every_s; a Server built while it exists restores it
        self.resume_path = str(resume_path or "")
        self.snapshot_every_s = float(_engine("master_snapshot_s", 10.0,
                                              snapshot_every_s))
        self._last_resume_save = 0.0
        self.resumed = False
        if self.resume_path and os.path.exists(self.resume_path):
            self.restore_resume(self.resume_path)

    # -- counters --------------------------------------------------------------

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    bytes_in = _codec_counter("bytes_in", "wire bytes received (all frames)")
    bytes_out = _codec_counter("bytes_out", "wire bytes sent (all frames)")
    bad_frames = _codec_counter("bad_frames",
                                "undecodable/garbage frames refused")
    tensor_bytes_raw_in = _codec_counter(
        "tensor_bytes_raw_in", "f32-equivalent tensor bytes received")
    tensor_bytes_wire_in = _codec_counter(
        "tensor_bytes_wire_in", "actual tensor bytes received")
    tensor_bytes_raw_out = _codec_counter(
        "tensor_bytes_raw_out", "f32-equivalent tensor bytes sent")
    tensor_bytes_wire_out = _codec_counter(
        "tensor_bytes_wire_out", "actual tensor bytes sent")

    # -- params <-> payloads ---------------------------------------------------

    def _trainables(self):
        return [f for f in self.workflow.forwards if f.has_weights]

    def snapshot_params(self) -> Dict:
        return {f.name: f.generate_data_for_slave()
                for f in self._trainables()}

    def apply_deltas(self, deltas: Dict, scale: float = 1.0) -> None:
        """Land a delta set on the global parameters in float32 and
        advance the apply counter; ``scale`` < 1 is the staleness-weighted
        apply."""
        from znicz_torch.nn_units import params_of

        with torch.no_grad():
            for f in self._trainables():
                d = deltas.get(f.name)
                if not d:
                    continue
                for k, t in params_of(f).items():
                    if k not in d:
                        continue
                    a = np.array(d[k], np.float32)
                    if scale != 1.0:
                        a *= np.float32(scale)
                    t.add_(torch.from_numpy(a).to(t.device, t.dtype))
        self._apply_step += 1

    # -- wire accounting -------------------------------------------------------

    def compression_ratio(self, direction: str = "both") -> Optional[float]:
        """float32-equivalent tensor bytes over the bytes on the wire
        (``"in"``, ``"out"`` or ``"both"``); None before any traffic."""
        return self.codec.compression_ratio(direction)

    def bytes_per_update(self) -> Optional[float]:
        """Mean wire bytes of one update message; None before the
        first."""
        if not self.updates_received:
            return None
        return self.update_bytes_in / self.updates_received

    # -- job management --------------------------------------------------------

    def effective_job_timeout(self) -> float:
        """The reap timeout: ``job_timeout`` until 5 round trips were
        seen, then ``job_timeout_mult`` x their median + 1 s, within
        [0.5, job_timeout]."""
        durations = list(self._durations)
        if len(durations) < 5:
            return self.job_timeout
        adaptive = self.job_timeout_mult * float(np.median(durations)) + 1.0
        return min(self.job_timeout, max(adaptive, 0.5))

    def _reap_lost_jobs(self) -> None:
        now = time.time()
        timeout = self.effective_job_timeout()
        lost = [jid for jid, (_, t, _) in self._inflight.items()
                if now - t > timeout]
        for jid in lost:
            job, _, _ = self._inflight.pop(jid)
            self._pending.append(job)
            self._inc("jobs_requeued")

    def _evict_dead_slaves(self) -> None:
        """A slave silent past ``slave_ttl`` moves to ``dead_slaves`` (its
        ``jobs_by_slave`` history stays) and must re-register; its jobs
        come back through the reaper."""
        if self.slave_ttl <= 0:
            return
        now = time.time()
        for sid in [s for s, seen in self.slaves.items()
                    if now - seen > self.slave_ttl]:
            self.dead_slaves[sid] = self.slaves.pop(sid)
            self.registered.discard(sid)
            self.slave_meshes.pop(sid, None)
            if not bool(self.decision.complete):
                self._inc("preemptions_ridden")
                log.info("preemption: slave=%s ttl_s=%s members=%d", sid,
                         self.slave_ttl, self.member_count())
            if sid in self.relays:
                # a relay's eviction changes the tree: re-plan, so that
                # rehome targets drop the dead subtree at once
                self._relay_leaves.pop(sid, None)
                self._replan(f"relay {sid} evicted")
            log.info("slave %s evicted (silent for %.0fs)", sid,
                     self.slave_ttl)

    def _quarantine_reason(self, deltas: Dict,
                           n_contrib: int = 1) -> Optional[str]:
        """Why a delta payload must never touch the parameters: a leaf of
        the wrong shape, a non-finite value, or an L2 norm (per
        contributor) beyond ``quarantine_norm_mult`` x the running median
        of accepted norms (once 5 are known).  Accepted norms feed the
        median.  Never raises: a payload too broken to inspect is itself
        the reason."""
        from znicz_torch.nn_units import params_of

        try:
            if self._param_shapes is None:
                self._param_shapes = {
                    f.name: {k: tuple(t.shape)
                             for k, t in params_of(f).items()}
                    for f in self._trainables()}
            shapes = self._param_shapes
            total = 0.0
            for name, layer in deltas.items():
                for k, arr in (layer or {}).items():
                    a = np.asarray(arr, np.float64)
                    want = shapes.get(name, {}).get(k)
                    if want is not None and tuple(a.shape) != want:
                        return (f"shape {tuple(a.shape)} != {want} "
                                f"for {name}.{k}")
                    if not np.all(np.isfinite(a)):
                        return "non-finite values"
                    total += float(np.dot(a.ravel(), a.ravel()))
        except Exception as exc:
            return f"undecodable delta payload: {exc!r}"
        norm = float(np.sqrt(total)) / max(1, int(n_contrib))
        if len(self._delta_norms) >= 5:
            med = float(np.median(self._delta_norms))
            if med > 0.0 and norm > self.quarantine_norm_mult * med:
                return (f"norm {norm:.3g} > {self.quarantine_norm_mult:g} "
                        f"x median {med:.3g}")
        self._delta_norms.append(norm)
        return None

    # -- elastic async training ------------------------------------------------

    @property
    def apply_step(self) -> int:
        """The apply counter, the clock job stamps count in."""
        return self._apply_step

    def _staleness(self, step, sid: str) -> int:
        """Applies since the job's stamp (0 for a peer that echoes none),
        observed into the leaf's window.  Never raises: it runs after the
        job left ``_inflight``."""
        if step is None:
            return 0
        try:
            s = max(0, self._apply_step - int(step))
        except (TypeError, ValueError):
            return 0
        hist = self._stale_hist.setdefault(
            sid, {"count": 0,
                  "window": collections.deque(maxlen=STALE_WINDOW)})
        hist["count"] += 1
        hist["window"].append(s)
        return s

    def _stale_scale(self, s) -> float:
        """The staleness-weighted factor ``1 / (1 + s)``; 1.0 when
        weighting is off or the delta is fresh."""
        if not self.staleness_weight:
            return 1.0
        w = 1.0 / (1.0 + max(0.0, float(s)))
        if w < 1.0:
            self._inc("weighted_applies")
        return w

    def _refuse_stale(self, job: dict, sid: str, s) -> dict:
        """A delta beyond ``staleness_bound`` never lands: counted, and
        the job re-queued without a bad-reply strike, on a budget of its
        own (``MAX_BAD_REPLIES`` stale refusals drop a non-tail job)."""
        self._inc("stale_refused")
        job["_stale_refusals"] = job.get("_stale_refusals", 0) + 1
        requeue = (bool(job.get("last_minibatch"))
                   or job["_stale_refusals"] < self.MAX_BAD_REPLIES)
        log.info("slave %s: delta staleness %s > bound %d — refused and %s",
                 sid, s, self.staleness_bound,
                 "re-queued" if requeue else
                 "DROPPED (repeated stale refusals)")
        if requeue:
            self._pending.append(job)
        return {"ok": False, "stale_refused": True, "staleness": int(s),
                "error": f"delta staleness {s} exceeds the "
                         f"{self.staleness_bound}-apply bound"}

    def staleness_summary(self) -> Dict[str, dict]:
        """Per leaf: observations, p50 and max over the recent window."""
        out = {}
        for sid, h in sorted(dict(self._stale_hist).items()):
            data = np.asarray(h["window"])
            if data.size:
                out[sid] = {"count": int(h["count"]),
                            "p50": float(np.median(data)),
                            "max": int(data.max())}
        return out

    def member_count(self) -> int:
        """Live training members, the quorum's count: the direct slaves
        seen within their TTL that are not relays, plus the leaves each
        live relay last reported on a job request (``leaves``)."""
        slaves = dict(self.slaves)
        n = sum(1 for sid in slaves if sid not in self.relays)
        n += sum(int(self._relay_leaves.get(sid, 0))
                 for sid in slaves if sid in self.relays)
        return n

    def quorum_met(self) -> bool:
        return self.min_slaves <= 0 or self.member_count() >= \
            self.min_slaves

    def degraded(self) -> bool:
        """True while the fleet sits below the quorum mid-run."""
        return not self.quorum_met() and not bool(self.decision.complete)

    def _note_quorum(self) -> None:
        """Log the quorum's transitions, once an episode."""
        if self.min_slaves <= 0:
            return
        deg = self.degraded()
        if deg == self._quorum_degraded:
            return
        log.info("%s: members=%d min_slaves=%d",
                 "quorum_degraded" if deg else "quorum_restored",
                 self.member_count(), self.min_slaves)
        self._quorum_degraded = deg

    # -- the aggregation tree --------------------------------------------------

    def _replan(self, why: str) -> None:
        """Recompute the master's view of the tree (the live relays, their
        endpoints and reported leaves) when relay membership changes: a
        relay joins, or TTL eviction removes one.  Orphaned children
        re-home through the register path and lost jobs come back through
        the reaper, so a re-plan never loses or double-applies work."""
        slaves = dict(self.slaves)
        live = [{"id": sid, "bind": self.relay_binds.get(sid),
                 "leaves": int(self._relay_leaves.get(sid, 0))}
                for sid in sorted(slaves) if sid in self.relays]
        self._tree_plan = {"relays": live, "reason": why,
                           "members": self.member_count()}
        self._inc("replans")
        log.info("replan: tree re-planned (%s): %d live relays, %d members",
                 why, len(live), self._tree_plan["members"])

    @property
    def tree_plan(self) -> Optional[dict]:
        """The last re-plan: ``{"relays": [{"id", "bind", "leaves"}],
        "reason", "members"}``; None before a relay joined."""
        plan = self._tree_plan
        return None if plan is None else dict(plan)

    def _rehome_target(self) -> Optional[str]:
        """A live relay's endpoint for an orphaned leaf, round-robin over
        the relays seen recently (within ``min(slave_ttl, 10)`` s: a
        healthy relay polls sub-second, so one silent for seconds is not a
        safe target even before its eviction)."""
        now = time.time()
        window = min(self.slave_ttl, 10.0) if self.slave_ttl > 0 else 10.0
        targets = [self.relay_binds[sid]
                   for sid, seen in sorted(dict(self.slaves).items())
                   if sid in self.relays and sid in self.relay_binds
                   and now - seen <= window]
        if not targets:
            return None
        self._rehome_rr = (self._rehome_rr + 1) % (1 << 30)
        return targets[self._rehome_rr % len(targets)]

    # -- the books -------------------------------------------------------------

    def jobs_ledger(self) -> Dict:
        """Every dispatched job id ends in exactly one bucket: done,
        re-queued, refused (malformed, quarantined, stale beyond the
        bound) or in flight.  ``balanced`` holds for a master that never
        restored a resume file."""
        out = {
            "dispatched": int(self._job_seq),
            "jobs_done": int(self.jobs_done),
            "jobs_requeued": int(self.jobs_requeued),
            "bad_updates": int(self.bad_updates),
            "quarantined_updates": int(self.quarantined_updates),
            "stale_refused": int(self.stale_refused),
            "in_flight": len(self._inflight),
        }
        out["balanced"] = out["dispatched"] == (
            out["jobs_done"] + out["jobs_requeued"] + out["bad_updates"]
            + out["quarantined_updates"] + out["stale_refused"]
            + out["in_flight"])
        return out

    def _scheduled_hypers(self) -> Optional[Dict]:
        """The per-layer (lr, lr_bias) of a TRAIN minibatch dispatched now,
        by the workflow's ``lr_adjust`` bindings: minibatch k at the rate
        written after minibatch k - 1 (minibatch 0 at the base)."""
        if not self._lr_bindings:
            return None
        it = self._lr_iteration
        out = {}
        for gd, base, base_bias, pol, bias_pol in self._lr_bindings:
            if it == 0:
                lr, lr_bias = base, base_bias
            else:
                lr, lr_bias = pol(base, it - 1), bias_pol(base_bias, it - 1)
            out[gd.forward.name] = (float(lr), float(lr_bias))
        return out

    def _advance_mb(self) -> dict:
        if self._hold is not None:
            mb, self._hold = self._hold, None
            return mb
        ldr = self.loader
        ldr.run()
        mb = {
            "indices": np.array(ldr.minibatch_indices).copy(),
            "class": int(ldr.minibatch_class),
            "size": int(ldr.minibatch_size),
            "last_minibatch": bool(ldr.last_minibatch),
            "class_ended": bool(ldr.class_ended),
            "epoch_number": int(ldr.epoch_number),
        }
        if mb["class"] == TRAIN:
            hypers = self._scheduled_hypers()
            if hypers:
                mb["hypers"] = hypers
            self._lr_iteration += 1
        return mb

    def _outstanding(self):
        return [j for j, _, _ in self._inflight.values()] + self._pending

    def _tail_outstanding(self) -> bool:
        return any(j.get("last_minibatch") for j in self._outstanding())

    def _next_job(self) -> Optional[dict]:
        """The next job: minibatches within an epoch run fully
        asynchronously, the epoch tail is issued once every other job of
        its epoch is back, and the next epoch starts after the tail's
        update is in."""
        self._reap_lost_jobs()
        if self._pending:
            return self._pending.pop(0)
        if bool(self.decision.complete):
            return None
        if self._tail_outstanding():
            return self._WAIT
        mb = self._advance_mb()
        if mb["last_minibatch"] and self._outstanding():
            self._hold = mb                 # the tail waits for stragglers
            return self._WAIT
        if self.segment_steps <= 1 or mb["class"] != TRAIN or \
                mb["last_minibatch"]:
            return mb
        seg = [mb]
        while len(seg) < self.segment_steps:
            nxt = self._advance_mb()
            if nxt["class"] == TRAIN and not nxt["last_minibatch"]:
                seg.append(nxt)
            else:
                self._hold = nxt
                break
        if len(seg) == 1:
            return mb
        return {"kind": "segment", "minibatches": seg,
                "class": TRAIN, "size": sum(m["size"] for m in seg)}

    def _refuse_update(self, job: dict, sid: str, why: str,
                       counter: str = "bad_updates",
                       quarantined: bool = False) -> dict:
        """The refuse/requeue/drop policy of a bad update: counted under
        ``counter`` and the job re-queued, at most ``MAX_BAD_REPLIES``
        times for a non-tail one (a tail is always re-queued)."""
        self._inc(counter)
        job["_bad_replies"] = job.get("_bad_replies", 0) + 1
        requeue = (bool(job.get("last_minibatch"))
                   or job["_bad_replies"] < self.MAX_BAD_REPLIES)
        log.warning("slave %s: %s — refusing the update and %s", sid, why,
                    "re-queueing the job" if requeue else
                    "DROPPING the job (repeated bad replies)")
        if requeue:
            self._pending.append(job)
        rep = {"ok": False, "error": why}
        if quarantined:
            rep["quarantined"] = True
        return rep

    def _feed_decision(self, job: dict, metrics: dict) -> None:
        d = self.decision
        d.minibatch_class = job["class"]
        d.last_minibatch = job["last_minibatch"]
        d.class_ended = job["class_ended"]
        d.epoch_number = job["epoch_number"]
        d.class_lengths = list(self.loader.class_lengths)
        d.minibatch_size = job["size"]
        d.minibatch_loss = float(metrics.get("loss", 0.0))
        if hasattr(d, "minibatch_n_err"):
            d.minibatch_n_err = int(metrics.get("n_err", 0))
            conf = metrics.get("confusion")
            d.confusion_matrix = None if conf is None else \
                torch.from_numpy(np.array(conf))
        d.run()

    # -- crash-resume ----------------------------------------------------------

    def save_resume(self, path: str) -> None:
        """Write the master's training state: the snapshotter's
        parameters, velocities and cursors, and what a restart needs
        besides (the loader's position, every outstanding job, the job id
        sequence, the Decision's accumulators, the counters)."""
        from znicz_torch import snapshotter

        snap = snapshotter.collect(self.workflow)
        d = self.decision
        acc = {"loss": list(d._acc_loss), "batches": list(d._acc_batches)}
        if hasattr(d, "_acc_n_err"):
            acc["n_err"] = list(d._acc_n_err)
            acc["samples"] = list(d._acc_samples)
            acc["confusion"] = [None if c is None else
                                np.asarray(torch.as_tensor(c).cpu())
                                for c in d._acc_confusion]
        snap["master"] = {
            "loader_pos": int(self.loader._pos),
            "hold": self._hold,
            "outstanding": [
                {k: v for k, v in j.items()
                 if k not in ("_bad_replies", "_stale_refusals")}
                for j in self._outstanding()],
            "job_seq": self._job_seq,
            "jobs_by_slave": dict(self.jobs_by_slave),
            "lr_iteration": self._lr_iteration,
            "apply_step": self._apply_step,
            "decision_acc": acc,
            "durations": list(self._durations),
            "delta_norms": list(self._delta_norms),
            "counters": dict(
                {name: getattr(self, name) for name in self.COUNTERS
                 if name != "resume_saves"},
                bytes_in=self.bytes_in, bytes_out=self.bytes_out,
                bad_frames=self.bad_frames,
                tensor_bytes_raw_in=self.tensor_bytes_raw_in,
                tensor_bytes_wire_in=self.tensor_bytes_wire_in,
                tensor_bytes_raw_out=self.tensor_bytes_raw_out,
                tensor_bytes_wire_out=self.tensor_bytes_wire_out),
        }
        # compressed by the extension: the loader picks its opener by
        # suffix at restart
        snapshotter.write_host_pickle(
            path, snap, "gz" if path.endswith(".gz") else "none")
        self._inc("resume_saves")

    def restore_resume(self, path: str) -> None:
        """Restore a :meth:`save_resume` file onto the workflow: jobs
        outstanding at the save are re-queued, updates issued after it
        are redone, and slaves re-register and go on."""
        from znicz_torch import snapshotter

        snap = snapshotter.Snapshotter.load(path)
        snapshotter.restore(self.workflow, snap)
        m = snap.get("master", {})
        self.loader._pos = int(m.get("loader_pos", 0))
        self._hold = m.get("hold")
        self._pending = list(m.get("outstanding", []))
        self._inflight.clear()
        # ids issued after the save were never saved: restart far past
        # them, so a surviving slave's pre-crash update is only stale
        self._job_seq = int(m.get("job_seq", 0)) + 100_000
        self.jobs_by_slave = dict(m.get("jobs_by_slave", {}))
        self._lr_iteration = int(m.get("lr_iteration", 0))
        self._apply_step = int(m.get("apply_step", 0))
        self._durations = collections.deque(m.get("durations", []),
                                            maxlen=64)
        self._delta_norms = collections.deque(m.get("delta_norms", []),
                                              maxlen=64)
        for name, value in m.get("counters", {}).items():
            setattr(self, name, int(value))
        acc = m.get("decision_acc", {})
        d = self.decision
        if "loss" in acc:
            d._acc_loss = list(acc["loss"])
            d._acc_batches = list(acc["batches"])
        if "n_err" in acc and hasattr(d, "_acc_n_err"):
            d._acc_n_err = list(acc["n_err"])
            d._acc_samples = list(acc["samples"])
            d._acc_confusion = [None if c is None else torch.as_tensor(c)
                                for c in acc["confusion"]]
        self.resumed = True
        log.info("master resumed from %s: epoch %d, %d jobs done, %d "
                 "outstanding jobs re-queued", path,
                 int(self.loader.epoch_number), self.jobs_done,
                 len(self._pending))

    def _maybe_save_resume(self) -> None:
        if not self.resume_path or self.snapshot_every_s <= 0:
            return
        if bool(self.decision.complete):
            return
        now = time.time()
        if now - self._last_resume_save < self.snapshot_every_s:
            return
        self._last_resume_save = now
        self.save_resume(self.resume_path)

    # -- the REP loop ----------------------------------------------------------

    def stop(self) -> None:
        """Make :meth:`serve` return at its next tick, with no drain: a
        simulated crash (only the periodic resume file survives)."""
        self._stop = True

    def start(self, linger: float = 3.0) -> "Server":
        """Serve on a thread; return once bound (``endpoint`` resolved).
        A bind failure raises here with its cause."""
        self._ready.clear()
        self._serve_error = None
        self._thread = threading.Thread(target=self.serve,
                                        kwargs={"linger": linger},
                                        daemon=True, name="znicz-master")
        self._thread.start()
        self._ready.wait()
        if self._serve_error is not None:
            raise RuntimeError(f"master failed on {self.bind}: "
                               f"{self._serve_error!r}") \
                from self._serve_error
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join a started server's thread; True once it exited."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def serve(self, linger: float = 3.0) -> None:
        """Serve until the Decision completes, then keep answering for
        ``linger`` seconds so every slave's last request gets its
        ``done``.  Rides the transport loop: the REP dispatch of
        :meth:`_reply_frames` and one tick for the reaper, eviction, the
        quorum log and the resume file."""
        from znicz_torch.transport import TransportLoop

        self._stop = False
        loop = self._transport = TransportLoop("master", instance=self.bind)
        state = {"deadline": None}

        def tick() -> None:
            if self._stop:
                loop.stop()
                return
            if bool(self.decision.complete):
                # jobs out with crashed slaves are never served again:
                # reap on timeout and drop, else the loop would wait on
                # a dead peer
                self._reap_lost_jobs()
                self._pending.clear()
            finished = (bool(self.decision.complete)
                        and not self._inflight and not self._pending)
            if finished and state["deadline"] is None:
                state["deadline"] = time.time() + linger
            if state["deadline"] is not None \
                    and time.time() > state["deadline"]:
                loop.stop()
                return
            self._evict_dead_slaves()
            self._note_quorum()
            self._maybe_save_resume()

        try:
            try:
                self._socket = loop.bind_rep(self.bind)
                self.endpoint = loop.resolved_endpoint(self._socket)
            except BaseException as exc:
                self._serve_error = exc
                raise
            finally:
                self._ready.set()
            loop.register(self._socket, self._reply_frames, reply=True)
            if self.transport_chaos is not None:
                loop.inject_faults(self.transport_chaos)
            loop.add_tick(tick)
            log.info("master serving %s at %s", self.workflow.name,
                     self.endpoint)
            tick()                      # the pre-poll pass (resume cadence)
            loop.run(poll_ms=100)
        finally:
            loop.close()
            self._socket = None
            if (self.resume_path and not self._stop
                    and bool(self.decision.complete)
                    and os.path.exists(self.resume_path)):
                # training finished: a rerun of the same command must not
                # restore stale mid-training state
                os.remove(self.resume_path)

    def _reply_frames(self, frames: List[bytes]) -> List:
        """Decode and dispatch one message, returning the reply frames.
        Never raises: an undecodable message, or a request that trips
        :meth:`_handle`, is refused with an error reply and counted.  A
        v2-framed (or undecodable) request is answered in v2 framing."""
        from znicz_torch.parallel import wire

        try:
            req, info = self.codec.decode(frames)
            if not isinstance(req, dict):
                raise wire.WireError(
                    f"decodes to {type(req).__name__}, not a request dict")
        except Exception as exc:
            rep_frames = self.codec.refusal(exc)
            log.warning("refused undecodable message (%d frames, %d bytes): "
                        "%s — bad_frames=%d", len(frames),
                        sum(len(f) for f in frames), exc, self.bad_frames)
            return rep_frames
        legacy = bool(info.get("legacy"))
        if req.get("cmd") == "update":
            self._inc("updates_received")
            self._inc("update_bytes_in", int(info["message_bytes"]))
        try:
            rep = self._handle(req)
        except Exception as exc:
            self.codec.count_bad_frame()
            log.exception("refused malformed request %r", req.get("cmd"))
            rep = {"ok": False, "bad_frame": True,
                   "error": f"malformed request: {exc!r}"}
        return self.codec.encode(rep, legacy=legacy)

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        sid = req.get("id", "?")
        if sid in self.registered:
            self.slaves[sid] = time.time()
        if cmd == "register":
            return self._register(req, sid)
        if cmd in ("job", "update") and sid not in self.registered:
            # the handshake is a gate: ``unregistered`` tells a slave that
            # outlived a master restart to register again, not to exit
            return {"ok": False, "unregistered": True,
                    "error": f"slave {sid!r} is not registered"}
        if cmd == "job":
            return self._job(req, sid)
        if cmd == "update":
            return self._update(req, sid)
        return {"error": f"unknown cmd {cmd!r}"}

    def _register(self, req: dict, sid: str) -> dict:
        from znicz_torch.network_common import (PROTOCOL_VERSION,
                                                check_handshake)

        refusal = check_handshake(req, self.workflow)
        if refusal:
            self.slaves.pop(sid, None)
            self.registered.discard(sid)
            return {"ok": False, "error": refusal}
        self.dead_slaves.pop(sid, None)
        if sid in self._ever_registered or sid in self.jobs_by_slave:
            # a repeat register: a reconnect, or a peer back at a resumed
            # master whose job history came back with the file
            self._inc("reregistrations")
        self._ever_registered.add(sid)
        self.registered.add(sid)
        newly_live = sid not in self.slaves
        if req.get("relay"):
            # a relay of the tree: a member (TTL, eviction and the reaper
            # apply), marked so that its leaves count through it
            self.relays.add(sid)
            if req.get("bind"):
                self.relay_binds[sid] = str(req["bind"])
        mesh = req.get("mesh")
        if isinstance(mesh, dict) and mesh:
            self.slave_meshes[sid] = {str(k): int(v)
                                      for k, v in mesh.items()}
        else:
            self.slave_meshes.pop(sid, None)
        self.slaves[sid] = time.time()
        if req.get("relay") and newly_live:
            self._replan(f"relay {sid} joined")
        rep = {"ok": True, "version": PROTOCOL_VERSION,
               "class_lengths": list(self.loader.class_lengths),
               "resumed": self.resumed,
               "epoch": int(self.loader.epoch_number)}
        if self.elastic_rehome and not req.get("relay"):
            # a leaf registering here while live relays exist is an
            # orphan (its relay died and it fell back): steer it back
            # under the tree; it keeps this endpoint as its fallback
            target = self._rehome_target()
            if target:
                rep["rehome"] = target
        return rep

    def _job(self, req: dict, sid: str) -> dict:
        if bool(self.decision.complete):
            return {"done": True}
        if sid in self.relays and req.get("leaves") is not None:
            # read before the rate limit: a throttled relay's requests
            # still refresh its subtree's leaf count
            try:
                self._relay_leaves[sid] = max(0, int(req["leaves"]))
            except (TypeError, ValueError):
                pass
        if not self._ingress.try_take(sid):
            # never fatal, never a strike: the slave's poll path waits
            self._inc("rate_limited_ingress")
            return {"wait": True, "rate_limited": True,
                    "policy": "rate_limited",
                    "error": f"slave {sid!r} is over the per-slave ingress "
                             f"rate limit ({self._ingress.rate:g} job "
                             f"requests/s)"}
        if not self.quorum_met():
            return {"wait": True, "degraded": True,
                    "members": self.member_count(),
                    "min_slaves": self.min_slaves}
        # a batched fetch (count=k): up to k jobs under one broadcast
        count = max(1, min(int(req.get("count", 1) or 1), 64))
        entries: List[dict] = []
        job = None
        for _ in range(count):
            job = self._next_job()
            if job is None or job is self._WAIT:
                break
            self._job_seq += 1
            jid = self._job_seq
            self._inflight[jid] = (job, time.time(), sid)
            entry = {"job_id": jid, "job": job,
                     "trace_id": f"{self._run_tag}-{jid}",
                     "train": job["class"] == TRAIN,
                     "step": self._apply_step}
            if self.job_deadline:
                # a budget, not a timestamp (clocks differ): past the reap
                # window the job is re-queued here anyway
                entry["deadline_ms"] = self.effective_job_timeout() * 1e3
            entries.append(entry)
        if not entries:
            if job is self._WAIT:
                return {"wait": True}
            return {"done": True}
        if req.get("prefetch"):
            self._inc("prefetch_hit")
        params = self.snapshot_params()
        if count <= 1:
            return dict(entries[0], params=params)
        return {"jobs": entries, "params": params}

    def _update(self, req: dict, sid: str) -> dict:
        if "contributors" in req:
            return self._handle_aggregated(req, sid)
        jid = req.get("job_id")
        entry = self._inflight.pop(jid, None)
        if entry is None:
            # reaped or finished: one job, one accepted update
            self._inc("stale_updates")
            return {"ok": False, "stale": True}
        job, t_issued, _ = entry
        self._durations.append(time.time() - t_issued)
        # from here the job is out of _inflight: every refusal re-queues
        # or drops it deliberately, and nothing may raise
        if "minibatches" in job:
            ms = req.get("metrics") or []
            if not isinstance(ms, (list, tuple)) \
                    or len(ms) != len(job["minibatches"]) \
                    or not all(m is None or isinstance(m, dict) for m in ms):
                n = len(ms) if hasattr(ms, "__len__") else type(ms)
                return self._refuse_update(
                    job, sid, f"segment metrics length {n!r} != "
                              f"{len(job['minibatches'])}")
        elif not (req.get("metrics") is None
                  or isinstance(req.get("metrics"), dict)):
            return self._refuse_update(
                job, sid, "metrics payload is "
                          f"{type(req.get('metrics')).__name__}, not a dict")
        s = self._staleness(req.get("step"), sid)
        if req.get("deltas"):
            if self.staleness_bound > 0 and s > self.staleness_bound:
                return self._refuse_stale(job, sid, s)
            reason = self._quarantine_reason(req["deltas"])
            if reason:
                return self._refuse_update(
                    job, sid, f"delta quarantined: {reason}",
                    counter="quarantined_updates", quarantined=True)
            self.apply_deltas(req["deltas"], scale=self._stale_scale(s))
        # arrivals after completion must not rewind the Decision
        if not bool(self.decision.complete):
            if "minibatches" in job:
                for mb, m in zip(job["minibatches"],
                                 req.get("metrics") or []):
                    self._feed_decision(mb, m or {})
            else:
                self._feed_decision(job, req.get("metrics") or {})
        self._inc("jobs_done")
        self.jobs_by_slave[sid] = self.jobs_by_slave.get(sid, 0) + 1
        return {"ok": True, "complete": bool(self.decision.complete)}

    def _handle_aggregated(self, req: dict, sid: str) -> dict:
        """A relay's aggregated update: one summed delta and a manifest of
        its contributors.  The books are kept per contributor, as if each
        update had come alone: a stale job is dropped and counted, an edge
        refusal counted as quarantined and re-queued, malformed metrics
        refused under ``MAX_BAD_REPLIES``, round trips fed to the adaptive
        reaper, staleness observed per leaf from each entry's ``step``,
        the Decision fed per minibatch in manifest order and ``jobs_done``
        credited to the leaf ids.  The summed delta passes the quarantine
        (its norm per contributing delta) and is applied once.

        The sum is indivisible: when it is refused, every fresh
        contributor's job is re-queued; when a contributor with a delta
        is malformed or past ``staleness_bound``, the whole aggregate is
        refused (the star refuses before it applies, and a gradient cannot
        be taken out of a sum), that contributor takes its refusal and
        the innocent ones are re-queued with no strike.  A relay resends
        the same flush after a lost reply; on the second delivery every
        contributor pops as stale, and the sum is dropped.

        A contributor reaped while its delta sat in a relay's flush buffer
        is dropped from the books while its share of the sum lands: bounded
        by the flush window, far inside the reap timeout."""
        contributors = req.get("contributors")
        if not isinstance(contributors, (list, tuple)) or not all(
                isinstance(c, dict) for c in contributors):
            # a bad-frame refusal: nothing has left _inflight yet
            raise ValueError("contributors manifest is not a list of "
                             "dicts")
        now = time.time()
        n_delta = sum(1 for c in contributors if c.get("delta"))
        fresh: List[tuple] = []         # (contributor, job, staleness)
        malformed: List[tuple] = []     # (contributor, job, why)
        outcomes: Dict = {}
        for c in contributors:
            jid = c.get("job_id")
            entry = self._inflight.pop(jid, None)
            if entry is None:
                self._inc("stale_updates")
                outcomes[jid] = "stale"
                continue
            job, t_issued, _ = entry
            self._durations.append(now - t_issued)
            cid = str(c.get("id", sid))
            s = self._staleness(c.get("step"), cid)
            if c.get("refused"):
                self._refuse_update(
                    job, cid, f"delta quarantined at relay {sid!r}: "
                              f"{c['refused']}",
                    counter="quarantined_updates", quarantined=True)
                outcomes[jid] = "quarantined"
                continue
            metrics = c.get("metrics")
            why = None
            if "minibatches" in job:
                ms = metrics or []
                if not isinstance(ms, (list, tuple)) \
                        or len(ms) != len(job["minibatches"]) \
                        or not all(m is None or isinstance(m, dict)
                                   for m in ms):
                    n = len(ms) if hasattr(ms, "__len__") else type(ms)
                    why = (f"segment metrics length {n!r} != "
                           f"{len(job['minibatches'])}")
            elif not (metrics is None or isinstance(metrics, dict)):
                why = f"metrics payload is {type(metrics).__name__}, not a dict"
            if why is not None:
                malformed.append((c, job, why))
                outcomes[jid] = "refused"
                continue
            fresh.append((c, job, s))
        deltas = req.get("deltas")

        def refuse_all(refused, refuse, **rep):
            """Refuse the whole aggregate: ``refuse`` each of ``refused``,
            re-queue every other fresh contributor with no strike."""
            for c, job, what in refused:
                refuse(job, str(c.get("id", sid)), what)
            for c, job, _ in fresh:
                self._pending.append(job)
                self._inc("jobs_requeued")
                outcomes[c.get("job_id")] = "requeued"
            return dict(rep, ok=False, outcomes=outcomes)

        if malformed and deltas and any(c.get("delta")
                                        for c, _, _ in malformed):
            return refuse_all(
                malformed, self._refuse_update,
                error="aggregate refused: " + "; ".join(
                    w for _, _, w in malformed))
        for c, job, why in malformed:
            # a delta-less malformed reply (eval metrics) has nothing in
            # the sum: refused alone, as in the star
            self._refuse_update(job, str(c.get("id", sid)), why)
        if deltas and self.staleness_bound > 0:
            over = [t for t in fresh
                    if t[0].get("delta") and t[2] > self.staleness_bound]
            if over:
                fresh = [t for t in fresh if t not in over]
                for c, _, _ in over:
                    outcomes[c.get("job_id")] = "stale_refused"
                return refuse_all(
                    over, self._refuse_stale, stale_refused=True,
                    error=f"aggregate refused: {len(over)} contributor "
                          f"delta(s) beyond the staleness bound")
        # the apply needs a fresh contributor with a delta: a resent flush
        # finds them all stale, and its sum must not land twice
        if deltas and any(c.get("delta") for c, _, _ in fresh):
            reason = self._quarantine_reason(deltas,
                                             n_contrib=max(1, n_delta))
            if reason:
                for c, job, _ in fresh:
                    self._refuse_update(
                        job, str(c.get("id", sid)),
                        f"aggregated delta quarantined: {reason}",
                        counter="quarantined_updates", quarantined=True)
                return {"ok": False, "quarantined": True,
                        "error": f"delta quarantined: {reason}",
                        "outcomes": outcomes}
            # one scale for the indivisible sum: its contributors' mean
            # staleness
            stales = [s for c, _, s in fresh if c.get("delta")]
            self.apply_deltas(deltas, scale=self._stale_scale(
                float(np.mean(stales)) if stales else 0.0))
        for c, job, _ in fresh:
            if not bool(self.decision.complete):
                if "minibatches" in job:
                    for mb, m in zip(job["minibatches"],
                                     c.get("metrics") or []):
                        self._feed_decision(mb, m or {})
                else:
                    self._feed_decision(job, c.get("metrics") or {})
            cid = str(c.get("id", sid))
            self._inc("jobs_done")
            self.jobs_by_slave[cid] = self.jobs_by_slave.get(cid, 0) + 1
            outcomes[c.get("job_id")] = "ok"
        self._inc("aggregated_updates")
        return {"ok": True, "complete": bool(self.decision.complete),
                "outcomes": outcomes}


def _counter_property(name: str):
    def get(self) -> int:
        with self._lock:
            return self._counts[name]

    def set_(self, value) -> None:
        with self._lock:
            self._counts[name] = int(value)

    return property(get, set_, doc=Server.COUNTERS[name])


for _name in Server.COUNTERS:
    setattr(Server, _name, _counter_property(_name))
del _name
