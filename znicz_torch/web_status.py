"""Web status dashboard (port of ``znicz_tpu/web_status.py``).

Registered workflows' progress (epoch, metrics, unit runs), the master's
star and relay tree, the serving and fleet panels and the card list, over
a stdlib ``ThreadingHTTPServer``::

    status = WebStatus(port=8080).start()
    status.register(workflow)
    ... train ...
    status.stop()

Endpoints: ``/`` (HTML page, auto-refresh), ``/status.json``,
``/metrics`` (Prometheus text of the process-wide telemetry registry; on
a fleet coordinator every member's series too, labelled
``member=<origin>``), ``/trace.json`` (the span ring as Chrome
trace-event JSON; ``?fleet=1`` the coordinator's stitched cross-process
timeline, narrowed with ``&trace_id=``), ``/events.json`` (the event
journal; ``since=<seq>``, ``?fleet=1`` for the merged fleet journal on
its ``mseq`` cursor), ``/slo.json`` (per-plane SLO burn rates),
``/fleet.json`` (the fleet rollup: merged metrics, stitched-trace
summary, journal origins, SLO state), and for a registered inference
service or balancer ``/healthz`` (liveness) and ``/readyz`` (readiness,
with the advisory ``slo`` field, which never changes the 200/503 gate).

The device list is ``torch.cuda``'s: the count, each card's name and
``mem_get_info``.  A failure to enumerate is reported as
``{"error": ..., "devices": []}``, never as the CPU in the card's place.

Lock discipline: the ``/metrics`` and ``/trace.json`` handlers render
the registry or ring into a plain string first and only then touch the
socket, so a stalled scraper cannot stall a loop that increments
counters.
"""

from __future__ import annotations

import html
import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


def cuda_devices() -> List[dict]:
    """The cards ``torch.cuda`` sees: index, name, free and total bytes.
    Raises when CUDA cannot be queried (no runtime, no card): the caller
    reports that as a structured error."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"index": i, "name": torch.cuda.get_device_name(i),
                    "mem_free": int(free), "mem_total": int(total)})
    return out


class WebStatus:
    def __init__(self, port: int = 8080, host: str = "127.0.0.1"):
        self.host = host
        self.port = int(port)
        self.workflows: List[object] = []
        self.server = None                  # optional master (topology)
        self.relays: List[object] = []      # optional relay nodes (tree)
        self.inference = None               # optional inference service
        self.inference_client = None        # optional breaker-side view
        self.balancer = None                # optional replica balancer
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def register(self, workflow) -> None:
        if workflow not in self.workflows:
            self.workflows.append(workflow)

    def register_server(self, server) -> None:
        """Show the master/slave topology (reference dashboard feature)."""
        self.server = server

    def register_relay(self, relay) -> None:
        """Show an aggregation-tree relay node: its children,
        upstream, queue/flush state and byte/refusal accounting — the
        tree-topology panel.  Register each co-located relay."""
        if relay not in self.relays:
            self.relays.append(relay)

    def register_inference(self, server) -> None:
        """Show the inference service's serving panel: qps,
        latency quantiles, batch occupancy, queue depth, per-bucket hit
        counts, shed/timed-out/bad-frame accounting — plus
        readiness/generation and the per-client admission table; also
        arms ``/healthz`` and ``/readyz``."""
        self.inference = server

    def register_inference_client(self, client) -> None:
        """Show a local InferenceClient's view: circuit-
        breaker state, resends/give-ups, in-flight depth."""
        self.inference_client = client

    def register_balancer(self, balancer) -> None:
        """Show a replica balancer's fleet panel: per-
        replica generation/p99/in-flight/last-heartbeat-age rows, the
        exactly-once ledger, hedging and rollover state — and make
        ``/readyz`` answer the FLEET AGGREGATE (``ready_replicas`` /
        ``total``, 503 below the ``min_replicas`` quorum, mirroring
        the master's training quorum) instead of any single process."""
        self.balancer = balancer

    # -- snapshotting the state (host side, lock-free reads) -------------------

    def snapshot(self) -> dict:
        from znicz_torch.decision import DecisionBase

        out = {"workflows": []}
        try:
            out["devices"] = cuda_devices()
        except Exception as exc:       # no card reachable: degrade visibly
            logging.getLogger("web_status").warning(
                "device enumeration failed: %r", exc)
            # structured: a consumer tells "no devices enumerable (why)"
            # from "zero devices"
            out["devices"] = {"error": f"{type(exc).__name__}: {exc}",
                              "devices": []}
        for wf in self.workflows:
            info = {"name": wf.name, "stopped": bool(wf.stopped),
                    "units": [{"name": u.name, "runs": u.run_count}
                              for u in wf.units if u.run_count]}
            fused = getattr(wf, "fused_stats", None)
            if fused and fused.get("wall_s"):
                info["fused"] = dict(fused)
            for u in wf.units:
                if isinstance(u, DecisionBase):
                    info["epoch"] = int(u.epoch_number)
                    info["best_metric"] = (None if u.best_metric != u.best_metric
                                           or u.best_metric == float("inf")
                                           else float(u.best_metric))
                    info["complete"] = bool(u.complete)
            out["workflows"].append(info)
        if self.server is not None:
            import time as _time

            now = _time.time()
            srv = self.server
            # C-level copies: the serve thread mutates these concurrently
            # (evictions pop, updates append) and iterating the live
            # structures from this HTTP thread could raise mid-request
            live = dict(srv.slaves)
            dead = dict(srv.dead_slaves)
            jobs_by_slave = dict(srv.jobs_by_slave)
            from znicz_torch.network_common import PROTOCOL_VERSION

            ratio = srv.compression_ratio()
            bpu = srv.bytes_per_update()
            out["master"] = {
                "endpoint": srv.endpoint,
                "protocol_version": PROTOCOL_VERSION,
                "jobs_done": srv.jobs_done,
                "jobs_requeued": srv.jobs_requeued,
                "stale_updates": srv.stale_updates,
                # wire-v3 traffic counters:
                "bytes_in": srv.bytes_in,
                "bytes_out": srv.bytes_out,
                "updates_received": srv.updates_received,
                "update_bytes_in": srv.update_bytes_in,
                "bytes_per_update": None if bpu is None else round(bpu, 1),
                "compression_ratio": None if ratio is None
                else round(ratio, 3),
                "prefetch_hit": srv.prefetch_hit,
                "wire_compress": srv.wire_compress,
                # robustness counters (fault model, README):
                "bad_updates": srv.bad_updates,
                "bad_frames": srv.bad_frames,
                "quarantined_updates": srv.quarantined_updates,
                "reregistrations": srv.reregistrations,
                # unified transport core: per-slave ingress
                # admission — additive key, historical names unchanged
                "rate_limited_ingress": srv.rate_limited_ingress,
                "resumed": bool(srv.resumed),
                "resume_saves": srv.resume_saves,
                "job_timeout_s": round(srv.effective_job_timeout(), 3),
                "aggregated_updates": srv.aggregated_updates,
                # elastic async training: quorum state,
                # staleness policy + per-leaf histograms, re-planner
                "elastic": {
                    "min_slaves": srv.min_slaves,
                    "members": srv.member_count(),
                    "degraded": bool(srv.degraded()),
                    "apply_step": srv.apply_step,
                    "staleness_bound": srv.staleness_bound,
                    "staleness_weight": bool(srv.staleness_weight),
                    "stale_refused": srv.stale_refused,
                    "weighted_applies": srv.weighted_applies,
                    "replans": srv.replans,
                    "preemptions_ridden": srv.preemptions_ridden,
                    "staleness_by_leaf": srv.staleness_summary(),
                    "tree_plan": srv.tree_plan,
                },
                "slaves": [
                    {"id": sid,
                     "jobs": jobs_by_slave.get(sid, 0),
                     "last_seen_s": round(now - seen, 1),
                     # tree topology: direct children that
                     # are relays, not leaf slaves
                     "relay": sid in srv.relays,
                     # pod-sliced leaves advertise their
                     # mesh shape on register; None = single-device
                     "mesh": srv.slave_meshes.get(sid)}
                    for sid, seen in sorted(live.items())],
                # leaf slaves working BEHIND relays: attributed in
                # jobs_by_slave (contributor manifests) but never
                # direct members (iterated from the copy above — the
                # serve thread mutates the live dict concurrently)
                "leaves": [
                    {"id": sid, "jobs": n}
                    for sid, n in sorted(jobs_by_slave.items())
                    if sid not in live and sid not in dead],
                # evicted-but-remembered membership (their job history
                # survives for the final report)
                "dead_slaves": [
                    {"id": sid,
                     "jobs": jobs_by_slave.get(sid, 0),
                     "last_seen_s": round(now - seen, 1)}
                    for sid, seen in sorted(dead.items())],
            }
        if self.relays:
            # each stats() assembles under the relay's own lock — safe
            # from this HTTP thread while the relays serve
            out["relays"] = [r.stats() for r in self.relays]
        if self.inference is not None:
            # stats() assembles from plain counters — safe to call from
            # this HTTP thread while the service runs
            out["serving"] = self.inference.stats()
        if self.balancer is not None:
            # assembles under the balancer's own lock — safe from this
            # HTTP thread while the fleet serves
            out["balancer"] = self.balancer.stats()
        if self.inference_client is not None:
            c = self.inference_client
            out["serving_client"] = {
                "endpoint": c.endpoint,
                "breaker": c.breaker_state,
                "in_flight": c.in_flight,
                "resends": c.resends,
                "give_ups": c.give_ups,
                "errors": c.errors,
                "bad_replies": c.bad_replies,
                "breaker_opens": c.breaker_opens,
                "breaker_short_circuits": c.breaker_short_circuits,
                # per-endpoint windows behind a balancer
                "replica_breakers": c.replica_breakers(),
            }
        return out

    def health(self) -> dict:
        """The ``/healthz`` body: liveness of the registered inference
        service (no service registered = the process itself answers,
        which is liveness enough)."""
        if self.balancer is not None:
            return {"ok": bool(self.balancer.alive())}
        inf = self.inference
        alive = True if inf is None else bool(inf.alive())
        return {"ok": alive}

    def readiness(self) -> dict:
        """The ``/readyz`` body: with a BALANCER registered
        the answer is the FLEET AGGREGATE — ``ready_replicas/total``
        with 503 below the ``min_replicas`` quorum (the old per-process
        answer said nothing about whether the fleet could serve);
        otherwise ready iff a registered inference service is up,
        warmed, not mid-rollover and not draining — or, with only a
        training MASTER registered, iff its elastic quorum
        is met (503 while degraded is the membership signal an
        operator's dashboards key on during preemptions)."""
        bal = self.balancer
        if bal is not None:
            ready = bal.ready_count()
            total = bal.member_count()
            if not bal.alive():
                return {"ready": False,
                        "reason": "dead (balancer loop exited)",
                        "ready_replicas": ready, "total": total,
                        "min_replicas": bal.min_replicas}
            if bal.degraded():
                return {"ready": False,
                        "reason": f"degraded: {ready}/{total} replicas "
                                  f"ready, below the min_replicas "
                                  f"quorum ({bal.min_replicas})",
                        "ready_replicas": ready, "total": total,
                        "min_replicas": bal.min_replicas}
            return {"ready": True, "reason": "ok",
                    "ready_replicas": ready, "total": total,
                    "min_replicas": bal.min_replicas}
        inf = self.inference
        if inf is None:
            srv = self.server
            if srv is not None:
                members = srv.member_count()
                if srv.degraded():
                    return {"ready": False,
                            "reason": f"degraded: {members} members "
                                      f"below the min_slaves quorum "
                                      f"({srv.min_slaves})",
                            "members": members,
                            "min_slaves": srv.min_slaves}
                return {"ready": True, "reason": "ok",
                        "members": members,
                        "min_slaves": srv.min_slaves}
            return {"ready": False,
                    "reason": "no inference service registered"}
        if inf.ready():
            return {"ready": True, "reason": "ok",
                    "generation": inf.runner.generation}
        if not inf.alive():
            # a crashed loop must not masquerade as "starting": an
            # operator would wait out a warmup that never ends
            reason = "dead (serve loop exited — see /healthz)"
        elif inf.draining:
            reason = "draining"
        elif inf.runner.swapping:
            reason = "warming (snapshot rollover in progress)"
        else:
            reason = "starting (warmup in progress)"
        return {"ready": False, "reason": reason,
                "generation": inf.runner.generation}

    # -- server ----------------------------------------------------------------

    def _make_handler(self):
        status = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):       # silence request logging
                pass

            def _query(self):
                parsed = urllib.parse.urlsplit(self.path)
                return {k: v[-1] for k, v in
                        urllib.parse.parse_qs(parsed.query).items()}

            def do_GET(self):
                code = 200
                if self.path.startswith("/healthz"):
                    # liveness: 503 tells a supervisor to
                    # restart the process
                    health = status.health()
                    code = 200 if health["ok"] else 503
                    body = json.dumps(health).encode()
                    ctype = "application/json"
                elif self.path.startswith("/readyz"):
                    # readiness: 503 while warming/draining pulls this
                    # replica out of a load balancer WITHOUT killing it
                    from znicz_torch import telemetry

                    ready = status.readiness()
                    # ADVISORY SLO state: surfaced for
                    # operators/dashboards, NEVER part of the gate —
                    # the 200/503 decision above this line is untouched
                    ready["slo"] = telemetry.slo_snapshot()["state"]
                    code = 200 if ready["ready"] else 503
                    body = json.dumps(ready).encode()
                    ctype = "application/json"
                elif self.path.startswith("/status.json"):
                    body = json.dumps(status.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    # Prometheus text exposition.  render
                    # returns a COMPLETE string — the socket write below
                    # happens with no registry lock held.  A coordinator
                    # holding member snapshots renders the
                    # fleet SUPERSET: local series byte-identical, member
                    # series appended under the same families with a
                    # member=<origin> label
                    from znicz_torch import telemetry

                    store = telemetry.fleet_metrics()
                    if store.members():
                        body = telemetry.render_fleet_prometheus(
                            telemetry.registry(), store).encode()
                    else:
                        body = telemetry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/trace.json"):
                    # Chrome trace-event JSON of the span ring (open in
                    # Perfetto); same snapshot-then-write discipline.
                    # ?fleet=1: the coordinator's stitched
                    # cross-process timeline instead (&trace_id= narrows
                    # to one request/job)
                    from znicz_torch import telemetry

                    q = self._query()
                    if q.get("fleet"):
                        trace = telemetry.fleet_trace().chrome_trace(
                            trace_id=q.get("trace_id"))
                    else:
                        trace = telemetry.chrome_trace()
                    body = json.dumps(trace).encode()
                    ctype = "application/json"
                elif self.path.startswith("/events.json"):
                    # the structured event journal: bounded,
                    # seq-cursorable; ?fleet=1 serves the coordinator's
                    # merged journal on its own mseq cursor
                    from znicz_torch import telemetry

                    q = self._query()
                    try:
                        since = int(q.get("since", 0))
                    except ValueError:
                        since = 0
                    if q.get("fleet"):
                        store = telemetry.fleet_events()
                        payload = {"fleet": True,
                                   "last_mseq": store.snapshot()["last_mseq"],
                                   "events": store.since(since)}
                    else:
                        j = telemetry.journal()
                        payload = {"origin": j.origin,
                                   "last_seq": j.last_seq,
                                   "dropped": j.dropped,
                                   "events": j.since(since)}
                    body = json.dumps(payload).encode()
                    ctype = "application/json"
                elif self.path.startswith("/slo.json"):
                    # per-plane SLO burn rates / error-budget state
                    from znicz_torch import telemetry

                    body = json.dumps(telemetry.slo_snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/fleet.json"):
                    # the structured fleet rollup
                    from znicz_torch import telemetry

                    ev = telemetry.fleet_events().snapshot()
                    body = json.dumps({
                        "metrics": telemetry.fleet_metrics().rollup(),
                        "trace": telemetry.fleet_trace().snapshot(),
                        "events": {"last_mseq": ev["last_mseq"],
                                   "origins": ev["origins"]},
                        "slo": telemetry.slo_snapshot(),
                    }).encode()
                    ctype = "application/json"
                else:
                    snap = status.snapshot()
                    rows = "".join(
                        f"<tr><td>{html.escape(w['name'])}</td>"
                        f"<td>{w.get('epoch', '-')}</td>"
                        f"<td>{w.get('best_metric', '-')}</td>"
                        f"<td>{'done' if w.get('complete') else 'running'}"
                        f"</td></tr>"
                        for w in snap["workflows"])
                    master_html = ""
                    master = snap.get("master")
                    if master:
                        ela = master.get("elastic", {})
                        stale_rows = "".join(
                            f"<tr><td>{html.escape(leaf)}</td>"
                            f"<td>{st['count']}</td><td>{st['p50']}</td>"
                            f"<td>{st['max']}</td></tr>"
                            for leaf, st in sorted(
                                ela.get("staleness_by_leaf",
                                        {}).items()))
                        elastic_html = (
                            "<p>elastic: "
                            f"{'DEGRADED' if ela.get('degraded') else 'ok'}"
                            f", members {ela.get('members')}"
                            f"/{ela.get('min_slaves')} min, apply step "
                            f"{ela.get('apply_step')}, staleness bound "
                            f"{ela.get('staleness_bound')}"
                            f" (weighting "
                            f"{'on' if ela.get('staleness_weight') else 'off'}"
                            f"), stale refused {ela.get('stale_refused')}"
                            f", weighted applies "
                            f"{ela.get('weighted_applies')}, re-plans "
                            f"{ela.get('replans')}, preemptions ridden "
                            f"{ela.get('preemptions_ridden')}</p>")
                        if stale_rows:
                            elastic_html += (
                                "<table border=1><tr><th>leaf</th>"
                                "<th>staleness n</th><th>p50</th>"
                                f"<th>max</th></tr>{stale_rows}</table>")
                        srows = "".join(
                            f"<tr><td>{html.escape(s['id'])}"
                            f"{' (relay)' if s.get('relay') else ''}"
                            f"</td><td>{s['jobs']}</td>"
                            f"<td>{s['last_seen_s']}s ago</td>"
                            # pod-sliced leaves show their
                            # slice, e.g. "data=4 x model=2"
                            f"<td>{'x'.join(f'{k}={v}' for k, v in s['mesh'].items()) if s.get('mesh') else 'single-device'}"
                            "</td></tr>"
                            for s in master["slaves"])
                        master_html = (
                            f"<h2>Master {html.escape(master['endpoint'])}"
                            f"</h2><p>jobs done: {master['jobs_done']}, "
                            f"re-queued: {master['jobs_requeued']}, stale "
                            f"updates: {master['stale_updates']}, bad "
                            f"frames: {master['bad_frames']}, quarantined: "
                            f"{master['quarantined_updates']}, reconnects: "
                            f"{master['reregistrations']}, job timeout: "
                            f"{master['job_timeout_s']}s"
                            f"{', RESUMED' if master['resumed'] else ''}"
                            "</p>"
                            f"<p>wire v{master['protocol_version']}: "
                            f"{master['bytes_in']} B in / "
                            f"{master['bytes_out']} B out, "
                            f"bytes/update: {master['bytes_per_update']}, "
                            "compression ratio: "
                            f"{master['compression_ratio']}, prefetch "
                            f"hits: {master['prefetch_hit']}</p>"
                            f"{elastic_html}"
                            "<table border=1><tr><th>slave</th><th>jobs"
                            "</th><th>last seen</th><th>mesh</th></tr>"
                            f"{srows}</table>"
                            f"<p>dead slaves: {len(master['dead_slaves'])}"
                            f", aggregated updates: "
                            f"{master.get('aggregated_updates', 0)}, "
                            "leaves behind relays: "
                            f"{len(master.get('leaves', []))}</p>")
                    relays_html = ""
                    for r in snap.get("relays", []):
                        # the tree-topology panel: one box
                        # per co-located relay, children indented under
                        # their upstream edge
                        crows = "".join(
                            f"<tr><td>{html.escape(c['id'])}</td>"
                            f"<td>{c['last_seen_s']}s ago</td></tr>"
                            for c in r["children"])
                        relays_html += (
                            f"<h2>Relay {html.escape(r['id'])}</h2>"
                            f"<p>{html.escape(r['bind'])} &rarr; "
                            f"upstream {html.escape(r['upstream'])}, "
                            f"fanout {r['fanout']}, wire "
                            f"{r['wire_dtype']}"
                            f"{', DONE' if r['complete'] else ''}</p>"
                            f"<p>flushes: {r['flushes']}, contributions: "
                            f"{r['contributions']}, refusals: "
                            f"{r['refusals']}, jobs served: "
                            f"{r['jobs_served']}, queue: "
                            f"{r['queue_depth']}, buffered: "
                            f"{r['buffered_contributions']}, bytes "
                            f"{r['bytes_in']} in / {r['bytes_out']} out, "
                            f"bad frames: {r['bad_frames']}, upstream "
                            f"reconnects: {r['upstream_reconnects']}</p>"
                            "<table border=1><tr><th>child</th>"
                            f"<th>last seen</th></tr>{crows}</table>")
                    serving_html = ""
                    serving = snap.get("serving")
                    if serving:
                        b = serving["batcher"]
                        # the port's serving stats carry the runner's
                        # keys at the top level
                        m = serving.get("model") or serving
                        adm = b.get("admission", {})
                        pad = b.get("pad_ratio", {})

                        def _bucket_order(kv):
                            # numeric (rows, seq) order: plain int rungs
                            # (1-D) and "RxS" keys (2-D) both parse —
                            # lexicographic order shuffled 16 before 2
                            return tuple(int(p) for p in
                                         str(kv[0]).split("x"))

                        brows = "".join(
                            f"<tr><td>{r}</td><td>{n}</td>"
                            f"<td>{pad.get(r, '-')}</td></tr>"
                            for r, n in sorted(b["bucket_hits"].items(),
                                               key=_bucket_order))
                        state = ("DRAINING" if serving.get("draining")
                                 else "ready" if serving.get("ready")
                                 else "warming")
                        mesh = m.get("mesh")
                        mesh_text = ("single-device" if not mesh
                                     else "x".join(
                                         f"{k}={v}"
                                         for k, v in mesh.items())
                                     + f" ({m.get('device_count')} "
                                       "devices)")
                        crows = "".join(
                            f"<tr><td>{html.escape(cid)}</td>"
                            f"<td>{c['accepted']}</td>"
                            f"<td>{c['rate_limited']}</td>"
                            f"<td>{c['shed']}</td></tr>"
                            for cid, c in sorted(
                                adm.get("clients", {}).items()))
                        serving_html = (
                            "<h2>Serving "
                            f"{html.escape(str(serving['endpoint']))}</h2>"
                            f"<p>state: {state}, snapshot generation: "
                            f"{serving['generation']}"
                            f"{' (swapping)' if m.get('swapping') else ''}"
                            f", swaps: {m.get('swaps')}, mesh: "
                            f"{html.escape(mesh_text)}</p>"
                            f"<p>qps: {serving['qps']}, p50: "
                            f"{serving['p50_ms']} ms, p99: "
                            f"{serving['p99_ms']} ms, served: "
                            f"{serving['served']}, rejected: "
                            f"{serving['rejected']}, timed out: "
                            f"{serving['timed_out']}, expired results: "
                            f"{serving['expired_results']}, bad frames: "
                            f"{serving['bad_frames']}</p>"
                            f"<p>batcher: occupancy "
                            f"{b['mean_occupancy']}, queue depth "
                            f"{b['queue_depth']}/{b['queue_bound']} rows, "
                            f"shed {b['shed']}, max_batch "
                            f"{b['max_batch']}, max_delay "
                            f"{b['max_delay_ms']} ms, padded cells "
                            f"{b.get('padded_cells', 0)} / real "
                            f"{b.get('real_cells', 0)}"
                            + (f", seq rungs {b['seq_rungs']}"
                               if b.get('seq_rungs') else "")
                            + f"; captures "
                            f"{m.get('compiles')} (graphs "
                            f"{m.get('graph_cache_size')})</p>"
                            f"<p>admission: "
                            f"{'on' if adm.get('enabled') else 'off'}, "
                            f"rate limit "
                            f"{adm.get('rate_limit_rows_per_s')} rows/s, "
                            f"fair: {adm.get('fair')}, rate_limited: "
                            f"{adm.get('rate_limited')}, active clients: "
                            f"{adm.get('active_clients')}</p>"
                            "<table border=1><tr><th>client</th>"
                            "<th>accepted</th><th>rate_limited</th>"
                            f"<th>shed</th></tr>{crows}</table>"
                            "<table border=1><tr><th>bucket</th>"
                            "<th>hits</th><th>pad_ratio</th></tr>"
                            f"{brows}</table>")
                        gen = serving.get("generate")
                        if gen:
                            # the generation rows:
                            # continuous-batching health — decode
                            # cadence, paged-pool occupancy, prefill/
                            # decode split — plus the prefix/paging row
                            # (shared pages, COW traffic, avoided work)
                            serving_html += (
                                f"<p>generation: active {gen['active']}, "
                                f"pending {gen['pending']}, KV pages "
                                f"{gen['pages_active']}/"
                                f"{gen['num_pages']} "
                                f"(leaked {gen['pages_leaked']}), "
                                f"inter-token p50 "
                                f"{gen['inter_token_p50_ms']} ms / p99 "
                                f"{gen['inter_token_p99_ms']} ms; "
                                f"tokens {gen['generated_tokens']} "
                                f"(prefill {gen['prefill_batches']} "
                                f"chunks / {gen['prefill_tokens']} "
                                f"tokens, decode {gen['decode_batches']} "
                                f"ticks / {gen['decode_tokens']} tokens), "
                                f"finished {gen['gen_finished']}, "
                                f"truncated {gen['gen_truncated']}, "
                                f"timed out {gen['gen_timed_out']}</p>"
                                f"<p>paging: page size {gen['page_size']}"
                                f", prefill chunk {gen['prefill_chunk']}"
                                f", prefix cache "
                                f"{'on' if gen['prefix_enabled'] else 'off'}"
                                f" ({gen['prefix_pages']} pages indexed, "
                                f"{gen['pages_shared']} shared, "
                                f"{gen['prefix_hits']} hits / "
                                f"{gen['prefix_misses']} misses, "
                                f"{gen['prefix_tokens_avoided']} prompt "
                                f"tokens avoided), "
                                f"COW copies {gen['cow_copies']}, "
                                f"on-device sampling "
                                f"{'on' if gen['on_device_sampling'] else 'off'}"
                                f" ({gen['fetch_bytes']} B fetched)</p>")
                            if "ttft_p50_ms" in gen:
                                # TTFT + queue-wait vs compute split
                                #: the user-facing latency
                                # decomposition per generation request
                                serving_html += (
                                    f"<p>TTFT p50 {gen['ttft_p50_ms']} ms"
                                    f" / p99 {gen['ttft_p99_ms']} ms "
                                    f"(queue-wait p50 "
                                    f"{gen['queue_wait_p50_ms']} ms / p99 "
                                    f"{gen['queue_wait_p99_ms']} ms, "
                                    f"compute p50 "
                                    f"{gen['compute_p50_ms']} ms / p99 "
                                    f"{gen['compute_p99_ms']} ms)</p>")
                        slow = serving.get("slow_requests")
                        if slow:
                            # slow-request exemplars: the N
                            # slowest requests of the window, named —
                            # a p99 regression with req/trace ids
                            xrows = "".join(
                                f"<tr><td>{html.escape(str(x['req_id']))}"
                                f"</td>"
                                f"<td>{html.escape(str(x.get('trace_id') or '-'))}</td>"
                                f"<td>{x['latency_ms']}</td>"
                                f"<td>{html.escape(str(x.get('bucket') or '-'))}</td>"
                                f"<td>{html.escape(str(x.get('kind') or '-'))}</td>"
                                f"<td>{html.escape(json.dumps(x.get('breakdown_ms')) if x.get('breakdown_ms') else '-')}</td></tr>"
                                for x in slow)
                            serving_html += (
                                "<h3>Slowest requests (window)</h3>"
                                "<table border=1><tr><th>req</th>"
                                "<th>trace</th><th>ms</th><th>bucket</th>"
                                "<th>kind</th><th>breakdown ms</th></tr>"
                                f"{xrows}</table>")
                    bal = snap.get("balancer")
                    if bal:
                        # the fleet panel: one row per
                        # replica — gen, p99 (top bucket), in-flight,
                        # last-heartbeat age, rotation state
                        led = bal["ledger"]
                        frows = "".join(
                            f"<tr><td>{html.escape(r['replica_id'])}"
                            f"{'' if r['in_rotation'] else ' (warming)'}"
                            f"{' (retiring)' if r.get('retiring') else ''}"
                            f"{' (healing)' if r.get('healing') else ''}"
                            f"</td><td>{'ready' if r['ready'] else 'NOT'}"
                            f"</td><td>{r['gen']}</td>"
                            # the mesh column: capacity-
                            # weighted dispatch divides load by this
                            f"<td>{html.escape('x'.join(str(v) for v in r['mesh'].values()) if r.get('mesh') else '1')}"
                            f" ({r.get('device_count', 1)}d)</td>"
                            # warm provenance: where this
                            # replica's executables came from + its
                            # boot-to-ready — the elasticity columns
                            f"<td>{html.escape(str(r.get('warm_source') or '-'))}"
                            f" {r.get('warm_hits', 0)}/"
                            f"{r.get('warm_misses', 0)}"
                            f"{' (%.2fs boot)' % r['boot_s'] if isinstance(r.get('boot_s'), (int, float)) else ''}"
                            f"</td>"
                            f"<td>{max(r['p99_ms_by_bucket'].values()) if r['p99_ms_by_bucket'] else '-'}"
                            f"</td><td>{r['in_flight']}</td>"
                            f"<td>{r['last_heartbeat_s']}s ago</td></tr>"
                            for r in bal["replicas"])
                        asc = bal.get("autoscale") or {}
                        asc_html = ""
                        if asc.get("enabled"):
                            # autoscale summary: band state
                            # + lifetime action counts
                            asc_html = (
                                f"<p>autoscale: {asc['servable']} "
                                f"servable (max {asc['max']}), pending "
                                f"spawns {asc['pending_spawns']}, "
                                f"retiring {asc['retiring']}, "
                                f"scale-ups {bal.get('scale_ups', 0)}, "
                                f"scale-downs "
                                f"{bal.get('scale_downs', 0)}</p>")
                        roll = bal.get("rollover")
                        roll_html = ""
                        if roll:
                            roll_html = (
                                f"<p>rollover: phase {roll['phase']} "
                                f"-> {html.escape(str(roll['path']))}, "
                                f"canary {roll['canary']}, samples "
                                f"{roll['canary_samples']}, parity "
                                f"mismatches "
                                f"{roll['parity_mismatches']}</p>")
                        serving_html += (
                            "<h2>Replica fleet "
                            f"{html.escape(str(bal['endpoint']))}</h2>"
                            f"<p>{'DEGRADED' if bal['degraded'] else 'ok'}"
                            f": {bal['ready_replicas']}/"
                            f"{bal['total_replicas']} ready "
                            f"(quorum {bal['min_replicas']}); ledger "
                            f"accepted {led['accepted']} = replied "
                            f"{led['replied']} + refused "
                            f"{led['refused']} + in-flight "
                            f"{led['in_flight']} "
                            f"({'BALANCED' if led['balanced'] else 'LEAK'})"
                            f"</p><p>failovers: {bal['failovers']}, "
                            f"hedges: {bal['hedges']} (wins "
                            f"{bal['hedge_wins']}), dups dropped: "
                            f"{bal['dup_replies_dropped']}, heals: "
                            f"{bal['heals']}, rollovers: "
                            f"{bal['rollovers']}, rollbacks: "
                            f"{bal['rollbacks']}, hedge delay: "
                            f"{bal['hedge_delay_ms']} ms</p>"
                            f"{asc_html}"
                            f"{roll_html}"
                            "<table border=1><tr><th>replica</th>"
                            "<th>ready</th><th>gen</th><th>mesh</th>"
                            "<th>warm (hit/miss)</th>"
                            "<th>p99 ms</th>"
                            "<th>in-flight</th><th>heartbeat</th></tr>"
                            f"{frows}</table>")
                    cli = snap.get("serving_client")
                    if cli:
                        serving_html += (
                            f"<p>client breaker: {cli['breaker']}, "
                            f"in flight: {cli['in_flight']}, resends: "
                            f"{cli['resends']}, give-ups: "
                            f"{cli['give_ups']}, opens: "
                            f"{cli['breaker_opens']}, short-circuits: "
                            f"{cli['breaker_short_circuits']}</p>")
                        rb = cli.get("replica_breakers") or {}
                        if rb:
                            serving_html += "<p>per-endpoint: " + ", ".join(
                                f"{html.escape(r)}={s['state']}"
                                f"({s['failures']}/{s['window']})"
                                for r, s in sorted(rb.items())) + "</p>"
                    # fleet observability panel: SLO
                    # error-budget state + the journal tail — the
                    # "why did the fleet do X" answer, on the page
                    from znicz_torch import telemetry

                    obs_html = ""
                    slo = telemetry.slo_snapshot()
                    if slo["planes"]:
                        orows = "".join(
                            f"<tr><td>{html.escape(plane)}</td>"
                            f"<td>{html.escape(name)}</td>"
                            f"<td>{o['target']}</td>"
                            f"<td>{'-' if o['fast_burn'] is None else round(o['fast_burn'], 3)}</td>"
                            f"<td>{'-' if o['slow_burn'] is None else round(o['slow_burn'], 3)}</td>"
                            f"<td>{round(o['budget_remaining'], 3)}</td>"
                            f"<td>{html.escape(o['state'])}</td></tr>"
                            for plane, p in sorted(slo["planes"].items())
                            for name, o in sorted(
                                p["objectives"].items()))
                        obs_html += (
                            f"<h2>SLOs ({html.escape(slo['state'])})</h2>"
                            "<table border=1><tr><th>plane</th>"
                            "<th>objective</th><th>target</th>"
                            "<th>fast burn</th><th>slow burn</th>"
                            "<th>budget left</th><th>state</th></tr>"
                            f"{orows}</table>")
                    tail = telemetry.journal().since(
                        max(0, telemetry.journal().last_seq - 10))
                    if tail:
                        erows = "".join(
                            f"<tr><td>{e['seq']}</td>"
                            f"<td>{html.escape(e['kind'])}</td>"
                            f"<td>{html.escape(e['plane'])}</td>"
                            f"<td>{html.escape(json.dumps({k: v for k, v in e.items() if k not in ('seq', 'ts', 'kind', 'plane', 'origin')}))}"
                            f"</td></tr>"
                            for e in reversed(tail))
                        obs_html += (
                            "<h2>Event journal (latest)</h2>"
                            "<table border=1><tr><th>seq</th>"
                            "<th>kind</th><th>plane</th><th>fields</th>"
                            f"</tr>{erows}</table>")
                    devs = snap["devices"]
                    dev_text = (f"unavailable — {devs['error']}"
                                if isinstance(devs, dict)
                                else ", ".join(
                                    f"cuda:{d['index']} {d['name']} "
                                    f"({d['mem_free'] >> 20}/"
                                    f"{d['mem_total'] >> 20} MiB free)"
                                    for d in devs))
                    body = (
                        "<html><head><meta http-equiv='refresh' content='2'>"
                        "<title>znicz-torch status</title></head><body>"
                        f"<h2>Devices</h2><p>{html.escape(dev_text)}</p>"
                        "<h2>Workflows</h2><table border=1>"
                        "<tr><th>name</th><th>epoch</th><th>best</th>"
                        f"<th>state</th></tr>{rows}</table>"
                        f"{master_html}{relays_html}{serving_html}"
                        f"{obs_html}"
                        "<p><a href='/metrics'>/metrics</a> "
                        "<a href='/trace.json'>/trace.json</a> "
                        "<a href='/trace.json?fleet=1'>?fleet=1</a> "
                        "<a href='/events.json'>/events.json</a> "
                        "<a href='/slo.json'>/slo.json</a> "
                        "<a href='/fleet.json'>/fleet.json</a> "
                        "<a href='/status.json'>/status.json</a> "
                        "<a href='/healthz'>/healthz</a> "
                        "<a href='/readyz'>/readyz</a></p>"
                        "</body></html>").encode()
                    ctype = "text/html"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def start(self) -> "WebStatus":
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]   # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
