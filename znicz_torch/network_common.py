"""The master/slave handshake and the ZMQ socket conventions shared by
every plane of the port (port of ``znicz_tpu/network_common.py``).

A slave's first message is ``register`` (:func:`handshake_request`): the
protocol version and the digest of its built graph
(:func:`workflow_digest`).  The master refuses a peer of another
protocol revision or another trainable graph with a readable reason
(:func:`check_handshake`) instead of mixing its gradients into the
weights.  The digest is the reference's, byte for byte: a port slave
registers with a reference master of the same config, and back.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Optional

#: the job/update message schema's revision (the reference's: v3 is the
#: multipart tensor-frame wire of ``parallel/wire.py``)
PROTOCOL_VERSION = 3

#: structural attributes that define a unit's computation beyond its
#: parameter shapes: conv/pool geometry, dropout rate, LRN constants
_UNIT_STRUCT_ATTRS = ("kx", "ky", "sliding", "padding", "n_kernels",
                      "dropout_ratio", "alpha", "beta", "n", "k",
                      "output_sample_shape", "heads", "head_dim", "causal",
                      "weights_transposed")


def whole_shape(f, key: str, t) -> tuple:
    """The whole shape of parameter ``key`` of module ``f``: on a mesh, a
    column-sharded leaf holds its rank's rows, ``1 / mp`` of them."""
    from znicz_torch.parallel import mesh as mesh_mod

    shape = tuple(t.shape)
    place = mesh_mod.placement_of(f)
    if place is not None and place.specs.get(key):
        shape = (shape[0] * mesh_mod.axis_size(place.mesh, "model"),) \
            + shape[1:]
    return shape


def _unit_fingerprint(f, batch: int) -> list:
    """A forward module's computational identity: its name and class, its
    input and output shapes at ``batch`` rows (the reference's unit
    Arrays carry the loader's minibatch rows), its structural attributes
    and, for a weighted module, its parameter shapes (whole on a mesh, as
    the reference's sharded arrays have their global shapes)."""
    from znicz_torch.nn_units import params_of

    attrs = []
    for a in _UNIT_STRUCT_ATTRS:
        v = getattr(f, a, None)
        if v is not None:
            attrs.append([a, list(v) if isinstance(v, (tuple, list))
                          else v])
    shapes = sorted((k, list(whole_shape(f, k, t)))
                    for k, t in params_of(f).items())
    io = None
    if f.in_shape:
        out = f.output_shape_for(f.in_shape)
        io = [[batch] + list(f.in_shape[1:]), [batch] + list(out[1:])]
    return [f.name, type(f).__name__, io or [None, None], attrs, shapes]


def _gd_hypers(gd) -> tuple:
    """A GD unit's configured hyperparameters, frozen when it was
    initialised (a ``lr_adjust`` schedule rewrites the live ones)."""
    hypers = getattr(gd, "initial_hypers", None)
    if hypers is None:
        hypers = tuple(float(v) for v in gd.hypers())
    return hypers


def workflow_digest(workflow) -> str:
    """A short digest of the built graph, the contract for shipping
    weights and deltas between peers: every forward module's class, IO
    shapes, structural attributes and parameter shapes, and each
    weighted layer's GD hyperparameters, in the reference's order (the
    GD chain from the last layer).  Not a digest of the config tree,
    which carries host-local paths."""
    loader = getattr(workflow, "loader", None)
    batch = int(getattr(loader, "max_minibatch_size", 1) or 1)
    desc = [_unit_fingerprint(f, batch) for f in workflow.forwards]
    chain = getattr(workflow, "gd_units", None)
    if chain is None:
        chain = list(getattr(workflow, "gds", {}).values())
    for gd in chain:
        if gd.forward.has_weights:
            desc.append([gd.forward.name, type(gd).__name__,
                         [round(float(v), 12) for v in _gd_hypers(gd)]])
    blob = json.dumps(desc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def handshake_request(workflow, mesh=None) -> dict:
    """The slave's first message (``register``).  ``mesh`` (a meshed
    slave's ``{"data": dp, "model": mp}``) rides along when given; the
    master validates only the version and the digest."""
    req = {"cmd": "register", "version": PROTOCOL_VERSION,
           "workflow_digest": workflow_digest(workflow)}
    if mesh:
        req["mesh"] = dict(mesh)
    return req


def check_handshake(req: dict, workflow) -> Optional[str]:
    """The master's validation of a register request: the refusal's
    reason, or None for a compatible peer."""
    v = req.get("version")
    if v != PROTOCOL_VERSION:
        hint = (" — v2 speaks the single-frame pickle wire; upgrade the "
                "slave to the v3 multipart tensor-frame wire"
                if v == 2 else "")
        return (f"protocol version mismatch: master speaks "
                f"{PROTOCOL_VERSION}, slave sent {v!r}{hint}")
    theirs = req.get("workflow_digest")
    mine = workflow_digest(workflow)
    if theirs != mine:
        return (f"workflow digest mismatch: master runs {mine}, "
                f"slave runs {theirs!r} — same trainable graph "
                f"(layer names/shapes/hyperparameters) required")
    return None


def bind_with_retry(sock, endpoint: str, attempts: int = 40,
                    delay_s: float = 0.05) -> None:
    """Bind a ZMQ socket, retrying only the EADDRINUSE race a restarted
    peer has with its predecessor's port release; any other bind error is
    permanent and raises at once."""
    import zmq

    for attempt in range(attempts):
        try:
            sock.bind(endpoint)
            return
        except zmq.error.ZMQError as exc:
            if exc.errno != zmq.EADDRINUSE or attempt == attempts - 1:
                raise
            time.sleep(delay_s)


def make_poller(*sockets):
    """A ``zmq.Poller`` with every socket registered POLLIN (the
    transport loop's registration convention)."""
    import zmq

    poller = zmq.Poller()
    for sock in sockets:
        poller.register(sock, zmq.POLLIN)
    return poller


def is_loopback_host(host: str) -> bool:
    """The loopback guard for services that take pickled payloads."""
    return host in ("127.0.0.1", "localhost", "::1", "0.0.0.0")
