"""Train or serve a sample workflow (port of the sample-run and serving
paths of ``znicz_tpu/launcher.py``):

    python -m znicz_torch {alexnet,mnist,cifar,mnist_ae,kohonen,wine,
                           kanji,video_ae,yale_faces,charlm}
                          [root.x.y=value ...]
                          [--device cpu] [--seed N] [--fused] [--fitness]
                          [--snapshot PATH]
                          [--serve [BIND]] [--replica-id ID]
                          [--announce EP] [--aot-cache [DIR]] [--generate]
                          [--master [BIND]] [--master-resume FILE]
                          [--min-slaves N] [--staleness-bound S]
                          [--slave EP] [--mesh-data N] [--mesh-model N]
    python -m znicz_torch --balance [BIND] [--replicas EP[,EP]]
                          [--min-replicas N] [--autoscale-max N
                          --spawn-cmd CMD] [root.x.y=value ...]
    python -m znicz_torch --relay UPSTREAM[:BIND] [--tree-fanout N]
                          [root.x.y=value ...]
    python -m znicz_torch --plan-tree N [--tree-fanout N] [--master EP]

Dotted overrides are applied to the port's config tree before the sample
module is imported, so its defaults do not clobber them.  The sample's
``run(device)`` trains on ``cuda:0`` unless ``--device`` names another
device; without a GPU it raises.  MNIST, CIFAR10, Wine, Kanji, VideoAE,
YaleFaces and charlm train on the unit engine unless ``--fused``
(``root.common.engine.fused``) asks for ``FusedTrainer``; AlexNet trains
on ``FusedTrainer``, as the reference's sample does; MnistAE (tied
weights) and Kohonen (no GD chain) train on the unit engine always.
YaleFaces writes its PNG tree under ``root.yale_faces.loader.data_dir``
first, unless it is there.  ``--snapshot`` resumes a sample that takes
one (all but AlexNet and Kohonen) from a snapshot file.  The last line of
the output is one JSON object with the run's finals under the names
``bench.py`` gives them: ``final_train_loss`` and ``valid_err_pct`` for
the classifiers (charlm adds ``valid_token_err_pct``, the VALID error
over tokens), ``final_train_mse`` and ``valid_mse`` for the
autoencoders (MnistAE, VideoAE), ``final_qerror`` and ``first_qerror``
for Kohonen; ``compute_dtype`` is
the dtype the train steps computed in.  ``--fitness`` adds one JSON line
after it, ``{"genetics_fitness": x}`` (the Decision's best metric, or
Kohonen's last quantisation error), the line the genetic search's
``genetics.SubprocessEvaluator`` reads; a run with no finite fitness
exits 3.  The precision knobs are dotted
overrides, as in the reference: ``root.common.engine.compute_dtype=bf16``
(or ``precision``), ``state_dtype=bfloat16`` and
``master_dtype=bfloat16`` (``FusedTrainer`` only).

``--serve [BIND]`` (default ``tcp://*:5580``) builds the sample's
workflow without training it (AlexNet's ``serving_workflow``: no
loader) and serves its forward over ZMQ (``serving.InferenceServer``):
``--snapshot`` is then the served snapshot, ``--replica-id`` the id each
reply is stamped with, ``root.common.serving.*`` the service's knobs, and
``root.common.serving.max_requests`` ends the run (exit 0) once that many
requests were answered.  It prints ``serving <workflow> at <endpoint>``
with the resolved endpoint (so a wildcard port can be found); SIGHUP
starts a rollover to the ``--snapshot`` file.  ``--announce EP``
heartbeats the replica into the balancer at ``EP``.  ``--fused`` is a
training flag: with ``--serve`` the run exits 2.

``--aot-cache [DIR]`` (with ``--serve``) arms the kernel-library cache
(``root.common.serving.aot_cache.enabled``; ``DIR`` sets its ``dir``,
default ``aot_cache/`` beside the ``--snapshot``): a restarted replica
loads its kernel libraries instead of compiling them
(``serving/aot_cache.py``).

``--generate`` (with ``--serve``) also speaks the ``generate`` request
kind (``root.common.serving.generate.enabled``): autoregressive
generation over a paged KV pool with prefix reuse, chunked prefill and
in-graph sampling, for a sequence sample (charlm); its knobs are
``root.common.serving.generate.*``.

``--master [BIND]`` (default ``tcp://127.0.0.1:*``) serves the sample's
job stream as the asynchronous parameter-server master
(``server.Server``) instead of training locally and prints ``master
serving <workflow> at <endpoint>``; ``--master-resume FILE`` implies it
and keeps a crash-resume file, restored when it exists; ``--min-slaves
N`` is its quorum.  ``--slave EP`` works for the master at ``EP``: with
``--fused`` (AlexNet: always) on ``FusedTrainer`` (``client.FusedClient``),
else on the unit engine (``client.Client``).  ``--master`` and
``--slave`` exclude each other, ``--serve`` and ``--balance``; a
``--slave`` with ``--master-resume`` exits 2.

``--relay UPSTREAM[:BIND]`` runs one relay of the aggregation tree
(``parallel.relay.Relay``) and builds no workflow: it accepts slaves and
lower relays at BIND (default ``tcp://*:5571``; a bare port means
``tcp://*:PORT``), checks and sums their deltas and sends one combined
update to UPSTREAM, until the upstream reports training done.  It prints
``relay <id>: children at <endpoint> -> upstream <UPSTREAM> ...`` with
the resolved endpoint.  ``--tree-fanout N``
(``root.common.engine.tree_fanout``) is its flush threshold and job-batch
factor.  ``--plan-tree N`` prints, as one JSON document, the relay tiers
a fleet of N slaves needs at the fanout (``parallel.relay.plan_tree``):
the relays top tier first, each slave's endpoint and ``relay_args``, the
``--relay`` spec of each relay; the master is ``--master EP`` (default
``root.common.engine.master_bind`` on 127.0.0.1).  ``--relay`` excludes
``--master``, ``--slave``, ``--serve`` and ``--balance``.
``--staleness-bound S`` (``root.common.engine.staleness_bound``) makes
the master refuse and re-queue a delta more than S applies old.

``--mesh-data N`` and ``--mesh-model M`` make the ``--slave`` a meshed
slave (``root.common.engine.train_shard`` and ``mesh.data``/``model``)
and the ``--serve`` replica a serving mesh (``root.common.serving.mesh``).
A mesh of more than one rank runs one process a rank under ``torchrun``
(``torchrun --nproc-per-node N*M -m znicz_torch ...``): each rank joins
its group from ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK`` (``parallel.mesh.distributed_init``; gloo on the CPU and where
ranks share a card); started without them the run exits 2.  Rank 0 talks
to the master (or serves), and the other ranks follow it.

``--balance [BIND]`` (default ``tcp://*:5590``) runs the replica balancer
(``serving.ReplicaBalancer``) and builds no workflow: a workflow argument
exits 2, as ``--serve`` or ``--fused`` beside it does.  ``--replicas``
lists static replica endpoints to pre-connect (membership still comes
from heartbeats), ``--min-replicas`` is the readiness quorum
(``root.common.serving.balance.min_replicas``), and ``--autoscale-max N``
with ``--spawn-cmd CMD`` arms the autoscaler, which starts replica
processes with ``CMD`` (``{announce}`` and ``{replica_id}`` substituted)
and ends the ones it started.  It prints ``balancing at <endpoint> ...``
with the resolved endpoint, and ends (exit 0) once
``root.common.serving.max_requests`` requests were answered, with one
JSON line of the balancer's ledger and counters.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import logging
import math
import os
import re
import signal
import sys
import threading

from znicz_torch.core import prng
from znicz_torch.core.config import apply_overrides, root

SAMPLES = ("alexnet", "mnist", "cifar", "mnist_ae", "kohonen", "wine",
           "kanji", "video_ae", "yale_faces", "charlm")
#: the samples trained on an MSE loss, whose finals are mean squared errors
AUTOENCODERS = ("mnist_ae", "video_ae")


def finals(sample: str, wf) -> dict:
    """The run's last-epoch finals, as ``bench.py`` names them."""
    d = wf.decision
    if sample == "kohonen":
        return {"epochs": len(d.epoch_qerror),
                "final_qerror": d.epoch_qerror[-1],
                "first_qerror": d.epoch_qerror[0]}
    train, valid = d.epoch_metrics[2] or {}, d.epoch_metrics[1] or {}
    if sample in AUTOENCODERS:
        return {"epochs": int(d.epoch_number) + 1,
                "final_train_mse": train.get("loss"),
                "valid_mse": valid.get("loss")}
    out = {"epochs": int(d.epoch_number) + 1,
           "valid_err_pct": valid.get("err_pct"),
           "train_loss": train.get("loss"),
           "final_train_loss": train.get("loss")}
    if sample == "charlm":
        # the Decision counts wrong TOKENS against samples: the token
        # error is over the VALID samples' tokens
        tokens = wf.loader.class_lengths[1] * wf.sample_shape[0]
        out["valid_token_err_pct"] = (
            None if not valid or not tokens
            else 100.0 * valid["n_err"] / tokens)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m znicz_torch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("workflow", nargs="?",
                    help=f"the sample: one of {', '.join(SAMPLES)} (none "
                         f"with --balance)")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides, root.a.b=value")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--seed", type=int, default=None,
                    help="global seed of the named random streams")
    ap.add_argument("--fused", action="store_true",
                    help="train with FusedTrainer instead of the "
                         "unit-at-a-time engine")
    ap.add_argument("--snapshot", default="",
                    help="resume from a snapshot file (with --serve: the "
                         "served snapshot)")
    ap.add_argument("--serve", nargs="?", const="tcp://*:5580",
                    default=None, metavar="BIND",
                    help="serve the workflow's forward over ZMQ instead "
                         "of training (default bind tcp://*:5580)")
    ap.add_argument("--replica-id", default=None,
                    help="with --serve: the id stamped on every reply")
    ap.add_argument("--announce", default=None, metavar="EP",
                    help="with --serve: heartbeat this replica into the "
                         "balancer at EP")
    ap.add_argument("--aot-cache", nargs="?", const="auto", default=None,
                    metavar="DIR",
                    help="with --serve: load the kernel libraries from the "
                         "cache in DIR (default aot_cache/ beside the "
                         "snapshot) and store the ones built")
    ap.add_argument("--generate", action="store_true",
                    help="with --serve: also speak the 'generate' request "
                         "kind (root.common.serving.generate.enabled; "
                         "knobs: root.common.serving.generate.*)")
    ap.add_argument("--master", nargs="?", const="tcp://127.0.0.1:*",
                    default=None, metavar="BIND",
                    help="serve this workflow as the asynchronous "
                         "parameter-server master instead of training "
                         "locally (default bind tcp://127.0.0.1:*)")
    ap.add_argument("--slave", default=None, metavar="EP",
                    help="work for the master at EP")
    ap.add_argument("--master-resume", default="", metavar="FILE",
                    help="the master's crash-resume file: restored when it "
                         "exists, kept up to date while serving (implies "
                         "--master)")
    ap.add_argument("--min-slaves", type=int, default=None, metavar="N",
                    help="the master's quorum (root.common.engine."
                         "min_slaves): below N live slaves dispatch "
                         "pauses")
    ap.add_argument("--staleness-bound", type=int, default=None,
                    metavar="S",
                    help="the master's bounded staleness (root.common."
                         "engine.staleness_bound): refuse and re-queue a "
                         "delta more than S applies old; 0: unbounded")
    ap.add_argument("--relay", default=None, metavar="UPSTREAM[:BIND]",
                    help="run a relay of the aggregation tree: accept "
                         "slaves and relays at BIND (default tcp://*:5571; "
                         "a bare port means tcp://*:PORT), sum their deltas "
                         "and send one update to UPSTREAM; takes no "
                         "workflow argument")
    ap.add_argument("--tree-fanout", type=int, default=None, metavar="N",
                    help="children per relay (root.common.engine."
                         "tree_fanout, default 2): the flush threshold and "
                         "the job-batch factor")
    ap.add_argument("--plan-tree", type=int, default=None,
                    metavar="N_SLAVES",
                    help="print the relay tree N_SLAVES slaves need at "
                         "--tree-fanout (relays, endpoints, --relay specs) "
                         "and exit")
    ap.add_argument("--mesh-data", type=int, default=None, metavar="N",
                    help="with --slave: a meshed slave's data axis "
                         "(root.common.engine.mesh.data, train_shard on); "
                         "with --serve: the serving mesh's "
                         "(root.common.serving.mesh.data); one process a "
                         "rank under torchrun")
    ap.add_argument("--mesh-model", type=int, default=None, metavar="N",
                    help="the mesh's model axis (engine.mesh.model with "
                         "--slave, serving.mesh.model with --serve): wide "
                         "FC layers split by rows over N ranks")
    ap.add_argument("--balance", nargs="?", const="tcp://*:5590",
                    default=None, metavar="BIND",
                    help="run the replica balancer at BIND (default "
                         "tcp://*:5590) over the replicas that --announce "
                         "into it; takes no workflow argument")
    ap.add_argument("--replicas", default="", metavar="EP[,EP]",
                    help="with --balance: static replica endpoints to "
                         "pre-connect")
    ap.add_argument("--min-replicas", type=int, default=None, metavar="N",
                    help="with --balance: the readiness quorum "
                         "(root.common.serving.balance.min_replicas)")
    ap.add_argument("--autoscale-max", type=int, default=None, metavar="N",
                    help="with --balance and --spawn-cmd: arm the "
                         "autoscaler, never past N replicas")
    ap.add_argument("--spawn-cmd", default="", metavar="CMD",
                    help="with --autoscale-max: a command that starts one "
                         "replica announcing to this balancer; {announce} "
                         "and {replica_id} are substituted")
    ap.add_argument("--fitness", action="store_true",
                    help="after the run, print a last JSON line with its "
                         "fitness (genetics.SubprocessEvaluator reads it)")
    # intermixed: overrides may follow the options on every Python 3.12
    # (older argparse leaves a "*" positional empty once an option has
    # come between it and the sample's name)
    args = ap.parse_intermixed_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    training_role = (args.master is not None or args.slave is not None
                     or bool(args.master_resume))
    if args.tree_fanout is not None:
        root.common.engine.tree_fanout = int(args.tree_fanout)
    if args.staleness_bound is not None:
        root.common.engine.staleness_bound = int(args.staleness_bound)
    if args.plan_tree is not None:
        return plan(args)
    if args.balance is not None:
        if args.serve is not None or args.fused or training_role \
                or args.relay is not None:
            print("error: --balance is exclusive of --serve, --relay, of "
                  "the master/slave roles and of the training flag --fused",
                  file=sys.stderr)
            return 2
        return balance(args)
    if args.relay is not None:
        if args.serve is not None or args.fused or training_role:
            print("error: --relay is mutually exclusive with the "
                  "master/slave/serve roles and the training flag --fused",
                  file=sys.stderr)
            return 2
        return relay(args)
    if args.workflow not in SAMPLES:
        ap.error(f"the sample must be one of {', '.join(SAMPLES)}; got "
                 f"{args.workflow!r}")
    if args.serve is not None and args.fused:
        print("error: --serve is exclusive of the training flag --fused",
              file=sys.stderr)
        return 2
    if args.announce and args.serve is None:
        print("error: --announce needs --serve", file=sys.stderr)
        return 2
    if args.aot_cache is not None and args.serve is None:
        print("error: --aot-cache needs --serve", file=sys.stderr)
        return 2
    if args.generate and args.serve is None:
        print("error: --generate needs --serve", file=sys.stderr)
        return 2
    if args.master is not None and args.slave is not None:
        print("error: --master and --slave are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.serve is not None and training_role:
        print("error: --serve is mutually exclusive with the master/slave "
              "training roles", file=sys.stderr)
        return 2
    if args.master_resume:
        if args.slave is not None:
            print("error: --master-resume applies to the master role",
                  file=sys.stderr)
            return 2
        root.common.engine.master_resume = args.master_resume
        if args.master is None:
            args.master = "tcp://127.0.0.1:*"       # implies --master
    if args.master is not None:
        root.common.engine.mode = "master"
        root.common.engine.master_bind = args.master
    elif args.slave is not None:
        root.common.engine.mode = "slave"
        root.common.engine.slave_endpoint = args.slave
    if args.min_slaves is not None:
        root.common.engine.min_slaves = int(args.min_slaves)
    meshed = args.mesh_data is not None or args.mesh_model is not None
    if meshed and args.slave is None and args.serve is None:
        print("error: --mesh-data and --mesh-model apply to --slave and "
              "--serve", file=sys.stderr)
        return 2
    if meshed:
        tree = (root.common.engine.mesh if args.slave is not None
                else root.common.serving.mesh)
        if args.slave is not None:
            root.common.engine.train_shard = True
        if args.mesh_data is not None:
            tree.data = int(args.mesh_data)
        if args.mesh_model is not None:
            tree.model = int(args.mesh_model)
    if args.aot_cache is not None:
        root.common.serving.aot_cache.enabled = True
        if args.aot_cache != "auto":
            root.common.serving.aot_cache.dir = str(args.aot_cache)
    if args.generate:
        root.common.serving.generate.enabled = True
    if args.overrides:
        apply_overrides(root, args.overrides)
    if args.fused:
        root.common.engine.fused = True
    if args.seed is not None:
        prng.seed_all(args.seed)
    if meshed:
        tree = (root.common.engine.mesh if args.slave is not None
                else root.common.serving.mesh)
        code = join_group(int(tree.get("data", 1)) * int(tree.get("model", 1)),
                          args.device)
        if code:
            return code
    mod = importlib.import_module(f"znicz_torch.samples.{args.workflow}")
    if args.serve is not None:
        return serve(mod, args)
    kwargs = {}
    if args.snapshot:
        if "snapshot" not in inspect.signature(mod.run).parameters:
            ap.error(f"{args.workflow} does not resume from a snapshot")
        kwargs["snapshot"] = args.snapshot
    wf = mod.run(device=args.device, **kwargs)
    stats = wf.train_stats
    # the fused trainer, when it ran (the SOM's own unit is named trainer
    # too, and has no compute_dtype)
    trainer = getattr(wf, "trainer", None)
    dtype = getattr(trainer, "compute_dtype", None)
    deep = trainer.stats["deep_epochs"] if dtype is not None else 0
    print(json.dumps({
        "workflow": args.workflow, "device": str(wf.device),
        **finals(args.workflow, wf),
        "train_steps": stats["train_steps"],
        "img_per_sec": stats["img_per_sec"],
        "warm_img_per_sec": stats["warm_img_per_sec"],
        # the epochs the deep pipeline queued, when it ran
        **({"deep_epochs": deep} if deep else {}),
        # the unit engine computes in float32 whatever compute_dtype says,
        # as the reference's does
        "compute_dtype": (str(dtype).split(".")[-1]
                          if dtype is not None else "float32")}))
    if args.fitness:
        return print_fitness(wf)
    return 0


def print_fitness(wf) -> int:
    """``--fitness``: print ``{"genetics_fitness": x}``, x the Decision's
    ``best_metric`` or else its last ``epoch_qerror``, and return 0; with
    no finite fitness (no epoch ever improved) write why on stderr and
    return 3, printing no fitness (JSON has no Infinity)."""
    decision = getattr(wf, "decision", None)
    fit = getattr(decision, "best_metric", None)
    if fit is None and getattr(decision, "epoch_qerror", None):
        fit = decision.epoch_qerror[-1]
    if fit is None or not math.isfinite(float(fit)):
        print("error: workflow exposes no finite fitness "
              "(decision.best_metric / epoch_qerror)", file=sys.stderr)
        return 3
    print(json.dumps({"genetics_fitness": float(fit)}), flush=True)
    return 0


#: what a rank of a mesh reads from ``torchrun``'s environment
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def join_group(world: int, device) -> int:
    """Join this process to a mesh of ``world`` ranks from ``torchrun``'s
    environment (``parallel.mesh.distributed_init``); 0 when joined or
    when one rank needs no group, 2 with a message when the environment
    is missing or names another world size.  Ranks on the CPU, or more
    ranks than cards, take gloo."""
    if world <= 1:
        return 0
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing or int(os.environ["WORLD_SIZE"]) != world:
        print(f"error: a mesh of {world} ranks runs one process a rank "
              f"under torchrun (torchrun --nproc-per-node {world} -m "
              f"znicz_torch ...), which sets {', '.join(TORCHRUN_ENV)}; "
              + (f"missing {', '.join(missing)}" if missing else
                 f"WORLD_SIZE is {os.environ['WORLD_SIZE']}"),
              file=sys.stderr)
        return 2
    import torch

    from znicz_torch.parallel.mesh import distributed_init

    cpu = device is not None and torch.device(device).type == "cpu"
    shared = cpu or world > max(torch.cuda.device_count(), 1)
    distributed_init(f"{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}", world,
                     int(os.environ["RANK"]),
                     backend="gloo" if shared else None,
                     device="cpu" if cpu else device)
    return 0


def plan(args) -> int:
    """``--plan-tree N``: print the relay tiers a fleet of N slaves needs
    at the fanout, as one JSON document: the relays (top tier first, so
    starting them in order brings the tree up parents first), each
    slave's endpoint, and ``relay_args``, the ``--relay`` spec of each
    relay."""
    from znicz_torch.parallel.relay import plan_tree

    master = args.master or str(root.common.engine.get("master_bind",
                                                       "tcp://*:5570"))
    m = re.match(r"^(\w+)://([^:/]+):(\d+)$", master)
    if m is None:
        print(f"error: --plan-tree needs the master's endpoint with its "
              f"port (--master tcp://HOST:PORT), not {master!r}",
              file=sys.stderr)
        return 2
    if m.group(2) == "*":
        master = f"{m.group(1)}://127.0.0.1:{m.group(3)}"
    try:
        tree = plan_tree(int(args.plan_tree),
                         int(root.common.engine.get("tree_fanout", 2)),
                         master)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    tree["master"] = master
    tree["relay_args"] = [f"{r['upstream']}:{r['bind']}"
                          for r in tree["relays"]]
    print(json.dumps(tree, indent=2), flush=True)
    return 0


def relay(args) -> int:
    """``--relay UPSTREAM[:BIND]``: run one relay until its upstream
    reports training done, or until interrupted.  No workflow is built:
    the relay checks its children by passing the first handshake
    upstream."""
    from znicz_torch.parallel.relay import Relay, parse_relay_spec

    args_in = ([args.workflow] if args.workflow else []) \
        + list(args.overrides)
    stray = [a for a in args_in if "=" not in a]
    if stray:
        print(f"error: --relay takes no workflow argument (got {stray})",
              file=sys.stderr)
        return 2
    if args_in:
        apply_overrides(root, args_in)
    try:
        upstream, bind = parse_relay_spec(args.relay)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    node = Relay(upstream, bind).start()
    print(f"relay {node.relay_id}: children at {node.endpoint} -> upstream "
          f"{upstream} (fanout {node.fanout}, wire {node.wire_dtype})",
          flush=True)
    try:
        node.join()
    except KeyboardInterrupt:
        node.stop()
    print(json.dumps({k: v for k, v in node.stats().items()
                      if k != "children"}), flush=True)
    return 0


def serving_workflow(mod, device):
    """The sample module's workflow, built for serving and not trained:
    its ``serving_workflow(device)`` where it has one, else the one
    ``Workflow`` subclass it defines."""
    if hasattr(mod, "serving_workflow"):
        return mod.serving_workflow(device)
    from znicz_torch.core.workflow import Workflow

    classes = [v for v in vars(mod).values()
               if isinstance(v, type) and issubclass(v, Workflow)
               and v.__module__ == mod.__name__]
    if len(classes) != 1:
        raise ValueError(f"--serve needs exactly one Workflow subclass in "
                         f"{mod.__name__}; found "
                         f"{[c.__name__ for c in classes] or 'none'}")
    return classes[0](device=device)


def serve(mod, args) -> int:
    """``--serve``: serve the sample's forward until interrupted or until
    ``root.common.serving.max_requests`` requests were answered."""
    from znicz_torch.parallel.mesh import process_index
    from znicz_torch.serving import InferenceServer
    from znicz_torch.serving.model import ModelRunner

    wf = serving_workflow(mod, args.device)
    if process_index() != 0:
        # a rank of a serving mesh other than 0 takes rank 0's steps
        ModelRunner(wf, snapshot=args.snapshot).follow()
        return 0
    max_requests = root.common.serving.get("max_requests", None)
    server = InferenceServer(
        wf, bind=args.serve, snapshot=args.snapshot,
        max_requests=None if max_requests is None else int(max_requests),
        replica_id=args.replica_id, announce=args.announce)
    server.start()
    print(f"serving {args.workflow} at {server.endpoint} (snapshot: "
          f"{args.snapshot or 'fresh init'}, device {wf.device})",
          flush=True)
    # a rollover to --snapshot on SIGHUP (new weights land at the same
    # path); signals can be wired from the main thread only
    if args.snapshot and hasattr(signal, "SIGHUP") \
            and threading.current_thread() is threading.main_thread():
        def rollover(signum, frame):
            try:
                server.swap_async(args.snapshot)
                print(f"SIGHUP: snapshot rollover from {args.snapshot} "
                      f"started", flush=True)
            except RuntimeError as exc:         # a swap already runs
                print(f"SIGHUP ignored: {exc}", flush=True)

        signal.signal(signal.SIGHUP, rollover)
    try:
        server.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    if server.error is not None:
        print(f"error: the compute loop died: {server.error!r}",
              file=sys.stderr)
        return 1
    stats = server.stats()
    print(json.dumps({"workflow": args.workflow, "device": str(wf.device),
                      "endpoint": server.endpoint,
                      **{k: stats[k] for k in (
                          "requests_in", "served", "rejected", "timed_out",
                          "bad_frames", "generation")}}), flush=True)
    return 0


def balance(args) -> int:
    """``--balance``: run the replica balancer until interrupted or until
    ``root.common.serving.max_requests`` requests were answered.  No
    workflow is built: the balancer moves frames, never arrays."""
    import shlex
    import subprocess
    import time

    from znicz_torch.serving import ReplicaBalancer

    # with no workflow, dotted overrides land in the workflow's slot too
    args_in = ([args.workflow] if args.workflow else []) \
        + list(args.overrides)
    stray = [a for a in args_in if "=" not in a]
    if stray:
        print(f"error: --balance takes no workflow argument (got "
              f"{stray})", file=sys.stderr)
        return 2
    if args_in:
        apply_overrides(root, args_in)
    if args.min_replicas is not None:
        root.common.serving.balance.min_replicas = int(args.min_replicas)
    replicas = tuple(ep.strip() for ep in args.replicas.split(",")
                     if ep.strip())
    max_requests = root.common.serving.get("max_requests", None)
    balancer = ReplicaBalancer(
        bind=args.balance, replicas=replicas,
        max_requests=None if max_requests is None else int(max_requests))
    balancer.start()
    static = ", ".join(replicas) if replicas \
        else "none — awaiting --announce heartbeats"
    print(f"balancing at {balancer.endpoint} (static replicas: {static}; "
          f"quorum {balancer.min_replicas})", flush=True)
    # the autoscaler starts and ends replica processes with --spawn-cmd;
    # it ends only the processes it started (the initial fleet is the
    # operator's)
    procs = {}
    plock = threading.Lock()
    if args.autoscale_max is not None and args.spawn_cmd:
        seq = [0]

        def spawn() -> None:
            with plock:
                seq[0] += 1
                rid = f"scale-{seq[0]}"
            cmd = args.spawn_cmd.format(announce=balancer.endpoint,
                                        replica_id=rid)
            proc = subprocess.Popen(shlex.split(cmd))
            with plock:
                procs[rid] = proc
            print(f"autoscale: spawned {rid} (pid {proc.pid})", flush=True)

        def retire(replica_id: str) -> None:
            with plock:
                proc = procs.pop(replica_id, None)
            if proc is None:
                print(f"autoscale: {replica_id} was not spawned here — "
                      f"drained only, not ended", flush=True)
                return
            proc.terminate()
            proc.wait(60)
            print(f"autoscale: retired {replica_id}", flush=True)

        balancer.enable_autoscale(spawn, retire,
                                  autoscale_max=int(args.autoscale_max))
        print(f"autoscaling up to {int(args.autoscale_max)} replicas via: "
              f"{args.spawn_cmd}", flush=True)
    try:
        while balancer.alive():
            if balancer.max_requests is not None and \
                    balancer.replied + balancer.refused \
                    >= balancer.max_requests:
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        balancer.stop()
        with plock:
            spawned = list(procs.values())
        for proc in spawned:            # spawned replicas end with us
            proc.terminate()
            proc.wait(60)
    stats = balancer.stats()
    print(json.dumps({"endpoint": balancer.endpoint,
                      "ledger": stats["ledger"],
                      **{k: stats[k] for k in ReplicaBalancer.COUNTERS}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
