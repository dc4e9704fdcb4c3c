"""Train or serve a sample workflow (port of the sample-run and serving
paths of ``znicz_tpu/launcher.py``):

    python -m znicz_torch {alexnet,mnist,cifar,mnist_ae,kohonen,wine,
                           kanji,video_ae,yale_faces}
                          [root.x.y=value ...]
                          [--device cpu] [--seed N] [--fused]
                          [--snapshot PATH]
                          [--serve [BIND]] [--replica-id ID]

Dotted overrides are applied to the port's config tree before the sample
module is imported, so its defaults do not clobber them.  The sample's
``run(device)`` trains on ``cuda:0`` unless ``--device`` names another
device; without a GPU it raises.  MNIST, CIFAR10, Wine, Kanji, VideoAE
and YaleFaces train on the unit engine unless ``--fused``
(``root.common.engine.fused``) asks for ``FusedTrainer``; AlexNet trains
on ``FusedTrainer``, as the reference's sample does; MnistAE (tied
weights) and Kohonen (no GD chain) train on the unit engine always.
YaleFaces writes its PNG tree under ``root.yale_faces.loader.data_dir``
first, unless it is there.  ``--snapshot`` resumes a sample that takes
one (all but AlexNet and Kohonen) from a snapshot file.  The last line of
the output is one JSON object with the run's finals under the names
``bench.py`` gives them: ``final_train_loss`` and ``valid_err_pct`` for
the classifiers, ``final_train_mse`` and ``valid_mse`` for the
autoencoders (MnistAE, VideoAE), ``final_qerror`` and ``first_qerror``
for Kohonen; ``compute_dtype`` is
the dtype the train steps computed in.  The precision knobs are dotted
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
starts a rollover to the ``--snapshot`` file.  ``--fused`` is a training
flag: with ``--serve`` the run exits 2.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import logging
import signal
import sys
import threading

from znicz_torch.core import prng
from znicz_torch.core.config import apply_overrides, root

SAMPLES = ("alexnet", "mnist", "cifar", "mnist_ae", "kohonen", "wine",
           "kanji", "video_ae", "yale_faces")
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
    return {"epochs": int(d.epoch_number) + 1,
            "valid_err_pct": valid.get("err_pct"),
            "train_loss": train.get("loss"),
            "final_train_loss": train.get("loss")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m znicz_torch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("workflow", choices=SAMPLES)
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
    # intermixed: overrides may follow the options on every Python 3.12
    # (older argparse leaves a "*" positional empty once an option has
    # come between it and the sample's name)
    args = ap.parse_intermixed_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.serve is not None and args.fused:
        print("error: --serve is exclusive of the training flag --fused",
              file=sys.stderr)
        return 2
    if args.overrides:
        apply_overrides(root, args.overrides)
    if args.fused:
        root.common.engine.fused = True
    if args.seed is not None:
        prng.seed_all(args.seed)
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
    from znicz_torch.serving import InferenceServer

    wf = serving_workflow(mod, args.device)
    max_requests = root.common.serving.get("max_requests", None)
    server = InferenceServer(
        wf, bind=args.serve, snapshot=args.snapshot,
        max_requests=None if max_requests is None else int(max_requests),
        replica_id=args.replica_id)
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


if __name__ == "__main__":
    sys.exit(main())
