"""Train a sample workflow (port of the sample-run path of
``znicz_tpu/launcher.py``):

    python -m znicz_torch {alexnet,mnist,cifar} [root.x.y=value ...]
                          [--device cpu] [--seed N] [--fused]
                          [--snapshot PATH]

Dotted overrides are applied to the port's config tree before the sample
module is imported, so its defaults do not clobber them.  The sample's
``run(device)`` trains on ``cuda:0`` unless ``--device`` names another
device; without a GPU it raises.  MNIST and CIFAR10 train on the unit
engine unless ``--fused`` (``root.common.engine.fused``) asks for
``FusedTrainer``; AlexNet trains on ``FusedTrainer``, as the reference's
sample does.  ``--snapshot`` resumes a sample that takes one (MNIST,
CIFAR10) from a snapshot file.  The last line of the output is one JSON
object with the run's finals; ``final_train_loss`` and ``valid_err_pct``
are the names ``bench.py`` gives them, and ``compute_dtype`` the dtype
the train steps computed in.  The precision knobs are dotted overrides,
as in the reference: ``root.common.engine.compute_dtype=bf16`` (or
``precision``), ``state_dtype=bfloat16`` and ``master_dtype=bfloat16``
(``FusedTrainer`` only).
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import logging
import sys

from znicz_torch.core import prng
from znicz_torch.core.config import apply_overrides, root

SAMPLES = ("alexnet", "mnist", "cifar")


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
                    help="resume from a snapshot file")
    # intermixed: overrides may follow the options on every Python 3.12
    # (older argparse leaves a "*" positional empty once an option has
    # come between it and the sample's name)
    args = ap.parse_intermixed_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.overrides:
        apply_overrides(root, args.overrides)
    if args.fused:
        root.common.engine.fused = True
    if args.seed is not None:
        prng.seed_all(args.seed)
    mod = importlib.import_module(f"znicz_torch.samples.{args.workflow}")
    kwargs = {}
    if args.snapshot:
        if "snapshot" not in inspect.signature(mod.run).parameters:
            ap.error(f"{args.workflow} does not resume from a snapshot")
        kwargs["snapshot"] = args.snapshot
    wf = mod.run(device=args.device, **kwargs)
    d, stats = wf.decision, wf.train_stats
    trainer = getattr(wf, "trainer", None)
    print(json.dumps({
        "workflow": args.workflow, "device": str(wf.device),
        "epochs": int(d.epoch_number) + 1,
        "valid_err_pct": (d.epoch_metrics[1] or {}).get("err_pct"),
        "train_loss": (d.epoch_metrics[2] or {}).get("loss"),
        "final_train_loss": (d.epoch_metrics[2] or {}).get("loss"),
        "train_steps": stats["train_steps"],
        "img_per_sec": stats["img_per_sec"],
        "warm_img_per_sec": stats["warm_img_per_sec"],
        # the unit engine computes in float32 whatever compute_dtype says,
        # as the reference's does
        "compute_dtype": (str(trainer.compute_dtype).split(".")[-1]
                          if trainer is not None else "float32")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
