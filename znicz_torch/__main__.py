"""Train a sample workflow (port of the sample-run path of
``znicz_tpu/launcher.py``):

    python -m znicz_torch alexnet [root.x.y=value ...] [--device cpu]

Dotted overrides are applied to the port's config tree before the sample
module is imported, so its defaults do not clobber them.  The sample's
``run(device)`` trains on ``cuda:0`` unless ``--device`` names another
device; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import sys

from znicz_torch.core import prng
from znicz_torch.core.config import apply_overrides, root

SAMPLES = ("alexnet",)


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
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.overrides:
        apply_overrides(root, args.overrides)
    if args.seed is not None:
        prng.seed_all(args.seed)
    mod = importlib.import_module(f"znicz_torch.samples.{args.workflow}")
    wf = mod.run(device=args.device)
    d = wf.decision
    print(json.dumps({
        "workflow": args.workflow, "device": str(wf.device),
        "epochs": int(d.epoch_number) + 1,
        "valid_err_pct": (d.epoch_metrics[1] or {}).get("err_pct"),
        "train_loss": (d.epoch_metrics[2] or {}).get("loss"),
        "train_steps": wf.trainer.stats["train_steps"],
        "img_per_sec": wf.trainer.stats["img_per_sec"],
        "warm_img_per_sec": wf.trainer.stats["warm_img_per_sec"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
