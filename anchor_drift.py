#!/usr/bin/env python3
"""Where the port's CIFAR10 anchor parts from the reference's, on the CPU.

    JAX_PLATFORMS=cpu python anchor_drift.py [--threads 1,8] [--steps 14]
                                             [--card anchors.json]

BASELINE config 1 (``samples/cifar.py`` at its defaults: 2000 + 400
images, batch 100, 12 epochs) from ``prng.reset(1013)`` in both packages:

  1. the reference's ``FusedTrainer.run()`` and the port's, the port once
     per thread count of ``--threads``: each run's per-step train losses,
     the first step at which the port's part from the reference's by a
     relative 1e-4, 1e-3 and 1e-2, and each run's finals (last-epoch
     train loss and valid error, the numbers ``ANCHOR_BANDS[1]`` holds);
  2. for each of the first ``--steps`` train steps, both packages take one
     update from the reference's exact state (parameters and velocities
     carried across): per step, the loss's relative difference and the
     largest difference of an updated parameter over the size of its
     update, with the parameter's name;
  3. with ``--card``, the per-step losses of the composed CIFAR10 run in
     the file ``chip_smoke.py --trace`` wrote on the card, against the
     reference's.

Every run is composed (routing knobs off).  The last line is one JSON
object with all of it.  This is a diagnosis, not a gate: it imports both
packages, so it is no part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

SEED = 1013
PART_AT = (1e-4, 1e-3, 1e-2)


def _parting(losses, ref):
    a, b = np.asarray(losses), np.asarray(ref)
    n = min(len(a), len(b))
    rel = np.abs(a[:n] - b[:n]) / np.abs(b[:n])
    return {f"{t:g}": (int(np.argmax(rel > t)) if (rel > t).any() else None)
            for t in PART_AT}


def reference_run():
    """(per-step train losses, finals) of the reference's fused run."""
    from znicz_tpu.core import prng
    from znicz_tpu.loader.base import TRAIN
    from znicz_tpu.parallel.fused import FusedTrainer
    from znicz_tpu.samples import cifar

    prng.reset(SEED)
    wf = cifar.CifarWorkflow()
    wf.initialize(device=None)
    trainer, losses = FusedTrainer(wf), []
    feed = trainer._feed_decision

    def record(mb, metrics):
        if mb["class"] == TRAIN:
            losses.append(float(metrics[0]))
        feed(mb, metrics)

    trainer._feed_decision = record
    trainer.run()
    return losses, _finals(wf.decision)


def port_run(threads):
    """(per-step train losses, finals) of the port's run on ``threads``
    CPU threads."""
    import torch

    from znicz_torch.core import prng
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples import cifar

    torch.set_num_threads(int(threads))
    prng.reset(SEED)
    wf = cifar.CifarWorkflow(device="cpu")
    trainer = FusedTrainer(wf)
    trainer.run()
    return list(trainer.train_losses), _finals(wf.decision)


def _finals(decision):
    return {"final_train_loss": float(decision.epoch_metrics[2]["loss"]),
            "valid_err_pct": float(decision.epoch_metrics[1]["err_pct"])}


def single_steps(n_steps):
    """One update of each package from the reference's exact state, for
    each of the first ``n_steps`` train steps of the default run."""
    import torch

    from znicz_torch.core import prng as tprng
    from znicz_torch.loader.base import TRAIN
    from znicz_torch.parallel.fused import FusedTrainer as TTrainer
    from znicz_torch.samples import cifar as tcifar
    from znicz_torch.weights import (params_from_jax, params_to_numpy,
                                     velocities_from_jax)
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
    from znicz_tpu.samples import cifar as jcifar

    torch.set_num_threads(max(1, os.cpu_count() or 1))
    jprng.reset(SEED)
    jwf = jcifar.CifarWorkflow()
    jwf.initialize(device=None)
    tprng.reset(SEED)
    twf = tcifar.CifarWorkflow(device="cpu")
    jt, tt = JTrainer(jwf), TTrainer(twf)
    params, vels, dataset, targets, _ = jt._device_state()
    step_fn = jt.make_train_step()
    ldr, out = twf.loader, []
    while len(out) < n_steps:
        ldr.run()
        if ldr.minibatch_class != TRAIN or ldr.last_minibatch:
            continue
        step = len(out)
        idx, bs = ldr.minibatch_indices.copy(), int(ldr.minibatch_size)
        start = {n: {k: np.asarray(v) for k, v in leaves.items()}
                 for n, leaves in params.items()}
        params_from_jax(start, twf)
        velocities_from_jax({n: {k: np.asarray(v) for k, v in leaves.items()}
                             for n, leaves in vels.items()}, twf)
        params, vels, (jloss, _, _) = step_fn(
            params, vels, jt.hypers(), dataset, targets,
            np.array(idx, np.int32), np.int32(bs),
            jprng.get("fused_trainer").jax_key(step))
        tloss, _, _ = tt.train_step(idx, bs, step)
        got = params_to_numpy(twf)
        worst, where = 0.0, ""
        for name, leaves in params.items():
            for key, want in leaves.items():
                want = np.asarray(want)
                update = float(np.abs(want - start[name][key]).max())
                d = float(np.abs(got[name][key] - want).max())
                if d / max(update, 1e-30) > worst:
                    worst, where = d / max(update, 1e-30), f"{name}.{key}"
        out.append({"step": step,
                    "loss_rel": abs(float(tloss) - float(jloss))
                    / abs(float(jloss)),
                    "worst_over_update": worst, "at": where})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1,8",
                    help="comma-separated CPU thread counts of the port's "
                         "runs")
    ap.add_argument("--steps", type=int, default=14,
                    help="train steps of the one-update comparison")
    ap.add_argument("--card", default="",
                    help="the file chip_smoke.py --trace wrote, to "
                         "compare the card's composed run")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from znicz_tpu.core.config import root as jroot

    jroot.common.dirs.snapshots = tempfile.mkdtemp(prefix="anchor_drift_")
    ref_losses, ref_finals = reference_run()
    result = {"reference": ref_finals, "port": {}}
    print(json.dumps({"reference": ref_finals}), flush=True)
    for threads in args.threads.split(","):
        losses, finals = port_run(threads)
        result["port"][f"threads={threads}"] = {
            **finals, "parts_at_step": _parting(losses, ref_losses)}
        print(json.dumps({f"port threads={threads}":
                          result["port"][f"threads={threads}"]}), flush=True)
    if args.card:
        with open(args.card) as f:
            card = json.load(f)["cifar"]
        result["card"] = {
            "final_train_loss": card["epochs"][-1]["train_loss"],
            "valid_err_pct": card["epochs"][-1]["valid_err_pct"],
            "parts_at_step": _parting(card["train_losses"], ref_losses)}
    result["single_steps"] = single_steps(args.steps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
