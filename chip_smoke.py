#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``znicz_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and forgotten):

  1. the card's name and power limit; build the CUDA kernels from
     ``znicz_torch/csrc`` (one ``nvcc`` per source, all at once);
  2. each forward kernel (K1, K2, K3) against its plain PyTorch version
     on the card, at the shapes AlexNet's forward gives it at batch 128:
     error against the stated tolerance, kernel / plain / library time,
     and the least time the card could take (bytes over 3.35 TB/s or
     operations over the float32 rate, whichever is larger);
  3. full-width AlexNet (227x227x3, 96/256/384/384/256/4096/4096, 1000
     classes, seeded random weights) behind ``InferenceServer``
     (max_batch 128) with ``fused_elementwise`` and ``fused_tail`` on:
     64 requests of 1-16 rows from 4 threads; every reply checked against
     the same rows through the composed forward (knobs off); the kernel
     counts must show 2 block launches and 3 bias+ReLU launches per
     dispatch;
  4. the same with ``pallas_lrn`` on and ``fused_elementwise`` off: 2 LRN
     launches and 5 bias+ReLU launches per dispatch;
  5. each backward kernel (K1b, K2b, K3b) against its plain version at
     the batch-128 shapes of the AlexNet train step, as in phase 2, with
     the bias gradient held to a tolerance relative to its sums;
  6. full-width AlexNet trained by ``FusedTrainer.run()`` (the port's
     ``samples/alexnet.py``: 227x227x3, batch 128, 256 train + 128 valid
     images, 2 epochs, 1000 classes) three times from the same weights and
     the same dropout masks: composed, ``fused`` and ``pallas_lrn``.  Every
     loss must be finite; each fused routing's per-step losses and final
     weights must stay within the stated bands of the composed run's; the
     kernel counts must be exactly 2/2/3/3 (K1/K1b/K2/K2b) per train step
     under ``fused`` and 2/2/5/5 (K3/K3b/K2/K2b) under ``pallas_lrn``, and
     eval steps launch forward kernels only.

The last lines are the ``kernels`` JSON object and then
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np

SEED = 20261016
BATCH = 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM float32, outside tensor cores

#: kernel vs plain: elementwise |k - p| <= ATOL + RTOL * |p|.  Same
#: float32 arithmetic in the same order; the kernel's powf and sqrtf may
#: differ from PyTorch's pow/sqrt by an ulp or two
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
#: a bias gradient vs plain, per channel: |k - p| <= DB_RTOL * sum|dx|.
#: Both sum the same terms over B, H, W in different orders
DB_RTOL = 1e-4
#: served logits vs the composed forward, as max|a - b| / max|b|: TF32
#: off, float32 throughout; the paths differ by rounding in the LRN and
#: by the convolution algorithm cuDNN picks per batch size
SERVE_TOL = 1e-4
#: a fused routing's training vs the composed run's: per-step losses
#: within LOSS_RTOL, final weights within |d| <= W_ATOL + W_RTOL*|w|, the
#: band of the reference's own trainer parity test
#: (tests/test_fused_block_pallas.py:244-248).  The routings differ by
#: rounding (rsqrt vs pow LRN, cuDNN's backward algorithms)
LOSS_RTOL, W_RTOL, W_ATOL = 1e-3, 5e-3, 5e-5
#: 2 train minibatches and 1 valid minibatch an epoch: 3 train steps in 2
#: epochs (the last tail's update is skipped once the run completes).
#: Rounding differences between the routings grow with every step: the
#: weight band's margin shrinks from 3 to 5 to 7 steps (PERF.md)
TRAIN_CFG = {"minibatch_size": BATCH, "n_train": 256, "n_valid": 128,
             "n_test": 0, "n_classes": 1000, "image_size": 227}
TRAIN_EPOCHS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around
    ``iters`` launches after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


#: the bias+ReLU kernels run at conv3-5 under ``fused`` and at conv1-5
#: under ``pallas_lrn``; their rows sum all five
BIAS_RELU_LAYERS = {"conv3": (13, 384), "conv4": (13, 384),
                    "conv5": (13, 256), "conv1": (55, 96), "conv2": (27, 256)}
#: kernel -> (source, TPU kernel it replaces, {layer: (plane, channels)})
KERNELS = {
    "fused_block_fwd": ("znicz_torch/csrc/fused_block.cu",
                        "znicz_tpu/pallas_fused_block.py:112",
                        {"conv1": (55, 96), "conv2": (27, 256)}),
    "bias_relu_fwd": ("znicz_torch/csrc/bias_relu.cu",
                      "znicz_tpu/pallas_fused_block.py:392", BIAS_RELU_LAYERS),
    "lrn_fwd": ("znicz_torch/csrc/lrn.cu", "znicz_tpu/ops/lrn_pallas.py:78",
                {"conv1": (55, 96), "conv2": (27, 256)}),
    "fused_block_bwd": ("znicz_torch/csrc/fused_block_bwd.cu",
                        "znicz_tpu/pallas_fused_block.py:125",
                        {"conv1": (55, 96), "conv2": (27, 256)}),
    "bias_relu_bwd": ("znicz_torch/csrc/bias_relu_bwd.cu",
                      "znicz_tpu/pallas_fused_block.py:400", BIAS_RELU_LAYERS),
    "lrn_bwd": ("znicz_torch/csrc/lrn_bwd.cu",
                "znicz_tpu/ops/lrn_pallas.py:86",
                {"conv1": (55, 96), "conv2": (27, 256)}),
}


def counters():
    """kernel name -> its wrapper (whose ``.launches`` counts it)."""
    from znicz_torch.fused_block import (bias_relu_bwd, bias_relu_fwd,
                                         fused_block_bwd, fused_block_fwd)
    from znicz_torch.ops.lrn import lrn_bwd, lrn_fwd

    return {"fused_block_fwd": fused_block_fwd,
            "bias_relu_fwd": bias_relu_fwd, "lrn_fwd": lrn_fwd,
            "fused_block_bwd": fused_block_bwd,
            "bias_relu_bwd": bias_relu_bwd, "lrn_bwd": lrn_bwd}


def _case(torch, name, x, b, gen, n, alpha, beta, k, pool):
    """(kernel fn, plain fn, library fn or None, bytes, operations) of
    kernel ``name`` on the raw conv output ``x`` and bias ``b``."""
    import torch.nn.functional as F

    from znicz_torch.fused_block import (bias_relu_bwd, bias_relu_bwd_plain,
                                         bias_relu_fwd, bias_relu_plain,
                                         fused_block_bwd,
                                         fused_block_bwd_plain,
                                         fused_block_fwd, fused_block_plain)
    from znicz_torch.ops.lrn import lrn_bwd, lrn_bwd_plain, lrn_fwd, \
        lrn_plain

    c = x.shape[-1]
    hw = x.shape[1]
    pooled = (BATCH, (hw - 3) // 2 + 1, (hw - 3) // 2 + 1, c)
    if name == "fused_block_fwd":
        out = BATCH * pooled[1] * pooled[2] * c
        return (lambda: fused_block_fwd(x, b, n, alpha, beta, k, pool),
                lambda: fused_block_plain(x, b, n, alpha, beta, k, pool),
                None, 4 * (x.numel() + c + out),
                x.numel() * (n + 8) + out * 8)
    if name == "bias_relu_fwd":
        return (lambda: bias_relu_fwd(x, b), lambda: bias_relu_plain(x, b),
                None, 4 * (2 * x.numel() + c), 2 * x.numel())
    if name == "fused_block_bwd":
        dp = torch.randn(pooled, generator=gen, device="cuda")
        return (lambda: fused_block_bwd(x, b, dp, n, alpha, beta, k, pool),
                lambda: fused_block_bwd_plain(x, b, dp, n, alpha, beta, k,
                                              pool),
                None, 4 * (2 * x.numel() + dp.numel() + 2 * c),
                x.numel() * (3 * n + 20) + dp.numel() * 18)
    if name == "bias_relu_bwd":
        dp = torch.randn(x.shape, generator=gen, device="cuda")
        return (lambda: bias_relu_bwd(x, b, dp),
                lambda: bias_relu_bwd_plain(x, b, dp),
                None, 4 * (3 * x.numel() + 2 * c), 4 * x.numel())
    r = torch.clamp_min(x, 0.0)                 # LRN reads ReLU output
    if name == "lrn_fwd":
        return (lambda: lrn_fwd(r, n, alpha, beta, k),
                lambda: lrn_plain(r, n, alpha, beta, k),
                lambda: F.local_response_norm(
                    r.permute(0, 3, 1, 2), n, alpha * n, beta, k)
                .permute(0, 2, 3, 1),
                4 * 2 * r.numel(), r.numel() * (n + 5))
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    return (lambda: lrn_bwd(r, dy, n, alpha, beta, k),
            lambda: lrn_bwd_plain(r, dy, n, alpha, beta, k),
            None, 4 * 3 * r.numel(), r.numel() * (3 * n + 14))


def check_kernels(torch, names):
    """Each kernel of ``names`` against its plain version at AlexNet's
    batch-128 shapes.  Returns {kernel: accumulated JSON row}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, alpha, beta, k, pool = 5, 1e-4, 0.75, 2.0, (3, 3, 2, 2)
    rows = {}
    for name in names:
        source, replaces, shapes = KERNELS[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": None}
        for layer, (hw, c) in shapes.items():
            x = torch.randn((BATCH, hw, hw, c), generator=gen,
                            device="cuda") * 2.0
            b = torch.randn((c,), generator=gen, device="cuda") * 0.1
            kern, plain, lib, nbytes, ops = _case(torch, name, x, b, gen, n,
                                                  alpha, beta, k, pool)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            db_note, db_ok = "", True
            if isinstance(got, tuple):          # backward: (dx, db)
                (got, got_db), (want, want_db) = got, want
                scale = want.abs().sum(dim=tuple(range(want.ndim - 1)))
                db_err = (got_db - want_db).abs()
                db_ok = bool((db_err <= DB_RTOL * scale).all()) and bool(
                    torch.isfinite(got_db).all())
                db_note = (f" db_max_abs_err={float(db_err.max()):.3e} "
                           f"db_max_rel_to_sum="
                           f"{float((db_err / scale.clamp_min(1e-30)).max()):.3e}"
                           f" db_tol=|d|<={DB_RTOL:g}*sum|dx|")
            if got.shape != want.shape:
                raise AssertionError(f"{name}[{layer}]: shape "
                                     f"{tuple(got.shape)} vs plain "
                                     f"{tuple(want.shape)}")
            err = (got - want).abs()
            limit = KERNEL_ATOL + KERNEL_RTOL * want.abs()
            max_err = float(err.max())
            rel = float((err / want.abs().clamp_min(1e-30)).max())
            ok = bool((err <= limit).all()) and bool(
                torch.isfinite(got).all()) and db_ok
            lib_err = None
            if lib is not None:
                lib_err = float((lib() - want).abs().max())
            del got, want
            t_k = cuda_ms(torch, kern)
            t_p = cuda_ms(torch, plain, iters=5, warmup=1)
            t_l = None if lib is None else cuda_ms(torch, lib)
            b_ms, b_by = bound_ms(nbytes, ops)
            log(f"[kernel] {name}[{layer}] shape={tuple(x.shape)} "
                f"max_abs_err={max_err:.3e} max_rel_err={rel:.3e} "
                f"tol=|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|plain|{db_note} "
                f"ms={t_k:.4f} plain_ms={t_p:.4f} "
                f"bound_us={b_ms * 1e3:.2f} ({b_by}, {nbytes / 1e6:.1f} MB)"
                + (" library_ms=none" if t_l is None else
                   f" library_ms={t_l:.4f} library_err={lib_err:.3e}")
                + f" -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}[{layer}] disagrees with its "
                                     f"plain version: {max_err:.3e}")
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
            row["ms"] += t_k
            row["plain_ms"] += t_p
            row["bound_ms"] += b_ms
            row["bound_by"] = b_by
            if t_l is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + t_l
            del x, b, kern, plain, lib
            torch.cuda.empty_cache()
        rows[name] = row
    return rows


def make_requests(n_requests: int = 64):
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(1, 17, size=n_requests)
    return [rng.standard_normal((int(s), 227, 227, 3), dtype=np.float32)
            for s in sizes]


def serve_phase(torch, label, wf, requests, knobs, expect):
    """Serve ``requests`` through a fresh InferenceServer with ``knobs``
    set; check the kernel counts per dispatch against ``expect``
    ({counter name: launches per dispatch}).  Returns (replies,
    launches, stats)."""
    from znicz_torch.core.config import root
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer

    ctrs = {name: fn for name, fn in counters().items() if name in expect}
    for key, val in knobs.items():
        setattr(root.common.engine, key, val)
    srv = InferenceServer(wf, max_batch=BATCH, max_delay_ms=5.0,
                          queue_bound=4096)
    t0 = time.perf_counter()
    srv.start()                                 # warms all 8 rungs
    log(f"[{label}] warmup of {len(srv.batcher.ladder.rungs)} rungs "
        f"{time.perf_counter() - t0:.2f}s")
    futures = [Future() for _ in requests]

    def client(tid):
        for i in range(tid, len(requests), 4):
            srv.submit(Request(requests[i], requests[i].shape[0],
                               reply_to=futures[i], req_id=i))

    for fn in ctrs.values():                    # the main path starts here
        fn.launches = 0
    srv.runner.dispatches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    replies = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ctrs.items()}
    dispatches = srv.runner.dispatches
    srv.stop()
    for key in knobs:
        setattr(root.common.engine, key, False)
    if srv.error is not None:
        raise RuntimeError(f"[{label}] compute loop died") from srv.error
    bad = [r for r in replies if not r["ok"]]
    if bad:
        raise AssertionError(f"[{label}] {len(bad)} refused/failed replies: "
                             f"{bad[0]}")
    rows = sum(r.shape[0] for r in requests)
    stats = srv.stats()
    log(f"[{label}] {len(requests)} requests, {rows} images, "
        f"{dispatches} dispatches, launches={launches} "
        f"batches={stats['batcher']['bucket_hits']}")
    for name, per in expect.items():
        if launches[name] != per * dispatches or dispatches == 0:
            raise AssertionError(
                f"[{label}] {name}: {launches[name]} launches for "
                f"{dispatches} dispatches, expected {per} per dispatch")
    return replies, launches, {"images_per_s": rows / wall, **stats}


def check_replies(label, replies, refs):
    worst = 0.0
    for i, (rep, ref) in enumerate(zip(replies, refs)):
        y = rep["y"]
        if y.shape != ref.shape or not np.isfinite(y).all():
            raise AssertionError(f"[{label}] request {i}: shape {y.shape} "
                                 f"vs {ref.shape} or non-finite")
        worst = max(worst, float(np.abs(y - ref).max()
                                 / max(np.abs(ref).max(), 1e-30)))
    log(f"[{label}] replies vs composed forward: max|d|/max|ref| = "
        f"{worst:.3e} (tol {SERVE_TOL:g})")
    if worst > SERVE_TOL:
        raise AssertionError(f"[{label}] replies disagree: {worst:.3e}")


#: routing -> (knobs, {kernel: (launches per train step, per eval step)})
TRAIN_ROUTINGS = {
    "composed": ({}, {}),
    "fused": ({"fused_elementwise": True, "fused_tail": True},
              {"fused_block_fwd": (2, 2), "fused_block_bwd": (2, 0),
               "bias_relu_fwd": (3, 3), "bias_relu_bwd": (3, 0)}),
    "pallas_lrn": ({"pallas_lrn": True, "fused_tail": True},
                   {"lrn_fwd": (2, 2), "lrn_bwd": (2, 0),
                    "bias_relu_fwd": (5, 5), "bias_relu_bwd": (5, 0)}),
    # the composed run again: its distance to the first is the run-to-run
    # spread (cuDNN's backward algorithms may sum in any order)
    "composed_repeat": ({}, {}),
}


def train_phase(torch, card):
    """Phase 6: ``FusedTrainer.run()`` on full-width AlexNet under each
    routing from the same start.  Returns {routing: {kernel: launches}}
    of the runs."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.decision import DecisionGD
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.alexnet import training_workflow

    root.alexnet.loader.update(TRAIN_CFG)
    root.alexnet.decision.max_epochs = TRAIN_EPOCHS
    prng.reset(SEED)
    t0 = time.perf_counter()
    wf = training_workflow(
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    ldr = wf.loader
    log(f"[train] AlexNet {wf.sample_shape} -> {wf.output_sample_shape}, "
        f"{ldr.class_lengths[2]} train + {ldr.class_lengths[1]} valid "
        f"images resident on {ldr.data.device}, batch {BATCH}, "
        f"{TRAIN_EPOCHS} epochs; built in {time.perf_counter() - t0:.2f}s")
    start = {f.name: {k: p.detach().clone()
                      for k, p in FusedTrainer._params_of(f).items()}
             for f in wf.forwards if f.has_weights}
    ctrs = counters()
    runs = {}
    for label, (knobs, expect) in TRAIN_ROUTINGS.items():
        prng.reset(SEED)                        # same shuffles, same masks
        ldr.reset()
        with torch.no_grad():
            for f in wf.forwards:
                for k, p in FusedTrainer._params_of(f).items() \
                        if f.has_weights else ():
                    p.copy_(start[f.name][k])
        for gd in wf.gds.values():
            gd.velocities = {}
        wf.decision = DecisionGD(max_epochs=TRAIN_EPOCHS, fail_iterations=0)
        valid_err = []
        wf.decision.on_epoch_end.append(
            lambda d: valid_err.append(d.epoch_metrics[1]["err_pct"]))
        for key, val in knobs.items():
            setattr(root.common.engine, key, val)
        trainer = FusedTrainer(wf)
        for fn in ctrs.values():                # the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in ctrs.items()}
        st = trainer.stats
        n_train, n_eval = st["train_steps"], st["eval_steps"]
        losses = list(trainer.train_losses)
        final = {name: {k: p.detach().clone() for k, p in leaves.items()}
                 for name, leaves in trainer.extract_params().items()}
        idx = np.arange(BATCH)
        step_ms = cuda_ms(torch, lambda: trainer.train_step(idx, BATCH, 0),
                          iters=5, warmup=1)
        for key in knobs:
            setattr(root.common.engine, key, False)
        log(f"[train:{label}] {n_train} train steps + {n_eval} eval steps "
            f"in {wall:.2f}s; losses {['%.6f' % v for v in losses]}; "
            f"valid err% per epoch {valid_err}")
        log(f"[train:{label}] {card}: images/s={st['img_per_sec']:.1f} "
            f"(after the first step of each kind "
            f"{st['warm_img_per_sec']:.1f}); one train step "
            f"{step_ms:.3f} ms on the device ({BATCH / step_ms * 1e3:.0f} "
            f"images/s); launches={launches}")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"[train:{label}] non-finite loss: {losses}")
        for name, fn in ctrs.items():
            per_train, per_eval = expect.get(name, (0, 0))
            want = per_train * n_train + per_eval * n_eval
            if launches[name] != want:
                raise AssertionError(
                    f"[train:{label}] {name}: {launches[name]} launches for "
                    f"{n_train} train + {n_eval} eval steps, expected {want}")
        runs[label] = (losses, final, launches)
    base_losses, base_final, _ = runs["composed"]
    for label in ("fused", "pallas_lrn", "composed_repeat"):
        losses, final, _ = runs[label]
        l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        w_err, w_worst, w_bad = 0.0, "", []
        for name, leaves in final.items():
            for k, w in leaves.items():
                ref = base_final[name][k]
                d = (w - ref).abs()
                e = float((d / (W_ATOL + W_RTOL * ref.abs())).max())
                if e > w_err:
                    w_err, w_worst = e, f"{name}.{k}"
                if e > 1.0:
                    w_bad.append(f"{name}.{k}")
        log(f"[train:{label}] vs composed: losses max rel "
            f"{l_err:.3e} (tol {LOSS_RTOL:g}); final weights max "
            f"|d|/({W_ATOL:g}+{W_RTOL:g}|w|) = {w_err:.3f} at {w_worst} "
            f"(tol 1)")
        if len(losses) != len(base_losses) or l_err > LOSS_RTOL or w_bad:
            raise AssertionError(f"[train:{label}] leaves the composed "
                                 f"run's band: losses {l_err:.3e}, weights "
                                 f"{w_bad}")
    return {label: launches for label, (_, _, launches) in runs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from znicz_torch import _build
    from znicz_torch.samples.alexnet import AlexNetWorkflow
    from znicz_torch.serving.model import ModelRunner

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[build] {len(build_logs)} libraries in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- phase 2: forward kernels against their plain versions --------------
    rows = check_kernels(torch, ["fused_block_fwd", "bias_relu_fwd",
                                 "lrn_fwd"])

    # -- phase 3/4: the served path -----------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wf = AlexNetWorkflow(sample_shape=(227, 227, 3), n_classes=1000,
                         generator=gen)
    with torch.no_grad():
        for f in wf.forwards:
            if f.bias is not None:
                f.bias.normal_(0.0, 0.05, generator=gen)
    widths = [f.n_kernels if hasattr(f, "n_kernels") else
              f.output_samples_number for f in wf.forwards if f.has_weights]
    log(f"[model] AlexNet widths {widths} on {wf.device}")
    requests = make_requests()

    # references: the same rows through the composed forward (knobs off)
    ref_runner = ModelRunner(wf)
    t0 = time.perf_counter()
    refs = [ref_runner.infer(x) for x in requests]
    log(f"[reference] {len(refs)} requests composed "
        f"{time.perf_counter() - t0:.2f}s; logits std "
        f"{float(np.std(np.concatenate(refs))):.4f}")
    if not float(np.std(np.concatenate(refs))) > 0:
        raise AssertionError("degenerate logits")

    phases = [
        ("fused", {"fused_elementwise": True, "fused_tail": True},
         {"fused_block_fwd": 2, "bias_relu_fwd": 3, "lrn_fwd": 0}),
        ("pallas_lrn", {"pallas_lrn": True, "fused_tail": True},
         {"fused_block_fwd": 0, "bias_relu_fwd": 5, "lrn_fwd": 2}),
    ]
    # device time of one batch-128 forward on each path (CUDA events)
    from znicz_torch.core.config import root

    staged = ref_runner.stage(np.concatenate(requests)[:BATCH])
    for label, knobs, _ in [("composed", {}, None)] + phases:
        for key, val in knobs.items():
            setattr(root.common.engine, key, val)
        t = cuda_ms(torch, lambda: ref_runner.infer_staged(staged), iters=10)
        for key in knobs:
            setattr(root.common.engine, key, False)
        log(f"[forward] {label} batch {BATCH}: {t:.3f} ms on the device "
            f"({BATCH / t * 1e3:.0f} images/s)")
    del staged
    by_path = {name: {} for name in KERNELS}
    for label, knobs, expect in phases:
        replies, launches, stats = serve_phase(torch, label, wf, requests,
                                               knobs, expect)
        check_replies(label, replies, refs)
        for name, count in launches.items():
            if expect[name]:
                by_path[name][f"serve:{label}"] = count
        log(f"[{label}] {card}: images/s={stats['images_per_s']:.1f} "
            f"p50_ms={stats['p50_ms']:.2f} p99_ms={stats['p99_ms']:.2f} "
            f"occupancy={stats['batcher']['mean_occupancy']:.3f}")
    del wf, ref_runner, refs, requests
    torch.cuda.empty_cache()

    # -- phase 5: backward kernels against their plain versions -------------
    rows.update(check_kernels(torch, ["fused_block_bwd", "bias_relu_bwd",
                                      "lrn_bwd"]))

    # -- phase 6: the training path -----------------------------------------
    for label, launches in train_phase(torch, card).items():
        for name, count in launches.items():
            if TRAIN_ROUTINGS[label][1].get(name):
                by_path[name][f"train:{label}"] = count

    for name, row in rows.items():
        if not by_path[name] or not all(by_path[name].values()):
            raise AssertionError(f"{name} was not launched on a main path: "
                                 f"{by_path[name]}")
        row["launches"] = sum(by_path[name].values())
        row["launches_by_path"] = by_path[name]

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
