#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``znicz_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and forgotten):

  1. the card's name and power limit; build the CUDA kernels from
     ``znicz_torch/csrc`` (one ``nvcc`` per source, all at once);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes AlexNet's forward gives it at batch 128: error against the
     stated tolerance, kernel / plain / library time, and the least time
     the card could take (bytes over 3.35 TB/s or operations over the
     float32 rate, whichever is larger);
  3. full-width AlexNet (227x227x3, 96/256/384/384/256/4096/4096, 1000
     classes, seeded random weights) behind ``InferenceServer``
     (max_batch 128) with ``fused_elementwise`` and ``fused_tail`` on:
     64 requests of 1-16 rows from 4 threads; every reply checked against
     the same rows through the composed forward (knobs off); the kernel
     counts must show 2 block launches and 3 bias+ReLU launches per
     dispatch;
  4. the same with ``pallas_lrn`` on and ``fused_elementwise`` off: 2 LRN
     launches and 5 bias+ReLU launches per dispatch.

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
#: float32 arithmetic in the same order; the kernel's 1/sqrtf, sqrtf and
#: powf may differ from PyTorch's rsqrt/sqrt/pow by an ulp or two
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
#: served logits vs the composed forward, as max|a - b| / max|b|: TF32
#: off, float32 throughout; the paths differ by rounding in the LRN and
#: by the convolution algorithm cuDNN picks per batch size
SERVE_TOL = 1e-4


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


def check_kernels(torch):
    """Phase 2: every kernel against its plain version at AlexNet's
    batch-128 shapes.  Returns {kernel: accumulated row}."""
    import torch.nn.functional as F

    from znicz_torch.fused_block import (bias_relu_plain, fused_bias_relu,
                                         fused_block, fused_block_plain)
    from znicz_torch.ops.lrn import lrn, lrn_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, alpha, beta, k, pool = 5, 1e-4, 0.75, 2.0, (3, 3, 2, 2)

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    cases = {
        "fused_block_fwd": ("znicz_torch/csrc/fused_block.cu",
                            "znicz_tpu/pallas_fused_block.py:112",
                            {"conv1": (55, 96), "conv2": (27, 256)}),
        "bias_relu_fwd": ("znicz_torch/csrc/bias_relu.cu",
                          "znicz_tpu/pallas_fused_block.py:392",
                          {"conv3": (13, 384), "conv4": (13, 384),
                           "conv5": (13, 256)}),
        "lrn_fwd": ("znicz_torch/csrc/lrn.cu",
                    "znicz_tpu/ops/lrn_pallas.py:78",
                    {"conv1": (55, 96), "conv2": (27, 256)}),
    }
    rows = {}
    for name, (source, replaces, shapes) in cases.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": None}
        for layer, (hw, c) in shapes.items():
            x = rand((BATCH, hw, hw, c), 2.0)
            b = rand((c,), 0.1)
            lib = None
            if name == "fused_block_fwd":
                def kern():
                    return fused_block(x, b, n, alpha, beta, k, pool)

                def plain():
                    return fused_block_plain(x, b, n, alpha, beta, k, pool)
                out_numel = BATCH * ((hw - 3) // 2 + 1) ** 2 * c
                nbytes = 4 * (x.numel() + c + out_numel)
                ops = x.numel() * (n + 8) + out_numel * 8
            elif name == "bias_relu_fwd":
                def kern():
                    return fused_bias_relu(x, b)

                def plain():
                    return bias_relu_plain(x, b)
                nbytes = 4 * (2 * x.numel() + c)
                ops = 2 * x.numel()
            else:
                x = torch.clamp_min(x, 0.0)       # LRN reads ReLU output

                def kern():
                    return lrn(x, n, alpha, beta, k)

                def plain():
                    return lrn_plain(x, n, alpha, beta, k)

                def lib():
                    return F.local_response_norm(
                        x.permute(0, 3, 1, 2), n, alpha * n, beta, k)
                nbytes = 4 * 2 * x.numel()
                ops = x.numel() * (n + 5)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape:
                raise AssertionError(f"{name}[{layer}]: shape "
                                     f"{tuple(got.shape)} vs plain "
                                     f"{tuple(want.shape)}")
            err = (got - want).abs()
            limit = KERNEL_ATOL + KERNEL_RTOL * want.abs()
            max_err = float(err.max())
            rel = float((err / want.abs().clamp_min(1e-30)).max())
            ok = bool((err <= limit).all()) and bool(
                torch.isfinite(got).all())
            t_k = cuda_ms(torch, kern)
            t_p = cuda_ms(torch, plain)
            t_l = None
            if lib is not None:
                t_l = cuda_ms(torch, lib)
                lib_err = float((lib().permute(0, 2, 3, 1) - want).abs()
                                .max())
            b_ms, b_by = bound_ms(nbytes, ops)
            log(f"[kernel] {name}[{layer}] shape={tuple(x.shape)} "
                f"max_abs_err={max_err:.3e} max_rel_err={rel:.3e} "
                f"tol=|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|plain| "
                f"ms={t_k:.4f} plain_ms={t_p:.4f} "
                f"bound_us={b_ms * 1e3:.2f} ({b_by}, {nbytes / 1e6:.1f} MB)"
                + ("" if t_l is None else
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
            del x, b, got, want
        rows[name] = row
    torch.cuda.empty_cache()
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
    from znicz_torch.fused_block import fused_bias_relu, fused_block
    from znicz_torch.ops.lrn import lrn
    from znicz_torch.serving.batcher import Request
    from znicz_torch.serving.frontend import InferenceServer

    counters = {"fused_block_fwd": fused_block, "bias_relu_fwd":
                fused_bias_relu, "lrn_fwd": lrn}
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

    for fn in counters.values():                # the main path starts here
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
    launches = {name: fn.launches for name, fn in counters.items()}
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
    log(f"[build] {time.perf_counter() - t0:.2f}s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- phase 2: kernels against their plain versions -----------------------
    rows = check_kernels(torch)

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
    main_launches = {}
    for label, knobs, expect in phases:
        replies, launches, stats = serve_phase(torch, label, wf, requests,
                                               knobs, expect)
        check_replies(label, replies, refs)
        for name, per in expect.items():
            if per and name not in main_launches:
                main_launches[name] = launches[name]
        log(f"[{label}] {card}: images/s={stats['images_per_s']:.1f} "
            f"p50_ms={stats['p50_ms']:.2f} p99_ms={stats['p99_ms']:.2f} "
            f"occupancy={stats['batcher']['mean_occupancy']:.3f}")
    for name, row in rows.items():
        row["launches"] = main_launches[name]

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
