#!/usr/bin/env python3
"""CIFAR10's seed sweep: the last-epoch train loss and valid error of
``python -m PACKAGE cifar --seed N`` at the sample's defaults over a range
of seeds, one process a seed, and the two-sample Kolmogorov-Smirnov test
of two sweeps' valid errors.

    python3 seed_sweep.py run PACKAGE FIRST LAST OUT.jsonl [OVERRIDE ...]
    python3 seed_sweep.py ks A.jsonl B.jsonl

``run`` appends one JSON line a seed to ``OUT.jsonl``: ``seed``,
``final_train_loss``, ``valid_err_pct`` and the run's wall seconds.
``PACKAGE`` is ``znicz_torch`` (its last output line is the finals JSON;
pass ``--device cpu`` as an override to stay off the card) or
``znicz_tpu`` (the reference; its finals are read from the Decision's
last epoch log line, six significant digits; run it under
``JAX_PLATFORMS=cpu``).  Snapshots go to a temporary directory.  ``ks``
prints one JSON line: the seeds of each file, ``scipy.stats.ks_2samp``'s
statistic and p-value over the two sets of valid errors.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

_EPOCH = re.compile(r"epoch \d+ .*valid: .*err_pct=([-+.\deinf]+).*"
                    r"train: loss=([-+.\deinf]+)")


def finals(package: str, out: str, err: str) -> dict:
    """{final_train_loss, valid_err_pct} of one run's output."""
    lines = out.strip().splitlines()
    if package == "znicz_torch" and lines:
        res = json.loads(lines[-1])
        return {"final_train_loss": res["final_train_loss"],
                "valid_err_pct": res["valid_err_pct"]}
    hits = _EPOCH.findall(err + out)
    if not hits:
        raise ValueError(f"{package}: no epoch line in the output")
    valid, loss = hits[-1]
    return {"final_train_loss": float(loss), "valid_err_pct": float(valid)}


def run(package: str, first: int, last: int, path: str, extra) -> None:
    with tempfile.TemporaryDirectory(prefix="seed_sweep_") as snaps:
        for seed in range(first, last + 1):
            cmd = [sys.executable, "-m", package, "cifar", "--seed",
                   str(seed), f"root.common.dirs.snapshots={snaps}",
                   *extra]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"seed {seed}: exit {proc.returncode}\n"
                                   f"{proc.stderr[-3000:]}")
            row = {"seed": seed, "package": package,
                   **finals(package, proc.stdout, proc.stderr),
                   "wall_s": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            with open(path, "a") as f:
                f.write(json.dumps(row) + "\n")


def ks(path_a: str, path_b: str) -> None:
    from scipy.stats import ks_2samp

    def load(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return {r["seed"]: r["valid_err_pct"] for r in rows}

    a, b = load(path_a), load(path_b)
    res = ks_2samp(list(a.values()), list(b.values()))
    print(json.dumps({"a": path_a, "seeds_a": sorted(a), "b": path_b,
                      "seeds_b": sorted(b),
                      "statistic": float(res.statistic),
                      "pvalue": float(res.pvalue)}))


def main(argv) -> int:
    if len(argv) >= 5 and argv[0] == "run":
        os.makedirs(os.path.dirname(os.path.abspath(argv[4])), exist_ok=True)
        run(argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5:])
        return 0
    if len(argv) == 3 and argv[0] == "ks":
        ks(argv[1], argv[2])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
