"""The port's MNIST and CIFAR10 samples (BASELINE configs 0 and 1)
against the JAX reference on the CPU.

  - training: each sample at a reduced size and its published widths,
    from the same seed, through the reference's ``FusedTrainer`` and the
    port's; every train minibatch's loss within ``STEP_TOL``, CIFAR10
    under the composed routing and under ``pallas_lrn`` + ``fused_tail``
    (the reference's Pallas kernels in interpret mode);
  - routing: the port's planners agree with the reference's on CIFAR10's
    layer list (no conv block, the bias+ReLU stage at its three
    convolutions), and one train step calls each kernel wrapper of the
    routing as often as the card launches it;
  - the anchor: ``python -m znicz_torch mnist --device cpu`` at the full
    default configuration lands inside ``bench.py``'s ``ANCHOR_BANDS[0]``.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_layers import jax_sample, port_sample, sample_config
from test_torch_planner import knobs
from test_torch_train import STEP_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent

#: tests/test_fused.py's reduced MNIST, and a CIFAR10 epoch at batch 50
REDUCED = {
    "mnist": {"loader__n_train": 300, "loader__n_valid": 60,
              "loader__n_test": 0, "loader__minibatch_size": 60,
              "decision__max_epochs": 2},
    "cifar": {"loader__n_train": 100, "loader__n_valid": 50,
              "loader__n_test": 0, "loader__minibatch_size": 50,
              "decision__max_epochs": 1},
}
ROUTINGS = {"composed": {},
            "pallas_lrn": {"pallas_lrn": True, "fused_tail": True}}


def _train_both(sample, routing, tmp_path):
    """(reference losses, port losses, reference workflow, port workflow)
    of a seeded reduced run; a loss for every TRAIN minibatch fed to the
    Decision, in order."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    with sample_config(sample, **REDUCED[sample]), knobs(**ROUTINGS[routing]):
        jwf = jax_sample(sample, tmp_path)
        twf = port_sample(sample, tmp_path)
        jt = JTrainer(jwf)
        j_losses = []
        feed = jt._feed_decision

        def record(mb, metrics):
            if mb["class"] == 2:
                j_losses.append(float(metrics[0]))
            feed(mb, metrics)

        jt._feed_decision = record
        jt.run()
        tt = FusedTrainer(twf)
        assert tt.hypers() == jt.hypers()
        tt.run()
    return j_losses, list(tt.train_losses), jwf, twf


@pytest.mark.parametrize("sample,routing", [
    ("mnist", "composed"), ("cifar", "composed"), ("cifar", "pallas_lrn")])
def test_reduced_training_matches_reference(sample, routing, tmp_path):
    j_losses, t_losses, jwf, twf = _train_both(sample, routing, tmp_path)
    n_train = REDUCED[sample]["loader__n_train"]
    batch = REDUCED[sample]["loader__minibatch_size"]
    assert len(t_losses) == len(j_losses) == \
        REDUCED[sample]["decision__max_epochs"] * n_train // batch
    np.testing.assert_allclose(t_losses, j_losses, **STEP_TOL)
    assert all(np.isfinite(t_losses))
    jd, td = jwf.decision, twf.decision
    assert td.complete and int(td.epoch_number) == int(jd.epoch_number)
    for klass in (1, 2):
        assert td.epoch_metrics[klass]["n_err"] == \
            jd.epoch_metrics[klass]["n_err"]
        np.testing.assert_allclose(td.epoch_metrics[klass]["loss"],
                                   jd.epoch_metrics[klass]["loss"],
                                   **STEP_TOL)


CIFAR_KNOBS = [{}, {"fused_tail": True},
               {"pallas_lrn": True, "fused_tail": True},
               {"fused_elementwise": True, "fused_tail": True}]


@pytest.mark.parametrize("knob_set", CIFAR_KNOBS,
                         ids=["off", "tail", "pallas_lrn", "fused"])
def test_cifar_plans_match_reference(knob_set, tmp_path):
    """CIFAR10's LRN follows its max pool, so no conv block fuses under
    any knob; ``fused_tail`` puts the bias+ReLU stage at the three
    convolutions (0, 3 and 5) and nowhere else."""
    from znicz_torch.fused_block import plan_fused_blocks, plan_fused_tail
    from znicz_tpu import pallas_fused_block as jfb

    with sample_config("cifar", **REDUCED["cifar"]):
        jwf = jax_sample("cifar", tmp_path)
        twf = port_sample("cifar", tmp_path)
    with knobs(**knob_set):
        t_blocks = plan_fused_blocks(twf.forwards)
        j_blocks = jfb.plan_fused_blocks(jwf.forwards)
        t_tail = {i: (s.kind, s.span) for i, s in
                  plan_fused_tail(twf.forwards, t_blocks).items()}
        j_tail = {i: (s.kind, s.span) for i, s in
                  jfb.plan_fused_tail(jwf.forwards, j_blocks).items()}
    assert t_blocks == {} and j_blocks == {}
    assert t_tail == j_tail == ({i: ("conv_bias_relu", 1) for i in (0, 3, 5)}
                                if knob_set.get("fused_tail") else {})


#: knobs -> the kernel wrappers one CIFAR10 train step calls, and how often
STEP_CALLS = {
    "composed": ({}, {}),
    "fused_tail": ({"fused_tail": True},
                   {"bias_relu_fwd": 3, "bias_relu_bwd": 3}),
    "pallas_lrn": ({"pallas_lrn": True, "fused_tail": True},
                   {"bias_relu_fwd": 3, "bias_relu_bwd": 3, "lrn_fwd": 1,
                    "lrn_bwd": 1}),
}


@pytest.mark.parametrize("routing", list(STEP_CALLS))
def test_cifar_train_step_calls_the_routings_kernels(routing, monkeypatch,
                                                     tmp_path):
    """The CPU twin of the card's launch counts: spies on the wrappers
    count what one train step at batch 50 calls (the card counts the same
    calls as launches); K1 and K1b are never called."""
    from znicz_torch import fused_block
    from znicz_torch.ops import lrn as lrn_ops
    from znicz_torch.parallel.fused import FusedTrainer

    calls = {}
    for mod, name in ((fused_block, "bias_relu_fwd"),
                      (fused_block, "bias_relu_bwd"),
                      (fused_block, "fused_block_fwd"),
                      (fused_block, "fused_block_bwd"),
                      (lrn_ops, "lrn_fwd"), (lrn_ops, "lrn_bwd")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    knob_set, want = STEP_CALLS[routing]
    with sample_config("cifar", **REDUCED["cifar"]), knobs(**knob_set):
        twf = port_sample("cifar", tmp_path)
        t = FusedTrainer(twf)
        loss, _, _ = t.train_step(np.arange(50), 50, 0)
    assert np.isfinite(float(loss))
    assert calls == want


def test_mnist_anchor_on_the_cpu(tmp_path):
    """The full default MNIST run (4000/800 images, batch 60, 5 epochs:
    334 updates) through the command line and ``FusedTrainer`` lands
    inside the anchor bands the reference recorded."""
    from bench import ANCHOR_BANDS

    out = subprocess.run(
        [sys.executable, "-m", "znicz_torch", "mnist", "--device", "cpu",
         "--fused", f"root.common.dirs.snapshots={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["epochs"] == 5
    assert res["train_steps"] == 334
    vals = {"final_train_loss": round(res["final_train_loss"], 6),
            "valid_err_pct": round(res["valid_err_pct"], 3)}
    for metric, (center, half) in ANCHOR_BANDS[0].items():
        assert abs(vals[metric] - center) <= half, (metric, vals[metric])
