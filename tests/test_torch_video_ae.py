"""The port's VideoAE sample and ``FusedTrainer``'s MSE head against the
JAX reference on the CPU.

  - ``datasets.videoframes`` bit for bit the reference's (the
    ``dataset.video`` stream), frames and clip ids;
  - a reduced VideoAE (200 + 100 frames, batch 50, 2 epochs; the published
    widths) from seed 1013 on the unit engine and on ``FusedTrainer``
    against the reference's run on the same engine: every train loss, the
    last epoch's losses and the final parameters within ``STEP_TOL``;
  - the MSE head on a hand batch whose last rows are padding (garbage the
    loss must not see): the port's loss equal to the reference's
    ``loss_and_metrics`` and to ``0.5 * sum((y - t)^2) / rows`` over the
    valid rows, n_err 0 and a (1, 1) confusion, and its gradient zero for
    the padded rows;
  - ``DecisionMSE`` has no ``minibatch_n_err``: the fused trainer feeds it
    the loss alone, as the reference's does;
  - ``python -m znicz_torch video_ae``'s JSON line.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_kanji import assert_same_run, train_both
from test_torch_layers import sample_config

REDUCED = {"loader__n_train": 200, "loader__n_valid": 100,
           "loader__minibatch_size": 50, "decision__max_epochs": 2}


@pytest.mark.parametrize("n", [40, 37, 1])
def test_videoframes_is_the_references_bit_for_bit(n):
    from znicz_torch import datasets as tdata
    from znicz_torch.core import prng as tprng
    from znicz_tpu import datasets as jdata
    from znicz_tpu.core import prng as jprng

    tprng.reset(1013)
    jprng.reset(1013)
    got, want = tdata.videoframes(n), jdata.videoframes(n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (n, 16, 16)
    assert got[1].tolist() == [i // 8 for i in range(n)]


@pytest.mark.parametrize("fused", [False, True], ids=["units", "fused"])
def test_reduced_video_ae_matches_the_reference(fused, tmp_path):
    with sample_config("video_ae", **REDUCED):
        jwf, j_losses, twf = train_both("video_ae", tmp_path, fused)
    assert type(twf.evaluator).__name__ == "EvaluatorMSE"
    assert type(twf.decision).__name__ == "DecisionMSE"
    assert twf.loader.targets is twf.loader.data
    assert_same_run(jwf, j_losses, twf, 8, ("loss", "mse"))
    assert twf.train_stats["train_steps"] == 7
    if fused:
        assert twf.trainer.loss_kind == "mse"
        assert not hasattr(twf.decision, "minibatch_n_err")


def _tiny_pair(tmp_path):
    """The reference's and the port's VideoAE at 10 + 10 frames, batch 5,
    from seed 1013, with their fused trainers."""
    from znicz_torch.core import prng as tprng
    from znicz_torch.core.config import root as troot
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.video_ae import VideoAEWorkflow as TWorkflow
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
    from znicz_tpu.samples.video_ae import VideoAEWorkflow as JWorkflow

    jroot.common.dirs.snapshots = troot.common.dirs.snapshots = str(tmp_path)
    with sample_config("video_ae", loader__n_train=10, loader__n_valid=10,
                       loader__minibatch_size=5, decision__max_epochs=2):
        jprng.reset(1013)
        jwf = JWorkflow()
        jwf.initialize(device=None)
        tprng.reset(1013)
        twf = TWorkflow(device="cpu")
    return JTrainer(jwf), FusedTrainer(twf)


def test_the_mse_head_matches_the_reference_on_padded_rows(tmp_path):
    jt, tt = _tiny_pair(tmp_path)
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 1, (5, 16, 16)).astype(np.float32)
    target = rng.uniform(0, 1, (5, 16, 16)).astype(np.float32)
    data[3:] = 1e3                                 # padding: never seen
    target[3:] = -1e3
    params, _, _, _, _ = jt._device_state()
    jloss, (_, j_err, j_conf) = jt.loss_and_metrics(
        params, data, target, np.int32(3), None, False)
    x = torch.from_numpy(data)
    loss, (mloss, n_err, conf) = tt.loss_and_metrics(
        x, torch.from_numpy(target), 3, 0, train=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(mloss) == float(loss)
    assert int(n_err) == int(j_err) == 0
    assert tuple(conf.shape) == tuple(np.shape(j_conf)) == (1, 1)
    assert int(conf.sum()) == 0
    y = tt.forward_pass(x[:3]).detach().numpy().reshape(3, -1)
    want = 0.5 * np.sum(np.square(y - target[:3].reshape(3, -1))) / 3
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    x.requires_grad_(True)
    loss, _ = tt.loss_and_metrics(x, torch.from_numpy(target), 3, 0,
                                  train=True)
    (gx,) = torch.autograd.grad(loss, [x])
    assert float(gx[3:].abs().max()) == 0.0
    assert float(gx[:3].abs().max()) > 0.0


def test_decision_mse_gets_no_n_err_from_the_fused_trainer(tmp_path):
    from znicz_torch.decision import DecisionMSE

    _, tt = _tiny_pair(tmp_path)
    d = tt.decision
    assert isinstance(d, DecisionMSE) and not hasattr(d, "minibatch_n_err")
    assert not hasattr(tt.workflow.evaluator, "confusion_explicit")
    assert tt.compute_confusion is True
    tt.run()
    assert not hasattr(d, "minibatch_n_err")
    assert not hasattr(d, "confusion_matrix")
    assert bool(d.complete) and len(d.train_losses) == 2 * 2
    for klass in (1, 2):
        m = d.epoch_metrics[klass]
        assert set(m) == {"loss", "mse"} and m["loss"] == m["mse"] > 0


def test_video_ae_cli_prints_its_finals(tmp_path, capsys):
    from znicz_torch.__main__ import main
    from znicz_torch.core.config import root

    try:
        with sample_config("video_ae", **REDUCED):
            assert main(["video_ae", "--device", "cpu", "--fused",
                         f"root.common.dirs.snapshots={tmp_path}"]) == 0
    finally:
        root.common.engine.fused = False
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workflow"] == "video_ae" and line["epochs"] == 2
    assert line["train_steps"] == 7
    assert line["final_train_mse"] > 0 and line["valid_mse"] > 0
    assert "valid_err_pct" not in line
    assert (tmp_path / "video_ae_best.pickle.gz").exists()
