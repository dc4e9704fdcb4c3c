"""The port's Kanji sample against the JAX reference on the CPU.

  - ``datasets.kanji`` bit for bit the reference's at several sizes and
    class counts (the ``dataset.kanji`` and ``dataset.kanji.classes``
    streams);
  - a reduced Kanji (256 + 128 glyphs, 8 classes, batch 64, 2 epochs; the
    published widths) from seed 1013 on the unit engine and on
    ``FusedTrainer`` under ``fused_tail`` (the reference's K2/K2b in
    interpret mode, the port's plain twins), against the reference's run
    on the same engine: every train loss, the last epoch's metrics and
    the final parameters within ``STEP_TOL``;
  - both packages' ``plan_fused_tail`` give the same spans on Kanji's and
    YaleFaces' layer lists: the two ``conv_strict_relu`` layers take the
    bias+ReLU stage and ``all2all_tanh`` no FC epilogue;
  - in bf16 under ``fused_tail`` the port's run within the reference's
    bf16 band (``tests/test_torch_bf16.py:56``) of the reference's bf16
    run;
  - ``python -m znicz_torch kanji``'s JSON line.

``train_both`` is shared with the VideoAE and YaleFaces tests.
"""

import importlib
import json

import numpy as np
import pytest

from test_torch_bf16 import LOSS_RTOL as BF16_LOSS_RTOL
from test_torch_bf16 import dtype_knobs
from test_torch_engine import _record_train_losses
from test_torch_layers import jax_params, sample_config
from test_torch_planner import knobs
from test_torch_train import STEP_TOL

REDUCED = {"loader__n_train": 256, "loader__n_valid": 128,
           "loader__n_classes": 8, "loader__minibatch_size": 64,
           "decision__max_epochs": 2}
WORKFLOWS = {"kanji": "KanjiWorkflow", "video_ae": "VideoAEWorkflow",
             "yale_faces": "YaleFacesWorkflow"}


def train_both(sample, tmp_path, fused, kwargs=None):
    """The reference's and the port's ``sample`` built after
    ``prng.reset(1013)`` and trained on the same engine (``fused``: each
    package's ``FusedTrainer`` through its ``engine.train``) under the
    config and knobs set now, the port on the CPU; ``kwargs`` go to both
    workflows.  Returns (reference workflow, its train losses, port
    workflow)."""
    from znicz_torch import engine
    from znicz_torch.core import prng as tprng
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.engine import train as jtrain

    kwargs = kwargs or {}
    jroot.common.dirs.snapshots = str(tmp_path / "ref")
    troot.common.dirs.snapshots = str(tmp_path / "port")
    jmod = importlib.import_module(f"znicz_tpu.samples.{sample}")
    tmod = importlib.import_module(f"znicz_torch.samples.{sample}")
    jprng.reset(1013)
    jwf = getattr(jmod, WORKFLOWS[sample])(**kwargs)
    jwf.initialize(device=None)
    j_losses = _record_train_losses(jwf.decision)
    jroot.common.engine.fused = fused
    try:
        jtrain(jwf)
    finally:
        jroot.common.engine.fused = False
    tprng.reset(1013)
    twf = getattr(tmod, WORKFLOWS[sample])(device="cpu", **kwargs)
    engine.train(twf, fused)
    assert hasattr(twf, "trainer") == fused
    return jwf, j_losses, twf


def assert_same_run(jwf, j_losses, twf, n_steps, metrics, tol=STEP_TOL):
    """Every train loss, the last epoch's ``metrics`` for VALID and TRAIN
    and every final parameter of the port's run within ``tol`` of the
    reference's."""
    from znicz_torch.weights import params_to_numpy

    t_losses = list(twf.decision.train_losses)
    assert len(t_losses) == len(j_losses) == n_steps
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, **tol)
    for klass in (1, 2):
        want = jwf.decision.epoch_metrics[klass]
        got = twf.decision.epoch_metrics[klass]
        for key in metrics:
            np.testing.assert_allclose(got[key], want[key], **tol,
                                       err_msg=f"class {klass} {key}")
    got, want = params_to_numpy(twf), jax_params(jwf)
    assert sorted(got) == sorted(want)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v, **tol,
                                       err_msg=f"{name}.{k}")


@pytest.mark.parametrize("n,n_classes", [(40, 64), (33, 8), (7, 1)])
def test_kanji_dataset_is_the_references_bit_for_bit(n, n_classes):
    from znicz_torch import datasets as tdata
    from znicz_torch.core import prng as tprng
    from znicz_tpu import datasets as jdata
    from znicz_tpu.core import prng as jprng

    tprng.reset(1013)
    jprng.reset(1013)
    got = tdata.kanji(n, n_classes=n_classes)
    want = jdata.kanji(n, n_classes=n_classes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (n, 24, 24)
    assert 0.0 <= got[0].min() and got[0].max() <= 1.0
    assert set(got[1].tolist()) <= set(range(n_classes))
    again = tdata.kanji(n, n_classes=n_classes)     # the streams move on
    assert not np.array_equal(again[0], got[0])


@pytest.mark.parametrize("fused", [False, True], ids=["units", "fused_tail"])
def test_reduced_kanji_matches_the_reference(fused, tmp_path):
    with sample_config("kanji", **REDUCED), knobs(fused_tail=fused):
        jwf, j_losses, twf = train_both("kanji", tmp_path, fused)
    np.testing.assert_array_equal(
        twf.loader.original_data, np.asarray(jwf.loader.original_data.mem))
    assert twf.loader.original_data.shape == (384, 24, 24, 1)
    assert_same_run(jwf, j_losses, twf, 8, ("loss", "err_pct"))
    assert twf.train_stats["train_steps"] == 7    # the last tail skipped


@pytest.mark.parametrize("sample", ["kanji", "yale_faces"])
def test_both_planners_give_the_same_spans(sample):
    from znicz_torch.fused_block import plan_fused_blocks as t_blocks
    from znicz_torch.fused_block import plan_fused_tail as t_tail
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_tpu.pallas_fused_block import plan_fused_blocks as j_blocks
    from znicz_tpu.pallas_fused_block import plan_fused_tail as j_tail
    from test_torch_planner import jax_workflow

    tmod = importlib.import_module(f"znicz_torch.samples.{sample}")
    layers = tmod.make_layers(8)
    shape = (24, 24, 1) if sample == "kanji" else (32, 32, 3)
    with knobs(fused_elementwise=True, fused_tail=True):
        jf = jax_workflow(layers, shape).forwards
        tf = StandardWorkflow(layers, shape, device="cpu").forwards
        jb, tb = j_blocks(jf), t_blocks(tf)
        jt = {i: tuple(s) for i, s in j_tail(jf, jb).items()}
        tt = {i: tuple(s) for i, s in t_tail(tf, tb).items()}
    assert jb == tb == {}
    assert tt == jt
    assert {i: s[:2] for i, s in tt.items()} == {
        0: ("conv_bias_relu", 1), 2: ("conv_bias_relu", 1)}


def test_bf16_kanji_stays_in_the_references_bf16_band(tmp_path):
    cfg = dict(REDUCED, decision__max_epochs=1)
    with sample_config("kanji", **cfg), knobs(fused_tail=True), \
            dtype_knobs(compute_dtype="bf16"):
        jwf, j_losses, twf = train_both("kanji", tmp_path, True)
        assert str(twf.trainer.compute_dtype) == "torch.bfloat16"
    t_losses = twf.decision.train_losses
    assert len(t_losses) == len(j_losses) == 4
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=BF16_LOSS_RTOL)


def test_kanji_cli_prints_its_finals(tmp_path, capsys):
    from znicz_torch.__main__ import main
    from znicz_torch.core.config import root

    try:
        with sample_config("kanji", **REDUCED):
            assert main(["kanji", "--device", "cpu", "--fused",
                         f"root.common.dirs.snapshots={tmp_path}",
                         "root.common.engine.fused_tail=True"]) == 0
    finally:
        root.common.engine.fused = False
        root.common.engine.fused_tail = False
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workflow"] == "kanji" and line["device"] == "cpu"
    assert line["epochs"] == 2 and line["train_steps"] == 7
    assert {"valid_err_pct", "final_train_loss", "img_per_sec",
            "compute_dtype"} <= set(line)
    assert (tmp_path / "kanji_best.pickle.gz").exists()
