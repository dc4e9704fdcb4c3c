"""The ``wine`` sample (13 features, 3 classes, a ``MeanDispNormalizer`` on
the loader) at its defaults, seed 1013, on the CPU: the port's run on
the unit engine and on ``FusedTrainer`` (``--fused``) against the
reference's unit-engine run, every TRAIN loss within rtol 1e-4, the
dataset after normalisation bit-equal, the last epoch's metrics; and
``python -m znicz_torch wine``'s JSON line."""

import json

import numpy as np
import pytest

from test_torch_engine import _record_train_losses
from test_torch_layers import sample_config

#: the port's losses against the reference's, step for step
LOSS_TOL = {"rtol": 1e-4}
#: the ``root.wine`` keys the asserts depend on, at the sample's defaults,
#: set in both packages' trees for each run (another test may have left
#: other values there)
WINE = {"decision__max_epochs": 20, "decision__fail_iterations": 0}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's wine run at its defaults: (normalised data, TRAIN
    losses, last epoch's metrics)."""
    from znicz_tpu.core import prng
    from znicz_tpu.core.config import root
    from znicz_tpu.engine import train
    from znicz_tpu.samples.wine import WineWorkflow

    root.common.dirs.snapshots = str(tmp_path_factory.mktemp("ref"))
    with sample_config("wine", **WINE):
        prng.reset(1013)
        wf = WineWorkflow()
        wf.initialize(device=None)
        data = np.array(wf.loader.original_data.mem)
        losses = _record_train_losses(wf.decision)
        train(wf)
    d = wf.decision
    return data, losses, {k: d.epoch_metrics[k]["err_pct"] for k in (1, 2)}


def _port_run(tmp_path, fused):
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import wine

    root.common.dirs.snapshots = str(tmp_path)
    with sample_config("wine", **WINE):
        prng.reset(1013)
        wf = wine.WineWorkflow(device="cpu")
        data = wf.loader.data.numpy().copy()
        wine.train(wf, "wine", fused=fused)
    return wf, data


@pytest.mark.parametrize("fused", [False, True])
def test_wine_matches_reference_step_for_step(fused, reference, tmp_path):
    from znicz_torch.__main__ import finals
    from znicz_torch.normalization import MeanDispNormalizer

    ref_data, ref_losses, ref_err = reference
    wf, data = _port_run(tmp_path, fused)
    np.testing.assert_array_equal(data, ref_data)
    assert isinstance(wf.loader.normalizer, MeanDispNormalizer)
    losses = list(wf.decision.train_losses)
    assert len(losses) == len(ref_losses) == 20 * 13
    np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL)
    assert hasattr(wf, "trainer") == fused
    assert wf.train_stats["train_steps"] == 259
    got = finals("wine", wf)
    assert got["epochs"] == 20
    assert got["valid_err_pct"] == ref_err[1]
    np.testing.assert_allclose(got["final_train_loss"],
                               wf.decision.epoch_metrics[2]["loss"])
    assert (tmp_path / "wf_best.pickle.gz").exists()


def test_wine_cli_prints_its_finals(tmp_path, capsys):
    from znicz_torch.__main__ import main

    with sample_config("wine", decision__max_epochs=2):
        assert main(["wine", "--device", "cpu", "--seed", "1013",
                     f"root.common.dirs.snapshots={tmp_path}"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workflow"] == "wine" and line["device"] == "cpu"
    assert line["epochs"] == 2 and line["train_steps"] == 25
    assert set(line) >= {"valid_err_pct", "final_train_loss",
                         "img_per_sec", "compute_dtype"}
