"""The port's Kohonen slice (BASELINE config 3) against the JAX reference
on the CPU.

  - unit pairs: KohonenForward (winners, hit map, the padded tail
    masked) and KohonenTrainer (one step at two epochs of decay, padded
    rows) from the same input and weights: winners equal, qerror and
    weights within ``STEP_TOL``; the trainer's weight draw bit for bit;
  - the reference's oracles (``tests/test_kohonen_rbm.py``), ported:
    winners against a numpy argmin, the winner moving toward its sample,
    the padded tail uncounted, the grid's coordinates;
  - the sample at the reference test's reduced size (300 points, batch
    50, 8 epochs) on both packages: every minibatch's winners equal,
    every epoch's qerror and the final weights within ``STEP_TOL``; a
    parameter tree round trip through ``weights``;
  - ``python -m znicz_torch kohonen --device cpu``: the reference CLI
    test's tiny override prints the finals JSON, and the default
    configuration at seed 1013 lands inside ``bench.py``'s
    ``ANCHOR_BANDS[3]``.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_layers import _rand, sample_config
from test_torch_train import STEP_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
#: tests/test_kohonen_rbm.py's reduced sample
REDUCED = {"loader__n_train": 300, "loader__minibatch_size": 50,
           "decision__max_epochs": 8}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _pair(x, w, batch_size, epoch):
    """The reference's and the port's (trainer, forward) after one run
    each, from input ``x`` and weights ``w``; the forward is tied to the
    trainer and runs after its update, as in the sample."""
    from znicz_torch import kohonen as tk
    from znicz_torch.memory import Array as TArray
    from znicz_tpu import kohonen as jk
    from znicz_tpu.memory import Array as JArray

    out = []
    for mod, arr, dev in ((jk, JArray, None), (tk, TArray, CPU)):
        tr = mod.KohonenTrainer(None, name="trainer", shape=(3, 4),
                                learning_rate=0.5, decay_epochs=15)
        tr.input = arr(x)
        tr.batch_size = batch_size
        tr.epoch_number = epoch
        tr.initialize(device=dev)
        if dev is None:
            tr.weights.mem = w.copy()
        else:
            tr.weights.copy_(torch.from_numpy(w))
        tr.run()
        fwd = mod.KohonenForward(None, name="forward", shape=(3, 4),
                                 weights_from=tr)
        fwd.input = arr(x)
        fwd.batch_size = batch_size
        fwd.initialize(device=dev)
        fwd.run()
        out.append((tr, fwd))
    return out


@pytest.mark.parametrize("batch_size,epoch", [(7, 0), (5, 2)])
def test_kohonen_units_match_reference(batch_size, epoch):
    x = _rand((7, 2), 101)
    w = _rand((12, 2), 102, 0.5)
    (jtr, jfwd), (ttr, tfwd) = _pair(x, w, batch_size, epoch)
    assert ttr.current_lr_sigma() == jtr.current_lr_sigma()
    np.testing.assert_allclose(ttr.qerror, jtr.qerror, **STEP_TOL)
    np.testing.assert_allclose(_np(ttr.weights),
                               np.array(jtr.weights.map_read()), **STEP_TOL)
    assert tfwd.weights is ttr.weights
    np.testing.assert_array_equal(tfwd.output.map_read(),
                                  np.array(jfwd.output.map_read()))
    np.testing.assert_array_equal(tfwd.hits.map_read(),
                                  np.array(jfwd.hits.map_read()))
    assert tfwd.total == jfwd.total == batch_size


def test_kohonen_weight_draws_match_reference():
    """The trainer's uniform ±0.1 and a standalone forward's fill, each
    from its own named stream, bit for bit."""
    from znicz_torch import kohonen as tk
    from znicz_torch.core import prng as tprng
    from znicz_torch.memory import Array as TArray
    from znicz_tpu import kohonen as jk
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.memory import Array as JArray

    x = _rand((4, 3), 103)
    jprng.reset(1013)
    tprng.reset(1013)
    units = []
    for mod, arr, dev in ((jk, JArray, None), (tk, TArray, CPU)):
        tr = mod.KohonenTrainer(None, name="trainer", shape=(2, 3))
        fwd = mod.KohonenForward(None, name="kf", shape=(2, 3))
        for u in (tr, fwd):
            u.input = arr(x)
            u.initialize(device=dev)
        units.append((tr, fwd))
    (jtr, jfwd), (ttr, tfwd) = units
    np.testing.assert_array_equal(_np(ttr.weights), jtr.weights.mem)
    np.testing.assert_array_equal(_np(tfwd.weights), jfwd.weights.mem)
    assert ttr.weights.dtype == torch.float32


# -- the reference's oracles -------------------------------------------------

def test_kohonen_forward_winner_oracle():
    from znicz_torch.kohonen import KohonenForward
    from znicz_torch.memory import Array

    rng = np.random.default_rng(23)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    fwd = KohonenForward(None, name="kf", shape=(3, 3))
    fwd.input = Array(x)
    fwd.initialize(device=CPU)
    fwd.run()
    w = _np(fwd.weights)
    want = np.argmin(((x[:, None, :] - w[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(fwd.output.map_read(), want)
    assert fwd.hits.map_read().sum() == 6
    assert fwd.total == 6


def test_kohonen_trainer_moves_winner_toward_sample():
    from znicz_torch.kohonen import KohonenTrainer
    from znicz_torch.memory import Array

    x = np.array([[1.0, 1.0]], np.float32)
    tr = KohonenTrainer(None, name="kt", shape=(2, 2), learning_rate=0.5,
                        radius=0.5, decay_epochs=1e9)
    tr.input = Array(x)
    tr.batch_size = 1
    tr.initialize(device=CPU)
    w0 = _np(tr.weights).copy()
    d0 = ((w0 - x) ** 2).sum(1)
    win = int(np.argmin(d0))
    tr.run()
    d1 = ((_np(tr.weights) - x) ** 2).sum(1)
    assert d1[win] < d0[win]
    assert tr.qerror > 0


def test_kohonen_forward_masks_padded_tail():
    from znicz_torch.kohonen import KohonenForward
    from znicz_torch.memory import Array

    x = np.random.default_rng(24).normal(size=(5, 3)).astype(np.float32)
    fwd = KohonenForward(None, name="kfm", shape=(2, 2))
    fwd.input = Array(x)
    fwd.batch_size = 3
    fwd.initialize(device=CPU)
    fwd.run()
    assert fwd.total == 3
    assert fwd.hits.map_read().sum() == 3
    fwd.reset_hits()
    assert fwd.total == 0 and not fwd.hits.map_read().any()


def test_kohonen_grid_coords():
    from znicz_torch.kohonen import grid_coords
    from znicz_tpu.kohonen import grid_coords as jgrid

    c = grid_coords(2, 3)
    assert c.shape == (6, 2) and c.dtype == np.float32
    np.testing.assert_allclose(c[0], [0, 0])
    np.testing.assert_allclose(c[-1], [1, 2])
    np.testing.assert_array_equal(c, jgrid(2, 3))


def test_kohonen_trainer_needs_a_sample_width():
    from znicz_torch.kohonen import KohonenTrainer
    from znicz_torch.memory import Array

    tr = KohonenTrainer(None, name="kt")
    tr.input = Array()
    with pytest.raises(ValueError, match="no sample"):
        tr.initialize(device=CPU)


# -- the sample --------------------------------------------------------------

def _record_winners(fwd):
    """Each firing's winners (the real rows), in order."""
    seen, run = [], fwd.run

    def record():
        run()
        bs = fwd.batch_size
        seen.append(np.array(fwd.output.map_read())[:int(bs)])

    fwd.run = record
    return seen


def test_reduced_kohonen_matches_reference():
    from znicz_torch import engine
    from znicz_torch.core import prng as tprng
    from znicz_torch.samples import kohonen as tk
    from znicz_torch.weights import (params_from_jax, params_to_numpy,
                                     velocities_to_numpy)
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.samples import kohonen as jk

    with sample_config("kohonen", **REDUCED):
        jprng.reset(1013)
        jwf = jk.KohonenWorkflow()
        jwf.initialize(device=None)
        j_win = _record_winners(jwf.forward)
        jwf.run()
        tprng.reset(1013)
        twf = tk.KohonenWorkflow(device="cpu")
        t_win = _record_winners(twf.forward)
        stats = engine.train(twf, fused=True)      # no GD chain: units
    np.testing.assert_array_equal(twf.loader.original_data,
                                  jwf.loader.original_data.mem)
    assert stats["train_steps"] == twf.trainer.run_count == 6 * 8
    assert len(t_win) == len(j_win) == 6 * 8
    for i, (got, want) in enumerate(zip(t_win, j_win)):
        np.testing.assert_array_equal(got, want, err_msg=f"minibatch {i}")
    jd, td = jwf.decision, twf.decision
    assert len(td.epoch_qerror) == len(jd.epoch_qerror) == 8
    np.testing.assert_allclose(td.epoch_qerror, jd.epoch_qerror, **STEP_TOL)
    assert td.epoch_qerror[-1] < td.epoch_qerror[0] * 0.5
    w = params_to_numpy(twf)
    assert sorted(w) == ["trainer"] and velocities_to_numpy(twf) == {}
    np.testing.assert_allclose(w["trainer"]["weights"],
                               np.array(jwf.trainer.weights.map_read()),
                               **STEP_TOL)
    np.testing.assert_array_equal(twf.forward.hits.map_read(),
                                  np.array(jwf.forward.hits.map_read()))
    # the reference's weights load into the trainer's tensor, which the
    # forward reads
    tree = {"trainer": {"weights": np.array(jwf.trainer.weights.map_read())}}
    params_from_jax(tree, twf)
    assert twf.forward.weights is twf.trainer.weights
    np.testing.assert_array_equal(_np(twf.forward.weights),
                                  tree["trainer"]["weights"])


def _cli(tmp_path, *args):
    out = subprocess.run(
        [sys.executable, "-m", "znicz_torch", "kohonen", "--device", "cpu",
         *args, f"root.common.dirs.snapshots={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_tiny_kohonen_prints_its_finals(tmp_path):
    res = _cli(tmp_path, "root.kohonen.decision.max_epochs=1")
    assert res["workflow"] == "kohonen" and res["device"] == "cpu"
    assert res["epochs"] == 1 and res["train_steps"] == 20
    assert res["final_qerror"] == res["first_qerror"] > 0
    assert "valid_err_pct" not in res and res["compute_dtype"] == "float32"


def test_kohonen_anchor_on_the_cpu(tmp_path):
    """The default run (1000 points, batch 50, 8x8, 10 epochs: 200
    updates) at seed 1013 lands inside the anchor band the reference
    recorded, its first epoch's qerror at the reference's 0.4628."""
    from bench import ANCHOR_BANDS

    res = _cli(tmp_path, "--seed", "1013")
    assert res["epochs"] == 10 and res["train_steps"] == 200
    for metric, (center, half) in ANCHOR_BANDS[3].items():
        assert abs(round(res[metric], 6) - center) <= half, (metric,
                                                            res[metric])
    assert abs(res["first_qerror"] - 0.4628) < 1e-3
