"""``root.common.engine.pool_bwd = "mask"`` and the reference's engine
knobs the port does not read, against the JAX reference on the CPU.

  - the masked max-pool gradient (dy split equally among a window's tied
    maxima) against the reference's ``_masked_maxpool`` vjp on tie-heavy
    ReLU output, float32, max-abs 1e-6: the same float32 operations in
    the same order on both sides, the masks, the tie count, ``g / nt`` and
    the sum of the dilated parts;
  - three composed ``FusedTrainer`` steps of the tiny AlexNet under
    ``mask`` against the reference's, in the band of the reference's own
    trainer parity test (``tests/test_fused_block_pallas.py:244-248``:
    losses rtol 1e-3, weights rtol 5e-3 / atol 5e-5);
  - the command line refuses a knob the port does not read, set away
    from the reference's default, naming its ROADMAP item.
"""

import contextlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_planner import jax_workflow, tiny_layers
from test_torch_samples import REDUCED
from test_torch_train import STEP_GD, STEPS, _jax_masks, _port_workflow

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the reference's trainer band (tests/test_fused_block_pallas.py:244-248)
LOSS_RTOL, W_RTOL, W_ATOL = 1e-3, 5e-3, 5e-5


@contextlib.contextmanager
def pool_bwd(value):
    """Set ``pool_bwd`` on both packages' trees; put "sas" back on exit."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    try:
        for tree in (jroot, troot):
            tree.common.engine.pool_bwd = value
        yield
    finally:
        for tree in (jroot, troot):
            tree.common.engine.pool_bwd = "sas"


def _tie_heavy(shape, seed):
    """ReLU output with most windows all zero and some tied maxima."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape) - 0.8, 0.0)
    x[:, ::3] = np.round(x[:, ::3], 1)           # ties among the positives
    return x.astype(np.float32)


@pytest.mark.parametrize("shape,pool", [
    ((2, 13, 13, 8), (3, 3, 2, 2)),      # AlexNet's 3x3/2, full windows
    ((2, 14, 14, 5), (3, 3, 2, 2)),      # ragged: the last windows padded
    ((2, 16, 16, 16), (2, 2, 2, 2)),     # CIFAR10's 2x2 pool
], ids=["alexnet", "ragged", "cifar"])
def test_masked_gradient_matches_the_reference(shape, pool):
    import jax

    from znicz_torch.pooling import MaxPooling
    from znicz_tpu.pooling import _masked_maxpool

    ky, kx, sy, sx = pool
    x = _tie_heavy(shape, 3)
    mod = MaxPooling(kx=kx, ky=ky, sliding=(sy, sx))
    y_ref, vjp = jax.vjp(_masked_maxpool(ky, kx, sy, sx), x)
    g = np.random.default_rng(4).normal(size=y_ref.shape).astype(np.float32)
    want, = vjp(g)
    tx = torch.from_numpy(x).requires_grad_(True)
    with pool_bwd("mask"):
        y = mod(tx)
        got, = torch.autograd.grad(y, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the default routes each window's gradient to its first maximum: on
    # these ties the two differ, and both conserve the gradient's sum
    first, = torch.autograd.grad(mod(tx), tx, torch.from_numpy(g))
    assert not torch.allclose(first, got)
    np.testing.assert_allclose(float(first.sum()), float(got.sum()),
                               rtol=1e-5)


def test_composed_train_steps_under_mask_match_the_reference():
    """Three composed train steps of the tiny AlexNet under ``mask``
    from the reference's parameters with its dropout masks: losses and
    final weights in the reference's trainer band."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_from_jax, params_to_numpy
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    layers = tiny_layers(gd=STEP_GD)
    jwf = jax_workflow(layers)
    with pool_bwd("mask"):
        jt = JTrainer(jwf)
        params, vels, dataset, targets, _ = jt._device_state()
        start = {n: {k: np.asarray(v) for k, v in l.items()}
                 for n, l in params.items()}
        twf = params_from_jax(start, _port_workflow(jwf, layers))
        tt = FusedTrainer(twf, mask_fn=_jax_masks())
        step_fn = jt.make_train_step()
        for step, (idx, bs) in enumerate(STEPS):
            key = jprng.get("fused_trainer").jax_key(step)
            params, vels, (jloss, _, _) = step_fn(
                params, vels, jt.hypers(), dataset, targets,
                np.array(idx, np.int32), np.int32(bs), key)
            tloss, _, _ = tt.train_step(np.array(idx), bs, step)
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=LOSS_RTOL)
    got = params_to_numpy(twf)
    for name, leaves in params.items():
        for k, v in leaves.items():
            assert not np.array_equal(start[name][k], np.asarray(v))
            np.testing.assert_allclose(got[name][k], np.asarray(v),
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=f"{name}.{k}")


def _star_knob(knob, value):
    """A knob of the master/slave star or its relay tree, read since it
    was ported (the case keeps the id it had while refused)."""
    return pytest.param(knob, value, None, id=f"{knob}-{value}-A.7")


@pytest.mark.parametrize("knob,value,item", [
    _star_knob("job_segment", 2),
    _star_knob("wire_dtype", "bfloat16"),
    _star_knob("slave_ttl", 30.0),
    _star_knob("job_prefetch", False),
    _star_knob("staleness_bound", 2),
    _star_knob("tree_fanout", 4),
    _star_knob("mode", "master"),
    _star_knob("master_bind", "tcp://*:5571"),
    # read since A.8 (seq_parallel) was ported; MNIST has no attention
    pytest.param("seq_parallel", 2, None, id="seq_parallel-2-A.8"),
])
def test_cli_refuses_an_unported_knob(knob, value, item, tmp_path):
    """``python -m znicz_torch mnist root.common.engine.<knob>=<value>``
    exits non-zero with a ``NotImplementedError`` naming the knob and its
    ROADMAP item, and writes no snapshot: nothing trained.  A knob of the
    star or the tree (``item`` None) is read: the local run trains with it
    (those knobs act in the master, slave and relay roles), and
    ``mode=master`` makes the CLI serve as the master.  So is
    ``seq_parallel``, which acts on attention layers only."""
    over = [f"root.mnist.{k.replace('__', '.')}={v}"
            for k, v in REDUCED["mnist"].items()]
    cmd = [sys.executable, "-m", "znicz_torch", "mnist", "--device", "cpu",
           f"root.common.dirs.snapshots={tmp_path}", *over,
           f"root.common.engine.{knob}={value!r}"]
    if knob == "mode":
        cmd.append("root.common.engine.master_bind='tcp://127.0.0.1:*'")
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        try:
            assert "master serving" in proc.stdout.readline()
        finally:
            proc.kill()
            proc.wait()
        return
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    if item is None:
        assert out.returncode == 0, out.stderr[-2000:]
        assert list(tmp_path.iterdir())
        return
    assert out.returncode != 0
    last = out.stderr.strip().splitlines()[-1]
    assert last.startswith("NotImplementedError"), out.stderr[-2000:]
    assert f"root.common.engine.{knob}=" in last
    assert f"ROADMAP queue {item}" in last
    assert not list(tmp_path.iterdir())


#: the segmented run's, the streaming path's, the deep pipeline's, the
#: compiler, the mesh's gate and the snapshot formats' knobs, each set
#: away from its default
PORTED_A4 = {"remat": True, "scan_chunk": 4, "async_snapshot": False,
             "prefetch_segments": 0, "decode_workers": 2,
             "stream_budget_mb": 64, "async_staging": False,
             "staging_donate": False, "pipeline_depth": 2, "backend": "cpu",
             "fuse": False, "xla_latency_hiding": True, "train_shard": True,
             "snapshot_format": "orbax", "snapshot_sharded": True}
#: the training SLO's knobs, read by the master since telemetry was ported
PORTED_OBS_SLO = {"obs_slo_apply_progress": 0.9,
                  "obs_slo_fast_window_s": 30.0,
                  "obs_slo_slow_window_s": 300.0}


def test_defaults_and_ported_knobs_pass_the_check():
    """Every unported knob set to the reference's default, and every knob
    the port reads set away from its default (the training SLO's
    ``obs_slo_*`` too, read since telemetry was ported), passes the
    check."""
    from znicz_torch.core.config import (ENGINE_DEFAULTS,
                                         UNPORTED_ENGINE_KNOBS,
                                         check_engine_knobs, root)

    assert not set(UNPORTED_ENGINE_KNOBS) & set(ENGINE_DEFAULTS)
    eng = root.common.engine
    try:
        for key, (default, _) in UNPORTED_ENGINE_KNOBS.items():
            eng.set_by_path(key, default)
        eng.pool_bwd = "mask"
        eng.fused_tail = True
        for key, value in PORTED_A4.items():
            assert value != ENGINE_DEFAULTS[key], key
            setattr(eng, key, value)
        for key, value in PORTED_OBS_SLO.items():
            assert value != ENGINE_DEFAULTS[key], key
            setattr(eng, key, value)
        check_engine_knobs()
    finally:
        for key in list(UNPORTED_ENGINE_KNOBS) + ["mesh"]:
            delattr(eng, key.split(".")[0])
        for key in list(PORTED_A4) + list(PORTED_OBS_SLO):
            delattr(eng, key)
        eng.pool_bwd = "sas"
        eng.fused_tail = False
