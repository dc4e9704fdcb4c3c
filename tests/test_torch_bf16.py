"""bf16 training in the port against the JAX reference on the CPU.

  - the precision knobs resolve as the reference's: ``compute_dtype``
    "bf16"/"bfloat16"/"float32", the legacy ``precision`` only when
    ``compute_dtype`` is unset, and a ``ValueError`` naming the knob for
    a bad spelling of ``compute_dtype``, ``state_dtype`` or
    ``master_dtype``;
  - the bf16 operands of K1, K1b, K2 and K2b: the port's plain versions
    compute in float32 and round once, bit for bit the float32 version on
    the widened operands; through ``fused_block`` and ``fused_bias_relu``
    (output, dx, db) they match the reference's custom vjps (its Pallas
    kernels in interpret mode) within the reference's own rtol/atol 2e-2
    (``tests/test_fused_block_pallas.py:65-75``), in the reference's
    dtypes;
  - ``sgd_update`` with a bf16 velocity: float32 arithmetic and one
    round-to-nearest-even store on both sides, bit for bit;
  - ``FusedTrainer`` in bf16: three train steps of the tiny AlexNet with
    the reference's dropout masks, composed and ``fused`` +
    ``fused_tail``, and a two-epoch run of the tiny AlexStyle workflow,
    per-step and per-epoch losses within rtol 5e-2 of the reference's
    bf16 runs and of each other (``tests/test_fused_block_pallas.py:
    251-266``); reduced MNIST for 2 epochs, bf16 against float32 within
    rtol 5e-2 (``tests/test_fused_tail.py:367-394``);
  - ``state_dtype`` bf16: velocities stored bf16 on both engines, the
    trajectory within rtol 2e-2 of the float32 run's
    (``tests/test_fused.py:178-203``); ``master_dtype`` bf16: parameters
    stored bf16, the final loss in ``tests/test_perf_guards.py``'s band;
  - a snapshot written under bf16 state restores into the reference and
    into the port;
  - refusals and ignores: ``pallas_lrn`` under bf16 is refused (its
    kernels have no bf16 variant yet); the unit engine and the serving
    forward ignore ``compute_dtype``, as the reference's do; the command
    line's dotted override reaches the trainer.
"""

import contextlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_layers import jax_sample, port_sample, sample_config
from test_torch_planner import SAMPLE, jax_workflow, knobs, tiny_layers
from test_torch_samples import REDUCED
from test_torch_train import (STEP_GD, STEPS, _alexstyle_port, _jax_masks,
                              _port_workflow)

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the reference's own bf16 bands: kernels against the float32 oracle
#: (tests/test_fused_block_pallas.py:65-75), trainer runs against each
#: other (tests/test_fused_block_pallas.py:251-266, test_fused_tail.py)
KERNEL_TOL = {"rtol": 2e-2, "atol": 2e-2}
LOSS_RTOL = 5e-2
#: the precision knobs and their defaults on both config trees
DTYPE_DEFAULTS = {"compute_dtype": None, "precision": "float32",
                  "state_dtype": "float32", "master_dtype": "float32"}


@contextlib.contextmanager
def dtype_knobs(**kw):
    """Set precision knobs on both packages' trees; put the defaults back
    on exit."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    try:
        for tree in (jroot, troot):
            for key, val in kw.items():
                setattr(tree.common.engine, key, val)
        yield
    finally:
        for tree in (jroot, troot):
            for key in kw:
                setattr(tree.common.engine, key, DTYPE_DEFAULTS[key])


def _tiny_port():
    from znicz_torch.standard_workflow import StandardWorkflow

    return StandardWorkflow(tiny_layers(), SAMPLE, device="cpu")


@pytest.fixture(scope="module")
def tiny_reference():
    return jax_workflow(tiny_layers())


# -- the knobs -----------------------------------------------------------------


@pytest.mark.parametrize("kw,want", [
    ({"compute_dtype": "bf16"}, torch.bfloat16),
    ({"compute_dtype": "bfloat16"}, torch.bfloat16),
    ({"compute_dtype": "float32"}, torch.float32),
    ({"precision": "bfloat16"}, torch.bfloat16),
    ({"precision": "bfloat16", "compute_dtype": "float32"}, torch.float32)])
def test_compute_dtype_resolves_as_the_reference(kw, want, tiny_reference):
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    with dtype_knobs(**kw):
        got = FusedTrainer(_tiny_port()).compute_dtype
        ref = JTrainer(tiny_reference).compute_dtype
    assert got == want
    assert str(ref) == str(want).split(".")[-1]


@pytest.mark.parametrize("knob", ["compute_dtype", "state_dtype",
                                  "master_dtype"])
def test_a_bad_spelling_raises_naming_the_knob(knob, tiny_reference):
    from znicz_torch.nn_units import GradientDescentBase
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.nn_units import _state_dtype
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    twf = _tiny_port()
    with dtype_knobs(**{knob: "float16"}):
        with pytest.raises(ValueError, match=knob):
            FusedTrainer(twf)
        with pytest.raises(ValueError, match=knob):
            if knob == "state_dtype":
                _state_dtype()          # read where the GD units initialise
            else:
                JTrainer(tiny_reference)
        if knob == "state_dtype":       # the port's GD units, likewise
            gd = next(g for g in twf.gd_units
                      if isinstance(g, GradientDescentBase)
                      and g.forward.has_weights)
            gd.velocities = {}
            with pytest.raises(ValueError, match=knob):
                gd.init_velocities()


# -- the kernels' bf16 operands ------------------------------------------------


def _bf16_operands(shape, pooled, seed):
    """x, bias and the cotangent as float32 numpy arrays that bf16 holds
    exactly, so both packages start from the same bits."""
    import ml_dtypes

    rng = np.random.default_rng(seed)

    def rounded(a):
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)

    return (rounded(rng.normal(size=shape) * 2.0),
            rounded(rng.normal(size=shape[-1:]) * 0.1),
            rounded(rng.normal(size=pooled)))


#: (stage, shape, pool): odd C, C not a multiple of 8, both pools
TWIN_CASES = [("block", (2, 9, 9, 32), (3, 3, 2, 2)),
              ("block", (2, 13, 13, 13), (3, 3, 2, 2)),
              ("block", (1, 8, 8, 20), (2, 2, 2, 2)),
              ("bias_relu", (2, 5, 5, 24), None),
              ("bias_relu", (1, 3, 3, 7), None)]


@pytest.mark.parametrize("stage,shape,pool", TWIN_CASES)
def test_bf16_stage_matches_the_reference(stage, shape, pool):
    """Output, dx and db of the port's stage (its bf16 plain versions on
    the CPU) against the reference's custom vjp (Pallas in interpret
    mode) on the same bf16 inputs, in the reference's dtypes; and each
    plain version is the float32 one on the widened operands, rounded
    once."""
    import jax
    import jax.numpy as jnp

    from znicz_torch import fused_block as tfb
    from znicz_tpu import pallas_fused_block as jfb

    n, alpha, beta, k = 5, 1e-4, 0.75, 2.0
    if stage == "block":
        ky, kx, sy, sx = pool
        pooled = (shape[0], (shape[1] - ky) // sy + 1,
                  (shape[2] - kx) // sx + 1, shape[3])
    else:
        pooled = shape
    x, b, dp = _bf16_operands(shape, pooled, seed=sum(shape))

    def jfn(xx, bb):
        if stage == "block":
            return jfb.fused_block(xx, bb, n, alpha, beta, k, pool)
        return jfb.fused_bias_relu(xx, bb)

    def tfn(xx, bb):
        if stage == "block":
            return tfb.fused_block(xx, bb, n, alpha, beta, k, pool)
        return tfb.fused_bias_relu(xx, bb)

    jx, jb, jdp = (jnp.asarray(a, jnp.bfloat16) for a in (x, b, dp))
    jy, vjp = jax.vjp(jfn, jx, jb)
    jdx, jdb = vjp(jdp)
    tx, tb, tdp = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                   for a in (x, b, dp))
    ty = tfn(tx, tb)
    tdx, tdb = torch.autograd.grad(ty, (tx, tb), tdp.detach())
    assert jy.dtype == jdx.dtype == jdb.dtype == jnp.bfloat16
    assert ty.dtype == tdx.dtype == tdb.dtype == torch.bfloat16
    for got, want, what in ((ty, jy, "out"), (tdx, jdx, "dx"),
                            (tdb, jdb, "db")):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   err_msg=what, **KERNEL_TOL)
    # the plain versions: float32 math on the widened operands, rounded
    # once; db float32 before the wrapper's cast
    xf, bf_, dpf = (torch.from_numpy(a) for a in (x, b, dp))
    xh, bh, dph = (t.to(torch.bfloat16) for t in (xf, bf_, dpf))
    if stage == "block":
        hyp = (n, alpha, beta, k, pool)
        pairs = [(tfb.fused_block_plain(xh, bh, *hyp),
                  tfb.fused_block_plain(xf, bf_, *hyp))]
        (dx16, db16), (dx32, db32) = (
            tfb.fused_block_bwd_plain(xh, bh, dph, *hyp),
            tfb.fused_block_bwd_plain(xf, bf_, dpf, *hyp))
    else:
        pairs = [(tfb.bias_relu_plain(xh, bh), tfb.bias_relu_plain(xf, bf_))]
        (dx16, db16), (dx32, db32) = (
            tfb.bias_relu_bwd_plain(xh, bh, dph),
            tfb.bias_relu_bwd_plain(xf, bf_, dpf))
    pairs.append((dx16, dx32))
    for got, f32 in pairs:
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16),
                           f32.to(torch.bfloat16).view(torch.int16))
    assert db16.dtype == torch.float32 and torch.equal(db16, db32)


def test_modules_keep_bf16_and_a_dropout_mask_widens():
    """Under bf16 compute every composed module of the tiny AlexNet takes
    and gives bf16 (StrictRELU's float32 zero does not widen it); the FC
    epilogue's product with the float32 dropout mask is float32, as the
    reference's, its gradients in the operands' dtypes."""
    from znicz_torch.fused_block import fused_fc_epilogue
    from znicz_torch.parallel.fused import FusedTrainer

    twf = _tiny_port()
    seen = []
    for f in twf.forwards:
        f.register_forward_hook(
            lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4,) + SAMPLE).astype(np.float32))
    with dtype_knobs(compute_dtype="bf16"):
        t = FusedTrainer(twf)
        with t._compute_params():
            y = t.forward_pass(t._cast(x), True, 0, t._cast)
    assert y.dtype == torch.bfloat16
    assert len(seen) == 12 and set(seen) == {(torch.bfloat16,) * 2}
    yb = torch.randn(4, 6).to(torch.bfloat16).requires_grad_()
    bb = torch.randn(6).to(torch.bfloat16).requires_grad_()
    mask = (torch.rand(4, 6) < 0.5).float() * 2.0
    out = fused_fc_epilogue(yb, bb, lambda: mask)
    assert out.dtype == torch.float32
    dy, db = torch.autograd.grad(out.sum(), (yb, bb))
    assert dy.dtype == db.dtype == torch.bfloat16


#: the standalone LRN in bf16, (shape, n, alpha, beta, k, input scale):
#: AlexNet's conv2 width at n 5; an even window; beta 0.6 (pow of a
#: rounded exponent) and 0.5; s over many binades; CIFAR10's C 16; n 1
LRN_BF16_CASES = [((8, 13, 13, 96), 5, 1e-4, 0.75, 2.0, 2.0),
                  ((4, 9, 9, 64), 4, 1e-4, 0.75, 2.0, 2.0),
                  ((4, 9, 9, 96), 5, 1e-4, 0.6, 2.0, 2.0),
                  ((4, 9, 9, 96), 5, 1e-4, 0.5, 2.0, 2.0),
                  ((4, 9, 9, 96), 5, 1e-2, 0.75, 1e-3, 100.0),
                  ((10, 16, 16, 16), 5, 1e-4, 0.75, 2.0, 2.0),
                  ((3, 9, 9, 32), 1, 1e-4, 0.75, 2.0, 2.0)]


def _lrn_operands(shape, scale, seed):
    """ReLU output x (zeros included, so t holds signed zeros) and dy,
    as ml_dtypes bf16 arrays and as the bf16 tensors of the same bits."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape) * scale, 0).astype(
        ml_dtypes.bfloat16)
    dy = rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    return x, dy, *(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                    for a in (x, dy))


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("shape,n,alpha,beta,k,scale", LRN_BF16_CASES)
def test_bf16_lrn_plain_is_the_reference_bit_for_bit(shape, n, alpha, beta,
                                                     k, scale):
    """The plain versions of the bf16 K3 and K3b (every operation rounded
    to bf16, the constants first) give the bits of the reference's
    ``lrn_pallas.lrn`` forward and vjp, its kernels in interpret mode, in
    every element, signed zeros included."""
    import jax

    from znicz_torch.ops.lrn import lrn_bwd_plain, lrn_plain
    from znicz_tpu.ops.lrn_pallas import lrn as jax_lrn

    x, dy, tx, tdy = _lrn_operands(shape, scale, sum(shape) + n)
    y, vjp = jax.vjp(lambda v: jax_lrn(v, n, alpha, beta, k), x)
    dx, = vjp(dy)
    assert y.dtype == dx.dtype == np.dtype(dy.dtype)
    np.testing.assert_array_equal(_bits(lrn_plain(tx, n, alpha, beta, k)),
                                  np.asarray(y).view(np.int16))
    np.testing.assert_array_equal(
        _bits(lrn_bwd_plain(tx, tdy, n, alpha, beta, k)),
        np.asarray(dx).view(np.int16))


@pytest.mark.parametrize("n,beta", [(5, 0.75), (4, 0.6), (1, 0.5)])
def test_float32_lrn_plain_keeps_its_bits(n, beta):
    """Rounding the constants to the operand dtype changes no float32 bit:
    the plain versions equal the formulation with the unrounded Python
    constants, which PyTorch casts to float32 itself."""
    from znicz_torch.ops.lrn import (lrn_bwd_plain, lrn_plain,
                                     windowed_channel_sum)

    rng = np.random.default_rng(n)
    x = torch.from_numpy(np.maximum(rng.normal(size=(3, 7, 7, 40)) * 2, 0)
                         .astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(3, 7, 7, 40)).astype(np.float32))
    alpha, k = 1e-4, 2.0
    s = k + alpha * windowed_channel_sum(x * x, n)
    sb = torch.pow(s, -beta)
    want_dx = dy * sb - (2.0 * alpha * beta) * x * windowed_channel_sum(
        dy * x * sb / s, n)
    assert torch.equal(lrn_plain(x, n, alpha, beta, k).view(torch.int32),
                       (x * sb).view(torch.int32))
    assert torch.equal(
        lrn_bwd_plain(x, dy, n, alpha, beta, k).view(torch.int32),
        want_dx.view(torch.int32))


def test_lrn_wrappers_take_the_bf16_plain_versions_on_the_cpu():
    """``lrn_fwd``, ``lrn_bwd`` and the op ``lrn`` on CPU bf16 tensors give
    the plain versions' bits, dx in x's dtype, and launch no kernel."""
    from znicz_torch.ops import lrn as ops

    *_, tx, tdy = _lrn_operands((2, 5, 5, 24), 2.0, 7)
    counts = [ops.lrn_fwd.launches, ops.lrn_bwd.launches,
              ops.lrn_bf16_fwd.launches, ops.lrn_bf16_bwd.launches]
    y = ops.lrn_fwd(tx)
    dx = ops.lrn_bwd(tx, tdy)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert np.array_equal(_bits(y), _bits(ops.lrn_plain(tx)))
    assert np.array_equal(_bits(dx), _bits(ops.lrn_bwd_plain(tx, tdy)))
    xg = tx.clone().requires_grad_(True)
    got, = torch.autograd.grad(ops.lrn(xg), xg, tdy)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(dx))
    assert counts == [ops.lrn_fwd.launches, ops.lrn_bwd.launches,
                      ops.lrn_bf16_fwd.launches, ops.lrn_bf16_bwd.launches]


@pytest.mark.parametrize("mom,clip", [(0.9, 0.0), (0.5, 0.05)])
def test_sgd_update_with_a_bf16_velocity_is_the_references(mom, clip):
    import jax.numpy as jnp
    import ml_dtypes

    from znicz_torch.nn_units import sgd_update
    from znicz_tpu.nn_units import sgd_update as jax_sgd

    rng = np.random.default_rng(21)
    w, g = (rng.normal(size=(6, 9)).astype(np.float32) * s
            for s in (0.5, 0.2))
    v = (rng.normal(size=(6, 9)) * 0.05).astype(ml_dtypes.bfloat16)
    f = np.float32
    hyp = dict(lr=f(0.01), weights_decay=f(0.0005), l1_vs_l2=f(0.0),
               momentum=f(mom), clip=f(clip))
    jw, jv = jax_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(v), **hyp)
    tw, tv = sgd_update(torch.from_numpy(w), torch.from_numpy(g),
                        torch.from_numpy(v.astype(np.float32))
                        .to(torch.bfloat16), **hyp)
    assert jv.dtype == jnp.bfloat16 and tv.dtype == torch.bfloat16
    assert tw.dtype == torch.float32
    np.testing.assert_array_equal(
        tv.view(torch.int16).numpy(),
        np.asarray(jv).view(np.int16))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# -- the trainer ---------------------------------------------------------------


@pytest.mark.parametrize("routing", [
    {}, {"fused_elementwise": True, "fused_tail": True},
    {"pallas_lrn": True, "fused_tail": True}],
    ids=["composed", "fused", "pallas_lrn"])
def test_bf16_train_steps_match_the_reference(routing):
    """Three train steps of the tiny AlexNet in bf16 from the reference's
    parameters with its dropout masks: per-step losses within rtol 5e-2
    of the reference's bf16 steps, the parameters still stored float32
    and moved."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_from_jax, params_to_numpy
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    layers = tiny_layers(gd=STEP_GD)
    jwf = jax_workflow(layers)
    with dtype_knobs(compute_dtype="bf16"), knobs(**routing):
        jt = JTrainer(jwf)
        params, vels, dataset, targets, _ = jt._device_state()
        start = {n: {k: np.asarray(v) for k, v in l.items()}
                 for n, l in params.items()}
        twf = params_from_jax(start, _port_workflow(jwf, layers))
        tt = FusedTrainer(twf, mask_fn=_jax_masks())
        assert tt.compute_dtype == torch.bfloat16
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
    for f in twf.forwards:
        if f.has_weights:
            assert f.weights.dtype == f.bias.dtype == torch.float32
            assert not np.array_equal(got[f.name]["weights"],
                                      start[f.name]["weights"])


def _epoch_losses(decision):
    losses = []
    decision.on_epoch_end.append(
        lambda d: losses.append(d.epoch_metrics[2]["loss"]))
    return losses


def test_bf16_runs_match_the_reference_and_each_other(tmp_path):
    """The tiny AlexStyle workflow (conv + LRN + pool + softmax, 19x19)
    trained 2 epochs by both packages' ``FusedTrainer`` in bf16, composed
    and under ``fused_elementwise`` + ``fused_tail``: each epoch loss
    within rtol 5e-2 of the reference's run and of the other routing's,
    and falling."""
    from test_fused_block_pallas import _tiny_alexstyle_workflow

    from znicz_torch.core.config import root as troot
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    jroot.common.dirs.snapshots = str(tmp_path)
    troot.common.dirs.snapshots = str(tmp_path)
    runs = {}
    for label, routing in (("composed", {}),
                           ("fused", {"fused_elementwise": True,
                                      "fused_tail": True})):
        with dtype_knobs(compute_dtype="bf16"), knobs(**routing):
            jwf = _tiny_alexstyle_workflow()
            twf = _alexstyle_port(jwf)
            j_losses, t_losses = (_epoch_losses(jwf.decision),
                                  _epoch_losses(twf.decision))
            JTrainer(jwf).run()
            FusedTrainer(twf).run()
        assert len(t_losses) == len(j_losses) == 2
        np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
        assert t_losses[-1] < t_losses[0], t_losses
        runs[label] = t_losses
    np.testing.assert_allclose(runs["fused"], runs["composed"],
                               rtol=LOSS_RTOL)


def _mnist_run(tmp_path, engine_fused=True, **dtype_kw):
    """Reduced MNIST (``test_torch_samples.REDUCED``, 2 epochs) through
    the port's ``engine.train``; returns (workflow, per-epoch train
    losses)."""
    from znicz_torch import engine

    with sample_config("mnist", **REDUCED["mnist"]), \
            dtype_knobs(**dtype_kw):
        wf = port_sample("mnist", tmp_path)
        losses = _epoch_losses(wf.decision)
        engine.train(wf, fused=engine_fused)
    return wf, losses


def test_mnist_bf16_trains_as_float32(tmp_path):
    """Reduced MNIST, 2 epochs on ``FusedTrainer``: bf16 activations
    (float32 master weights) track the float32 run within rtol 5e-2 and
    train; the legacy ``precision`` spelling takes the same path."""
    _, l32 = _mnist_run(tmp_path)
    wf, l16 = _mnist_run(tmp_path, compute_dtype="bfloat16")
    assert wf.trainer.compute_dtype == torch.bfloat16
    np.testing.assert_allclose(l16, l32, rtol=LOSS_RTOL)
    assert l16[-1] < l16[0], l16
    _, l_alias = _mnist_run(tmp_path, precision="bfloat16")
    assert l_alias == l16


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "units"])
def test_state_dtype_bf16_stores_velocities_in_bf16(fused, tmp_path):
    """``state_dtype`` "bfloat16" on either engine: every velocity is
    stored bf16, the update arithmetic stays float32, and
    the trajectory tracks the float32 run's within rtol 2e-2
    (``tests/test_fused.py:178-203``)."""
    _, l32 = _mnist_run(tmp_path, engine_fused=fused)
    wf, l16 = _mnist_run(tmp_path, engine_fused=fused,
                         state_dtype="bfloat16")
    assert hasattr(wf, "trainer") == fused
    vels = [v for g in wf.gd_units for v in g.velocities.values()]
    assert vels and {v.dtype for v in vels} == {torch.bfloat16}
    assert {f.weights.dtype for f in wf.forwards if f.has_weights} == \
        {torch.float32}
    np.testing.assert_allclose(l16, l32, rtol=2e-2)
    assert l16[-1] < l16[0], l16


def test_master_dtype_bf16_stores_parameters_in_bf16(tmp_path):
    """``master_dtype`` "bfloat16" (``FusedTrainer`` only): parameters
    stored bf16 and updated in float32; the final loss within
    ``tests/test_perf_guards.py:229-262``'s band of the float32 run."""
    from znicz_torch.snapshotter import Snapshotter as TSnap

    _, l32 = _mnist_run(tmp_path)
    wf, lm = _mnist_run(tmp_path, master_dtype="bfloat16")
    assert wf.trainer.master_dtype == torch.bfloat16
    params = [p for f in wf.forwards if f.has_weights
              for p in (f.weights, f.bias)]
    assert {p.dtype for p in params} == {torch.bfloat16}
    vels = [v for g in wf.gd_units for v in g.velocities.values()]
    assert {v.dtype for v in vels} == {torch.float32}
    assert lm[-1] < 1.5 * l32[-1] + 0.05, (lm, l32)
    # the snapshot widens them: float32 leaves, the same values
    snap = TSnap.load(wf.snapshotter.save("final"))
    for f in wf.forwards:
        if f.has_weights:
            leaf = snap["units"][f.name]["weights"]
            assert leaf.dtype == np.float32
            np.testing.assert_array_equal(leaf, f.weights.detach().float()
                                          .numpy())


@pytest.mark.parametrize("reference_state", ["float32", "bfloat16"])
def test_bf16_state_snapshot_restores_in_both_packages(reference_state,
                                                       tmp_path):
    """A snapshot the port writes under bf16 state holds float32 numpy
    leaves (the widening is exact): it restores into the reference's
    workflow under either state dtype, each velocity cast to the live
    dtype, and into a fresh port workflow bit for bit."""
    from znicz_torch.snapshotter import Snapshotter as TSnap
    from znicz_torch.snapshotter import restore as trestore
    from znicz_tpu.snapshotter import Snapshotter as JSnap
    from znicz_tpu.snapshotter import restore as jrestore

    trained, _ = _mnist_run(tmp_path, state_dtype="bfloat16")
    path = trained.snapshotter.save("final")
    snap = TSnap.load(path)
    leaves = [v for vs in snap["velocities"].values() for v in vs.values()]
    assert leaves and {v.dtype for v in leaves} == {np.dtype(np.float32)}
    live = {g.name: {k: v.float().numpy() for k, v in g.velocities.items()}
            for g in trained.gd_units if g.velocities}
    with sample_config("mnist", **REDUCED["mnist"]), \
            dtype_knobs(state_dtype=reference_state):
        fresh = jax_sample("mnist", tmp_path / "ref")
        jrestore(fresh, JSnap.load(path))
        for gd in fresh.gds:
            for k, a in gd._velocities.items():
                got = np.asarray(a.map_read())
                assert str(got.dtype) == reference_state
                np.testing.assert_array_equal(got.astype(np.float32),
                                              live[gd.name][k])
        port = port_sample("mnist", tmp_path / "port")
    with dtype_knobs(state_dtype="bfloat16"):
        trestore(port, snap)
    for gd in trained.gd_units:
        twin = next(g for g in port.gd_units if g.name == gd.name)
        for k, v in gd.velocities.items():
            assert twin.velocities[k].dtype == v.dtype == torch.bfloat16
            assert torch.equal(twin.velocities[k], v)


# -- refusals and ignores ------------------------------------------------------


def test_float32_pallas_lrn_still_trains(tiny_reference):
    """The float32 half of the old bf16 refusal test: ``FusedTrainer``
    constructs under float32 ``pallas_lrn`` and takes a train step whose
    LRN layers compute in float32."""
    from znicz_torch.lrn import LRNormalizerForward
    from znicz_torch.parallel.fused import FusedTrainer

    twf = _port_workflow(tiny_reference, tiny_layers())
    seen = []
    for f in twf.forwards:
        if isinstance(f, LRNormalizerForward):
            f.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with knobs(pallas_lrn=True):
        t = FusedTrainer(twf, mask_fn=_jax_masks())
        assert t.compute_dtype == torch.float32
        idx, bs = STEPS[0]
        loss, _, _ = t.train_step(np.array(idx), bs, 0)
    assert np.isfinite(float(loss))
    assert seen == [torch.float32] * 2


def test_the_unit_engine_ignores_compute_dtype(tmp_path):
    """The reference reads ``compute_dtype`` in ``FusedTrainer`` alone:
    its unit engine and the port's train the same float32 losses with it
    set."""
    with sample_config("mnist", **REDUCED["mnist"]):
        j_losses = {}
        for cd in (None, "bf16"):
            with dtype_knobs(compute_dtype=cd):
                jwf = jax_sample("mnist", tmp_path / "ref")
                j_losses[cd] = _epoch_losses(jwf.decision)
                jwf.run()
    assert j_losses[None] == j_losses["bf16"]
    wf32, l32 = _mnist_run(tmp_path, engine_fused=False)
    wf16, l16 = _mnist_run(tmp_path, engine_fused=False,
                           compute_dtype="bf16")
    assert l16 == l32 and wf16.decision.train_losses == \
        wf32.decision.train_losses
    np.testing.assert_allclose(l32, j_losses[None], rtol=1e-4)


def test_serving_stays_float32():
    """``forward_pass``, which serving calls, casts nothing: under
    ``compute_dtype`` bf16 the logits are the float32 ones, bit for
    bit."""
    from znicz_torch.parallel.fused import FusedTrainer

    twf = _tiny_port()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3,) + SAMPLE).astype(np.float32))
    with torch.no_grad():
        want = FusedTrainer(twf).forward_pass(x)
        with dtype_knobs(compute_dtype="bf16"):
            got = FusedTrainer(twf).forward_pass(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_the_command_line_override_reaches_the_trainer(tmp_path):
    """``python -m znicz_torch alexnet root.common.engine.compute_dtype=
    bf16`` trains in bf16 and says so in its JSON line; a bad spelling
    is refused."""
    base = [sys.executable, "-m", "znicz_torch", "alexnet", "--device",
            "cpu", f"root.common.dirs.snapshots={tmp_path}",
            "root.alexnet.loader.image_size=67",
            "root.alexnet.loader.n_train=8", "root.alexnet.loader.n_valid=4",
            "root.alexnet.loader.minibatch_size=4",
            "root.alexnet.loader.n_classes=10",
            "root.alexnet.decision.max_epochs=1",
            "root.common.engine.fused_elementwise=True",
            "root.common.engine.fused_tail=True"]
    out = subprocess.run(base + ["root.common.engine.compute_dtype=bf16"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["compute_dtype"] == "bfloat16"
    assert np.isfinite(line["final_train_loss"])
    bad = subprocess.run(base + ["root.common.engine.compute_dtype=fp16"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode != 0 and "compute_dtype" in bad.stderr
