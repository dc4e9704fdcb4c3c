"""The port's MnistAE slice (BASELINE config 2) against the JAX reference on
the CPU.

  - unit pairs, from the same numpy input, parameters, velocities and
    ``err_output``, one forward unit ``run()`` and one GD unit ``run()``
    of each package: Deconv and GDDeconv (own and tied weights, stride 1,
    stride 2 with targets that need an output padding, asymmetric
    padding, the tanh and sigmoid kinds), Depooling and GDDepooling over
    max pooling (the same bits) and average pooling; ``output`` within
    ``FWD_TOL``, ``err_input``, parameters and velocities within
    ``STEP_TOL``; EvaluatorMSE with padded rows and its ``class_targets``
    mode, and DecisionMSE over a sequence of minibatches;
  - the reference's own deconvolution tests, ported: the adjoint of a
    convolution, and GDDeconv's weight step against finite differences;
  - reduced MnistAE (100 train, 50 valid, batch 50, 2 epochs) on the
    unit engine against the reference's: every train loss, the epoch
    metrics and the final weights within ``STEP_TOL``; ``conv.weights``
    and ``deconv.weights`` one tensor through build, training, a
    snapshot round trip and a reference parameter tree loaded through
    ``weights.params_from_jax``, which continues as the reference does;
  - ``FusedTrainer`` refuses the tie (``FusedUnsupportedError``) and
    ``engine.train`` trains such a graph on the unit engine instead;
  - ``python -m znicz_torch mnist_ae --device cpu``: the reference CLI
    test's tiny overrides print the finals JSON, and the default
    configuration lands inside ``bench.py``'s ``ANCHOR_BANDS[2]``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_gd_units import HYPERS
from test_torch_layers import FWD_TOL, _rand, _tie_heavy, sample_config
from test_torch_train import STEP_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
#: tests/test_cli_samples.py's tiny run of the sample
TINY = ["root.mnist_ae.loader.n_train=100", "root.mnist_ae.loader.n_valid=50",
        "root.mnist_ae.loader.minibatch_size=50",
        "root.mnist_ae.decision.max_epochs=1"]
REDUCED = {"loader__n_train": 100, "loader__n_valid": 50,
           "loader__n_test": 0, "loader__minibatch_size": 50,
           "decision__max_epochs": 2}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# -- Deconv / GDDeconv ------------------------------------------------------

CONV_S1 = {"n_kernels": 4, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)}
CONV_S2 = {"n_kernels": 5, "kx": 3, "ky": 2, "sliding": (2, 2),
           "padding": (0, 1, 1, 0)}
#: id -> (kind, Deconv keywords, conv keywords to tie to (None: own
#: weights), deconv input shape, target (H, W, C))
DECONV_CASES = {
    "s1": ("deconv", dict(CONV_S1), None, (2, 6, 6, 4), (6, 6, 3)),
    "s2_output_padding": ("deconv", {"n_kernels": 4, "kx": 3, "ky": 3,
                                     "sliding": (2, 2),
                                     "padding": (1, 1, 1, 1)},
                          None, (2, 4, 4, 4), (8, 8, 3)),
    "s2_asymmetric": ("deconv", dict(CONV_S2), None, (2, 4, 3, 5),
                      (8, 7, 3)),
    "sigmoid": ("deconv_sigmoid", dict(CONV_S1), None, (2, 6, 6, 4),
                (6, 6, 3)),
    "tied_s1": ("deconv", {}, dict(CONV_S1), (2, 6, 6, 4), (6, 6, 3)),
    "tied_tanh_s2": ("deconv_tanh", {}, dict(CONV_S2), (2, 4, 3, 5),
                     (8, 7, 3)),
}


def _jax_deconv(kind, kw, conv_kw, x, target, w, vel, err):
    """The reference's (conv unit or None, Deconv unit, GDDeconv unit)
    after one run each."""
    from znicz_tpu.conv import Conv
    from znicz_tpu.memory import Array
    from znicz_tpu.standard_workflow import _registry

    fwd_cls, gd_cls = _registry()[kind]
    conv = None
    if conv_kw is not None:
        conv = Conv(None, name="c", include_bias=False, **conv_kw)
        conv.input = Array(np.zeros((1,) + target, np.float32))
        conv.initialize(device=None)
        conv.weights.mem = w.copy()
        dec = fwd_cls(None, name="f", weights_from=conv)
        dec.output_shape_from = conv.input
    else:
        dec = fwd_cls(None, name="f", output_sample_shape=target, **kw)
    dec.input = Array(x)
    dec.initialize(device=None)
    if conv is None:
        dec.weights.mem = w.copy()
    dec.run()
    gd = gd_cls(None, name="g", forward=dec, **HYPERS)
    gd.err_output = Array(err)
    gd.initialize(device=None)
    gd._velocities["weights"].mem = vel.copy()
    gd.run()
    return conv, dec, gd


def _port_deconv(kind, kw, conv_kw, x, target, w, vel, err):
    """The port's (conv module or None, Deconv unit, GDDeconv unit) after
    one run each."""
    from znicz_torch.conv import Conv
    from znicz_torch.memory import Array
    from znicz_torch.nn_units import ForwardBase
    from znicz_torch.standard_workflow import _registry

    mod_cls, unit_cls, gd_cls = _registry()[kind]
    conv = None
    if conv_kw is not None:
        conv = Conv(name="c", include_bias=False, **conv_kw)
        conv.build((1,) + target, CPU)
        with torch.no_grad():
            conv.weights.copy_(torch.from_numpy(w))
        mod = mod_cls(name="f", weights_from=conv)
        mod.output_shape_from = Array(np.zeros((1,) + target, np.float32))
    else:
        mod = mod_cls(name="f", output_sample_shape=target, **kw)
    mod.build(x.shape, CPU)
    if conv is None:
        with torch.no_grad():
            mod.weights.copy_(torch.from_numpy(w))
    fwd = unit_cls(None, module=mod)
    assert isinstance(fwd, ForwardBase)
    fwd.input = Array(x)
    fwd.initialize(device=CPU)
    fwd.run()
    gd = gd_cls(None, name="g", forward=fwd, **HYPERS)
    gd.err_output = Array(err)
    gd.initialize(device=CPU)
    gd.velocities["weights"] = torch.from_numpy(vel.copy())
    gd.run()
    return conv, fwd, gd


@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconv_pair_matches_reference(case):
    kind, kw, conv_kw, in_shape, target = DECONV_CASES[case]
    geo = conv_kw if conv_kw is not None else kw
    w_shape = (geo["n_kernels"], geo["ky"], geo["kx"], target[2])
    assert in_shape[-1] == geo["n_kernels"]
    x = _rand(in_shape, 71)
    w = _rand(w_shape, 72, 0.5)
    vel = _rand(w_shape, 73, 0.01)
    err = _rand((in_shape[0],) + target, 74, 0.3)
    jconv, jfwd, jgd = _jax_deconv(kind, kw, conv_kw, x, target, w, vel, err)
    tconv, tfwd, tgd = _port_deconv(kind, kw, conv_kw, x, target, w, vel,
                                    err)
    out = _np(tfwd.output.devmem)
    assert out.shape == (in_shape[0],) + target
    np.testing.assert_allclose(out, np.array(jfwd.output.map_read()),
                               **FWD_TOL)
    np.testing.assert_allclose(_np(tgd.err_input.devmem),
                               np.array(jgd.err_input.map_read()), **STEP_TOL)
    assert set(tgd.velocities) == set(jgd._velocities) == {"weights"}
    got = _np(tfwd.module.weights)
    assert not np.array_equal(got, w)
    np.testing.assert_allclose(got, np.array(jfwd.weights.map_read()),
                               **STEP_TOL)
    np.testing.assert_allclose(_np(tgd.velocities["weights"]),
                               np.array(jgd._velocities["weights"].map_read()),
                               **STEP_TOL)
    assert tfwd.module.bias is None and not tfwd.module.include_bias
    if conv_kw is not None:
        # the tie: the update landed in the one tensor both modules hold
        assert jconv.weights is jfwd.weights
        assert tconv.weights is tfwd.module.weights
        assert tconv.weights.data_ptr() == tfwd.module.weights.data_ptr()


@pytest.mark.parametrize("variant", ["tied", "untied", "stale"])
def test_tied_updates_follow_the_reference_order(variant):
    """ConvTanh -> tied Deconv, then gd_deconv and gd_conv, in both
    packages at lr 0.5: ``gd_deconv`` updates the shared tensor in place
    and ``gd_conv`` takes its vjp at the updated weights, so the final
    weights match the reference's within ``STEP_TOL``.  Two wrong
    versions land elsewhere: untied (the Deconv holding a copy, so the
    convolution never sees the decoder's update), and stale (``gd_conv``'s
    vjp taken at the weights from before ``gd_deconv``'s update, which is
    then added back): the tie and the order are both needed."""
    from znicz_torch.conv import ConvTanh as TConv
    from znicz_torch.deconv import Deconv as TDeconv
    from znicz_torch.gd_conv import GDTanhConv as TGDConv
    from znicz_torch.gd_deconv import GDDeconv as TGDDeconv
    from znicz_torch.memory import Array as TArray
    from znicz_torch.nn_units import ForwardBase
    from znicz_tpu.conv import ConvTanh as JConv
    from znicz_tpu.deconv import Deconv as JDeconv
    from znicz_tpu.gd_conv import GDTanhConv as JGDConv
    from znicz_tpu.gd_deconv import GDDeconv as JGDDeconv
    from znicz_tpu.memory import Array as JArray

    hypers = {"learning_rate": 0.5, "gradient_moment": 0.9}
    x = _rand((2, 6, 6, 3), 76)
    w, b = _rand((4, 3, 3, 3), 77, 0.5), _rand((4,), 78, 0.1)
    err = _rand((2, 6, 6, 3), 79)
    jconv = JConv(None, name="conv", **CONV_S1)
    jconv.input = JArray(x)
    jconv.initialize(device=None)
    jconv.weights.mem, jconv.bias.mem = w.copy(), b.copy()
    jdec = JDeconv(None, name="deconv", weights_from=jconv)
    jdec.output_shape_from = jconv.input
    tconv = TConv(name="conv", **CONV_S1)
    tdec = TDeconv(name="deconv", weights_from=tconv)
    hidden = tconv.build(x.shape, CPU)
    tdec.build(hidden, CPU)
    with torch.no_grad():
        tconv.weights.copy_(torch.from_numpy(w))
        tconv.bias.copy_(torch.from_numpy(b))
    if variant == "untied":
        tdec.weights = torch.nn.Parameter(tconv.weights.detach().clone(),
                                          requires_grad=False)
    tcu, tdu = ForwardBase(None, module=tconv), ForwardBase(None, module=tdec)
    tcu.input = TArray(x)
    for conv, dec, gd_dec_cls, gd_conv_cls, dev in (
            (jconv, jdec, JGDDeconv, JGDConv, None),
            (tcu, tdu, TGDDeconv, TGDConv, CPU)):
        arr = JArray if dev is None else TArray
        conv.initialize(device=dev)
        conv.run()
        dec.input = conv.output
        dec.initialize(device=dev)
        dec.run()
        gdd = gd_dec_cls(None, name="gd_deconv", forward=dec, **hypers)
        gdd.err_output = arr(err)
        gdd.initialize(device=dev)
        gdd.run()
        gdc = gd_conv_cls(None, name="gd_conv", forward=conv,
                          need_err_input=False, **hypers)
        gdc.err_output = gdd.err_input
        gdc.initialize(device=dev)
        if variant == "stale" and dev is not None:
            shared = tconv.weights
            updated = shared.detach().clone()
            with torch.no_grad():
                shared.copy_(torch.from_numpy(w))
            gdc.run()
            with torch.no_grad():
                shared.add_(updated - torch.from_numpy(w))
        else:
            gdc.run()
    want = {k: np.array(a.map_read()) for k, a in jconv.params().items()}
    got = {k: _np(p) for k, p in tcu.params().items()}
    assert jconv.weights is jdec.weights
    if variant == "tied":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **STEP_TOL)
    else:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got["weights"], want["weights"],
                                       **STEP_TOL)


def test_deconv_refusals_and_minimal_cover():
    from znicz_torch.deconv import Deconv

    with pytest.raises(ValueError, match="weights_transposed"):
        Deconv(name="d", weights_transposed=True)
    with pytest.raises(ValueError, match="no bias"):
        Deconv(name="d", include_bias=True)
    # the least plane a (1, 3, 3, 4) map covers: (3-1)*2 + 2 = 6
    dec = Deconv(name="own", n_kernels=4, kx=2, ky=2, sliding=(2, 2))
    assert dec.build((1, 3, 3, 4), CPU) == (1, 6, 6, 1)
    assert tuple(dec.weights.shape) == (4, 2, 2, 1)
    y = dec(torch.from_numpy(_rand((1, 3, 3, 4), 75)))
    assert tuple(y.shape) == (1, 6, 6, 1)


def test_deconv_is_conv_adjoint():
    """<conv(x), y> == <x, deconv(y)> for all x, y (the reference's
    ``tests/test_deconv.py`` test, on the port's modules)."""
    from znicz_torch.conv import Conv
    from znicz_torch.deconv import Deconv
    from znicz_torch.memory import Array

    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    conv = Conv(name="adc", n_kernels=4, kx=3, ky=3, sliding=(2, 2),
                padding=(1, 1, 1, 1), include_bias=False)
    out_shape = conv.build(x.shape, CPU)
    cy = _np(conv(torch.from_numpy(x)))
    dec = Deconv(name="add", weights_from=conv)
    dec.output_shape_from = Array(x)
    dec.build(out_shape, CPU)
    y = rng.normal(size=cy.shape).astype(np.float32)
    dx = _np(dec(torch.from_numpy(y)))
    assert dx.shape == x.shape
    np.testing.assert_allclose(np.sum(cy * y), np.sum(x * dx), rtol=1e-4)


def test_gd_deconv_finite_differences():
    """GDDeconv's weight step at lr 1 against central differences of
    <err, deconv(x)> (the reference's ``tests/test_deconv.py`` test)."""
    from znicz_torch.deconv import Deconv
    from znicz_torch.gd_deconv import GDDeconv
    from znicz_torch.memory import Array
    from znicz_torch.nn_units import ForwardBase

    rng = np.random.default_rng(19)
    x = rng.normal(size=(1, 3, 3, 2)).astype(np.float32)
    mod = Deconv(name="gdd", n_kernels=2, kx=2, ky=2, sliding=(2, 2),
                 output_sample_shape=(6, 6, 1))
    mod.build(x.shape, CPU)
    w0 = _np(mod.weights).copy()
    dec = ForwardBase(None, module=mod)
    dec.input = Array(x)
    dec.initialize(device=CPU)
    dec.run()
    err = rng.normal(size=dec.output.shape).astype(np.float32)
    gd = GDDeconv(None, name="gddgd", forward=dec, learning_rate=1.0)
    gd.err_output = Array(err)
    gd.initialize(device=CPU)
    gd.run()
    dw = w0 - _np(mod.weights)

    def loss(w):
        with torch.no_grad():
            mod.weights.copy_(torch.from_numpy(w))
            return float(np.sum(err * _np(mod(torch.from_numpy(x)))))

    eps = 1e-3
    for idx in [(0, 0, 0, 0), (1, 1, 1, 0)]:
        wp, wm = w0.copy(), w0.copy()
        wp[idx] += eps
        wm[idx] -= eps
        num = (loss(wp) - loss(wm)) / (2 * eps)
        assert abs(num - dw[idx]) < 5e-2 * max(1.0, abs(num)), idx


# -- Depooling / GDDepooling ------------------------------------------------

#: id -> (pooling kind, keywords, input shape, input data)
DEPOOL_CASES = {
    "max": ("max_pooling", {"kx": 2, "ky": 2}, (2, 8, 8, 3), "ties"),
    "max_partial": ("max_pooling", {"kx": 2, "ky": 2}, (2, 7, 8, 3),
                    "ties"),
    "avg": ("avg_pooling", {"kx": 2, "ky": 2}, (2, 7, 7, 3), "random"),
}


@pytest.mark.parametrize("case", list(DEPOOL_CASES))
def test_depooling_pair_matches_reference(case):
    """Depooling scatters to the reference's offsets and GDDepooling
    gathers back, with the same bits over a max pooling (no window
    overlaps, nothing is summed); over an average pooling the spread is
    the vjp of the average and the gather the average itself, its
    adjoint."""
    from znicz_torch.depooling import Depooling as TDepool
    from znicz_torch.depooling import GDDepooling as TGD
    from znicz_torch.memory import Array as TArray
    from znicz_torch.nn_units import ForwardBase
    from znicz_torch.standard_workflow import _registry as treg
    from znicz_tpu.depooling import Depooling as JDepool
    from znicz_tpu.depooling import GDDepooling as JGD
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.standard_workflow import _registry as jreg

    kind, kw, in_shape, data = DEPOOL_CASES[case]
    x = _tie_heavy(in_shape, 81) if data == "ties" else _rand(in_shape, 81)
    jpool = jreg()[kind][0](None, name="p", **kw)
    jpool.input = JArray(x)
    jpool.initialize(device=None)
    jpool.run()
    mod_cls, unit_cls, _ = treg()[kind]
    pmod = mod_cls(name="p", **kw)
    pooled_shape = pmod.build(in_shape, CPU)
    tpool = unit_cls(None, module=pmod)
    tpool.input = TArray(x)
    tpool.initialize(device=CPU)
    tpool.run()
    v = _rand(pooled_shape, 82)
    err = _rand(in_shape, 83)

    jdep = JDepool(None, name="d", pooling_from=jpool)
    jdep.input = JArray(v)
    jdep.initialize(device=None)
    jdep.run()
    dmod = TDepool(name="d", pooling_from=tpool)
    assert dmod.build(pooled_shape, CPU) == in_shape
    tdep = ForwardBase(None, module=dmod)
    tdep.input = TArray(v)
    tdep.initialize(device=CPU)
    tdep.run()
    got_up, want_up = _np(tdep.output.devmem), np.array(jdep.output.map_read())
    tgd = TGD(None, name="g", forward=tdep)
    tgd.err_output = TArray(err)
    tgd.initialize(device=CPU)
    tgd.run()
    got_back = _np(tgd.err_input.devmem)
    assert not tgd.apply_gradient and not tgd.velocities
    if kind == "max_pooling":
        np.testing.assert_array_equal(_np(tpool.input_offset.devmem),
                                      np.array(jpool.input_offset.map_read()))
        np.testing.assert_array_equal(got_up, want_up)
        jgd = JGD(None, name="g", forward=jdep)
        jgd.err_output = JArray(err)
        jgd.initialize(device=None)
        jgd.run()
        np.testing.assert_array_equal(got_back,
                                      np.array(jgd.err_input.map_read()))
    else:
        np.testing.assert_allclose(got_up, want_up, **FWD_TOL)
        import jax.numpy as jnp

        want_back = np.array(jpool.apply({}, jnp.asarray(err)))
        np.testing.assert_allclose(got_back, want_back, **FWD_TOL)
    # adjoint pair: <depool(v), err> == <v, gd(err)>
    np.testing.assert_allclose(np.sum(got_up * err), np.sum(v * got_back),
                               rtol=1e-5)


def test_depooling_needs_recorded_offsets():
    from znicz_torch.depooling import Depooling
    from znicz_torch.pooling import MaxPooling, MaxPoolingUnit

    pmod = MaxPooling(name="p")
    shape = pmod.build((1, 4, 4, 1), CPU)
    pool = MaxPoolingUnit(None, module=pmod)
    pool.initialize(device=CPU)
    dep = Depooling(name="d", pooling_from=pool)
    dep.build(shape, CPU)
    with pytest.raises(RuntimeError, match="recorded no pooling offsets"):
        dep(torch.zeros(shape))
    with pytest.raises(ValueError, match="pooling_from"):
        Depooling(name="d")


# -- EvaluatorMSE / DecisionMSE ---------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "class_targets"])
def test_evaluator_mse_matches_reference(mode):
    """Two padded rows out of six; ``class_targets``: n_err counts the
    real rows whose nearest class target is not their label."""
    from znicz_torch.evaluator import EvaluatorMSE as TEv
    from znicz_torch.memory import Array as TArray
    from znicz_tpu.evaluator import EvaluatorMSE as JEv
    from znicz_tpu.memory import Array as JArray

    y = _rand((6, 4, 4, 1), 91)
    t = _rand((6, 4, 4, 1), 92)
    ct = _rand((3, 4, 4, 1), 93)
    labels = np.array([0, 1, 2, 0, 1, 2], np.int32)
    jev, tev = JEv(None, name="e"), TEv(None, name="e")
    jev.output, jev.target = JArray(y), JArray(t)
    tev.output, tev.target = TArray(y), TArray(t)
    jev.batch_size = tev.batch_size = 4
    if mode == "class_targets":
        # the nearest class target of each row, then two rows mislabelled
        near = np.argmin(((y.reshape(6, 1, -1) - ct.reshape(1, 3, -1)) ** 2)
                         .sum(-1), axis=1)
        labels = near.astype(np.int32)
        labels[[1, 5]] = (labels[[1, 5]] + 1) % 3     # 5 is a padded row
        jev.labels, tev.labels = JArray(labels), TArray(labels.astype(
            np.int64))
        jev.class_targets, tev.class_targets = JArray(ct), TArray(ct)
    jev.initialize(device=None)
    tev.initialize(device=CPU)
    jev.run()
    tev.run()
    np.testing.assert_allclose(_np(tev.err_output.devmem),
                               np.array(jev.err_output.map_read()),
                               **FWD_TOL)
    assert tuple(tev.err_output.devmem.shape) == y.shape
    np.testing.assert_allclose(_np(tev.mse.devmem),
                               np.array(jev.mse.map_read()), **FWD_TOL)
    assert not _np(tev.err_output.devmem)[4:].any()
    np.testing.assert_allclose(tev.loss, jev.loss, **FWD_TOL)
    assert tev.n_err == jev.n_err == (1 if mode == "class_targets" else 0)


def test_decision_mse_matches_reference():
    """The same minibatch sequence (valid then train, three epochs) into
    both DecisionMSEs: the same epoch metrics, improvement and stop."""
    from znicz_torch.decision import DecisionMSE as TDec
    from znicz_tpu.decision import DecisionMSE as JDec

    decs = [JDec(None, name="d", max_epochs=3, fail_iterations=0),
            TDec(None, name="d", max_epochs=3, fail_iterations=0)]
    rng = np.random.default_rng(95)
    seen = [[], []]
    for epoch in range(3):
        steps = [(1, False, False), (1, True, False), (2, False, False),
                 (2, True, True)]
        for klass, class_ended, last in steps:
            loss = float(rng.uniform(0.5, 2.0))
            for i, d in enumerate(decs):
                d.minibatch_class = klass
                d.class_ended = class_ended
                d.last_minibatch = last
                d.epoch_number = epoch
                d.class_lengths = [0, 100, 200]
                d.minibatch_size = 50
                d.minibatch_loss = loss
                d.run()
                seen[i].append((bool(d.gd_skip), bool(d.improved),
                                bool(d.complete), bool(d.epoch_ended)))
        for d in decs[1:]:
            for klass in (1, 2):
                want = decs[0].epoch_metrics[klass]
                got = d.epoch_metrics[klass]
                assert set(got) == set(want) == {"loss", "mse"}
                np.testing.assert_allclose(got["loss"], want["loss"],
                                           rtol=1e-12)
    assert seen[0] == seen[1]
    assert decs[1].best_epoch == decs[0].best_epoch
    assert bool(decs[1].complete)


# -- the MSE loss on StandardWorkflow ----------------------------------------

#: an untied autoencoder as a layer list: conv, max pooling and a
#: stride-2 deconvolution back to the 8x8 input
MSE_GD = {"learning_rate": 0.02, "gradient_moment": 0.9}
MSE_LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 3, "kx": 3, "ky": 3,
                                 "padding": (1, 1, 1, 1)},
     "<-": dict(MSE_GD)},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "deconv", "->": {"n_kernels": 3, "kx": 2, "ky": 2,
                              "sliding": (2, 2),
                              "output_sample_shape": (8, 8, 1)},
     "<-": dict(MSE_GD)},
]
#: (test, valid, train) rows of the 8x8 images
MSE_LENGTHS = [0, 20, 40]


def _mse_loader(pkg):
    """A ``FullBatchLoaderMSE`` of seeded 8x8 images that are their own
    targets, in package ``pkg``."""
    import importlib

    base = importlib.import_module(f"{pkg}.loader.fullbatch")
    data = _rand((sum(MSE_LENGTHS), 8, 8, 1), 131)

    class Loader(base.FullBatchLoaderMSE):
        def load_data(self):
            if pkg == "znicz_tpu":
                self.original_data.mem = data.copy()
            else:
                self.original_data = data.copy()
            self.class_lengths = list(MSE_LENGTHS)
            super().load_data()

    return Loader(name="loader", targets_from_data=True, minibatch_size=20)


def test_mse_standard_workflow_matches_reference(tmp_path):
    """A layer list with a ``deconv`` under ``loss_function="mse"``
    (``EvaluatorMSE`` on the loader's ``minibatch_targets``,
    ``DecisionMSE``) on a ``FullBatchLoaderMSE``, trained 2 epochs on the
    unit engine of each package from seed 1013: every train loss, the
    epoch metrics and the final parameters within ``STEP_TOL``.  The
    graph is untied, so ``engine.train(fused=True)`` trains it on the
    port's ``FusedTrainer`` with the MSE head, within ``STEP_TOL`` of the
    reference's fused run from the same seed; a ``depooling`` layer
    needs its pooling unit, which a layer list cannot hold, in both
    packages."""
    from znicz_torch import engine
    from znicz_torch.core import prng as tprng
    from znicz_torch.core.config import root as troot
    from znicz_torch.standard_workflow import StandardWorkflow as TWorkflow
    from znicz_torch.weights import params_to_numpy
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.engine import train as jtrain
    from znicz_tpu.standard_workflow import StandardWorkflow as JWorkflow

    kw = {"loss_function": "mse", "decision_config": {"max_epochs": 2},
          "snapshotter_config": {"prefix": "mse_ae", "interval": 0}}
    jroot.common.dirs.snapshots = str(tmp_path / "ref")
    troot.common.dirs.snapshots = str(tmp_path / "port")
    jprng.reset(1013)
    jwf = JWorkflow(name="MseAE", loader=_mse_loader("znicz_tpu"),
                    layers=MSE_LAYERS, **kw)
    jwf.initialize(device=None)
    j_losses = _record_train_losses(jwf.decision)
    jwf.run()
    tprng.reset(1013)
    twf = TWorkflow(MSE_LAYERS, device="cpu", name="MseAE",
                    loader=_mse_loader("znicz_torch"), **kw)
    t_losses = _record_train_losses(twf.decision)
    stats = engine.train(twf)
    assert type(twf.evaluator).__name__ == "EvaluatorMSE"
    assert type(twf.decision).__name__ == "DecisionMSE"
    assert len(t_losses) == len(j_losses) == 4
    assert stats["train_steps"] == 3             # the last tail is skipped
    np.testing.assert_allclose(t_losses, j_losses, **STEP_TOL)
    for klass in (1, 2):
        want = jwf.decision.epoch_metrics[klass]
        got = twf.decision.epoch_metrics[klass]
        for key in ("loss", "mse"):
            np.testing.assert_allclose(got[key], want[key], **STEP_TOL)
    got = params_to_numpy(twf)
    want = {f.name: {k: np.array(a.map_read()) for k, a in
                     f.params().items()} for f in jwf.forwards
            if f.params()}
    assert sorted(got) == sorted(want) == ["fwd_conv_tanh_0",
                                           "fwd_deconv_2"]
    for name, leaves in want.items():
        assert set(got[name]) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v,
                                       err_msg=f"{name}.{k}", **STEP_TOL)
    jprng.reset(1013)
    jwf = JWorkflow(name="MseAE", loader=_mse_loader("znicz_tpu"),
                    layers=MSE_LAYERS, **kw)
    jwf.initialize(device=None)
    j_losses = _record_train_losses(jwf.decision)
    jroot.common.engine.fused = True
    try:
        jtrain(jwf)
    finally:
        jroot.common.engine.fused = False
    tprng.reset(1013)
    twf = TWorkflow(MSE_LAYERS, device="cpu", name="MseAE",
                    loader=_mse_loader("znicz_torch"), **kw)
    engine.train(twf, fused=True)
    assert twf.trainer.loss_kind == "mse"
    assert len(twf.decision.train_losses) == len(j_losses) == 4
    np.testing.assert_allclose(twf.decision.train_losses, j_losses,
                               **STEP_TOL)
    got = params_to_numpy(twf)
    for f in jwf.forwards:
        for k, a in f.params().items():
            np.testing.assert_allclose(got[f.name][k], np.array(a.map_read()),
                                       err_msg=f"{f.name}.{k}", **STEP_TOL)
    depool = [MSE_LAYERS[0], MSE_LAYERS[1], {"type": "depooling"}]
    with pytest.raises(AssertionError, match="pooling_from"):
        JWorkflow(name="Depool", loader=_mse_loader("znicz_tpu"),
                  layers=depool, **kw)
    with pytest.raises(ValueError, match="pooling_from"):
        TWorkflow(depool, device="cpu", loader=_mse_loader("znicz_torch"),
                  **kw)


# -- the sample --------------------------------------------------------------

def _jax_ae(tmp_path):
    from znicz_tpu.core import prng
    from znicz_tpu.core.config import root
    from znicz_tpu.samples import mnist_ae

    root.common.dirs.snapshots = str(tmp_path)
    prng.reset(1013)
    wf = mnist_ae.MnistAEWorkflow()
    wf.initialize(device=None)
    return wf


def _port_ae(tmp_path):
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import mnist_ae

    root.common.dirs.snapshots = str(tmp_path)
    prng.reset(1013)
    return mnist_ae.MnistAEWorkflow(device="cpu")


def _record_train_losses(decision):
    losses, run = [], decision.run

    def record():
        if int(decision.minibatch_class) == 2:
            losses.append(float(decision.minibatch_loss))
        run()

    decision.run = record
    return losses


def _jax_params(jwf):
    return {u.name: {k: np.array(a.map_read()) for k, a in u.params().items()}
            for u in (jwf.conv, jwf.deconv)}


def _tied(twf):
    return (twf.deconv.module.weights is twf.conv.module.weights
            and twf.deconv.module.weights.data_ptr()
            == twf.conv.module.weights.data_ptr())


def test_reduced_mnist_ae_matches_reference(tmp_path):
    from znicz_torch import engine
    from znicz_torch.snapshotter import Snapshotter, restore
    from znicz_torch.weights import params_to_numpy, velocities_to_numpy

    with sample_config("mnist_ae", **REDUCED):
        jwf = _jax_ae(tmp_path / "ref")
        j_losses = _record_train_losses(jwf.decision)
        jwf.run()
        twf = _port_ae(tmp_path / "port")
        assert _tied(twf)
        stats = engine.train(twf, fused=True)      # no forwards: units
    assert not hasattr(twf, "trainer")
    assert len(twf.decision.train_losses) == len(j_losses) == 4
    assert stats["train_steps"] == 3             # the last tail is skipped
    assert twf.gd_conv.run_count == twf.gd_deconv.run_count == 3
    np.testing.assert_allclose(twf.decision.train_losses, j_losses,
                               **STEP_TOL)
    for klass in (1, 2):
        want = jwf.decision.epoch_metrics[klass]
        got = twf.decision.epoch_metrics[klass]
        for key in ("loss", "mse"):
            np.testing.assert_allclose(got[key], want[key], **STEP_TOL)
    got, want = params_to_numpy(twf), _jax_params(jwf)
    assert sorted(got) == sorted(want) == ["conv", "deconv"]
    for name, leaves in want.items():
        assert set(got[name]) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v,
                                       err_msg=f"{name}.{k}", **STEP_TOL)
    np.testing.assert_array_equal(got["conv"]["weights"],
                                  got["deconv"]["weights"])
    vel = velocities_to_numpy(twf)
    for unit, name in ((jwf.gd_conv, "conv"), (jwf.gd_deconv, "deconv")):
        for k, a in unit._velocities.items():
            np.testing.assert_allclose(vel[name][k], np.array(a.map_read()),
                                       err_msg=f"{name}.{k}", **STEP_TOL)
    assert _tied(twf)
    # a snapshot round trip keeps the tie
    snap = Snapshotter.load(twf.snapshotter.destination)
    assert sorted(snap["units"]) == ["conv", "deconv"]
    assert sorted(snap["velocities"]) == ["gd_conv", "gd_deconv",
                                          "gd_depool", "gd_pool"]
    with sample_config("mnist_ae", **REDUCED):
        fresh = _port_ae(tmp_path / "fresh")
    restore(fresh, snap)
    assert _tied(fresh)
    for name, leaves in snap["units"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(params_to_numpy(fresh)[name][k], v)


def test_reference_tree_loads_into_the_tie_and_continues(tmp_path):
    """A trained reference parameter tree (``conv`` and ``deconv``, one
    tensor on both sides) loaded through ``params_from_jax`` into a fresh
    port workflow, and into a fresh reference one: the next epoch's train
    losses agree within ``STEP_TOL``, and the tie holds after it."""
    from znicz_torch import engine
    from znicz_torch.weights import params_from_jax

    one_epoch = dict(REDUCED, decision__max_epochs=1)
    with sample_config("mnist_ae", **REDUCED):
        trained = _jax_ae(tmp_path / "a")
        trained.run()
    tree = _jax_params(trained)
    with sample_config("mnist_ae", **one_epoch):
        jwf = _jax_ae(tmp_path / "b")
        for name, leaves in tree.items():
            for k, v in leaves.items():
                getattr(jwf, name).params()[k].mem = v.copy()
        j_losses = _record_train_losses(jwf.decision)
        jwf.run()
        twf = _port_ae(tmp_path / "c")
        init = twf.conv.module.weights.detach().clone()
        params_from_jax(tree, twf)
        assert _tied(twf)
        assert not torch.equal(init, twf.conv.module.weights)
        engine.train(twf)
    assert len(twf.decision.train_losses) == len(j_losses) == 2
    np.testing.assert_allclose(twf.decision.train_losses, j_losses,
                               **STEP_TOL)
    assert _tied(twf)
    bad = {"conv": dict(tree["conv"]),
           "deconv": {"weights": tree["deconv"]["weights"] + 1.0}}
    with pytest.raises(ValueError, match="tied"):
        params_from_jax(bad, twf)


def test_fused_trainer_refuses_tied_weights(tmp_path, caplog):
    """The port of ``tests/test_fused.py::test_fused_rejects_tied_weights``:
    given MnistAE's modules as a StandardWorkflow's, ``FusedTrainer``
    raises ``FusedUnsupportedError`` (a ValueError) naming the tie, before
    the loss check; ``engine.train`` then trains on the unit engine on
    the workflow's device."""
    from znicz_torch import engine
    from znicz_torch.parallel.fused import (FusedTrainer,
                                            FusedUnsupportedError)

    with sample_config("mnist_ae", **dict(REDUCED, decision__max_epochs=1)):
        twf = _port_ae(tmp_path)
        twf.forwards = [u.module for u in (twf.conv, twf.pool, twf.depool,
                                           twf.deconv)]
        twf.gds = {"conv": twf.gd_conv, "deconv": twf.gd_deconv}
        with pytest.raises(ValueError, match="tied") as exc:
            FusedTrainer(twf)
        assert exc.type is FusedUnsupportedError
        with caplog.at_level("WARNING", logger="znicz_torch.engine"):
            stats = engine.train(twf, fused=True)
    assert "tied" in caplog.text and not hasattr(twf, "trainer")
    assert stats["train_steps"] == 1 and bool(twf.decision.complete)
    assert twf.conv.output.devmem.device == twf.device


def test_cli_tiny_mnist_ae_prints_its_finals(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "znicz_torch", "mnist_ae", "--device", "cpu",
         *TINY, f"root.common.dirs.snapshots={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["workflow"] == "mnist_ae" and res["device"] == "cpu"
    assert res["epochs"] == 1 and res["train_steps"] == 1
    assert np.isfinite(res["final_train_mse"]) and np.isfinite(
        res["valid_mse"])
    assert "valid_err_pct" not in res
    assert (tmp_path / "mnist_ae_best.pickle.gz").is_file()


def test_mnist_ae_anchor_on_the_cpu(tmp_path):
    """The default MnistAE run (2000/400 digits, batch 100, 5 epochs: 99
    updates) through the command line on the unit engine lands inside the
    anchor bands the reference recorded.  One thread (about 10 s): beside
    other test workers the default thread pool oversubscribes the cores
    and the same run takes minutes."""
    from bench import ANCHOR_BANDS

    out = subprocess.run(
        [sys.executable, "-m", "znicz_torch", "mnist_ae", "--device", "cpu",
         "--seed", "1013", f"root.common.dirs.snapshots={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["epochs"] == 5 and res["train_steps"] == 99
    for metric, (center, half) in ANCHOR_BANDS[2].items():
        assert abs(round(res[metric], 6) - center) <= half, (metric,
                                                            res[metric])
