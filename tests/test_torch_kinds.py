"""The layer kinds the port's registry took last (the seven standalone
``activation_*`` kinds, ``ForwardMul``, ``cutter``, ``resizable_all2all``,
stochastic pooling plain and abs) and the planners' plain-``Conv`` +
StrictRELU-layer matches, against the reference on the CPU:

  - each activation kind's forward and ``err_input`` from one unit
    ``run()`` of each package, at a random tensor and at the edges (±0,
    ±9 and ±10 where TanhLog changes branch and its ``max`` ties, large
    |x| for Log, SinCos's odd and even flat indices across the batch
    axis), within rtol 1e-5 / atol 1e-6;
  - the cutter forward and backward with a zero side and an asymmetric
    crop, bit for bit;
  - ``ResizableAll2All`` grown and shrunk, with and without
    ``weights_transposed``: weights and bias bit-equal to the
    reference's after the same init, the GD velocities zeroed at the new
    shapes, a train step after the resize as the reference's (after
    ``tests/test_services.py:130``, ``:250``), and the parameter trees of
    ``weights.py`` at the new shapes;
  - stochastic pooling on the unit engine with the reference's offsets
    injected: the sampled output and the GD scatter bit-equal, the
    eval-time expectation and its offsets (after
    ``tests/test_pooling.py:108``), the all-zero window at position 0;
    the default sampler against its probabilities by a chi-square test
    at a fixed seed; ``FusedTrainer`` steps with the reference's offsets
    against the reference trainer's;
  - the planners on the tiny AlexNet built from plain ``conv`` +
    ``activation_str``: the reference's plans (spans 4 and 2), none for
    a max-abs or stochastic pool, a non-strict activation or a conv
    without bias; ``FusedTrainer`` steps on it under every routing
    against the reference's, and bit-equal to the ``conv_strict_relu``
    model's steps from the same weights and masks.
"""

import numpy as np
import pytest
import torch

from test_torch_gd_units import _np, _port, _reference
from test_torch_layers import FWD_TOL, _rand
from test_torch_planner import _plans, jax_workflow, knobs, tiny_layers
from test_torch_train import (ROUTINGS, STEP_GD, STEP_TOL, STEPS,
                              _jax_masks, _port_workflow)

ACTIVATIONS = ("activation_tanh", "activation_sigmoid", "activation_relu",
               "activation_str", "activation_log", "activation_sincos",
               "activation_tanhlog")
#: ±0, TanhLog's branch point and tie, large |x|, 15 values: SinCos's
#: parity runs across the rows of a (3, 5) batch.  Log's large |x| are
#: positive here: for x << 0 its ``x + sqrt(x^2 + 1)`` cancels and its
#: gradient is noise in the reference itself (at -1e3 the reference's
#: jitted and eager vjps differ by 1.7%); :data:`LOG_NEGATIVE` holds the
#: forward there
EDGES = np.array([[0.0, -0.0, 9.0, -9.0, 10.0],
                  [-10.0, 9.5, -10.5, 1e3, -12.5],
                  [3e4, 20.0, -20.0, 1e-3, -1e-3]], np.float32)
LOG_NEGATIVE = np.array([[-20.0, -1e3, -3e4, -1e30]], np.float32)


@pytest.mark.parametrize("data", ["random", "edges"])
@pytest.mark.parametrize("kind", ACTIVATIONS)
def test_activation_unit_matches_reference(kind, data):
    x = _rand((3, 4, 5), 71) * 4.0 if data == "random" else EDGES.copy()
    if kind == "activation_log" and data == "edges":
        x[2, 2] = 2e3
    err = _rand(x.shape, 72, 0.3)
    jfwd, jgd = _reference(kind, {}, x, {}, {}, err, 2)
    tfwd, tgd = _port(kind, {}, x, {}, {}, err, 2)
    want = np.array(jfwd.output.map_read())
    got = _np(tfwd.output.devmem)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(_np(tgd.err_input.devmem),
                               np.array(jgd.err_input.map_read()),
                               **FWD_TOL)
    assert tgd.apply_gradient is False and jgd.apply_gradient is False
    assert not tfwd.module.has_weights and tgd.velocities == {}


def test_log_forward_at_large_negative_x():
    """Where Log's sum cancels (to 0 at -3e4: -inf), the forward is still
    the reference's."""
    x = LOG_NEGATIVE
    jfwd, _ = _reference("activation_log", {}, x, {}, {}, x, 2)
    tfwd, _ = _port("activation_log", {}, x, {}, {}, x, 2)
    got, want = _np(tfwd.output.devmem), np.array(jfwd.output.map_read())
    np.testing.assert_allclose(got, want, **FWD_TOL)
    assert np.isneginf(got[0, 2]) and np.isneginf(want[0, 2])


def test_tanhlog_branches_and_tie():
    """|x| < 10 is the scaled tanh; outside, the log tail; at |x| == 10
    the ``max`` ties and autograd gives it half the gradient, as jax's
    ``maximum`` does."""
    from znicz_torch.ops.activations import TANH_A, tanh_scaled, tanhlog

    x = torch.tensor([-10.0, -9.5, 9.99, 10.0, 10.5, 19.0],
                     requires_grad=True)
    y = tanhlog(x)
    y.sum().backward()
    np.testing.assert_allclose(y[1:3].detach(), tanh_scaled(x[1:3]).detach())
    np.testing.assert_allclose(y[[0, 3]].detach(), [-TANH_A, TANH_A])
    np.testing.assert_allclose(y[5].item(), TANH_A + np.log(10.0), rtol=1e-6)
    np.testing.assert_allclose(x.grad[[0, 3]], [0.5, 0.5])
    np.testing.assert_allclose(x.grad[[4, 5]], [1 / 1.5, 0.1], rtol=1e-6)


def test_is_strict_relu_unit():
    from znicz_torch import activation as act
    from znicz_torch.conv import ConvStrictRELU

    assert act.is_strict_relu_unit(act.ForwardStrictRELU())
    assert not act.is_strict_relu_unit(act.ForwardTanh())
    assert not act.is_strict_relu_unit(act.ActivationForward())
    assert not act.is_strict_relu_unit(ConvStrictRELU())


def test_forward_mul_is_the_product():
    from znicz_torch.activation import ForwardMul
    from znicz_torch.memory import Array
    from znicz_tpu.activation import ForwardMul as JMul
    from znicz_tpu.memory import Array as JArray

    a, b = _rand((4, 3, 2), 73), _rand((4, 3, 2), 74)
    unit = ForwardMul(None, name="mul")
    unit.input, unit.x2 = Array(a), Array(b)
    unit.initialize(device=torch.device("cpu"))
    unit.run()
    ref = JMul(None, name="mul")
    ref.input, ref.x2 = JArray(a), JArray(b)
    ref.initialize(device=None)
    ref.run()
    np.testing.assert_array_equal(_np(unit.output.devmem), a * b)
    np.testing.assert_array_equal(_np(unit.output.devmem),
                                  np.array(ref.output.map_read()))
    assert unit.name == "mul" and not unit.has_weights


@pytest.mark.parametrize("padding", [(1, 2, 0, 3), (0, 0, 0, 0),
                                     (2, 0, 1, 1)])
def test_cutter_matches_reference(padding):
    x = _rand((2, 7, 6, 3), 75)
    kw = {"padding": padding}
    left, top, right, bottom = padding
    err = _rand((2, 7 - top - bottom, 6 - left - right, 3), 76)
    jfwd, jgd = _reference("cutter", kw, x, {}, {}, err, 2)
    tfwd, tgd = _port("cutter", kw, x, {}, {}, err, 2)
    np.testing.assert_array_equal(_np(tfwd.output.devmem),
                                  np.array(jfwd.output.map_read()))
    got = _np(tgd.err_input.devmem)
    np.testing.assert_array_equal(got, np.array(jgd.err_input.map_read()))
    assert got.shape == x.shape
    np.testing.assert_array_equal(
        got[:, top:7 - bottom, left:6 - right], err)
    assert float(np.abs(got).sum()) == pytest.approx(float(np.abs(err).sum()))
    assert tfwd.module.output_shape_for(x.shape) == err.shape
    assert tgd.apply_gradient is False


# -- ResizableAll2All ---------------------------------------------------------


def _resizable_pair(transposed, bias_seed=77):
    """(reference unit, port unit) of width 4 on a (2, 5) input, from the
    same seed, with the same random bias."""
    from znicz_torch.core import prng as tprng
    from znicz_torch.memory import Array
    from znicz_torch.resizable_all2all import (ResizableAll2All,
                                               ResizableAll2AllUnit)
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.resizable_all2all import ResizableAll2All as JResizable

    jprng.reset(1013)
    tprng.reset(1013)
    x = _rand((2, 5), 78)
    ref = JResizable(None, name="rsz", output_sample_shape=(4,),
                     weights_transposed=transposed)
    ref.input = JArray(x)
    ref.initialize(device=None)
    mod = ResizableAll2All(name="rsz", output_sample_shape=(4,),
                           weights_transposed=transposed)
    mod.build(x.shape, torch.device("cpu"))
    bias = _rand((4,), bias_seed)
    ref.bias.mem = bias.copy()
    with torch.no_grad():
        mod.bias.copy_(torch.from_numpy(bias))
    unit = ResizableAll2AllUnit(None, module=mod)
    unit.input = Array(x)
    unit.initialize(device=torch.device("cpu"))
    return ref, unit


@pytest.mark.parametrize("transposed", [False, True])
def test_resize_keeps_rows_and_draws_the_reference_bits(transposed):
    ref, unit = _resizable_pair(transposed)
    mod = unit.module
    np.testing.assert_array_equal(_np(mod.weights),
                                  np.array(ref.weights.map_read()))
    for width in (7, 3, 3, 9):
        old_w = _np(mod.weights).copy()
        ref.resize(width)
        unit.resize(width)
        w = _np(mod.weights)
        np.testing.assert_array_equal(w, np.array(ref.weights.map_read()))
        np.testing.assert_array_equal(_np(mod.bias),
                                      np.array(ref.bias.map_read()))
        assert w.shape == ((5, width) if transposed else (width, 5))
        keep = min(old_w.shape[1 if transposed else 0], width)
        rows = (lambda a: a[:, :keep]) if transposed else \
            (lambda a: a[:keep])
        np.testing.assert_array_equal(rows(w), rows(old_w))
        assert isinstance(mod.weights, torch.nn.Parameter)
        assert not mod.weights.requires_grad
        assert mod.output_sample_shape == (width,)
        unit.run()
        ref.run()
        np.testing.assert_allclose(_np(unit.output.devmem),
                                   np.array(ref.output.map_read()),
                                   **FWD_TOL)
    assert _np(mod.bias).shape == (9,)


def test_resize_zeroes_the_velocities_and_trains_as_the_reference():
    """After ``tests/test_services.py:250``: the GD unit's velocities are
    zeros at the new shapes, and a step after the resize updates the
    weights as the reference's does; the parameter trees of
    ``weights.py`` carry the new shapes."""
    from znicz_torch.core import prng as tprng
    from znicz_torch.core.workflow import Workflow
    from znicz_torch.gd import GradientDescent
    from znicz_torch.memory import Array
    from znicz_torch.resizable_all2all import (ResizableAll2All,
                                               ResizableAll2AllUnit)
    from znicz_torch.weights import (params_from_jax, params_to_numpy,
                                     velocities_from_jax,
                                     velocities_to_numpy)
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.workflow import Workflow as JWorkflow
    from znicz_tpu.gd import GradientDescent as JGD
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.resizable_all2all import ResizableAll2All as JResizable

    jprng.reset(1013)
    tprng.reset(1013)
    x = _rand((2, 5), 79)
    cpu = torch.device("cpu")
    jwf = JWorkflow(name="rszwf")
    jf = JResizable(jwf, name="rszv", output_sample_shape=(4,))
    jf.input = JArray(x)
    jf.initialize(device=None)
    jgd = JGD(jwf, name="rszv_gd", forward=jf, gradient_moment=0.9,
              need_err_input=False)
    jgd.err_output = JArray(_rand((2, 4), 80))
    jgd.initialize(device=None)
    twf = Workflow(name="rszwf")
    mod = ResizableAll2All(name="rszv", output_sample_shape=(4,))
    mod.build(x.shape, cpu)
    tf = ResizableAll2AllUnit(twf, module=mod)
    tf.input = Array(x)
    tf.initialize(device=cpu)
    tgd = GradientDescent(twf, name="rszv_gd", forward=tf,
                          gradient_moment=0.9, need_err_input=False)
    tgd.err_output = Array(_rand((2, 4), 80))
    tgd.initialize(device=cpu)
    for u in (jf, jgd, tf, tgd):
        u.run()
    assert float(np.abs(_np(tgd.velocities["weights"])).sum()) > 0
    jf.resize(7)
    tf.resize(7)
    for k in ("weights", "bias"):
        v = _np(tgd.velocities[k])
        assert v.shape == tuple(jgd._velocities[k].shape)
        assert not v.any() and tgd.velocities[k].dtype == torch.float32
    np.testing.assert_array_equal(_np(mod.weights),
                                  np.array(jf.weights.map_read()))
    err = _rand((2, 7), 81)
    jgd.err_output = JArray(err)
    tgd.err_output = Array(err)
    for u in (jf, jgd, tf, tgd):
        u.run()
    for k, a in jf.params().items():
        np.testing.assert_allclose(_np(tf.params()[k]),
                                   np.array(a.map_read()), **STEP_TOL)
        np.testing.assert_allclose(_np(tgd.velocities[k]),
                                   np.array(jgd._velocities[k].map_read()),
                                   **STEP_TOL)
    tree = params_to_numpy(twf)
    assert tree["rszv"]["weights"].shape == (7, 5)
    assert velocities_to_numpy(twf)["rszv"]["bias"].shape == (7,)
    jtree = {"rszv": {k: np.array(a.map_read())
                      for k, a in jf.params().items()}}
    params_from_jax(jtree, twf)
    np.testing.assert_array_equal(_np(mod.weights), jtree["rszv"]["weights"])
    velocities_from_jax({"rszv": {k: np.array(a.map_read()) for k, a
                                  in jgd._velocities.items()}}, twf)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({"rszv": {"weights": np.zeros((4, 5), np.float32),
                                  "bias": np.zeros(4, np.float32)}}, twf)
    # a resize to the same width changes nothing
    before = mod.weights
    tf.resize(7)
    assert mod.weights is before


def test_resizable_kind_builds_in_a_workflow():
    from znicz_torch.resizable_all2all import ResizableAll2AllUnit
    from znicz_torch.standard_workflow import StandardWorkflow

    wf = StandardWorkflow([{"type": "resizable_all2all",
                            "->": {"output_sample_shape": 6}},
                           {"type": "softmax",
                            "->": {"output_sample_shape": 3}}],
                          (4,), device="cpu")
    unit = wf.forward_units[0]
    assert isinstance(unit, ResizableAll2AllUnit)
    assert wf.forwards[0].name == "fwd_resizable_all2all_0"
    assert type(wf.gds[unit.name]).__name__ == "GradientDescent"


# -- stochastic pooling: the unit engine --------------------------------------

POOLS = {"stochastic_pooling": {"kx": 2, "ky": 2},
         "stochastic_abs_pooling": {"kx": 3, "ky": 3, "sliding": (2, 2)}}


def _stochastic_units(kind, kw, x, klass, inject=False):
    """(reference forward unit, port forward unit, the port's offset-seam
    calls) after one run each on ``x``; with ``inject`` the port's
    offsets are the reference unit's, through ``offset_fn``."""
    from znicz_torch.memory import Array
    from znicz_torch.standard_workflow import _registry as treg
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.standard_workflow import _registry as jreg

    ref = jreg()[kind][0](None, name="sp", **kw)
    ref.input = JArray(x)
    ref.minibatch_class = klass
    ref.initialize(device=None)
    ref.run()
    mod_cls, unit_cls, _ = treg()[kind]
    mod = mod_cls(name="sp", **kw)
    mod.build(x.shape, torch.device("cpu"))
    unit = unit_cls(None, module=mod)
    unit.input = Array(x)
    unit.minibatch_class = klass
    seen = []
    if inject:
        offsets = np.array(ref.input_offset.map_read(), np.int64)

        def offset_fn(step, probs):
            seen.append((step, tuple(probs.shape)))
            return torch.from_numpy(offsets)

        unit.offset_fn = offset_fn
    unit.initialize(device=torch.device("cpu"))
    unit.run()
    return ref, unit, seen


def _pool_input(seed, shape=(2, 7, 9, 3)):
    """Random signs, with window (0, 0) of channel 0 all negative (all
    zero weights for ``StochasticPooling``) and window (0, 1) all zero."""
    x = _rand(shape, seed)
    x[0, :3, :3, 0] = -np.abs(x[0, :3, :3, 0]) - 0.1
    x[0, :3, 3:6, 0] = 0.0
    return x


@pytest.mark.parametrize("kind", list(POOLS))
def test_stochastic_unit_train_mode_with_reference_offsets(kind):
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.standard_workflow import _registry as jreg

    kw = POOLS[kind]
    x = _pool_input(82)
    ref, unit, seen = _stochastic_units(kind, kw, x, 2, inject=True)
    ref_off = np.array(ref.input_offset.map_read())
    assert seen == [(0, ref_off.shape + (kw["kx"] * kw["ky"],))]
    assert unit._step_counter == 1
    np.testing.assert_array_equal(_np(unit.input_offset.devmem), ref_off)
    np.testing.assert_array_equal(_np(unit.output.devmem),
                                  np.array(ref.output.map_read()))
    err = _rand(ref_off.shape, 83)
    jgd = jreg()[kind][1](None, name="g", forward=ref)
    jgd.err_output = JArray(err)
    jgd.initialize(device=None)
    jgd.run()
    from znicz_torch.memory import Array
    from znicz_torch.standard_workflow import _registry as treg

    tgd = treg()[kind][2](None, name="g", forward=unit)
    tgd.err_output = Array(err)
    tgd.initialize(device=torch.device("cpu"))
    tgd.run()
    got = _np(tgd.err_input.devmem)
    want = np.array(jgd.err_input.map_read())
    if kind == "stochastic_pooling":        # windows apart: no sums
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    assert tgd.apply_gradient is False
    # the all-zero windows sample position 0 in both packages
    if kind == "stochastic_pooling":
        assert ref_off[0, 0, 0, 0] == 0
    assert ref_off[0, 0, 1, 0] == 0


@pytest.mark.parametrize("kind", list(POOLS))
def test_stochastic_unit_eval_mode_is_the_expectation(kind):
    kw = POOLS[kind]
    x = _pool_input(84)
    ref, unit, _ = _stochastic_units(kind, kw, x, 1)
    np.testing.assert_allclose(_np(unit.output.devmem),
                               np.array(ref.output.map_read()), **FWD_TOL)
    np.testing.assert_array_equal(_np(unit.input_offset.devmem),
                                  np.array(ref.input_offset.map_read()))
    assert unit._step_counter == 0
    # the expectation of one window, as the reference's test reads it
    win = x[1, 0:2, 0:2, 2].reshape(-1) if kind == "stochastic_pooling" \
        else x[1, 0:3, 0:3, 2].reshape(-1)
    w = np.maximum(win, 0.0) if kind == "stochastic_pooling" \
        else np.abs(win)
    np.testing.assert_allclose(_np(unit.output.devmem)[1, 0, 0, 2],
                               float((win * (w / w.sum())).sum()), rtol=1e-6)
    # the module's own forward (serving) is the same expectation
    np.testing.assert_array_equal(_np(unit.module(torch.from_numpy(x))),
                                  _np(unit.output.devmem))


def test_stochastic_default_sampler_follows_the_probabilities():
    """Chi-square of the default sampler's counts over 200000 windows of
    fixed probabilities, at a fixed seed (so the statistic is one fixed
    number): below 16.27, the 0.1% point of chi-square with 3 degrees of
    freedom.  Zero-probability positions are never drawn, and a window
    of zero weights draws position 0."""
    from znicz_torch.core import prng
    from znicz_torch.pooling import StochasticPooling

    prng.reset(1013)
    p = torch.tensor([0.1, 0.0, 0.2, 0.3, 0.0, 0.4])
    n = 200000
    probs = p.repeat(n, 1).reshape(n // 100, 10, 10, 6)
    gen = prng.get("sampler").torch_generator(0, 0, "cpu")
    off = StochasticPooling.sample_offsets(probs, gen)
    counts = np.bincount(off.numpy().reshape(-1), minlength=6)
    assert counts[1] == counts[4] == 0
    want = p.numpy()[[0, 2, 3, 5]] * n
    chi2 = float((((counts[[0, 2, 3, 5]] - want) ** 2) / want).sum())
    assert chi2 < 16.27, (counts, chi2)
    again = StochasticPooling.sample_offsets(
        probs, prng.get("sampler").torch_generator(0, 0, "cpu"))
    assert torch.equal(off, again)
    pool = StochasticPooling(name="sp", kx=2, ky=2)
    pool.build((1, 2, 2, 1), torch.device("cpu"))
    zero = pool.probabilities(pool.windows(-torch.ones(1, 2, 2, 1), 0.0))
    np.testing.assert_array_equal(zero.numpy().reshape(-1), [1, 0, 0, 0])
    assert int(StochasticPooling.sample_offsets(zero, gen).item()) == 0


def test_stochastic_units_get_the_minibatch_class():
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.standard_workflow import StandardWorkflow

    ld = FullBatchLoader(minibatch_size=4)
    ld.original_data = _rand((8, 6, 6, 2), 85)
    ld.original_labels = np.arange(8, dtype=np.int32) % 3
    ld.class_lengths = [0, 4, 4]
    wf = StandardWorkflow(
        [{"type": "stochastic_abs_pooling", "->": {"kx": 2, "ky": 2}},
         {"type": "activation_sincos"},
         {"type": "cutter", "->": {"padding": (1, 0, 0, 1)}},
         {"type": "softmax", "->": {"output_sample_shape": 3}}],
        device="cpu", loader=ld)
    pool = wf.forward_units[0]
    assert pool.has_linked_attr("minibatch_class")
    ld.run()
    assert pool.minibatch_class == ld.minibatch_class == 1
    assert not wf.forward_units[1].has_linked_attr("minibatch_class")
    assert wf.output_sample_shape == (3,)
    assert wf.forwards[2].output_shape_for((1, 3, 3, 2)) == (1, 2, 2, 2)


# -- stochastic pooling on FusedTrainer ---------------------------------------


def _jax_offsets():
    """The reference trainer's draw as the port's offset seam wants it:
    ``categorical(fold_in(key(step), index), log(max(p, 1e-30)))`` on the
    port's probabilities."""
    import jax
    import jax.numpy as jnp

    from znicz_tpu.core import prng as jprng

    def offsets(step, index, probs):
        key = jax.random.fold_in(jprng.get("fused_trainer").jax_key(step),
                                 index)
        logits = jnp.log(jnp.maximum(jnp.asarray(probs.numpy()), 1e-30))
        return torch.from_numpy(np.array(
            jax.random.categorical(key, logits, axis=-1)).astype(np.int64))

    return offsets


def stochastic_layers(kind, gd=None):
    gd = gd or dict(STEP_GD)
    return [
        {"type": "conv_tanh",
         "->": {"n_kernels": 6, "kx": 3, "ky": 3, "sliding": (2, 2)},
         "<-": dict(gd)},
        {"type": kind, "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "activation_tanhlog"},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": dict(gd)},
    ]


def _step_both(layers, knob_set, mask_fn=None, offset_fn=None):
    """The reference trainer's and the port's train steps over ``STEPS``
    from the same parameters; returns (losses of each, final trees)."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_from_jax, params_to_numpy
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    jwf = jax_workflow(layers)
    jt = JTrainer(jwf)
    params, vels, dataset, targets, _ = jt._device_state()
    start = {n: {k: np.asarray(v) for k, v in l.items()}
             for n, l in params.items()}
    twf = params_from_jax(start, _port_workflow(jwf, layers))
    tt = FusedTrainer(twf, mask_fn=mask_fn, offset_fn=offset_fn)
    jl, tl = [], []
    with knobs(**knob_set):
        step_fn = jt.make_train_step()
        for step, (idx, bs) in enumerate(STEPS):
            key = jprng.get("fused_trainer").jax_key(step)
            params, vels, (jloss, _, _) = step_fn(
                params, vels, jt.hypers(), dataset, targets,
                np.array(idx, np.int32), np.int32(bs), key)
            tloss, _, _ = tt.train_step(np.array(idx), bs, step)
            jl.append(float(jloss))
            tl.append(float(tloss))
    want = {n: {k: np.asarray(v) for k, v in l.items()}
            for n, l in params.items()}
    return jl, tl, start, want, params_to_numpy(twf), tt


@pytest.mark.parametrize("kind", list(POOLS))
def test_fused_trainer_stochastic_steps_match_reference(kind):
    seen = []
    ref_offsets = _jax_offsets()

    def offset_fn(step, index, probs):
        seen.append((step, index))
        return ref_offsets(step, index, probs)

    jl, tl, start, want, got, tt = _step_both(
        stochastic_layers(kind), {}, offset_fn=offset_fn)
    assert seen == [(s, 1) for s in range(len(STEPS))]
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    for name, leaves in want.items():
        for k, v in leaves.items():
            assert not np.array_equal(start[name][k], v)
            np.testing.assert_allclose(got[name][k], v, err_msg=name,
                                       **STEP_TOL)
    # eval (and serving) is the expectation: no draw
    x = torch.from_numpy(_rand((2, 31, 31, 3), 86))
    tt.forward_pass(x, train=False)
    assert len(seen) == len(STEPS)


def test_fused_stochastic_backward_scatters_to_the_sampled_offsets():
    """The train-mode select's gradient is ``scatter_at_offsets`` of the
    output gradient, the same bits on a second backward."""
    from znicz_torch.pooling import StochasticPooling

    pool = StochasticPooling(name="sp", kx=3, ky=3, sliding=(2, 2))
    pool.build((2, 9, 9, 4), torch.device("cpu"))
    x = torch.from_numpy(_rand((2, 9, 9, 4), 87)).requires_grad_(True)
    probs = pool.probabilities(pool.windows(x.detach(), 0.0))
    off = pool.sample_offsets(probs, torch.Generator().manual_seed(3))
    g = torch.from_numpy(_rand((2, 4, 4, 4), 88))
    grads = []
    for _ in range(2):
        y = pool.select_sampled(x, off)
        grads.append(torch.autograd.grad(y, x, g)[0])
    assert torch.equal(grads[0], grads[1])
    want = pool.scatter_at_offsets(g, off, tuple(x.shape))
    assert torch.equal(grads[0], want)
    win = pool.windows(x.detach(), 0.0)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        torch.gather(win, -1, off.unsqueeze(-1)).squeeze(-1).numpy())


# -- the planners on plain conv + activation_str ------------------------------


def plain_conv(layers):
    """``layers`` with each ``conv_strict_relu`` as a plain ``conv`` (the
    same keywords) followed by an ``activation_str``."""
    out = []
    for layer in layers:
        if layer["type"] == "conv_strict_relu":
            out.append({**layer, "type": "conv"})
            out.append({"type": "activation_str"})
        else:
            out.append(layer)
    return out


def test_plain_conv_plans_match_reference():
    with knobs(fused_elementwise=True, fused_tail=True):
        (jb, jt), (tb, tt) = _plans(plain_conv(tiny_layers()))
    assert tb == jb and tt == jt
    assert sorted(tb) == [0, 4] and {s[0] for s in tb.values()} == {4}
    assert sorted(tt) == [8, 10, 12, 15, 17]
    assert all(tt[i] == ("conv_bias_relu", 2, 0.0, -1) for i in (8, 10, 12))
    assert tt[15] == ("fc_epilogue", 2, 0.5, 16)


@pytest.mark.parametrize("opt_out", ["pallas_lrn", "lrn_pow"])
def test_plain_conv_tail_plan_takes_every_conv(opt_out):
    with knobs(fused_elementwise=True, fused_tail=True, **{opt_out: True}):
        (jb, jt), (tb, tt) = _plans(plain_conv(tiny_layers()))
    assert jb == tb == {}
    assert tt == jt and sorted(tt) == [0, 4, 8, 10, 12, 15, 17]


def _plans_no_bias(layers):
    """``_plans`` for a list with a conv without bias (whose empty bias
    the shared reference helper cannot randomise)."""
    from znicz_torch.fused_block import plan_fused_blocks as t_blocks
    from znicz_torch.fused_block import plan_fused_tail as t_tail
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_tpu.core import prng
    from znicz_tpu.loader.fullbatch import FullBatchLoader
    from znicz_tpu.pallas_fused_block import plan_fused_blocks as j_blocks
    from znicz_tpu.pallas_fused_block import plan_fused_tail as j_tail
    from znicz_tpu.standard_workflow import StandardWorkflow as JWorkflow

    prng.reset(1013)
    ld = FullBatchLoader(name="loader", minibatch_size=2)
    ld.original_data.mem = _rand((2, 31, 31, 3), 89)
    ld.original_labels.mem = np.arange(2, dtype=np.int32)
    jwf = JWorkflow(name="nobias", loader=ld, layers=layers)
    jwf.initialize(device=None)
    twf = StandardWorkflow(layers, (31, 31, 3), device="cpu")
    out = []
    for blocks, tail, fwds in ((j_blocks, j_tail, jwf.forwards),
                               (t_blocks, t_tail, list(twf.forwards))):
        bp = blocks(fwds)
        out.append(({i: tuple(s) for i, s in bp.items()},
                    {i: tuple(s) for i, s in tail(fwds, bp).items()}))
    return out


@pytest.mark.parametrize("change", ["maxabs_pooling", "stochastic_pooling",
                                    "activation_tanh", "no_bias"])
def test_plain_conv_mismatches_are_not_fused(change):
    layers = plain_conv(tiny_layers())
    if change.endswith("pooling"):
        layers[3] = {"type": change, "->": dict(layers[3]["->"])}
    elif change == "activation_tanh":
        layers[1] = {"type": "activation_tanh"}
    else:
        layers[0] = {**layers[0], "->": {**layers[0]["->"],
                                         "include_bias": False}}
    with knobs(fused_elementwise=True, fused_tail=True):
        (jb, jt), (tb, tt) = (_plans_no_bias if change == "no_bias"
                              else _plans)(layers)
    assert tb == jb and tt == jt
    assert 0 not in tb and sorted(tb) == [4]
    if change.endswith("pooling"):          # the tail still takes conv1
        assert tt[0] == ("conv_bias_relu", 2, 0.0, -1)
    else:
        assert 0 not in tt


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_plain_conv_steps_match_reference(routing):
    jl, tl, start, want, got, _ = _step_both(
        plain_conv(tiny_layers(gd=STEP_GD)), ROUTINGS[routing],
        mask_fn=_jax_masks())
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    for name, leaves in want.items():
        for k, v in leaves.items():
            assert not np.array_equal(start[name][k], v)
            np.testing.assert_allclose(got[name][k], v, err_msg=name,
                                       **STEP_TOL)


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_plain_conv_steps_equal_the_conv_strict_relu_model(routing):
    """From the same weights and the same dropout masks (looked up by the
    ``conv_strict_relu`` model's indices), the plain-conv model's losses
    and final weights are the same bits under every routing."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax, params_to_numpy

    layers = tiny_layers(gd=STEP_GD)
    plain = plain_conv(layers)
    jwf = jax_workflow(layers)
    base = _port_workflow(jwf, layers)
    other = _port_workflow(jwf, plain)
    tree = params_to_numpy(base)
    names = [f.name for f in other.forwards if f.has_weights]
    params_from_jax(dict(zip(names, tree.values())), other)
    remap = {}
    for i, f in enumerate(other.forwards):
        if f.layer_kind != "activation_str":
            remap[i] = len(remap)
    masks = _jax_masks()
    runs = []
    for wf, index in ((base, lambda i: i), (other, remap.get)):
        t = FusedTrainer(wf, mask_fn=lambda s, i, shape, r, index=index:
                         masks(s, index(i), shape, r))
        with knobs(**ROUTINGS[routing]):
            losses = [float(t.train_step(np.array(idx), bs, step)[0])
                      for step, (idx, bs) in enumerate(STEPS)]
        runs.append((losses, list(params_to_numpy(wf).values())))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert isinstance(base, StandardWorkflow)


@pytest.mark.parametrize("kind", list(POOLS))
def test_eval_forward_is_the_reference_expectation(kind):
    """``FusedTrainer.forward_pass(train=False)`` (serving's path) through
    stochastic pooling, TanhLog and the softmax head equals the
    reference's eval forward on the same parameters."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_from_jax
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    layers = stochastic_layers(kind)
    jwf = jax_workflow(layers)
    jt = JTrainer(jwf)
    params = jt._device_state()[0]
    tree = {n: {k: np.asarray(v) for k, v in l.items()}
            for n, l in params.items()}
    twf = params_from_jax(tree, _port_workflow(jwf, layers))
    x = _rand((4, 31, 31, 3), 90)
    want = np.asarray(jt.forward_pass(params, x, None, False))
    got = FusedTrainer(twf).forward_pass(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(_np(got), want, **FWD_TOL)


def test_resizable_unit_pair_matches_reference():
    """The ``resizable_all2all`` kind's forward and GD units (momentum,
    decay, clip, from nonzero velocities) against the reference's, as
    ``test_torch_gd_units`` holds every other weighted kind."""
    x = _rand((4, 6), 91)
    params = {"weights": _rand((5, 6), 92, 0.5), "bias": _rand((5,), 93)}
    vels = {k: _rand(v.shape, 94, 0.01) for k, v in params.items()}
    err = _rand((4, 5), 95, 0.3)
    kw = {"output_sample_shape": 5}
    jfwd, jgd = _reference("resizable_all2all", kw, x, params, vels, err, 2)
    tfwd, tgd = _port("resizable_all2all", kw, x, params, vels, err, 2)
    np.testing.assert_allclose(_np(tfwd.output.devmem),
                               np.array(jfwd.output.map_read()), **FWD_TOL)
    np.testing.assert_allclose(_np(tgd.err_input.devmem),
                               np.array(jgd.err_input.map_read()),
                               **STEP_TOL)
    assert tgd.apply_gradient
    for k, a in jfwd.params().items():
        np.testing.assert_allclose(_np(tfwd.params()[k]),
                                   np.array(a.map_read()), err_msg=k,
                                   **STEP_TOL)
        np.testing.assert_allclose(_np(tgd.velocities[k]),
                                   np.array(jgd._velocities[k].map_read()),
                                   err_msg=k, **STEP_TOL)
