"""Every ported layer kind's forward and GD unit against the reference's
units on the CPU.

One parametrised test over the 15 kinds of
``znicz_torch/standard_workflow.py``'s registry and the cases that part
the unit path from the fused one: from the same numpy input, parameters,
velocities and ``err_output``, one forward unit ``run()`` and one GD unit
``run()`` of each package.  ``output`` within rtol 1e-5 / atol 1e-6 (the
forward of one layer), ``err_input``, the updated parameters and the
velocities within ``STEP_TOL`` (rtol 1e-4 / atol 1e-5: the two libraries
sum products and convolutions in different orders).  The cases:

  - the weighted kinds with momentum, weight decay, an L1/L2 mix and a
    clip (``HYPERS``), from nonzero velocities;
  - max and max-abs pooling on tie-heavy inputs, with partial and
    overlapping windows: the unit path's offsets equal (max-abs picks the
    first of ``x`` and ``-x``, where the fused path's forward keeps the
    positive), so ``err_input`` is equal bit for bit where windows do not
    overlap (where they do, the two scatters sum in different orders);
  - LRN composed and under ``pallas_lrn`` (the reference's Pallas kernel
    in interpret mode);
  - dropout with the reference's mask injected through ``mask_fn``, and
    on an eval minibatch.
"""

import numpy as np
import pytest
import torch

from test_torch_layers import FWD_TOL, _rand, _tie_heavy
from test_torch_planner import knobs
from test_torch_train import STEP_TOL

HYPERS = {"learning_rate": 0.05, "learning_rate_bias": 0.03,
          "weights_decay": 0.01, "weights_decay_bias": 0.002,
          "l1_vs_l2": 0.3, "gradient_moment": 0.9,
          "gradient_moment_bias": 0.5, "gradient_clip": 0.2}
FC = {"output_sample_shape": 5}
CONV = {"n_kernels": 4, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)}
CONV_S2 = {"n_kernels": 5, "kx": 3, "ky": 2, "sliding": (2, 2),
           "padding": (0, 1, 1, 0)}

#: id -> (kind, "->" keywords, input shape, input data, knobs, minibatch
#: class)
CASES = {
    "all2all": ("all2all", FC, (4, 3, 3, 2), "random", {}, 2),
    "all2all_tanh": ("all2all_tanh", FC, (4, 6), "random", {}, 2),
    "all2all_relu": ("all2all_relu", FC, (4, 6), "random", {}, 2),
    "all2all_strict_relu": ("all2all_strict_relu", FC, (4, 6), "random",
                            {}, 2),
    "all2all_sigmoid": ("all2all_sigmoid", FC, (4, 6), "random", {}, 2),
    "softmax": ("softmax", FC, (4, 3, 3, 2), "random", {}, 2),
    "conv": ("conv", CONV, (2, 6, 6, 3), "random", {}, 2),
    "conv_tanh": ("conv_tanh", CONV, (2, 6, 6, 3), "random", {}, 2),
    "conv_relu": ("conv_relu", CONV_S2, (2, 7, 6, 3), "random", {}, 2),
    "conv_strict_relu": ("conv_strict_relu", CONV, (2, 6, 6, 3), "random",
                         {}, 2),
    "max_pooling": ("max_pooling", {"kx": 2, "ky": 2}, (2, 7, 8, 3),
                    "ties", {}, 2),
    "max_pooling_overlap": ("max_pooling", {"kx": 3, "ky": 3,
                                            "sliding": (2, 2)},
                            (2, 7, 8, 3), "ties", {}, 2),
    "maxabs_pooling": ("maxabs_pooling", {"kx": 2, "ky": 2}, (2, 7, 8, 3),
                       "ties", {}, 2),
    "maxabs_pooling_overlap": ("maxabs_pooling",
                               {"kx": 3, "ky": 2, "sliding": (2, 1)},
                               (2, 7, 8, 3), "ties", {}, 2),
    "avg_pooling": ("avg_pooling", {"kx": 2, "ky": 2}, (2, 7, 7, 3),
                    "random", {}, 2),
    "norm": ("norm", {}, (2, 3, 4, 7), "random", {}, 2),
    "norm_pallas_lrn": ("norm", {}, (2, 3, 4, 7), "random",
                        {"pallas_lrn": True}, 2),
    "dropout": ("dropout", {"dropout_ratio": 0.4}, (4, 6), "random", {}, 2),
    "dropout_eval": ("dropout", {"dropout_ratio": 0.4}, (4, 6), "random",
                     {}, 1),
}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _reference(kind, kw, x, params, vels, err, klass):
    """(forward unit, GD unit) of the reference after one run each."""
    from znicz_tpu.memory import Array
    from znicz_tpu.standard_workflow import _registry

    fwd_cls, gd_cls = _registry()[kind]
    fwd = fwd_cls(None, name="f", **kw)
    fwd.input = Array(x)
    fwd.minibatch_class = klass
    fwd.initialize(device=None)
    for k, a in fwd.params().items():
        a.mem = params[k].copy()
    fwd.run()
    gd = gd_cls(None, name="g", forward=fwd,
                **(HYPERS if fwd.has_weights else {}))
    gd.err_output = Array(err)
    gd.initialize(device=None)
    for k, a in gd._velocities.items():
        a.mem = vels[k].copy()
    gd.run()
    return fwd, gd


def _port(kind, kw, x, params, vels, err, klass, mask=None):
    """(forward unit, GD unit) of the port after one run each."""
    from znicz_torch.memory import Array
    from znicz_torch.standard_workflow import _registry

    cpu = torch.device("cpu")
    mod_cls, unit_cls, gd_cls = _registry()[kind]
    mod = mod_cls(name="f", **kw)
    mod.build(x.shape, cpu)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    fwd = unit_cls(None, module=mod)
    fwd.input = Array(x)
    fwd.minibatch_class = klass
    if mask is not None:
        fwd.mask_fn = lambda step, shape, ratio: torch.from_numpy(mask)
    fwd.initialize(device=cpu)
    fwd.run()
    gd = gd_cls(None, name="g", forward=fwd,
                **(HYPERS if mod.has_weights else {}))
    gd.err_output = Array(err)
    gd.initialize(device=cpu)
    for k, v in vels.items():
        gd.velocities[k] = torch.from_numpy(v.copy())
    gd.run()
    return fwd, gd


@pytest.mark.parametrize("case", list(CASES))
def test_unit_pair_matches_reference(case):
    kind, kw, in_shape, data, knob_set, klass = CASES[case]
    x = _tie_heavy(in_shape, 61) if data == "ties" else _rand(in_shape, 61)
    if data == "ties":
        x[1, :2, :2, 1] = [[-0.5, 0.5], [0.0, 0.25]]   # -v before +v
    with knobs(**knob_set):
        from znicz_torch.standard_workflow import _registry

        mod = _registry()[kind][0](name="f", **kw)
        out_shape = mod.build(in_shape, torch.device("cpu"))
        params, vels = {}, {}
        if mod.has_weights:
            for i, (k, p) in enumerate((("weights", mod.weights),
                                        ("bias", mod.bias))):
                params[k] = _rand(tuple(p.shape), 62 + i, 0.5)
                vels[k] = _rand(tuple(p.shape), 64 + i, 0.01)
        err = _rand(out_shape, 66, 0.3)
        jfwd, jgd = _reference(kind, kw, x, params, vels, err, klass)
        mask = None
        if kind == "dropout" and klass == 2:
            mask = np.array(jfwd.mask.map_read())
            assert 0 < (mask == 0).sum() < mask.size
        tfwd, tgd = _port(kind, kw, x, params, vels, err, klass, mask)
    np.testing.assert_allclose(_np(tfwd.output.devmem),
                               np.array(jfwd.output.map_read()), **FWD_TOL)
    if data == "ties":
        np.testing.assert_array_equal(_np(tfwd.input_offset.devmem),
                                      np.array(jfwd.input_offset.map_read()))
        if case == "maxabs_pooling":
            # the fused path's forward keeps +0.5; the unit path the first
            assert _np(tfwd.module(torch.from_numpy(x)))[1, 0, 0, 1] == 0.5
            assert _np(tfwd.output.devmem)[1, 0, 0, 1] == -0.5
        if tuple(kw.get("sliding", (kw["ky"], kw["kx"]))) == \
                (kw["ky"], kw["kx"]):
            # one window an element: nothing is summed, so the same bits
            np.testing.assert_array_equal(
                _np(tgd.err_input.devmem),
                np.array(jgd.err_input.map_read()))
    np.testing.assert_allclose(_np(tgd.err_input.devmem),
                               np.array(jgd.err_input.map_read()),
                               **STEP_TOL)
    assert set(tgd.velocities) == set(jgd._velocities)
    assert tgd.apply_gradient == jgd.apply_gradient == mod.has_weights
    for k, a in jfwd.params().items():
        got = _np(tfwd.params()[k])
        assert not np.array_equal(got, params[k])
        np.testing.assert_allclose(got, np.array(a.map_read()), err_msg=k,
                                   **STEP_TOL)
        np.testing.assert_allclose(_np(tgd.velocities[k]),
                                   np.array(jgd._velocities[k].map_read()),
                                   err_msg=k, **STEP_TOL)
