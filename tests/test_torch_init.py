"""The port's weight init against the reference's, on the CPU.

A narrow AlexNet-shaped workflow (``test_torch_planner.tiny_layers``) is
built by both packages from the same global seed.  Each unit fills its
weights, then its bias, from its own named numpy stream in float32, so
every parameter must be bit-identical: with the default keywords, with
every init keyword set, and with the FC weights stored transposed."""

import numpy as np
import pytest

from test_torch_planner import SAMPLE, tiny_layers

SEED = 4242


def _with(layers, **fc_and_conv):
    """``layers`` with ``fc_and_conv`` added to every weighted layer's
    forward keywords (``weights_transposed`` to the FC layers only)."""
    out = []
    for layer in layers:
        layer = dict(layer)
        if "<-" in layer:
            kw = dict(layer.get("->", {}))
            for key, val in fc_and_conv.items():
                if key != "weights_transposed" or \
                        layer["type"] != "conv_strict_relu":
                    kw[key] = val
            layer["->"] = kw
        out.append(layer)
    return out


def _reference_params(layers):
    from znicz_tpu.core import prng
    from znicz_tpu.loader.fullbatch import FullBatchLoader
    from znicz_tpu.standard_workflow import StandardWorkflow

    prng.reset(SEED)

    class _Loader(FullBatchLoader):
        def load_data(self):
            self.original_data.mem = np.zeros((4,) + SAMPLE, np.float32)
            self.original_labels.mem = np.zeros((4,), np.int32)
            self.class_lengths = [0, 0, 4]
            super().load_data()

    wf = StandardWorkflow(
        name="TinyAlexNet", loader=_Loader(name="loader", minibatch_size=4),
        layers=layers, loss_function="softmax",
        decision_config={"max_epochs": 1, "fail_iterations": 0})
    wf.initialize(device=None)
    return {f.name: {k: np.array(a.map_read()) for k, a in f.params().items()}
            for f in wf.forwards if f.has_weights}


def _port_params(layers):
    from znicz_torch.core import prng
    from znicz_torch.standard_workflow import StandardWorkflow

    prng.reset(SEED)
    wf = StandardWorkflow(layers, SAMPLE, device="cpu")
    return {f.name: {"weights": f.weights.numpy(),
                     **({"bias": f.bias.numpy()} if f.bias is not None
                        else {})}
            for f in wf.forwards if f.has_weights}


@pytest.mark.parametrize("keywords", [
    {},
    {"weights_filling": "gaussian", "weights_stddev": 0.05,
     "bias_filling": "uniform", "bias_stddev": 0.02},
    {"weights_transposed": True, "bias_filling": "constant",
     "bias_stddev": 0.1},
], ids=["defaults", "gaussian_weights_uniform_bias", "transposed"])
def test_seeded_init_is_bit_identical_to_the_reference(keywords):
    layers = _with(tiny_layers(), **keywords)
    want = _reference_params(layers)
    got = _port_params(layers)
    assert sorted(got) == sorted(want)
    for name, leaves in want.items():
        assert sorted(got[name]) == sorted(leaves), name
        for key, arr in leaves.items():
            assert got[name][key].dtype == np.float32
            np.testing.assert_array_equal(got[name][key], arr,
                                          err_msg=f"{name}.{key}")
    # the keywords took effect: not all biases zero, FC weights (in, out)
    biases = np.concatenate([v["bias"] for v in got.values()])
    assert (np.any(biases != 0.0)) == ("bias_stddev" in keywords)
    fc = got["fwd_all2all_strict_relu_10"]["weights"]
    assert fc.shape == ((fc.size // 32, 32) if keywords.get(
        "weights_transposed") else (32, fc.size // 32))
