"""The observers against the reference on the CPU (after
``tests/test_graphics.py`` and the plotter and image-saver tests of
``tests/test_aux.py``):

  - live streaming: a ``GraphicsServer`` (XPUB) and the port's
    ``python -m znicz_torch.graphics`` client process render the figures
    the offline path renders; no server: offline PNGs; ``render=False``
    only accumulates; the client refuses a non-loopback endpoint (the
    loopback rule the reference's, endpoint for endpoint); every plotter
    kind survives the wire trip, its ``snapshot()`` equal to the
    reference plotter's on the same inputs;
  - ``StandardWorkflow(plotters=True, image_saver_config=...)`` on the
    unit engine and under ``FusedTrainer``: the PNGs, one point an epoch,
    the stop lap not advancing the loader, an MSE workflow plotting its
    loss; the reference's and the port's plot series, weight tiles and
    confusion matrices after the same seeded run, the tiles bit-equal once
    the reference's weights are carried across;
  - the fused trainer's epoch-end plots read that epoch's weights: epoch
    2's tiles are the trained parameters and differ from epoch 1's;
  - ``ImageSaver`` writes the misclassified samples as the reference's.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from test_torch_layers import jax_params, sample_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the seconds a client process is given (a hang guard)
CLIENT_S = 120
#: trained weights, port unit engine against the reference's
#: (``tests/test_torch_engine.py``'s ``W_TOL``)
W_TOL = {"rtol": 1e-3, "atol": 1e-5}
MNIST_TINY = {"loader__n_train": 120, "loader__n_valid": 60,
              "loader__minibatch_size": 60}
GD = {"learning_rate": 0.1, "gradient_moment": 0.9}


@pytest.fixture
def dirs(tmp_path):
    """Both packages' ``root.common.dirs`` pointed into ``tmp_path``, put
    back afterwards."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    keys = ("snapshots", "plots", "image_saver")
    saved = [(tree, {k: tree.common.dirs.get(k, None) for k in keys})
             for tree in (troot, jroot)]
    for tree in (troot, jroot):
        tree.common.dirs.snapshots = str(tmp_path)
        tree.common.dirs.plots = str(tmp_path / "plots")
        tree.common.dirs.image_saver = str(tmp_path / "imgs")
    yield tmp_path
    for tree, old in saved:
        for k, v in old.items():
            if v is None:
                delattr(tree.common.dirs, k)
            else:
                setattr(tree.common.dirs, k, v)


def _client(endpoint, out, figures):
    return subprocess.Popen(
        [sys.executable, "-m", "znicz_torch.graphics", endpoint, str(out),
         "--max-figures", str(figures), "--timeout", str(CLIENT_S)],
        cwd=REPO, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))


# -- graphics -----------------------------------------------------------------


def test_live_streaming_to_client_process(dirs):
    from znicz_torch.core.config import root
    from znicz_torch.graphics import GraphicsServer
    from znicz_torch.memory import Array
    from znicz_torch.plotting_units import AccumulatingPlotter, Weights2D

    out = dirs / "live"
    server = GraphicsServer.start("tcp://127.0.0.1:*")
    try:
        proc = _client(server.endpoint, out, 3)
        assert server.wait_for_subscribers(1, timeout=CLIENT_S)
        losses = iter([2.0, 1.0])
        acc = AccumulatingPlotter(name="live_loss",
                                  fetch=lambda: next(losses))
        weights = Weights2D(
            name="live_w",
            source=Array(np.random.default_rng(0).normal(
                size=(4, 16)).astype(np.float32)),
            sample_shape=(4, 4))
        acc.run()
        acc.run()
        weights.run()
        stdout, _ = proc.communicate(timeout=CLIENT_S)
    finally:
        GraphicsServer.stop()
    assert proc.returncode == 0
    assert "rendered 3 figures" in stdout
    assert (out / "live_loss.png").exists()
    assert (out / "live_w.png").exists()
    # while a server is active the units stream instead of rendering
    assert not os.path.exists(os.path.join(root.common.dirs.plots,
                                           "live_loss.png"))


def test_graceful_offline_degradation(dirs):
    from znicz_torch.graphics import GraphicsServer
    from znicz_torch.plotting_units import AccumulatingPlotter

    assert GraphicsServer.active() is None
    vals = iter([1.0, 0.5])
    acc = AccumulatingPlotter(name="off_loss", fetch=lambda: next(vals))
    acc.run()
    acc.run()
    assert acc.values == [1.0, 0.5]
    assert os.path.exists(acc.path())


def test_render_false_still_accumulates(dirs):
    from znicz_torch.plotting_units import AccumulatingPlotter

    vals = iter([2.0, 1.0])
    acc = AccumulatingPlotter(name="noren", fetch=lambda: next(vals),
                              render=False)
    acc.run()
    acc.run()
    assert acc.values == [2.0, 1.0]
    assert not os.path.exists(acc.path())


def test_client_refuses_non_loopback_endpoint(tmp_path):
    from znicz_torch.graphics import GraphicsClient, _is_loopback
    from znicz_tpu.graphics import _is_loopback as j_is_loopback

    with pytest.raises(ValueError, match="loopback"):
        GraphicsClient("tcp://198.51.100.7:5555", str(tmp_path))
    for ep in ("tcp://127.0.0.1:9000", "ipc:///tmp/sock", "inproc://x",
               "tcp://[2001:db8::1]:9000", "tcp://localhost:1",
               "tcp://[::1]:2", "tcp://10.0.0.1:3", "udp://127.0.0.1:4"):
        assert _is_loopback(ep) == j_is_loopback(ep), ep
    assert _is_loopback("tcp://127.0.0.1:9000")
    assert not _is_loopback("tcp://[2001:db8::1]:9000")


def _kinds(pu, Array, rng):
    """One plotter of every kind, on ``rng``'s draws."""
    hits = rng.integers(0, 9, size=(12,)).astype(np.int32)

    class StubSOM:                       # what KohonenHits reads
        sy, sx, total = 3, 4, 36

    StubSOM.hits = Array(hits)
    return [
        pu.AccumulatingPlotter(name="k_acc", fetch=iter([1.0]).__next__),
        pu.Weights2D(name="k_w", source=Array(rng.normal(
            size=(4, 9)).astype(np.float32)), sample_shape=(3, 3)),
        pu.MatrixPlotter(name="k_m", fetch=lambda: np.eye(3)),
        pu.KohonenHits(name="k_som", forward=StubSOM()),
        pu.MultiHistogram(name="k_h", source=Array(rng.normal(
            size=(50,)).astype(np.float32))),
    ]


def test_client_renders_all_plotter_kinds(tmp_path):
    """Every kind's snapshot equals the reference plotter's on the same
    inputs, survives the wire's pickle and renders through the client."""
    from znicz_torch import plotting_units as pu
    from znicz_torch.graphics import GraphicsClient
    from znicz_torch.memory import Array
    from znicz_tpu import plotting_units as jpu
    from znicz_tpu.memory import Array as JArray

    plotters = _kinds(pu, Array, np.random.default_rng(3))
    refs = _kinds(jpu, JArray, np.random.default_rng(3))
    client = GraphicsClient.__new__(GraphicsClient)   # render() only
    client.out_dir = str(tmp_path)
    for p, r in zip(plotters, refs):
        data, want = p.snapshot(), r.snapshot()
        assert data.keys() == want.keys(), p.name
        for k in data:
            np.testing.assert_array_equal(np.asarray(data[k]),
                                          np.asarray(want[k]), err_msg=k)
        payload = pickle.loads(pickle.dumps(
            {"kind": "figure", "cls": type(p).__name__, "name": p.name,
             "data": data}))
        path = client.render(payload)
        assert path is not None and os.path.exists(path), p.name
    assert client.render({"kind": "figure", "cls": "GraphicsServer",
                          "name": "x", "data": {}}) is None


def test_a_tensor_source_is_pulled_to_the_host():
    """A ``Weights2D`` on a live tensor (bf16 too) reads it at each
    snapshot, as float32 on the host."""
    import torch

    from znicz_torch.plotting_units import Weights2D, host_array

    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    plot = Weights2D(name="t_w", source=lambda: w, render=False)
    np.testing.assert_array_equal(plot.snapshot()["weights"], w.numpy())
    w.add_(1.0)
    np.testing.assert_array_equal(plot.snapshot()["weights"], w.numpy())
    got = host_array(w.to(torch.bfloat16))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, w.numpy())


# -- the workflow's observers -------------------------------------------------


def _port_obs(name, max_epochs=2, loss="softmax", loader=None, layers=None,
              **kw):
    from znicz_torch.core import prng
    from znicz_torch.samples.mnist import MnistLoader
    from znicz_torch.standard_workflow import StandardWorkflow

    prng.reset(1013)
    layers = layers or [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 50},
         "<-": dict(GD)},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": dict(GD)}]
    return StandardWorkflow(
        layers, name=name, device="cpu",
        loader=loader or MnistLoader(name="loader", minibatch_size=60),
        loss_function=loss, decision_config={"max_epochs": max_epochs},
        **kw)


def _jax_obs(name, max_epochs=2, **kw):
    from znicz_tpu.core import prng
    from znicz_tpu.samples.mnist import MnistLoader
    from znicz_tpu.standard_workflow import StandardWorkflow

    prng.reset(1013)
    wf = StandardWorkflow(
        name=name, loader=MnistLoader(name="loader", minibatch_size=60),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 50},
                 "<-": dict(GD)},
                {"type": "softmax", "->": {"output_sample_shape": 10},
                 "<-": dict(GD)}],
        loss_function="softmax", decision_config={"max_epochs": max_epochs},
        **kw)
    wf.initialize(device=None)
    return wf


def test_plotters_render_pngs(dirs):
    from znicz_torch.memory import Array
    from znicz_torch.plotting_units import (AccumulatingPlotter,
                                            MatrixPlotter, MultiHistogram,
                                            Weights2D)

    vals = iter([3.0, 2.0, 1.0])
    acc = AccumulatingPlotter(name="acc_plot", fetch=lambda: next(vals))
    for _ in range(3):
        acc.run()
    assert acc.values == [3.0, 2.0, 1.0]
    assert os.path.exists(acc.path())
    w = Weights2D(name="w_plot",
                  source=Array(np.random.default_rng(0).normal(
                      size=(9, 16)).astype(np.float32)),
                  sample_shape=(4, 4))
    w.run()
    assert os.path.exists(w.path())
    m = MatrixPlotter(name="conf_plot",
                      fetch=lambda: np.eye(4, dtype=np.int32))
    m.run()
    assert os.path.exists(m.path())
    h = MultiHistogram(name="hist_plot",
                       source=Array(np.random.default_rng(1).normal(
                           size=(100,)).astype(np.float32)))
    h.run()
    assert os.path.exists(h.path())


def test_standard_workflow_wires_observers(dirs):
    """Plotters and the image saver on the unit engine, as the
    reference's: the PNGs, one point an epoch, misclassified dumps, and
    the stop lap leaving the loader where training ended."""
    with sample_config("mnist", **MNIST_TINY):
        wf = _port_obs("MnistObs", image_saver_config={"limit": 8},
                       plotters=True)
        wf.run()
    assert bool(wf.decision.complete)
    assert {"plot_err.png", "plot_weights.png",
            "plot_confusion.png"} <= set(os.listdir(dirs / "plots"))
    assert [p.name for p in wf.plotters] == ["plot_err", "plot_weights",
                                             "plot_confusion"]
    assert len(wf.plotters[0].values) == 2
    epochs = os.listdir(dirs / "imgs")
    assert epochs and any(os.listdir(dirs / "imgs" / e) for e in epochs)
    assert wf.loader.samples_served == 2 * (120 + 60)
    assert any(v > 0 for v in wf.plotters[0].values)
    assert wf.image_saver is not None and wf.image_saver.limit == 8


def test_observers_match_the_reference(dirs):
    """The same seeded run on both unit engines: the error series and the
    confusion equal, the weight tiles within the engines' band, and bit
    for bit once the reference's weights are carried across; both graphs
    wired alike."""
    from znicz_torch.weights import params_from_jax

    with sample_config("mnist", **MNIST_TINY):
        twf = _port_obs("MnistObs", image_saver_config={"limit": 8},
                        plotters=True)
        jwf = _jax_obs("MnistObs", image_saver_config={"limit": 8},
                       plotters=True)
        twf.run()
        jwf.run()
    assert twf.plotters[0].values == jwf.plotters[0].values
    assert twf.plotters[0].ylabel == jwf.plotters[0].ylabel

    def snaps(wf):
        return [p.snapshot() for p in wf.plotters[1:]]

    (tw, tm), (jw, jm) = snaps(twf), snaps(jwf)
    np.testing.assert_array_equal(tm["matrix"], jm["matrix"])
    assert tw["sample_shape"] == jw["sample_shape"]
    np.testing.assert_allclose(tw["weights"], jw["weights"], **W_TOL)
    params_from_jax(jax_params(jwf), twf)
    np.testing.assert_array_equal(twf.plotters[1].snapshot()["weights"],
                                  jw["weights"])

    def edges(wf):
        return {(u.name, t.name) for u in wf.units for t in u.links_to}

    assert edges(twf) == edges(jwf)
    assert bool(twf.repeater.gate_block) == bool(jwf.repeater.gate_block)


def test_fused_engine_runs_plotters_at_epoch_ends(dirs):
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **MNIST_TINY):
        wf = _port_obs("MnistObsFused", plotters=True)
        FusedTrainer(wf).run()
    assert bool(wf.decision.complete)
    assert len(wf.plotters[0].values) == 2
    assert {"plot_err.png", "plot_weights.png",
            "plot_confusion.png"} <= set(os.listdir(dirs / "plots"))
    # the trainer's stats under the reference's name
    assert wf.fused_stats["train_steps"] > 0


def test_fused_epoch_end_plots_show_that_epochs_weights(dirs):
    """Each epoch's ``plot_weights`` payload is the first layer's weights
    as the epoch left them: epoch 2's equal the trained parameters, and
    differ from epoch 1's; the error series is the unit engine's."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **MNIST_TINY):
        wf = _port_obs("MnistEpochs", plotters=True)
        units = _port_obs("MnistEpochsUnits", plotters=True)
    seen = []
    plot = wf.plotters[1]
    take = plot.snapshot

    def record():
        data = take()
        seen.append(data["weights"].copy())
        return data

    plot.snapshot = record
    with sample_config("mnist", **MNIST_TINY):
        FusedTrainer(wf).run()
        units.run()
    assert len(seen) == 2
    live = wf.forward_units[0].params()["weights"].detach().numpy()
    np.testing.assert_array_equal(seen[1], live[:plot.limit].reshape(
        seen[1].shape))
    assert np.abs(seen[1] - seen[0]).max() > 0
    assert wf.plotters[0].values == units.plotters[0].values


def test_plotters_mse_workflow(dirs):
    """On an MSE workflow the error plot is the VALID loss."""
    from znicz_torch.samples.video_ae import VideoAELoader

    with sample_config("video_ae", loader__n_train=200, loader__n_valid=100,
                       loader__minibatch_size=100):
        wf = _port_obs(
            "VideoAEPlots", loss="mse",
            loader=VideoAELoader(name="loader", targets_from_data=True,
                                 minibatch_size=100),
            layers=[{"type": "all2all_tanh",
                     "->": {"output_sample_shape": 24}, "<-": dict(GD)},
                    {"type": "all2all",
                     "->": {"output_sample_shape": (16, 16)},
                     "<-": dict(GD)}],
            plotters=True)
        wf.run()
    assert bool(wf.decision.complete)
    assert [p.name for p in wf.plotters] == ["plot_err", "plot_weights"]
    assert len(wf.plotters[0].values) == 2
    assert all(v > 0 for v in wf.plotters[0].values)
    assert wf.plotters[0].ylabel == "valid loss"
    assert os.path.exists(dirs / "plots" / "plot_err.png")


def test_image_saver(dirs):
    """The port's saver and the reference's write the same files from the
    same minibatch."""
    from znicz_torch.image_saver import ImageSaver
    from znicz_torch.memory import Array
    from znicz_tpu.image_saver import ImageSaver as JImageSaver
    from znicz_tpu.memory import Array as JArray

    rng = np.random.default_rng(3)
    data = rng.random(size=(4, 16)).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    probs = np.full((4, 4), 0.1, np.float32)
    probs[np.arange(4), [0, 1, 0, 0]] = 0.7   # samples 2 and 3 are wrong
    files = []
    for cls, arr, root_mod in ((ImageSaver, Array, "znicz_torch"),
                               (JImageSaver, JArray, "znicz_tpu")):
        sv = cls(name="imgsave", limit=8)
        sv.input, sv.labels, sv.output = arr(data), arr(labels), arr(probs)
        sv.batch_size, sv.epoch_number, sv.last_minibatch = 4, 0, True
        sv.run()
        d = os.path.join(str(dirs / "imgs"), "epoch_0")
        files.append(sorted(os.listdir(d)))
        assert not sv._pending
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
    assert files[0] == files[1]
    assert len(files[0]) == 2 and any(f.startswith("2_as_0")
                                      for f in files[0])


def test_fused_training_streams_plots_live(dirs):
    """A fused run with wired plotters streams its epoch figures to a
    client process: the error curve, the weights and the confusion over
    two epochs."""
    from znicz_torch.graphics import GraphicsServer
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **MNIST_TINY):
        wf = _port_obs("MnistLive", plotters=True)
    out = dirs / "live"
    server = GraphicsServer.start("tcp://127.0.0.1:*")
    try:
        proc = _client(server.endpoint, out, 6)
        assert server.wait_for_subscribers(1, timeout=CLIENT_S)
        with sample_config("mnist", **MNIST_TINY):
            FusedTrainer(wf).run()
        stdout, _ = proc.communicate(timeout=CLIENT_S)
        published = server.published
    finally:
        GraphicsServer.stop()
    assert proc.returncode == 0
    assert "rendered 6 figures" in stdout
    assert published == 6
    for png in ("plot_err.png", "plot_weights.png", "plot_confusion.png"):
        assert (out / png).exists(), png
