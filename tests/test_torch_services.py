"""The port's services against the reference on the CPU (after
``tests/test_services.py``'s publishing, forge and shell tests):

  - ``publishing``: the Markdown report of a trained MNIST carries the
    reference's sections and metric keys; the PDF is a valid document
    with a title, a timing and a plot page; a ``FusedTrainer`` run adds
    the ``fused_*`` speed keys, an ``engine.train`` run its train stats;
  - ``forge``: pack, upload, list, download and delete in a local
    registry and over HTTP (``ForgeServer`` on 127.0.0.1, port 0), the
    downloaded parameters bit-equal to the workflow's and restored into a
    fresh workflow that trains on; a name that escapes the registry and a
    URL off the loopback are refused; a package the reference packed is
    downloaded and restored by the port, bit for bit;
  - ``interaction.Shell`` is a counting no-op when not interactive;
  - ``genetics.SubprocessEvaluator`` passes its config file where the
    reference's does, and the run applies it.
"""

import json
import os
import re

import numpy as np
import pytest

from test_torch_layers import jax_params, jax_sample, port_sample, \
    sample_config

MNIST_TINY = {"loader__n_train": 120, "loader__n_valid": 60,
              "loader__minibatch_size": 60}


@pytest.fixture
def dirs(tmp_path):
    """Both packages' snapshots and plots under ``tmp_path``, put back
    afterwards."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    keys = ("snapshots", "plots")
    saved = [(tree, {k: tree.common.dirs.get(k, None) for k in keys})
             for tree in (troot, jroot)]
    for tree in (troot, jroot):
        tree.common.dirs.snapshots = str(tmp_path)
        tree.common.dirs.plots = str(tmp_path / "plots")
    yield tmp_path
    for tree, old in saved:
        for k, v in old.items():
            if v is None:
                delattr(tree.common.dirs, k)
            else:
                setattr(tree.common.dirs, k, v)


def _trained(tmp_path, epochs=1, package="znicz_torch"):
    """The reduced MNIST sample trained ``epochs`` on the unit engine of
    ``package``, seeded."""
    with sample_config("mnist", decision__max_epochs=epochs, **MNIST_TINY):
        wf = (port_sample("mnist", tmp_path) if package == "znicz_torch"
              else jax_sample("mnist", tmp_path))
        wf.run()
    return wf


def _port_params(wf):
    from znicz_torch.weights import params_to_numpy

    return params_to_numpy(wf)


# -- publishing ---------------------------------------------------------------


def test_publishing(dirs):
    """The report's sections and metric keys are the reference's."""
    from znicz_torch.publishing import gather_report, publish
    from znicz_tpu.publishing import publish as jpublish

    wf = _trained(dirs)
    path = publish(wf, backend="markdown", directory=str(dirs / "rep"))
    text = open(path).read()
    assert path.endswith("MnistWorkflow_report.md")
    assert "# Training report — MnistWorkflow" in text
    assert "best_metric" in text and "| unit | runs |" in text
    jtext = open(jpublish(_trained(dirs, package="znicz_tpu"),
                          backend="markdown",
                          directory=str(dirs / "jrep"))).read()

    def keys(md):
        return re.findall(r"^- \*\*(\w+)\*\*", md, re.M)

    assert keys(text) == keys(jtext)
    assert re.findall(r"^#+ .*", text, re.M) == \
        re.findall(r"^#+ .*", jtext, re.M)
    rep = gather_report(wf)
    assert rep["metrics"]["valid"]["err_pct"] == \
        wf.decision.epoch_metrics[1]["err_pct"]
    html_path = publish(wf, backend="html", directory=str(dirs / "rep"))
    assert "<title>MnistWorkflow</title>" in open(html_path).read()


def test_publishing_pdf(dirs):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    from znicz_torch.publishing import publish

    plots = dirs / "plots"
    plots.mkdir()
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    fig.savefig(plots / "err.png")
    plt.close(fig)
    wf = _trained(dirs)
    path = publish(wf, backend="pdf", directory=str(dirs / "rep"))
    assert path.endswith(".pdf")
    blob = open(path, "rb").read()
    assert blob.startswith(b"%PDF-") and blob.rstrip().endswith(b"%%EOF")
    assert len(blob) > 2000
    assert blob.count(b"/Type /Page") >= 3      # title, timing, plot


def test_publish_includes_fused_stats(dirs):
    from znicz_torch import engine
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.publishing import publish

    with sample_config("mnist", decision__max_epochs=1, **MNIST_TINY):
        wf = port_sample("mnist", dirs)
        FusedTrainer(wf).run()
    text = open(publish(wf, backend="markdown",
                        directory=str(dirs / "rep"))).read()
    assert "fused_img_per_sec" in text and "fused_train_steps" in text
    # engine.train's stats, on the unit engine
    with sample_config("mnist", decision__max_epochs=1, **MNIST_TINY):
        wf = port_sample("mnist", dirs)
        engine.train(wf, fused=False)
    text = open(publish(wf, backend="html",
                        directory=str(dirs / "rep2"))).read()
    assert "fused_img_per_sec" not in text
    assert "img_per_sec" in text and "train_steps" in text


# -- forge --------------------------------------------------------------------


def _assert_units_equal(snap, wf):
    params = _port_params(wf)
    assert set(snap["units"]) == set(params)
    for name, leaves in params.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(snap["units"][name][k], v)


def test_forge_roundtrip(dirs):
    from znicz_torch.forge import Forge

    wf = _trained(dirs)
    forge = Forge(registry=str(dirs / "registry"))
    forge.upload(wf, "mnist-mlp", metadata={"acc": 0.9})
    entries = forge.list()
    assert entries[0]["name"] == "mnist-mlp"
    assert entries[0]["workflow"] == "MnistWorkflow"
    snap = forge.download("mnist-mlp")
    _assert_units_equal(snap, wf)
    assert "loader" in snap["config"]["mnist"]      # the config tree
    forge.delete("mnist-mlp")
    assert forge.list() == []


def test_forge_rejects_escaping_names(tmp_path):
    from znicz_torch.forge import Forge

    forge = Forge(registry=str(tmp_path / "reg2"))
    for bad in ("..", ".", "/", "___"):
        with pytest.raises(ValueError):
            forge._pkg_dir(bad)
    assert forge._pkg_dir("../x").startswith(forge.registry)


def test_forge_remote_roundtrip(dirs):
    """Publish over HTTP, fetch, restore into a fresh workflow and train
    it on."""
    from znicz_torch import snapshotter
    from znicz_torch.forge import ForgeServer, RemoteForge

    wf = _trained(dirs)
    server = ForgeServer(registry=str(dirs / "server_reg"), port=0).start()
    try:
        remote = RemoteForge(server.url)
        remote.upload(wf, "mnist-mlp", metadata={"acc": 0.9})
        assert [e["name"] for e in remote.list()] == ["mnist-mlp"]
        assert remote.manifest("mnist-mlp")["metadata"]["acc"] == 0.9
        snap = remote.download("mnist-mlp")
        _assert_units_equal(snap, wf)
        with pytest.raises(Exception):
            remote.download("missing")
        with sample_config("mnist", decision__max_epochs=2, **MNIST_TINY):
            wf2 = port_sample("mnist", dirs)
            snapshotter.restore(wf2, snap)
            _assert_units_equal(snap, wf2)
            wf2.run()
        assert bool(wf2.decision.complete)
        remote.delete("mnist-mlp")
        assert remote.list() == []
    finally:
        server.stop()
    with pytest.raises(ValueError, match="non-loopback"):
        RemoteForge("http://evil.example.com:80")
    RemoteForge("http://evil.example.com:80", allow_remote=True)


def test_a_reference_package_restores_in_the_port(dirs):
    """A package the reference's forge packed, stored in the port's
    registry and served over the port's HTTP server: the port restores
    its parameters and velocities bit for bit, and trains on."""
    from znicz_torch import snapshotter
    from znicz_torch.forge import Forge, ForgeServer, RemoteForge
    from znicz_torch.weights import velocities_to_numpy
    from znicz_tpu.forge import pack as jpack

    jwf = _trained(dirs, package="znicz_tpu")
    blob, manifest = jpack(jwf, "ref-mlp", {"from": "reference"})
    Forge(registry=str(dirs / "reg")).put_package("ref-mlp", blob, manifest)
    server = ForgeServer(registry=str(dirs / "reg"), port=0).start()
    try:
        snap = RemoteForge(server.url).download("ref-mlp")
    finally:
        server.stop()
    with sample_config("mnist", decision__max_epochs=2, **MNIST_TINY):
        wf = port_sample("mnist", dirs)
        snapshotter.restore(wf, snap)
        for name, leaves in jax_params(jwf).items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(_port_params(wf)[name][k], v)
        vel = velocities_to_numpy(wf)     # by forward, the snapshot by GD
        assert len(vel) == 2
        for name, leaves in vel.items():
            for k, v in leaves.items():
                assert np.abs(v).max() > 0, (name, k)
                np.testing.assert_array_equal(
                    v, snap["velocities"][wf.gds[name].name][k])
        assert wf.decision.best_metric == jwf.decision.best_metric
        wf.run()
    assert bool(wf.decision.complete)


# -- the shell and the tuning units' config -----------------------------------


def test_shell_unit_noop():
    from znicz_torch.interaction import Shell

    sh = Shell(name="shell", interactive=False)
    sh.run()
    sh.run()
    assert sh.invocations == 2


def test_subprocess_evaluator_passes_the_config(tmp_path):
    """The config file goes right after the workflow, as in the
    reference's command, and the run applies it."""
    from znicz_torch.genetics import SubprocessEvaluator

    cfg = tmp_path / "cfg.py"
    cfg.write_text("from znicz_torch.core.config import root\n"
                   "root.mnist.loader.n_train = 120\n"
                   "root.mnist.loader.n_valid = 60\n"
                   "root.mnist.loader.minibatch_size = 60\n"
                   "root.mnist.decision.max_epochs = 1\n")
    ev = SubprocessEvaluator(
        "mnist", str(cfg), overrides=[
            f"root.common.dirs.snapshots={tmp_path}", "--device", "cpu"],
        prefix="root.mnist", timeout=300.0)
    cmd = ev.command({"learning_rate": 0.1})
    assert cmd[3:5] == ["mnist", str(cfg)]
    assert cmd[-2:] == ["root.mnist.learning_rate=0.1", "--fitness"]
    assert SubprocessEvaluator("mnist").command({})[3:] == ["mnist",
                                                            "--fitness"]
    fit = ev.fitness_from(ev.launch({"learning_rate": 0.1}))
    assert np.isfinite(fit) and 0.0 <= fit
    proc = ev.launch({"learning_rate": 0.1})
    out, _ = proc.communicate(timeout=300)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert lines[0]["epochs"] == 1           # the config's max_epochs
    assert os.path.exists(tmp_path / "mnist_best.pickle.gz")
