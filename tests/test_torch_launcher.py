"""The port's launcher (``python -m znicz_torch``) against the reference's
(after ``tests/test_aux.py``'s launcher tests, ``tests/test_cli_samples.py``
and ``tests/test_services.py::test_launcher_fused_flag``):

  - ``--list``, and no workflow at all, print the reference's line;
  - a sample with ``--workflow-graph``: the graph's nodes and edges are
    the reference's;
  - every bundled sample through the port's ``main`` at the reference's
    tiny overrides (``tests/test_cli_samples.TINY``), on the CPU;
  - ``--fused`` sets ``root.common.engine.fused``;
  - on both packages: a config file applied before the dotted overrides
    (a first positional holding ``=`` is an override), a workflow given
    as a ``.py`` file (its ``run()`` called with the keywords it takes)
    and as a module path;
  - ``--backend cpu`` is ``--device cpu``; the JSON finals of a workflow
    that is not a sample.

Every config key a run sets is put back afterwards.
"""

import contextlib
import json
import re

import pytest

from test_cli_samples import TINY

#: a run's snapshots, in both trees
SNAP = "root.common.dirs.snapshots={}"
MNIST_TINY = TINY["mnist"]


@pytest.fixture(autouse=True)
def reference_logging_untouched(monkeypatch):
    """The reference's launcher puts its log handler on the ``stderr`` of
    the test that calls it first, which pytest closes after that test;
    later tests of the worker would log into it.  Its logging is not what
    these tests compare, so it is left unconfigured."""
    from znicz_tpu import launcher

    monkeypatch.setattr(launcher, "setup_logging", lambda *a, **k: None)


def _leaves(tree, path):
    """``{dotted path: value}`` of every leaf at or under ``path``."""
    from znicz_torch.core.config import Config as TConfig
    from znicz_tpu.core.config import Config as JConfig

    missing = object()
    node = tree.get_by_path(path, missing)
    if node is missing:
        return {}
    if not isinstance(node, (TConfig, JConfig)):
        return {path: node}
    out = {}
    for key, _ in node.items():
        out.update(_leaves(tree, f"{path}.{key}"))
    return out


@contextlib.contextmanager
def restored(*samples, keys=()):
    """Every leaf under ``root.<sample>`` of both trees and the dotted
    ``keys`` put back on exit, leaf by leaf, the ones a run added
    removed (the samples' modules imported first, so their defaults are
    among them)."""
    import importlib

    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    for sample in samples:
        for pkg in ("znicz_torch", "znicz_tpu"):
            importlib.import_module(f"{pkg}.samples.{sample}")
    paths = [*samples, *keys]
    saved = [(tree, {p: v for path in paths
                     for p, v in _leaves(tree, path).items()})
             for tree in (troot, jroot)]
    try:
        yield
    finally:
        for tree, old in saved:
            for path in paths:
                for leaf in _leaves(tree, path):
                    if leaf not in old:
                        head, _, name = leaf.rpartition(".")
                        delattr(tree.get_by_path(head) if head else tree,
                                name)
            for leaf, value in old.items():
                tree.set_by_path(leaf, value)


def _graph(path):
    text = open(path).read()
    nodes = set(re.findall(r'^\s*"([^"]+)" \[', text, re.M))
    edges = set(re.findall(r'"([^"]+)" -> "([^"]+)"', text))
    return nodes, edges


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_launcher_list(capsys):
    from znicz_torch.__main__ import SAMPLES, main
    from znicz_tpu.launcher import SAMPLES as JSAMPLES
    from znicz_tpu.launcher import main as jmain

    assert SAMPLES == JSAMPLES
    assert jmain(["--list"]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert want.startswith("bundled samples: mnist, cifar")
    for argv in (["--list"], [], ["mnist", "--list"]):
        assert main(argv) == 0
        assert capsys.readouterr().out.strip().splitlines()[-1] == want


def test_launcher_runs_sample(tmp_path, capsys):
    """A sample with ``--workflow-graph`` on both packages: one graph."""
    from znicz_torch.__main__ import main
    from znicz_tpu.launcher import main as jmain

    args = ["mnist", *MNIST_TINY, SNAP.format(tmp_path)]
    with restored("mnist", keys=("common.dirs.snapshots",)):
        assert main([*args, "--device", "cpu", "--workflow-graph",
                     str(tmp_path / "g.dot")]) == 0
        line = _last_json(capsys)
        assert jmain([*args, "--workflow-graph",
                      str(tmp_path / "jg.dot")]) == 0
    assert line["workflow"] == "mnist" and line["epochs"] == 1
    nodes, edges = _graph(tmp_path / "g.dot")
    assert "repeater" in nodes and ("repeater", "loader") in edges
    assert (nodes, edges) == _graph(tmp_path / "jg.dot")


def test_every_registered_sample_has_tiny_overrides():
    from znicz_torch.__main__ import SAMPLES

    assert set(TINY) == set(SAMPLES)


@pytest.mark.parametrize("sample", sorted(TINY))
def test_sample_cli_smoke(sample, tmp_path, monkeypatch, capsys):
    from znicz_torch.__main__ import main
    from znicz_torch.core import prng
    from znicz_torch.core.config import root

    monkeypatch.chdir(tmp_path)
    prng.reset(1013)
    with restored(sample, keys=("common.dirs.snapshots",)):
        if sample == "yale_faces":
            root.yale_faces.loader.data_dir = str(tmp_path / "faces")
        assert main([sample, *TINY[sample], SNAP.format(tmp_path),
                     "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["workflow"] == sample and line["device"] == "cpu"
    assert line["epochs"] >= 1


def test_launcher_fused_flag(tmp_path, monkeypatch, capsys):
    from znicz_torch.__main__ import main
    from znicz_torch.core import prng
    from znicz_torch.core.config import root

    monkeypatch.chdir(tmp_path)
    prng.reset(1013)
    with restored("mnist", keys=("common.dirs.snapshots",
                                 "common.engine.fused")):
        assert main(["mnist", *MNIST_TINY[:3],
                     "root.mnist.decision.max_epochs=2",
                     SNAP.format(tmp_path), "--fused", "--device",
                     "cpu"]) == 0
        assert bool(root.common.engine.get("fused")) is True
    line = _last_json(capsys)
    assert line["epochs"] == 2 and line["compute_dtype"] == "float32"


CONFIG = """
from {pkg}.core.config import root
root.mnist.loader.n_train = 120
root.mnist.loader.n_valid = 60
root.mnist.loader.minibatch_size = 60
root.mnist.decision.max_epochs = 2
"""


@pytest.mark.parametrize("pkg", ["znicz_torch", "znicz_tpu"])
def test_config_file_runs_before_the_overrides(pkg, tmp_path, capsys):
    """The config file sets the run; an override after it wins over it,
    as the first positional or later."""
    import importlib

    main = (importlib.import_module("znicz_torch.__main__").main
            if pkg == "znicz_torch" else
            importlib.import_module("znicz_tpu.launcher").main)
    tree = importlib.import_module(f"{pkg}.core.config").root
    cfg = tmp_path / "cfg.py"
    cfg.write_text(CONFIG.format(pkg=pkg))
    flags = ["--device", "cpu"] if pkg == "znicz_torch" else []
    with restored("mnist", keys=("common.dirs.snapshots",)):
        assert main(["mnist", str(cfg), SNAP.format(tmp_path),
                     *flags]) == 0
        assert int(tree.mnist.decision.max_epochs) == 2
        assert int(tree.mnist.loader.n_train) == 120
        if pkg == "znicz_torch":
            assert _last_json(capsys)["epochs"] == 2
        assert main(["mnist", str(cfg), "root.mnist.decision.max_epochs=1",
                     SNAP.format(tmp_path), *flags]) == 0
        assert int(tree.mnist.decision.max_epochs) == 1
        if pkg == "znicz_torch":
            assert _last_json(capsys)["epochs"] == 1
        # no config file: the first override sits in the config's slot
        assert main(["mnist", *MNIST_TINY, SNAP.format(tmp_path),
                     *flags]) == 0
        assert int(tree.mnist.loader.n_train) == 120


WORKFLOW = """
from {pkg}.core.config import root
from {pkg}.samples.mnist import MnistLoader
from {pkg}.standard_workflow import StandardWorkflow

GD = {{"learning_rate": 0.1, "gradient_moment": 0.9}}


def build(**kw):
    return StandardWorkflow(
        name="FileWorkflow",
        loader=MnistLoader(name="loader", minibatch_size=60),
        layers=[{{"type": "all2all_tanh", "->": {{"output_sample_shape": 20}},
                  "<-": dict(GD)}},
                {{"type": "softmax", "->": {{"output_sample_shape": 10}},
                  "<-": dict(GD)}}],
        loss_function="softmax", decision_config={{"max_epochs": 1}},
        plotters=True, **kw)
"""

#: the port's run() (``device`` taken) and the reference's
PORT_RUN = """

def run(device=None):
    from znicz_torch.engine import train

    wf = build(device=device)
    train(wf)
    return wf
"""
JAX_RUN = """

def run():
    wf = build()
    wf.initialize(device=None)
    wf.run()
    return wf
"""


def _workflow_file(tmp_path, pkg, run=None):
    path = tmp_path / f"wf_{pkg}.py"
    path.write_text(WORKFLOW.format(pkg=pkg)
                    + (run or (PORT_RUN if pkg == "znicz_torch"
                               else JAX_RUN)))
    return str(path)


def test_a_workflow_file_runs_on_both_packages(tmp_path, capsys):
    """A ``.py`` workflow with a config file and ``--workflow-graph``:
    the port calls ``run(device=...)``, prints its finals and writes the
    reference's graph."""
    from znicz_torch.__main__ import main
    from znicz_torch.core.config import root
    from znicz_tpu.launcher import main as jmain

    with restored("mnist", keys=("common.dirs.snapshots",
                                 "common.dirs.plots")):
        for pkg in ("znicz_torch", "znicz_tpu"):
            (tmp_path / f"cfg_{pkg}.py").write_text(
                CONFIG.format(pkg=pkg) + f"\nroot.common.dirs.plots = "
                f"{str(tmp_path / pkg)!r}\n")
        assert main([_workflow_file(tmp_path, "znicz_torch"),
                     str(tmp_path / "cfg_znicz_torch.py"),
                     SNAP.format(tmp_path), "--device", "cpu",
                     "--workflow-graph", str(tmp_path / "g.dot")]) == 0
        line = _last_json(capsys)
        assert root.common.dirs.plots == str(tmp_path / "znicz_torch")
        assert jmain([_workflow_file(tmp_path, "znicz_tpu"),
                      str(tmp_path / "cfg_znicz_tpu.py"),
                      SNAP.format(tmp_path), "--workflow-graph",
                      str(tmp_path / "jg.dot")]) == 0
    assert line["device"] == "cpu" and line["epochs"] == 1
    assert 0.0 <= line["valid_err_pct"] <= 100.0
    assert line["train_steps"] == 1           # the tail's update skipped
    assert (tmp_path / "znicz_torch" / "plot_weights.png").exists()
    nodes, edges = _graph(tmp_path / "g.dot")
    assert {"plot_err", "plot_weights", "plot_confusion"} <= nodes
    assert (nodes, edges) == _graph(tmp_path / "jg.dot")


def test_backend_cpu_is_device_cpu(tmp_path, capsys):
    """``--backend cpu`` reaches a ``run()`` that takes ``device`` as the
    CPU, and one that does not through ``root.common.engine.backend``;
    the reference's ``tpu`` has no meaning here."""
    from znicz_torch.__main__ import main
    from znicz_torch.core.config import root

    no_device = ("\n\ndef run():\n    from znicz_torch.engine import train"
                 "\n\n    wf = build()\n    train(wf)\n    return wf\n")
    with restored("mnist", keys=("common.dirs.snapshots",
                                 "common.dirs.plots",
                                 "common.engine.backend")):
        root.common.dirs.plots = str(tmp_path / "plots")
        assert main(["mnist", *MNIST_TINY, SNAP.format(tmp_path),
                     "--backend", "cpu"]) == 0
        assert _last_json(capsys)["device"] == "cpu"
        assert main([_workflow_file(tmp_path, "znicz_torch", no_device),
                     *MNIST_TINY, SNAP.format(tmp_path),
                     "--backend", "cpu"]) == 0
        assert _last_json(capsys)["device"] == "cpu"
        assert root.common.engine.backend == "cpu"
        with pytest.raises(ValueError, match="tpu"):
            main(["mnist", *MNIST_TINY, SNAP.format(tmp_path),
                  "--backend", "tpu"])


def test_a_module_path_runs_on_both_packages(tmp_path, capsys):
    from znicz_torch.__main__ import main
    from znicz_tpu.launcher import main as jmain

    with restored("mnist", keys=("common.dirs.snapshots",)):
        assert main(["znicz_torch.samples.mnist", *MNIST_TINY,
                     SNAP.format(tmp_path), "--device", "cpu"]) == 0
        line = _last_json(capsys)
        assert jmain(["znicz_tpu.samples.mnist", *MNIST_TINY,
                      SNAP.format(tmp_path)]) == 0
    assert line["workflow"] == "znicz_torch.samples.mnist"
    assert line["epochs"] == 1 and "final_train_loss" in line


def test_finals_of_a_workflow_that_is_not_a_sample():
    """Kohonen's, an MSE loss's and a classifier's finals by the
    Decision's kind; none without a Decision."""
    import types

    from znicz_torch.__main__ import finals

    assert finals("x.py", types.SimpleNamespace()) == {}
    som = types.SimpleNamespace(decision=types.SimpleNamespace(
        epoch_qerror=[3.0, 2.0]))
    assert finals("x.py", som) == {"epochs": 2, "final_qerror": 2.0,
                                   "first_qerror": 3.0}
    d = types.SimpleNamespace(epoch_number=0, epoch_metrics=[
        None, {"loss": 0.5}, {"loss": 0.25}])
    mse = types.SimpleNamespace(decision=d, loss_function="mse")
    assert finals("x.py", mse) == {"epochs": 1, "final_train_mse": 0.25,
                                   "valid_mse": 0.5}
    d.epoch_metrics[1]["err_pct"] = 10.0
    cls = types.SimpleNamespace(decision=d, loss_function="softmax")
    assert finals("x.py", cls)["valid_err_pct"] == 10.0
