"""The port stands alone: no file of ``znicz_torch/`` and no line of
``chip_smoke.py`` imports JAX or the JAX package, or names the
reference's ``native/`` directory (the host runtime is built from the
port's own copy of its source); the port serves a batch (in process
and over ZMQ, charlm's variable-length requests and its generations
too), trains (``python -m znicz_torch alexnet``'s ``main``), lists its
samples, runs a workflow file with its observers, reports and forges
in a process where ``jax`` was never imported; and an entry point asked
for the card on a machine without one raises instead of dropping to the
CPU."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "znicz_tpu")


def _port_files():
    return sorted((REPO / "znicz_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if name in ("__import__", "import_module"):
                yield node.args[0].value


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 15
    for sample in ("alexnet", "mnist", "cifar", "kanji", "video_ae",
                   "yale_faces", "charlm"):
        assert REPO / "znicz_torch" / "samples" / f"{sample}.py" in files
    for module in ("attention.py", "ops/attention.py", "ops/random.py",
                   "serving/model.py", "serving/batcher.py",
                   "serving/frontend.py", "serving/client.py", "rbm.py",
                   "misc_units.py", "ensemble.py", "accelerated_units.py",
                   "genetics.py", "core/logger.py", "plotting_units.py",
                   "graphics.py", "image_saver.py", "publishing.py",
                   "forge.py", "interaction.py"):
        assert REPO / "znicz_torch" / module in files
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_names(tree):
            if name.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


def _native_dir_refs(tree):
    """String constants of ``tree`` that name a ``native`` directory."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            parts = node.value.replace("\\", "/").split("/")
            if "native" in parts:
                yield node.value


def test_no_port_file_reads_the_reference_native_dir():
    from znicz_torch import native

    assert native.SOURCE.is_relative_to(REPO / "znicz_torch" / "csrc")
    assert native.SOURCE.is_file()
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        offenders += [f"{path.relative_to(REPO)}: {s!r}"
                      for s in _native_dir_refs(tree)]
    assert not offenders, offenders
    tree = ast.parse("p = os.path.join(root, 'native', 'x.cpp')\n"
                     "q = 'native/znicz_native.cpp'\n"
                     "r = 'csrc/host/znicz_native.cpp'\n")
    assert sorted(_native_dir_refs(tree)) == ["native",
                                              "native/znicz_native.cpp"]


def test_the_scan_sees_a_forbidden_import():
    tree = ast.parse("import jax.numpy as jnp\n"
                     "from znicz_tpu.conv import Conv\n"
                     "m = importlib.import_module('jaxlib')\n")
    assert [n.split(".")[0] for n in _imported_names(tree)] \
        == ["jax", "znicz_tpu", "jaxlib"]


def test_port_serves_without_jax_in_the_process():
    code = (
        "import sys, numpy as np\n"
        "from znicz_torch.core.config import root\n"
        "from znicz_torch.samples.alexnet import AlexNetWorkflow\n"
        "from znicz_torch.serving.model import ModelRunner\n"
        "root.common.engine.fused_elementwise = True\n"
        "root.common.engine.fused_tail = True\n"
        "wf = AlexNetWorkflow(sample_shape=(67, 67, 3), n_classes=10,"
        " device='cpu')\n"
        "y = ModelRunner(wf).infer(np.ones((2, 67, 67, 3), np.float32))\n"
        "assert y.shape == (2, 10) and np.isfinite(y).all()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('served')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "served"


def test_port_serves_over_zmq_without_jax_in_the_process():
    """A full ZMQ round trip (the ROUTER frontend, the wire-v3 codec, the
    DEALER client) in a process where jax was never imported."""
    code = (
        "import sys, numpy as np\n"
        "from znicz_torch.core.config import root\n"
        "from znicz_torch.samples.alexnet import AlexNetWorkflow\n"
        "from znicz_torch.serving import InferenceClient, InferenceServer\n"
        "root.common.engine.fused_elementwise = True\n"
        "root.common.engine.fused_tail = True\n"
        "wf = AlexNetWorkflow(sample_shape=(67, 67, 3), n_classes=10,"
        " device='cpu')\n"
        "srv = InferenceServer(wf, bind='tcp://127.0.0.1:*', max_batch=2)"
        ".start()\n"
        "cli = InferenceClient(srv.endpoint, timeout=120)\n"
        "y = cli.infer(np.ones((2, 67, 67, 3), np.float32))\n"
        "assert y.shape == (2, 10) and np.isfinite(y).all()\n"
        "assert cli.ping()['pong']\n"
        "cli.close()\n"
        "srv.stop()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('served over zmq')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "served over zmq"


def test_charlm_serves_variable_length_without_jax_in_the_process():
    """The sequence model on the 2-D ladder over ZMQ (the attention ops
    and modules, the charlm sample, the seq batcher) in a process where
    jax was never imported."""
    code = (
        "import sys, numpy as np\n"
        "from znicz_torch.core.config import root\n"
        "from znicz_torch.samples.charlm import CharLMWorkflow\n"
        "from znicz_torch.serving import InferenceClient, InferenceServer\n"
        "root.charlm.loader.update({'n_train': 32, 'n_valid': 16,"
        " 'seq_len': 8, 'minibatch_size': 16})\n"
        "wf = CharLMWorkflow(device='cpu')\n"
        "srv = InferenceServer(wf, bind='tcp://127.0.0.1:*', max_batch=2)"
        ".start()\n"
        "assert srv.batcher.ladder.seq_rungs == [1, 2, 4, 8]\n"
        "cli = InferenceClient(srv.endpoint, timeout=120)\n"
        "y = cli.infer(np.ones((2, 5), np.uint8))\n"
        "assert y.shape == (2, 5, 32) and np.isfinite(y).all()\n"
        "cli.close()\n"
        "srv.stop()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('served charlm')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "served charlm"


def test_charlm_generates_without_jax_in_the_process():
    """Generation serving over ZMQ (the threefry sampler, the paged
    runner, the scheduler, the client's generate API, streamed and not)
    in a process where jax was never imported."""
    code = (
        "import sys, numpy as np\n"
        "from znicz_torch.core.config import root\n"
        "from znicz_torch.samples.charlm import CharLMWorkflow\n"
        "from znicz_torch.serving import InferenceClient, InferenceServer\n"
        "root.charlm.loader.update({'n_train': 32, 'n_valid': 16,"
        " 'seq_len': 16, 'minibatch_size': 16})\n"
        "root.common.serving.generate.update({'enabled': True,"
        " 'page_size': 4, 'slots': 2})\n"
        "wf = CharLMWorkflow(device='cpu')\n"
        "srv = InferenceServer(wf, bind='tcp://127.0.0.1:*', max_batch=2)"
        ".start()\n"
        "assert srv.warm_report['ok'], srv.warm_report\n"
        "cli = InferenceClient(srv.endpoint, timeout=120)\n"
        "p = np.arange(1, 7, dtype=np.uint8)\n"
        "a = cli.generate(p, 5, temperature=0.8, seed=3)\n"
        "got = []\n"
        "b = cli.generate(p, 5, temperature=0.8, seed=3, stream=True,"
        " on_token=lambda t, i: got.append(t))\n"
        "assert list(a['tokens']) == list(b['tokens']) == got, (a, b, got)\n"
        "cli.close()\n"
        "srv.stop()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('generated charlm')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "generated charlm"


def test_the_tuning_units_run_without_jax_in_the_process():
    """The RBM, the misc units, an ensemble's vote, the device benchmark
    and the genetic search (in process) where jax was never imported."""
    code = (
        "import sys, numpy as np, torch\n"
        "from znicz_torch.accelerated_units import DeviceBenchmark\n"
        "from znicz_torch.all2all import All2AllSigmoid\n"
        "from znicz_torch.core.config import Config\n"
        "from znicz_torch.ensemble import EnsembleEvaluator\n"
        "from znicz_torch.genetics import GeneticsOptimizer, Tune\n"
        "from znicz_torch.memory import Array\n"
        "from znicz_torch.misc_units import MeanDispForward\n"
        "from znicz_torch.rbm import GradientRBM\n"
        "v = (np.arange(64 * 16).reshape(64, 16) % 3 == 0)"
        ".astype(np.float32)\n"
        "h = All2AllSigmoid(name='h', output_sample_shape=(8,))\n"
        "h.build(v.shape, torch.device('cpu'))\n"
        "rbm = GradientRBM(name='rbm', hidden=h)\n"
        "rbm.input, rbm.batch_size = Array(v), 64\n"
        "rbm.initialize(device='cpu')\n"
        "rbm.run()\n"
        "assert np.isfinite(rbm.reconstruction_error)\n"
        "md = MeanDispForward(name='md')\n"
        "md.set_stats(v.mean(0), np.ones(16), 'cpu')\n"
        "p = EnsembleEvaluator.pure_forward([md, h], v)\n"
        "assert tuple(p.shape) == (64, 8)\n"
        "bench = DeviceBenchmark(size=32, repeats=1)\n"
        "times = bench.run()\n"
        "assert 'cpu' in times\n"
        "assert bench.best() == min(times, key=times.get)\n"
        "cfg = Config('g')\n"
        "cfg.x = Tune(1.0, -2.0, 2.0)\n"
        "best, fit = GeneticsOptimizer(lambda: cfg.get('x') ** 2, cfg,"
        " generations=2, population=4).run()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('tuned')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "tuned"


#: a workflow file and a config file for the port's launcher
LAUNCHER_WORKFLOW = """
from znicz_torch.engine import train
from znicz_torch.samples.mnist import MnistLoader
from znicz_torch.standard_workflow import StandardWorkflow


def run(device=None):
    gd = {"learning_rate": 0.1, "gradient_moment": 0.9}
    wf = StandardWorkflow(
        [{"type": "all2all_tanh", "->": {"output_sample_shape": 20},
          "<-": dict(gd)},
         {"type": "softmax", "->": {"output_sample_shape": 10},
          "<-": dict(gd)}],
        name="FileWorkflow", device=device,
        loader=MnistLoader(name="loader", minibatch_size=60),
        decision_config={"max_epochs": 2}, plotters=True,
        image_saver_config={"limit": 4})
    train(wf)
    return wf
"""
LAUNCHER_CONFIG = """
from znicz_torch.core.config import root
root.mnist.loader.n_train = 120
root.mnist.loader.n_valid = 60
root.common.dirs.snapshots = {out!r}
root.common.dirs.plots = {out!r} + "/plots"
root.common.dirs.image_saver = {out!r} + "/imgs"
"""


def test_the_launcher_and_the_observers_run_without_jax(tmp_path):
    """``--list``; a workflow file with a config file, plotters, the image
    saver and ``--workflow-graph``; its reports, a forge round trip over
    HTTP and the shell, in a process where jax was never imported."""
    (tmp_path / "wf.py").write_text(LAUNCHER_WORKFLOW)
    (tmp_path / "cfg.py").write_text(
        LAUNCHER_CONFIG.format(out=str(tmp_path)))
    code = (
        "import os, sys\n"
        "import numpy as np\n"
        "from znicz_torch.__main__ import main, load_module\n"
        "assert main(['--list']) == 0\n"
        f"out = {str(tmp_path)!r}\n"
        "assert main([out + '/wf.py', out + '/cfg.py', '--device', 'cpu',"
        " '--workflow-graph', out + '/g.dot']) == 0\n"
        "wf = sys.modules['znicz_torch._user_workflow'].run('cpu')\n"
        "assert open(out + '/g.dot').read().count('plot_weights') == 3\n"
        "assert {'plot_err.png', 'plot_weights.png', 'plot_confusion.png'}"
        " <= set(os.listdir(out + '/plots'))\n"
        "assert os.listdir(out + '/imgs')\n"
        "from znicz_torch.publishing import publish\n"
        "for backend in ('markdown', 'html', 'pdf'):\n"
        "    assert os.path.getsize(publish(wf, backend, out + '/rep'))\n"
        "from znicz_torch.forge import ForgeServer, RemoteForge\n"
        "srv = ForgeServer(registry=out + '/reg').start()\n"
        "RemoteForge(srv.url).upload(wf, 'm')\n"
        "snap = RemoteForge(srv.url).download('m')\n"
        "srv.stop()\n"
        "w = wf.forward_units[0].params()['weights'].detach().numpy()\n"
        "assert np.array_equal(snap['units'][wf.forward_units[0].name]"
        "['weights'], w)\n"
        "from znicz_torch.interaction import Shell\n"
        "sh = Shell(name='s', interactive=False)\n"
        "sh.run()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('edges ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("bundled samples: mnist, cifar")
    assert lines[-1] == "edges ok"
    finals = [json.loads(x) for x in lines if x.startswith("{")]
    assert finals[0]["epochs"] == 2 and finals[0]["device"] == "cpu"


def test_the_star_trains_without_jax_in_the_process(tmp_path):
    """A port master and a fused port slave train reduced MNIST over ZMQ
    in a process where jax was never imported; the star's modules are
    among the files checked above."""
    for rel in ("server.py", "client.py", "distributable.py",
                "loader/zmq_loader.py", "serving/aot_cache.py"):
        assert REPO / "znicz_torch" / rel in _port_files()
    code = (
        "import sys\n"
        "from znicz_torch.core import prng\n"
        "from znicz_torch.core.config import root\n"
        "from znicz_torch.client import FusedClient\n"
        "from znicz_torch.server import Server\n"
        "from znicz_torch.samples import mnist\n"
        "root.mnist.loader.n_train = 120\n"
        "root.mnist.loader.n_valid = 60\n"
        "root.mnist.decision.max_epochs = 1\n"
        f"root.common.dirs.snapshots = {str(tmp_path)!r}\n"
        "def wf():\n"
        "    prng.reset(1013)\n"
        "    return mnist.MnistWorkflow(device='cpu')\n"
        "srv = Server(wf(), job_timeout=60.0).start()\n"
        "done = FusedClient(wf(), endpoint=srv.endpoint).run()\n"
        "assert srv.join(120) and done == srv.jobs_done > 0\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('trained through the star')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained through the star"


def test_the_relay_tree_trains_without_jax_in_the_process(tmp_path):
    """A port master, a relay and a meshless fused slave behind it train
    reduced MNIST over ZMQ in a process where jax was never imported;
    the tree's modules are among the files checked above."""
    for rel in ("parallel/relay.py", "parallel/chaos.py", "server.py",
                "client.py", "__main__.py"):
        assert REPO / "znicz_torch" / rel in _port_files()
    code = (
        "import sys\n"
        "from znicz_torch.core import prng\n"
        "from znicz_torch.core.config import root\n"
        "from znicz_torch.client import FusedClient\n"
        "from znicz_torch.parallel.chaos import RelayHarness\n"
        "from znicz_torch.server import Server\n"
        "from znicz_torch.samples import mnist\n"
        "root.mnist.loader.n_train = 120\n"
        "root.mnist.loader.n_valid = 60\n"
        "root.mnist.decision.max_epochs = 1\n"
        f"root.common.dirs.snapshots = {str(tmp_path)!r}\n"
        "def wf():\n"
        "    prng.reset(1013)\n"
        "    return mnist.MnistWorkflow(device='cpu')\n"
        "srv = Server(wf(), job_timeout=60.0).start()\n"
        "relay = RelayHarness(srv.endpoint, 'tcp://127.0.0.1:*')\n"
        "relay.start()\n"
        "done = FusedClient(wf(), endpoint=relay.endpoint).run()\n"
        "assert srv.join(120) and done == srv.jobs_done > 0\n"
        "assert srv.aggregated_updates == srv.updates_received > 0\n"
        "relay.kill()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n"
        "print('trained through a relay')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "trained through a relay"


def test_a_relay_process_runs_without_jax(tmp_path):
    """``python -m znicz_torch --relay`` (no workflow) serves and ends in
    a process where jax was never imported: it prints its endpoint, and
    exits 0 once stopped."""
    code = (
        "import sys, threading\n"
        "from znicz_torch import __main__ as cli\n"
        "from znicz_torch.parallel import relay as relay_mod\n"
        "made = []\n"
        "class Stopped(relay_mod.Relay):\n"
        "    def start(self, linger=3.0):\n"
        "        made.append(self)\n"
        "        super().start(linger)\n"
        "        threading.Timer(0.5, self.stop).start()\n"
        "        return self\n"
        "relay_mod.Relay = Stopped\n"
        "assert cli.main(['--relay', 'tcp://127.0.0.1:1:tcp://127.0.0.1:*'"
        "]) == 0\n"
        "assert made and made[0].endpoint != 'tcp://127.0.0.1:*'\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "children at tcp://127.0.0.1:" in out.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    from znicz_torch.backends import resolve_device
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlexNetWorkflow(sample_shape=(67, 67, 3), n_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


TINY_ALEXNET = ["root.alexnet.loader.image_size=67",
                "root.alexnet.loader.n_train=12",
                "root.alexnet.loader.n_valid=4",
                "root.alexnet.loader.minibatch_size=4",
                "root.alexnet.loader.n_classes=10",
                "root.alexnet.decision.max_epochs=2"]


def test_port_trains_without_jax_in_the_process(tmp_path):
    args = TINY_ALEXNET + [f"root.common.dirs.snapshots={tmp_path}"]
    code = (
        "import json, sys\n"
        "from znicz_torch.__main__ import main\n"
        f"assert main(['alexnet', '--device', 'cpu', *{args!r}]) "
        "== 0\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'znicz_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["epochs"] == 2
    assert res["train_steps"] == 5                # 3 + 2 (last tail skipped)


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from znicz_torch.__main__ import main
    from znicz_torch.samples import alexnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alexnet.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alexnet.training_workflow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["alexnet", *TINY_ALEXNET])
    assert torch.backends.cudnn.deterministic


@pytest.mark.parametrize("sample,cls", [
    ("mnist", "MnistWorkflow"), ("cifar", "CifarWorkflow"),
    ("kanji", "KanjiWorkflow"), ("video_ae", "VideoAEWorkflow"),
    ("yale_faces", "YaleFacesWorkflow"), ("charlm", "CharLMWorkflow")])
def test_sample_entry_points_raise_without_a_card(sample, cls, monkeypatch,
                                                  tmp_path):
    import importlib

    from znicz_torch.__main__ import main

    mod = importlib.import_module(f"znicz_torch.samples.{sample}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(mod, cls)()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([sample])
    assert not list(tmp_path.iterdir())         # nothing written first
