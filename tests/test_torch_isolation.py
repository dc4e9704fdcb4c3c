"""The port stands alone: no file of ``znicz_torch/`` and no line of
``chip_smoke.py`` imports JAX or the JAX package, or names the
reference's ``native/`` directory (the host runtime is built from the
port's own copy of its source); the port serves a batch (in process
and over ZMQ) and trains (``python -m znicz_torch alexnet``'s ``main``)
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
                   "yale_faces"):
        assert REPO / "znicz_torch" / "samples" / f"{sample}.py" in files
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
    ("yale_faces", "YaleFacesWorkflow")])
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
