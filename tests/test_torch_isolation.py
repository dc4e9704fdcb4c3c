"""The port stands alone: no file of ``znicz_torch/`` and no line of
``chip_smoke.py`` imports JAX or the JAX package; the port serves a batch
and trains (``python -m znicz_torch alexnet``'s ``main``) in a process
where ``jax`` was never imported; and an entry point asked for the card
on a machine without one raises instead of dropping to the CPU."""

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
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_names(tree):
            if name.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


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


def test_port_trains_without_jax_in_the_process():
    code = (
        "import json, sys\n"
        "from znicz_torch.__main__ import main\n"
        f"assert main(['alexnet', '--device', 'cpu', *{TINY_ALEXNET!r}]) "
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
