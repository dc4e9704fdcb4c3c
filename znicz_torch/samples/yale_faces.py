"""YaleFaces (port of ``znicz_tpu/samples/yale_faces.py``): grayscale face
identification from directories of image files, through
``FullBatchFileImageLoader`` (directory scan, PIL decode, resize, the
host runtime's u8 -> f32).

The faces are the reference's synthetic stand-in with the Yale B
structure: each subject is a fixed face geometry (:func:`_subject_geometry`),
each image of it varies only lighting direction, exposure, a small
shift and noise (:func:`_render_face`), all drawn from the
``dataset.yale`` stream.  :func:`ensure_dataset` writes them as PNG files
under ``<data_dir>/<train|valid>/subject_NN/`` unless a train directory is
there already.  The PNGs are grayscale and decode to 3 channels.  Two
``conv_strict_relu`` layers (8 kernels 5x5, 16 kernels 3x3), each with a
2x2 max pool, tanh 48 and a softmax over the subjects, with the
``root.yale_faces`` defaults of the reference entry for entry; under
``fused_tail`` on ``FusedTrainer`` the two convolutions take K2/K2b at
(B, 32, 32, 8) and (B, 16, 16, 16).
"""

from __future__ import annotations

import os

import numpy as np

from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.core import prng
from znicz_torch.core.config import root
from znicz_torch.loader.image import FullBatchFileImageLoader
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.standard_workflow import StandardWorkflow

root.yale_faces.defaults({
    "loader": {"data_dir": "yale_faces_data", "n_subjects": 8,
               "n_train_per_subject": 16, "n_valid_per_subject": 4,
               "minibatch_size": 32, "size": 32},
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "weights_decay": 0.0001,
    "decision": {"max_epochs": 10, "fail_iterations": 0},
    "snapshotter": {"prefix": "yale", "interval": 0},
})


def _render_face(rng, geom, size):
    """One (size, size) float32 image in [0, 1] of the subject ``geom``
    under a random lighting direction and exposure."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    dy = float(rng.uniform(-0.04, 0.04))
    dx = float(rng.uniform(-0.04, 0.04))
    cy, cx = 0.5 + dy, 0.5 + dx
    face = np.exp(-(((xx - cx) / geom["fw"]) ** 2
                    + ((yy - cy) / geom["fh"]) ** 2) ** 2)
    img = 0.55 * face
    for side in (-1.0, 1.0):
        ex = cx + side * geom["eye_dx"]
        ey = cy - geom["eye_dy"]
        eye = np.exp(-((xx - ex) ** 2 + (yy - ey) ** 2)
                     / (2 * geom["eye_r"] ** 2))
        img -= 0.5 * eye
        brow = np.exp(-((xx - ex) ** 2 / (2 * (2.2 * geom["eye_r"]) ** 2)
                        + (yy - (ey - geom["brow_h"])) ** 2
                        / (2 * (0.35 * geom["eye_r"]) ** 2)))
        img -= 0.3 * brow
    mouth_y = cy + geom["mouth_dy"] + geom["mouth_curve"] * \
        np.square((xx - cx) / geom["fw"])
    mouth = np.exp(-((yy - mouth_y) ** 2 / (2 * 0.015 ** 2))
                   - ((xx - cx) ** 2 / (2 * geom["mouth_w"] ** 2)))
    img -= 0.4 * mouth
    ang = float(rng.uniform(0, 2 * np.pi))
    light = 0.5 + 0.5 * ((xx - 0.5) * np.cos(ang) + (yy - 0.5) * np.sin(ang))
    img = img * (0.45 + 0.55 * light) * float(rng.uniform(0.7, 1.0))
    img += rng.normal(0, 0.04, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _subject_geometry(rng):
    return {
        "fw": float(rng.uniform(0.26, 0.36)),
        "fh": float(rng.uniform(0.33, 0.45)),
        "eye_dx": float(rng.uniform(0.09, 0.15)),
        "eye_dy": float(rng.uniform(0.06, 0.12)),
        "eye_r": float(rng.uniform(0.02, 0.035)),
        "brow_h": float(rng.uniform(0.04, 0.07)),
        "mouth_dy": float(rng.uniform(0.12, 0.2)),
        "mouth_w": float(rng.uniform(0.05, 0.1)),
        "mouth_curve": float(rng.uniform(-0.12, 0.12)),
    }


def ensure_dataset(data_dir=None) -> str:
    """Write the PNG tree of ``root.yale_faces.loader`` under ``data_dir``
    (default its ``data_dir``) unless it has a train directory already,
    drawing from the ``dataset.yale`` stream in the reference's order
    (per subject its geometry, then its train and its valid images);
    returns the directory."""
    from PIL import Image

    cfg = root.yale_faces.loader
    base = data_dir or cfg.get("data_dir")
    if os.path.isdir(os.path.join(base, "train")):
        return base
    size = int(cfg.get("size"))
    rng = prng.get("dataset.yale").state
    for si in range(int(cfg.get("n_subjects"))):
        geom = _subject_geometry(rng)
        for split, count in (("train", int(cfg.get("n_train_per_subject"))),
                             ("valid", int(cfg.get("n_valid_per_subject")))):
            d = os.path.join(base, split, f"subject_{si:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                img = (_render_face(rng, geom, size) * 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"img_{i:03d}.png"))
    return base


def make_layers(n_classes: int):
    cfg = root.yale_faces
    gd = {"learning_rate": float(cfg.get("learning_rate")),
          "gradient_moment": float(cfg.get("gradient_moment")),
          "weights_decay": float(cfg.get("weights_decay"))}
    return [
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 8, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 16, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 48},
         "<-": dict(gd)},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(gd)},
    ]


class YaleFacesWorkflow(StandardWorkflow):
    """The convnet of ``root.yale_faces`` on ``device``, its loader
    reading the PNG tree under ``data_dir`` (written first if absent)."""

    def __init__(self, device: DeviceLike = None, data_dir=None, **kwargs):
        cfg = root.yale_faces
        device = resolve_device(device)     # no card: raise, write nothing
        size = int(cfg.loader.get("size"))
        base = ensure_dataset(data_dir)
        loader = FullBatchFileImageLoader(
            train_path=os.path.join(base, "train"),
            valid_path=os.path.join(base, "valid"),
            target_shape=(size, size), grayscale=False,
            minibatch_size=int(cfg.loader.get("minibatch_size")))
        super().__init__(
            make_layers(int(cfg.loader.get("n_subjects"))), device=device,
            name="YaleFacesWorkflow", loader=loader,
            loss_function="softmax",
            decision_config={
                "max_epochs": int(cfg.decision.get("max_epochs")),
                "fail_iterations": int(cfg.decision.get("fail_iterations"))},
            snapshotter_config={
                "prefix": cfg.snapshotter.get("prefix"),
                "interval": int(cfg.snapshotter.get("interval", 0))},
            **kwargs)


def run(device: DeviceLike = None, snapshot: str = "") -> YaleFacesWorkflow:
    """Build :class:`YaleFacesWorkflow` on ``device`` (the PNG tree under
    ``root.yale_faces.loader.data_dir``), resume it from ``snapshot`` if
    one is named, and train it with ``engine.train`` (the unit graph
    unless ``root.common.engine.fused``)."""
    wf = YaleFacesWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "yale_faces")
