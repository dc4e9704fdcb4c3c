"""``FusedTrainer`` on a mesh of gloo ranks on the CPU: spawned processes,
one a rank, joined over a ``FileStore`` in ``tmp_path`` (never a fixed
port), each writing its results to a file; the parent joins them with a
timeout of at most 120 s and kills them on failure.  The counterparts of
``tests/test_shard_training.py``'s layouts and staged segments,
``tests/test_multihost_fused.py`` and ``tests/test_multihost_streaming.py``:

  - the reduced MNIST of ``test_shard_training.py`` (hidden 1024, batch
    60) at 2 × 1, 1 × 2 and 2 × 2: shard shapes, losses and weights in the
    reference's cross-layout band of the port's single process and of the
    reference's meshed run, the ranks bit-equal, snapshots from rank 0;
  - the deep pipeline (``pipeline_depth`` 3) on two ranks against one
    process, with the snapshotter active;
  - a partial last minibatch (130 rows, batch 60): one rank's shard
    wholly invalid, the loss one process's;
  - host-staged streaming (each rank gathers only its rows: disjoint,
    their union the batch) and image-file ingest (each rank decodes and
    prefetches only its rows);
  - ``samples.alexnet.run(mesh=...)`` under the fused kernels' routing:
    fc6/fc7 split by rows, the dropout masks one process's; CIFAR10
    under ``pallas_lrn`` on two data ranks;
  - a meshed snapshot loads into one process and into the reference, and
    a single process's loads into a mesh;
  - the sharded orbax snapshots of (1, 2) and (2, 1) (each rank writing
    its own rows, each row once) restore with ``restore_sharded`` onto a
    fresh pair of either shape and onto one process, and finish within
    the band of the saving pair's losses; the reference's own orbax
    directory restores onto (1, 2).

Run as a script, this file is the rank worker:
``python test_torch_multiprocess.py RANK WORLD STORE OUTDIR SCENARIOS``.
"""

import contextlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the cross-layout band of ``tests/test_shard_training.py:165-170``
LOSS_RTOL = 1e-3
W_TOL = {"rtol": 2e-3, "atol": 2e-5}
#: the multi-process runs against one process
#: (``tests/test_multihost_fused.py``)
PROC_LOSS_RTOL = 1e-4
#: the reference's reduced MNIST for sharding: hidden 1024 >= the
#: trainer's ``tp_threshold``, so a model axis splits it
MNIST = {"loader__n_train": 120, "loader__n_valid": 60, "loader__n_test": 0,
         "loader__minibatch_size": 60, "decision__max_epochs": 2,
         "layers": [1024, 10]}
#: the staged and image-file runs (``test_multihost_streaming.py``)
STREAM = {"loader__n_train": 256, "loader__n_valid": 64, "loader__n_test": 0,
          "loader__minibatch_size": 64, "decision__max_epochs": 2,
          "layers": [100, 10]}
#: a reduced AlexNet on the CPU: fc6/fc7 keep their 4096 rows
ALEXNET = {"loader__image_size": 67, "loader__n_train": 16,
           "loader__n_valid": 8, "loader__minibatch_size": 8,
           "loader__n_classes": 10, "decision__max_epochs": 2}
FUSED_KNOBS = {"fused_elementwise": True, "fused_tail": True}
#: a reduced CIFAR10 under the standalone LRN kernels' routing
CIFAR = {"loader__n_train": 100, "loader__n_valid": 50, "loader__n_test": 0,
         "loader__minibatch_size": 50, "decision__max_epochs": 2}
LRN_KNOBS = {"pallas_lrn": True, "fused_tail": True}
#: the longest the parent waits for a group of ranks
JOIN_S = 120
_UNSET = object()


# -- run on both sides: in the ranks, and with mesh None in the parent --------


@contextlib.contextmanager
def port_config(sample=None, values=(), **knobs):
    """``root.<sample>.<key>`` and ``root.common.engine.<knob>`` set in the
    port's tree, the old values put back on exit."""
    import importlib

    from znicz_torch.core.config import root

    if sample is not None:
        importlib.import_module(f"znicz_torch.samples.{sample}")
    saved = []
    items = [(f"{sample}.{k.replace('__', '.')}", v)
             for k, v in dict(values).items()]
    items += [(f"common.engine.{k.replace('__', '.')}", v)
              for k, v in knobs.items()]
    try:
        for path, val in items:
            saved.append((path, root.get_by_path(path, _UNSET)))
            root.set_by_path(path, val)
        yield
    finally:
        for path, old in reversed(saved):
            if old is _UNSET:
                head, _, leaf = path.rpartition(".")
                delattr(root.get_by_path(head) if "." in head
                        else getattr(root, head), leaf)
            else:
                root.set_by_path(path, old)


def _mesh(shape):
    from znicz_torch.parallel.mesh import make_mesh

    return None if shape is None else make_mesh(tuple(shape),
                                                ("data", "model"))


def _record(wf, trainer, snapdir):
    """What a run leaves: TRAIN losses, per-class epoch metrics, the whole
    parameters and velocities (gathered: every rank joins), the local
    shapes, counters and the snapshot files."""
    from znicz_torch.snapshotter import collect

    d = wf.decision
    snap = collect(wf)
    return {
        "losses": [float(x) for x in d.train_losses],
        "epoch": {k: {"loss": float(m["loss"]), "err_pct": m.get("err_pct"),
                      "confusion": (None if m.get("confusion") is None
                                    else np.asarray(m["confusion"]))}
                  for k, m in enumerate(d.epoch_metrics) if m is not None},
        "units": snap["units"], "velocities": snap["velocities"],
        "shapes": {f.name: {k: tuple(p.shape)
                            for k, p in trainer._params_of(f).items()}
                   for f in trainer._weighted()},
        "stats": {k: trainer.stats[k] for k in (
            "train_steps", "eval_steps", "eager_steps", "captured_steps",
            "collectives", "collective_s", "deep_epochs", "deep_pulls")},
        "uncaptured": trainer.uncaptured_reason,
        "files": sorted(os.listdir(snapdir)) if os.path.isdir(snapdir)
        else [],
        "destination": wf.snapshotter.destination,
        "written": wf.snapshotter.async_saves_written,
        "mesh_shape": trainer.mesh_shape}


def _mnist_workflow(snapdir, loader_cls=None):
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import mnist

    root.common.dirs.snapshots = snapdir
    orig = mnist.MnistLoader
    if loader_cls is not None:
        mnist.MnistLoader = loader_cls
    try:
        prng.reset(1013)
        return mnist.MnistWorkflow(device="cpu")
    finally:
        mnist.MnistLoader = orig


def run_mnist(mesh_shape, snapdir, depth=1, cfg=MNIST):
    """A seeded MNIST run on ``FusedTrainer(wf, mesh=make_mesh(...))``;
    ``valid`` records (rows, valid rows) of this rank's every step."""
    from znicz_torch.parallel.fused import FusedTrainer

    with port_config("mnist", cfg, pipeline_depth=depth):
        wf = _mnist_workflow(snapdir)
        trainer = FusedTrainer(wf, mesh=_mesh(mesh_shape))
        valid, inner = [], trainer.loss_and_metrics

        def counted(data, target, batch_size, *args, **kw):
            n = data.shape[0]
            valid.append((n, max(0, min(n, int(batch_size)
                                        - trainer._d * n))))
            return inner(data, target, batch_size, *args, **kw)
        trainer.loss_and_metrics = counted
        trainer.run()
        return dict(_record(wf, trainer, snapdir), valid=valid)


def run_config_mesh(mesh_shape, snapdir):
    """MNIST through ``engine.train``, its mesh built from the config
    (``train_shard`` and ``mesh.data``/``mesh.model``)."""
    from znicz_torch import engine

    dp, mp = mesh_shape
    with port_config("mnist", MNIST, train_shard=True, mesh__data=dp,
                     mesh__model=mp):
        wf = _mnist_workflow(snapdir)
        engine.train(wf, fused=True)
        return _record(wf, wf.trainer, snapdir)


def _stream_loader(images=None):
    """A host-staged streaming MNIST loader class: the digits as float32,
    or ``images``, a class tree of PNGs decoded by a pool of 2."""
    from znicz_torch import datasets
    from znicz_torch.core.config import root
    from znicz_torch.loader.streaming import (HostArraySource,
                                              StreamingLoader,
                                              class_dir_source)

    class Staged(StreamingLoader):
        def __init__(self, workflow=None, name="loader", **kwargs):
            cfg = root.mnist.loader
            n = int(cfg.n_train) + int(cfg.n_valid)
            if images is None:
                data, labels = datasets.load_or_generate(
                    None, datasets.digits, n)
                source = HostArraySource(
                    data.reshape(n, -1).astype(np.float32), labels)
            else:
                source = class_dir_source(images, target_shape=(12, 12),
                                          workers=2)
            super().__init__(workflow=workflow, name=name, source=source,
                             class_lengths=[0, int(cfg.n_valid),
                                            int(cfg.n_train)],
                             device_budget_bytes=0,
                             scale=1.0 if images is None else 1.0 / 255.0,
                             **kwargs)

    return Staged


def run_staged(mesh_shape, snapdir, images=None):
    """A host-staged run; the rows each staged segment gathered on this
    rank, keyed by the segment's global index rows, and the decode pool's
    counters."""
    from znicz_torch.loader.ingest import DeviceStager
    from znicz_torch.parallel.fused import FusedTrainer

    with port_config("mnist", STREAM):
        wf = _mnist_workflow(snapdir, _stream_loader(images))
        trainer = FusedTrainer(wf, mesh=_mesh(mesh_shape))
        assert trainer.staging
        local = threading.local()
        segments, lock = {}, threading.Lock()
        gather, stage = wf.loader.host_gather, trainer._stage_direct

        def host_gather(idx, out=None):
            getattr(local, "rows", []).append(np.array(idx))
            return gather(idx, out=out)

        def stage_direct(idx_rows):
            local.rows = []
            seg = stage(idx_rows)
            with lock:
                segments[DeviceStager.key_of(idx_rows)] = (
                    np.stack([np.asarray(r) for r in idx_rows]),
                    np.concatenate(local.rows))
            return seg
        wf.loader.host_gather = host_gather
        trainer._stage_direct = stage_direct
        trainer.run()
        out = _record(wf, trainer, snapdir)
    out.update(segments=segments, ingest=wf.loader.ingest_stats,
               served=int(wf.loader.samples_served),
               staged=trainer.stats["staged_segments"])
    return out


def run_alexnet(mesh_shape, snapdir):
    """``samples.alexnet.run(device="cpu", mesh=...)`` under the fused
    kernels' routing (their plain twins on the CPU); the snapshot files
    are named, not written (160 MB of gzip a save)."""
    from znicz_torch import snapshotter
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import alexnet

    root.common.dirs.snapshots = snapdir
    written, write = [], snapshotter.write_host_pickle
    snapshotter.write_host_pickle = lambda path, *a, **k: written.append(path)
    try:
        with port_config("alexnet", ALEXNET, **FUSED_KNOBS):
            prng.reset(1013)
            wf = alexnet.run(device="cpu", mesh=_mesh(mesh_shape))
            wf.snapshotter.flush_async()
            out = _record(wf, wf.trainer, snapdir)
    finally:
        snapshotter.write_host_pickle = write
    out["files"] = [os.path.basename(p) for p in written]
    return out


def run_cifar(mesh_shape, snapdir):
    """CIFAR10 on ``FusedTrainer(wf, mesh=...)`` under ``pallas_lrn`` and
    ``fused_tail`` (the plain twins of K3/K3b and K2/K2b on the CPU)."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples import cifar

    root.common.dirs.snapshots = snapdir
    with port_config("cifar", CIFAR, **LRN_KNOBS):
        prng.reset(1013)
        wf = cifar.CifarWorkflow(device="cpu")
        trainer = FusedTrainer(wf, mesh=_mesh(mesh_shape))
        trainer.run()
        return _record(wf, trainer, snapdir)


def run_restore(mesh_shape, snapdir, path):
    """A fresh MNIST workflow on a mesh, the snapshot at ``path``
    restored into it: the whole parameters and velocities collected
    back, and this rank's local shapes."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import Snapshotter, collect, restore

    with port_config("mnist", MNIST):
        wf = _mnist_workflow(snapdir)
        trainer = FusedTrainer(wf, mesh=_mesh(mesh_shape))
        restore(wf, Snapshotter.load(path))
        snap = collect(wf)
    return {"units": snap["units"], "velocities": snap["velocities"],
            "shapes": {f.name: tuple(f.weights.shape)
                       for f in trainer._weighted()}}


#: the sharded checkpoint runs (``tests/test_multihost_checkpoint.py``):
#: 4 epochs, an orbax snapshot at the end of epoch 1 (``interval`` 2)
CKPT = dict(MNIST, decision__max_epochs=4)


def run_sharded_save(mesh_shape, snapdir, ckpt, sharded=True):
    """MNIST for 4 epochs on the mesh, the snapshotter in the orbax
    format (each rank writing its own rows under ``sharded``) writing
    ``mnist_epoch_1.orbax`` and its best saves into ``ckpt``, the
    directory every rank shares; the run goes on to its end."""
    from znicz_torch.parallel.fused import FusedTrainer

    with port_config("mnist", CKPT, snapshot_format="orbax",
                     snapshot_sharded=sharded):
        wf = _mnist_workflow(ckpt)
        wf.snapshotter.interval = 2
        trainer = FusedTrainer(wf, mesh=_mesh(mesh_shape))
        trainer.run()
        return _record(wf, trainer, ckpt)


def run_sharded_restore(mesh_shape, snapdir, path):
    """A fresh MNIST workflow on the mesh (or one process), the orbax
    snapshot at ``path`` restored by ``restore_sharded``, then run to the
    end: the whole leaves as restored, and the run's record."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import collect

    with port_config("mnist", CKPT):
        wf = _mnist_workflow(snapdir)
        trainer = FusedTrainer(wf, mesh=_mesh(mesh_shape))
        meta = trainer.restore_sharded(path)
        restored = collect(wf)
        trainer.run()
        return dict(_record(wf, trainer, snapdir), meta_epoch=meta["epoch"],
                    restored={g: restored[g]
                              for g in ("units", "velocities")})


def run_refusals(mesh_shape, snapdir):
    """The mesh refusals inside a group: a mesh larger and one smaller
    than the world."""
    from znicz_torch.parallel.mesh import make_mesh

    out = {}
    for shape in ((4, 1), (1, 1)):
        try:
            make_mesh(shape, ("data", "model"))
            out[shape] = None
        except ValueError as exc:
            out[shape] = str(exc)
    return out


SCENARIOS = {"mnist": run_mnist, "config": run_config_mesh,
             "staged": run_staged, "alexnet": run_alexnet, "cifar": run_cifar,
             "restore": run_restore, "refusals": run_refusals,
             "sharded_save": run_sharded_save,
             "sharded_restore": run_sharded_restore}


def worker(rank: int, world: int, store: str, outdir: str,
           scenarios: list) -> None:
    import torch

    from znicz_torch.parallel.mesh import distributed_init

    torch.set_num_threads(1)
    distributed_init(f"file://{store}", world, rank, backend="gloo",
                     device="cpu")
    out = {}
    for label, name, kw in scenarios:
        snapdir = os.path.join(outdir, f"{label}_snap_{rank}")
        out[label] = SCENARIOS[name](snapdir=snapdir, **kw)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# -- the parent ----------------------------------------------------------------

#: the deep pipeline's run: 4 epochs at depth 3 (a fill, then the drain)
DEEP = dict(MNIST, decision__max_epochs=4)
#: 130 TRAIN rows at batch 60: a last minibatch of 10, all of it rank 0's
PARTIAL = dict(MNIST, loader__n_train=130)


def spawn(tmp_path, world: int, scenarios: list) -> list:
    """Run ``scenarios`` ([(label, scenario, kwargs)]) on ``world`` gloo
    ranks; each rank's {label: record}."""
    outdir = tmp_path / f"ranks{world}"
    outdir.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world),
         str(outdir / "store"), str(outdir), json.dumps(scenarios)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]
    deadline = time.monotonic() + JOIN_S
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, (rank, err[-4000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out = []
    for rank in range(world):
        with open(outdir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A class tree of 320 seeded 12x12 PNGs (256 TRAIN + 64 VALID)."""
    from PIL import Image

    base = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(7)
    for cname in ("cat", "dog"):
        (base / cname).mkdir()
        for i in range(160):
            Image.fromarray(rng.integers(0, 255, (12, 12, 3),
                                         dtype=np.uint8)).save(
                base / cname / f"{i}.png")
    return str(base)


@pytest.fixture(scope="module")
def single(tmp_path_factory, images):
    """The port's one-process runs of every scenario."""
    tmp = tmp_path_factory.mktemp("single")
    return {"mnist": run_mnist(None, str(tmp / "mnist")),
            "deep": run_mnist(None, str(tmp / "deep"), depth=3, cfg=DEEP),
            "partial": run_mnist(None, str(tmp / "partial"), cfg=PARTIAL),
            "staged": run_staged(None, str(tmp / "staged")),
            "images": run_staged(None, str(tmp / "images"), images=images),
            "alexnet": run_alexnet(None, str(tmp / "alexnet")),
            "cifar": run_cifar(None, str(tmp / "cifar")),
            "snapshot": str(tmp / "mnist" / "mnist_best.pickle.gz")}


#: the sharded saves: label -> (mesh shape, sharded)
CKPT_SAVES = {"save_m2": ([1, 2], True), "save_d2": ([2, 1], True),
              "save_whole": ([1, 2], False)}
#: the restores of a save's epoch-1 directory: label -> (save, mesh shape)
CKPT_RESUMES = {"resume_m2": ("save_m2", [1, 2]),
                "resume_m2_on_d2": ("save_m2", [2, 1]),
                "resume_d2": ("save_d2", [2, 1]),
                "resume_d2_on_m2": ("save_d2", [1, 2])}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """The sharded saves' directories, and the reference's own orbax
    directory of the seeded, untrained reduced MNIST (``ref.orbax``)."""
    from test_torch_layers import jax_sample, sample_config

    base = tmp_path_factory.mktemp("ckpt")
    with sample_config("mnist", **CKPT):
        jwf = jax_sample("mnist", base / "jax")
        jwf.snapshotter.format = "orbax"
        jwf.snapshotter.directory = str(base)
        jwf.snapshotter.prefix = "ref"
        jwf.snapshotter.save("start")
    return base


def _epoch1(ckpt_dir, save):
    return str(ckpt_dir / save / "mnist_epoch_1.orbax")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, single, images, ckpt_dir):
    """Every two-rank scenario, in two groups (each joined within
    ``JOIN_S``): [rank 0's, rank 1's].  The second group's fresh pairs
    restore the first group's sharded snapshots."""
    groups = [
        [*[(label, "sharded_save", {"mesh_shape": shape,
                                    "ckpt": str(ckpt_dir / label),
                                    "sharded": sharded})
           for label, (shape, sharded) in CKPT_SAVES.items()],
         ("d2", "mnist", {"mesh_shape": [2, 1]}),
         ("m2", "mnist", {"mesh_shape": [1, 2]}),
         ("config", "config", {"mesh_shape": [1, 2]}),
         ("restore", "restore", {"mesh_shape": [1, 2],
                                 "path": single["snapshot"]}),
         ("refusals", "refusals", {"mesh_shape": None}),
         ("deep", "mnist", {"mesh_shape": [2, 1], "depth": 3,
                            "cfg": DEEP}),
         ("segmented", "mnist", {"mesh_shape": [2, 1], "cfg": DEEP}),
         ("partial", "mnist", {"mesh_shape": [2, 1], "cfg": PARTIAL})],
        [("staged", "staged", {"mesh_shape": [2, 1]}),
         ("images", "staged", {"mesh_shape": [2, 1], "images": images}),
         ("alexnet_m2", "alexnet", {"mesh_shape": [1, 2]}),
         ("cifar", "cifar", {"mesh_shape": [2, 1]}),
         *[(label, "sharded_restore", {"mesh_shape": shape,
                                       "path": _epoch1(ckpt_dir, save)})
           for label, (save, shape) in CKPT_RESUMES.items()],
         ("resume_ref_on_m2", "sharded_restore", {
             "mesh_shape": [1, 2],
             "path": str(ckpt_dir / "ref_start.orbax")})]]
    ranks = [{}, {}]
    for scenarios in groups:
        for rank, got in enumerate(
                spawn(tmp_path_factory.mktemp("two"), 2, scenarios)):
            ranks[rank].update(got)
    return ranks


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("four"), 4, [
        ("d2m2", "mnist", {"mesh_shape": [2, 2]}),
        ("alexnet_d2m2", "alexnet", {"mesh_shape": [2, 2]})])


_REFERENCE = {}


def reference_meshed(shape, tmp_path):
    """(TRAIN losses, whole weights) of the reference's reduced MNIST on
    its ``FusedTrainer(wf, mesh=make_mesh(shape, ("data", "model")))``
    over conftest's virtual devices; one run a shape."""
    if shape not in _REFERENCE:
        from test_torch_layers import jax_params, jax_sample, sample_config

        from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
        from znicz_tpu.parallel.mesh import make_mesh

        with sample_config("mnist", **MNIST):
            jwf = jax_sample("mnist", tmp_path)
            jt = JTrainer(jwf, mesh=make_mesh(shape, ("data", "model")))
            losses, feed = [], jt._feed_decision

            def record(mb, metrics):
                if mb["class"] == 2:
                    losses.append(float(metrics[0]))
                feed(mb, metrics)
            jt._feed_decision = record
            jt.run()
        _REFERENCE[shape] = (losses, jax_params(jwf))
    return _REFERENCE[shape]


def assert_band(got, want, loss_rtol=LOSS_RTOL):
    """Losses and whole weights of two runs in the cross-layout band."""
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=loss_rtol)
    for name, leaves in want["units"].items():
        for k, w in leaves.items():
            np.testing.assert_allclose(got["units"][name][k], w, **W_TOL,
                                       err_msg=f"{name}.{k}")


def assert_ranks_equal(records):
    """Every rank's losses, metrics, whole weights and velocities the same
    bits."""
    first = records[0]
    for other in records[1:]:
        assert other["losses"] == first["losses"]
        for group in ("units", "velocities"):
            for name, leaves in first[group].items():
                for k, a in leaves.items():
                    assert np.array_equal(other[group][name][k], a), \
                        f"{group}:{name}.{k}"
        for klass, m in first["epoch"].items():
            assert other["epoch"][klass]["loss"] == m["loss"]
            assert other["epoch"][klass]["err_pct"] == m["err_pct"]
            if m["confusion"] is not None:
                assert np.array_equal(other["epoch"][klass]["confusion"],
                                      m["confusion"])


def assert_rank0_writes(records, name):
    """Only rank 0's snapshot directory holds ``name``; every rank points
    its ``destination`` at it."""
    assert records[0]["files"] == [name]
    for rec in records[1:]:
        assert rec["files"] == []
    assert {os.path.basename(r["destination"]) for r in records} == {name}


@pytest.mark.parametrize("label,shape", [("d2", (2, 1)), ("m2", (1, 2)),
                                         ("d2m2", (2, 2))])
def test_layouts_shapes_band_and_parity(label, shape, two_ranks,
                                        four_ranks, single, tmp_path):
    """The reduced MNIST at 2 × 1, 1 × 2 and 2 × 2 (``tests/
    test_shard_training.py:137``): each rank holds the hidden layer as
    (1024 // mp, 784), its bias (1024 // mp,), the head whole; losses and
    weights in the reference's cross-layout band of the port's single
    process and of the reference's meshed run at the same layout; the
    ranks bit-equal; it trains; uncaptured, every step counted eager."""
    ranks = two_ranks if label in two_ranks[0] else four_ranks
    recs = [r[label] for r in ranks]
    mp = shape[1]
    for rec in recs:
        assert rec["mesh_shape"] == {"data": shape[0], "model": mp}
        assert rec["shapes"]["fwd0"] == {"weights": (1024 // mp, 784),
                                         "bias": (1024 // mp,)}
        assert rec["shapes"]["fwd1"] == {"weights": (10, 1024),
                                         "bias": (10,)}
        assert rec["uncaptured"] and rec["stats"]["captured_steps"] == 0
        assert rec["stats"]["collectives"] > 0
    assert_ranks_equal(recs)
    assert_band(recs[0], single["mnist"])
    ref_losses, ref_weights = reference_meshed(shape, tmp_path)
    assert_band(recs[0], {"losses": ref_losses, "units": ref_weights})
    assert recs[0]["epoch"][2]["loss"] < single["mnist"]["losses"][0]
    assert_rank0_writes(recs, "mnist_best.pickle.gz")


def test_train_shard_config_builds_the_mesh(two_ranks):
    """``engine.train`` under ``train_shard`` with ``mesh.model`` 2 builds
    the mesh from the config: the same bits as the explicit
    ``make_mesh((1, 2))`` run."""
    for rank in two_ranks:
        assert rank["config"]["mesh_shape"] == {"data": 1, "model": 2}
        assert rank["config"]["losses"] == rank["m2"]["losses"]
        for name, leaves in rank["m2"]["units"].items():
            for k, w in leaves.items():
                assert np.array_equal(rank["config"]["units"][name][k], w)


def test_deep_pipeline_on_two_ranks(two_ranks, single):
    """``pipeline_depth`` 3 on two ranks (``tests/test_multihost_fused.py
    :178``): within the band of one process's deep run, bit-equal to the
    meshed segmented run and across ranks; the epoch vectors read in
    pulls; rank 0 alone wrote the snapshots it queued."""
    recs = [r["deep"] for r in two_ranks]
    assert_ranks_equal(recs)
    assert recs[0]["stats"]["deep_epochs"] == 4
    assert recs[0]["stats"]["deep_pulls"] >= 1
    assert_band(recs[0], single["deep"], PROC_LOSS_RTOL)
    seg = two_ranks[0]["segmented"]
    assert seg["losses"] == recs[0]["losses"]
    for name, leaves in seg["units"].items():
        for k, w in leaves.items():
            assert np.array_equal(recs[0]["units"][name][k], w)
    assert recs[0]["written"] > 0 and recs[1]["written"] == 0
    assert_rank0_writes(recs, "mnist_best.pickle.gz")


def test_partial_last_minibatch(two_ranks, single):
    """130 TRAIN rows at batch 60 on two data ranks: the last minibatch's
    10 rows are all rank 0's, rank 1's shard of it wholly invalid, and
    the losses one process's within the band."""
    r0, r1 = (r["partial"] for r in two_ranks)
    assert (30, 10) in r0["valid"] and (30, 0) not in r0["valid"]
    assert (30, 0) in r1["valid"]
    assert all(n == 30 for n, _ in r0["valid"] + r1["valid"])
    assert len(r0["losses"]) == 3 * 2
    assert_ranks_equal([r0, r1])
    assert_band(r0, single["partial"], PROC_LOSS_RTOL)


def test_staged_segments_gather_own_rows(two_ranks, single):
    """Host-staged streaming on two data ranks (``tests/
    test_shard_training.py:192``, ``test_multihost_streaming.py:104``):
    each staged segment's rows that each rank gathered are disjoint and
    together the segment's index rows; the losses one process's."""
    r0, r1 = (r["staged"] for r in two_ranks)
    assert r0["staged"] > 0 and r0["segments"].keys() == r1["segments"].keys()
    for key, (rows, got0) in r0["segments"].items():
        got1 = r1["segments"][key][1]
        assert len(got0) == len(got1) == rows.size // 2
        assert not set(got0.tolist()) & set(got1.tolist())
        assert sorted(got0.tolist() + got1.tolist()) == \
            sorted(rows.reshape(-1).tolist())
    assert_ranks_equal([r0, r1])
    assert_band(r0, single["staged"], PROC_LOSS_RTOL)


def test_image_ingest_prefetches_own_rows(two_ranks, single):
    """Image files through the decode pool on two data ranks (``tests/
    test_multihost_streaming.py:240``): each rank decodes about half the
    rows the run served, most of them prefetched; the losses one
    process's."""
    recs = [r["images"] for r in two_ranks]
    for rec in recs:
        assert rec["ingest"]["rows_decoded"] <= 0.75 * rec["served"], rec
        assert rec["ingest"]["prefetch_hits"] > 0
    assert single["images"]["ingest"]["rows_decoded"] >= \
        single["images"]["served"]
    assert_ranks_equal(recs)
    assert_band(recs[0], single["images"], PROC_LOSS_RTOL)


@pytest.mark.parametrize("label,shape", [("alexnet_m2", (1, 2)),
                                         ("alexnet_d2m2", (2, 2))])
def test_alexnet_run_on_a_mesh(label, shape, two_ranks, four_ranks,
                               single):
    """``samples.alexnet.run(mesh=...)`` under ``fused_elementwise`` and
    ``fused_tail`` (the FC epilogue with its dropout masks, drawn at the
    global shape): fc6 and fc7 split by rows, the head whole, every TRAIN
    loss (each a forward under that step's masks) one process's within
    ``PROC_LOSS_RTOL``, the ranks bit-equal, rank 0 alone saving.  The
    weights are held to the band on MNIST's smooth net (above): here a
    StrictRELU gate of this tiny run sits 2.6e-8 from zero, so a
    summation order flips it and moves that row's gradient."""
    ranks = two_ranks if label in two_ranks[0] else four_ranks
    recs = [r[label] for r in ranks]
    mp = shape[1]
    shapes = recs[0]["shapes"]
    assert shapes["fwd_all2all_strict_relu_10"]["weights"][0] == 4096 // mp
    assert shapes["fwd_all2all_strict_relu_12"]["weights"] == \
        (4096 // mp, 4096)
    assert shapes["fwd_softmax_14"]["weights"] == (10, 4096)
    assert_ranks_equal(recs)
    np.testing.assert_allclose(recs[0]["losses"], single["alexnet"]["losses"],
                               rtol=PROC_LOSS_RTOL)
    assert recs[0]["files"] == ["alexnet_best.pickle.gz"]
    assert all(not r["files"] for r in recs[1:])


def test_cifar_under_pallas_lrn_on_two_data_ranks(two_ranks, single):
    """CIFAR10 under ``pallas_lrn`` and ``fused_tail`` (K3/K3b and K2/K2b
    on the card) at 2 × 1: 25 rows a rank, every layer whole, the ranks
    bit-equal, losses and weights in the band of one process's run."""
    recs = [r["cifar"] for r in two_ranks]
    assert recs[0]["mesh_shape"] == {"data": 2, "model": 1}
    assert recs[0]["shapes"] == single["cifar"]["shapes"]
    assert_ranks_equal(recs)
    assert_band(recs[0], single["cifar"], PROC_LOSS_RTOL)


def test_meshed_snapshot_loads_anywhere(two_ranks, single, tmp_path):
    """The (1, 2) run's best snapshot, written by rank 0 alone, holds
    whole arrays and loads into one process of the port and into the
    reference; one process's snapshot restored on the mesh gives each
    rank its rows, and gathers back to the file's arrays."""
    from test_torch_layers import jax_params, jax_sample, port_sample, \
        sample_config

    from znicz_torch.nn_units import params_of
    from znicz_torch.snapshotter import Snapshotter, restore
    from znicz_tpu.snapshotter import Snapshotter as JSnapshotter
    from znicz_tpu.snapshotter import restore as jrestore

    recs = [r["config"] for r in two_ranks]
    assert_rank0_writes(recs, "mnist_best.pickle.gz")
    snap = Snapshotter.load(recs[0]["destination"])
    assert snap["units"]["fwd0"]["weights"].shape == (1024, 784)
    assert snap["velocities"]["gd0"]["weights"].shape == (1024, 784)
    with sample_config("mnist", **MNIST):
        twf = port_sample("mnist", tmp_path / "port")
        restore(twf, snap)
        jwf = jax_sample("mnist", tmp_path / "ref")
        jrestore(jwf, JSnapshotter.load(recs[0]["destination"]))
    for f in twf.forwards:
        for k, p in params_of(f).items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          snap["units"][f.name][k])
    for name, leaves in jax_params(jwf).items():
        for k, a in leaves.items():
            np.testing.assert_array_equal(a, snap["units"][name][k])
    one = Snapshotter.load(single["snapshot"])
    for rank in two_ranks:
        got = rank["restore"]
        assert got["shapes"]["fwd0"] == (512, 784)
        for group in ("units", "velocities"):
            for name, leaves in one[group].items():
                for k, a in leaves.items():
                    np.testing.assert_array_equal(got[group][name][k], a)


def _chunks(path):
    """{leaf: [(first row, rows, file)]} of the orbax directory's
    ``arrays/``, as ``torch.distributed.checkpoint`` stored them."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import MetadataIndex

    md = FileSystemReader(os.path.join(path, "arrays")).read_metadata()
    out = {}
    for fqn, leaf in md.state_dict_metadata.items():
        out[fqn] = sorted(
            (int(c.offsets[0]), int(c.sizes[0]), md.storage_data[
                MetadataIndex(fqn, c.offsets)].relative_path)
            for c in leaf.chunks)
    return out


def test_sharded_snapshot_writes_each_row_once(two_ranks, ckpt_dir):
    """Reduced MNIST on (1, 2) and (2, 1) saves sharded orbax snapshots
    (``tests/test_multihost_checkpoint.py:128``), every rank into one
    directory: on (1, 2) each rank wrote its 512 rows of the hidden
    layer and its velocity, and the replicated leaves were written once;
    on (2, 1) and unsharded every leaf is one whole chunk, written once;
    the ranks trained to the same bits; the directory holds the
    snapshot's arrays and metadata."""
    from znicz_torch.snapshotter import Snapshotter

    for label in CKPT_SAVES:
        recs = [r[label] for r in two_ranks]
        assert_ranks_equal(recs)
        assert recs[0]["files"] == ["mnist_best.orbax",
                                    "mnist_epoch_1.orbax",
                                    "mnist_epoch_3.orbax"]
        assert len(recs[0]["losses"]) == 8
        chunks = _chunks(_epoch1(ckpt_dir, label))
        split = label == "save_m2"
        for fqn, got in chunks.items():
            if split and fqn.endswith(("fwd0.weights", "fwd0.bias",
                                       "gd0.weights", "gd0.bias")):
                assert [c[:2] for c in got] == [(0, 512), (512, 512)], fqn
                assert got[0][2] != got[1][2], fqn
            else:
                assert len(got) == 1 and got[0][0] == 0, (fqn, got)
        snap = Snapshotter.load(_epoch1(ckpt_dir, label))
        assert snap["epoch"] == 1
        assert snap["units"]["fwd0"]["weights"].shape == (1024, 784)
        assert snap["velocities"]["gd0"]["weights"].shape == (1024, 784)


@pytest.mark.parametrize("label", list(CKPT_RESUMES))
def test_sharded_snapshot_restores_on_any_mesh(label, two_ranks, ckpt_dir,
                                              tmp_path):
    """A fresh pair restores the epoch-1 snapshot with
    ``restore_sharded``, on the mesh that saved it and on the other
    shape: every leaf as restored (gathered whole) is the file's, each
    rank holds its own rows, the ranks stay bit-equal, and the run's
    last two epochs are the saving pair's within ``LOSS_RTOL``.  One
    process restores the same directory and finishes within the same
    band."""
    from znicz_torch.snapshotter import Snapshotter

    save, shape = CKPT_RESUMES[label]
    path = _epoch1(ckpt_dir, save)
    snap = Snapshotter.load(path)
    want = two_ranks[0][save]["losses"][4:]
    recs = [r[label] for r in two_ranks]
    assert_ranks_equal(recs)
    for rec in recs:
        assert rec["meta_epoch"] == 1
        assert rec["mesh_shape"] == {"data": shape[0], "model": shape[1]}
        assert rec["shapes"]["fwd0"]["weights"] == (1024 // shape[1], 784)
        for group in ("units", "velocities"):
            for name, leaves in snap[group].items():
                for k, a in leaves.items():
                    np.testing.assert_array_equal(
                        rec["restored"][group][name][k], a)
    np.testing.assert_allclose(recs[0]["losses"], want, rtol=LOSS_RTOL)
    one = run_sharded_restore(None, str(tmp_path), path)
    np.testing.assert_allclose(one["losses"], want, rtol=LOSS_RTOL)
    for name, leaves in snap["units"].items():
        for k, a in leaves.items():
            np.testing.assert_array_equal(one["restored"]["units"][name][k],
                                          a)


def test_reference_orbax_directory_restores_on_a_mesh(two_ranks, ckpt_dir):
    """The reference's orbax directory (OCDBT + zarr, read through
    ``tensorstore``) restores with ``restore_sharded`` onto (1, 2): each
    rank holds its 512 rows, every leaf gathered back is the reference's
    own load's, and the pair trains on from it, bit-equal across ranks."""
    from znicz_tpu.snapshotter import Snapshotter as JSnapshotter

    want = JSnapshotter.load(str(ckpt_dir / "ref_start.orbax"))
    recs = [r["resume_ref_on_m2"] for r in two_ranks]
    assert_ranks_equal(recs)
    for rec in recs:
        assert rec["shapes"]["fwd0"]["weights"] == (512, 784)
        for group in ("units", "velocities"):
            for name, leaves in want[group].items():
                for k, a in leaves.items():
                    np.testing.assert_array_equal(
                        rec["restored"][group][name][k], np.asarray(a))
    losses = recs[0]["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_mesh_refusals_inside_a_group(two_ranks):
    """In a group of two: a (4, 1) mesh names ``distributed_init`` and the
    four ranks it needs; a (1, 1) mesh, which covers one rank of two, is
    refused."""
    got = two_ranks[0]["refusals"]
    assert "needs 4 ranks" in got[(4, 1)] and "distributed_init" in \
        got[(4, 1)]
    assert "spans the world" in got[(1, 1)]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           [tuple(s) for s in json.loads(sys.argv[5])])
