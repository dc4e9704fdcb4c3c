"""The training mesh's single-process half (``znicz_torch/parallel/mesh.py``
and ``FusedTrainer(wf, mesh=...)``) on the CPU; the spawned ranks are
``tests/test_torch_multiprocess.py``'s.

  - the ``train_shard`` gate and its refusals (axes below 1, a mesh
    larger than the world), as ``tests/test_shard_training.py:88``;
  - the placement rule has one home (``:125``), and gives the
    reference's specs for the same shapes and mesh;
  - ``train_shard`` with a 1 × 1 mesh is the single device bit for bit
    (``:174``), through ``FusedTrainer`` and through ``engine.train``;
  - the per-rank rows, the padding, ``place_tree``;
  - ``distributed_init`` for one process, the rank's device.
"""

import pathlib
import types

import numpy as np
import pytest
import torch

from test_torch_layers import port_sample, sample_config

PKG = pathlib.Path(__file__).resolve().parents[1] / "znicz_torch"
_UNSET = object()

#: the reference's 1 × 1 run (``tests/test_shard_training.py:174``)
MNIST = {"loader__n_train": 120, "loader__n_valid": 60, "loader__n_test": 0,
         "loader__minibatch_size": 60, "decision__max_epochs": 2,
         "layers": [100, 10]}


@pytest.fixture
def engine_mesh():
    """Set the training mesh's knobs in both packages' trees for a test,
    and put the defaults back after it."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    def set_mesh(dp, mp=1, shard=True):
        for tree in (troot, jroot):
            tree.common.engine.train_shard = bool(shard)
            tree.common.engine.mesh.data = int(dp)
            tree.common.engine.mesh.model = int(mp)
    yield set_mesh
    for tree in (troot, jroot):
        tree.common.engine.train_shard = False
        delattr(tree.common.engine, "mesh")


def stub_mesh(dp, mp, d=0, m=0):
    """What the placement helpers read of a (dp, mp) mesh at coordinate
    (d, m): its dims' names and sizes and this rank's coordinates."""
    sizes, coords = {"data": dp, "model": mp}, {"data": d, "model": m}
    return types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        size=lambda i: sizes[("data", "model")[i]],
        get_local_rank=lambda axis: coords[axis])


def test_train_mesh_config_gate_and_refusals(engine_mesh):
    """Off by default and with ``train_shard`` off whatever the mesh knobs
    say, None at 1 × 1, in both packages; a mesh larger than this
    process's world of one names ``distributed_init``; axes below 1 name
    the training plane."""
    from znicz_torch.parallel.mesh import make_mesh, train_mesh_from_config
    from znicz_tpu.parallel.mesh import \
        train_mesh_from_config as jtrain_mesh_from_config

    assert train_mesh_from_config() is None
    engine_mesh(4, 2, shard=False)
    assert train_mesh_from_config() is None
    assert jtrain_mesh_from_config() is None
    engine_mesh(1, 1)
    assert train_mesh_from_config() is None
    assert jtrain_mesh_from_config() is None
    engine_mesh(4, 1)
    with pytest.raises(ValueError, match="needs 4 ranks.*distributed_init"):
        train_mesh_from_config()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((1, 2), ("data", "model"))
    engine_mesh(0, 2)
    with pytest.raises(ValueError, match="training mesh axes"):
        train_mesh_from_config()
    with pytest.raises(ValueError, match="training mesh axes"):
        jtrain_mesh_from_config()


def test_param_sharding_rule_has_exactly_one_home():
    """The rule's body (``>= tp_threshold`` and the divisibility check)
    is in ``parallel/mesh.py`` and nowhere else in the port; the trainer
    and the snapshotter import it."""
    owners = [p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
              if ">= tp_threshold" in p.read_text()]
    assert owners == ["parallel/mesh.py"], owners
    for user in ("parallel/fused.py", "snapshotter.py"):
        assert "from znicz_torch.parallel import mesh as mesh_mod" in \
            (PKG / user).read_text(), user


@pytest.mark.parametrize("dp,mp", [(8, 1), (4, 2), (2, 4)])
def test_param_sharding_matches_the_reference(dp, mp):
    """The port's spec of every AlexNet and MNIST parameter shape, and of
    shapes at the rule's edges, is the reference's ``PartitionSpec`` on
    conftest's virtual devices."""
    from znicz_torch.parallel.mesh import param_sharding
    from znicz_tpu.parallel.mesh import make_mesh
    from znicz_tpu.parallel.mesh import param_sharding as jparam_sharding

    jmesh = make_mesh((dp, mp), ("data", "model"))
    for shape in [(4096, 9216), (4096,), (4096, 4096), (1000, 4096),
                  (1000,), (1024, 784), (1024,), (1022, 784), (1023,),
                  (10, 1024), (96, 11, 11, 3), (2048, 3, 3, 8), (0,)]:
        arr = np.zeros(shape, np.float32)
        want = tuple(jparam_sharding(jmesh, arr).spec)
        got = param_sharding(stub_mesh(dp, mp), arr)
        assert got + (None,) * (len(want) - len(got)) == want, shape
    assert param_sharding(None, np.zeros((4096, 9216))) == ()


def test_local_rows_padding_and_cover():
    """Each data coordinate takes ``ceil(B / dp)`` columns; a column past
    B repeats the last index; the real columns cover the batch once."""
    from znicz_torch.parallel.mesh import local_rows, shard_index_rows

    for batch in (60, 61, 7, 1):
        mat = np.arange(2 * batch).reshape(2, batch) + 100
        for dp in (1, 2, 3, 4, 8):
            n = -(-batch // dp)
            seen = []
            for d in range(dp):
                row0, rows = local_rows(batch, dp, d)
                assert (row0, rows) == (d * n, n)
                part = shard_index_rows(mat, dp, d)
                assert part.shape == (2, n)
                real = max(0, min(n, batch - row0))
                np.testing.assert_array_equal(part[:, :real],
                                              mat[:, row0:row0 + real])
                assert (part[:, real:] == mat[:, -1:]).all()
                seen.extend(part[0, :real].tolist())
            assert seen == mat[0].tolist()


def test_place_tree_and_placement():
    """``place_tree`` keeps a rank's rows of the split leaves (numpy or
    torch) and every replicated leaf whole; a ``Placement`` cuts a full
    leaf the same way."""
    from znicz_torch.parallel.mesh import Placement, place_tree, \
        tree_shardings

    tree = {"fc6": {"weights": np.arange(4096 * 3).reshape(4096, 3),
                    "bias": torch.arange(4096.0)},
            "fc8": {"weights": np.ones((1000, 3)), "bias": np.ones(1000)}}
    mesh = stub_mesh(1, 4, m=2)
    specs = tree_shardings(mesh, tree)
    assert specs == {"fc6": {"weights": ("model", None),
                             "bias": ("model",)},
                     "fc8": {"weights": (), "bias": ()}}
    local = place_tree(mesh, tree)
    np.testing.assert_array_equal(local["fc6"]["weights"],
                                  tree["fc6"]["weights"][2048:3072])
    assert torch.equal(local["fc6"]["bias"], torch.arange(2048.0, 3072.0))
    assert local["fc8"]["weights"] is tree["fc8"]["weights"]
    place = Placement(mesh, specs["fc6"])
    np.testing.assert_array_equal(place.local("weights",
                                              tree["fc6"]["weights"]),
                                  local["fc6"]["weights"])


def test_mesh_shape_dict():
    from znicz_torch.parallel.mesh import mesh_shape_dict

    assert mesh_shape_dict(None) is None
    assert mesh_shape_dict(stub_mesh(2, 4)) == {"data": 2, "model": 4}


def test_distributed_init_for_one_process_and_the_rank_device():
    """One process joins no group; without a card a rank with no device
    named is refused before any group forms; the rank's device is what
    ``resolve_device(None)`` gives, unless the backend names the CPU."""
    import torch.distributed as dist

    from znicz_torch import backends
    from znicz_torch.core.config import root
    from znicz_torch.parallel.mesh import distributed_init, world_size

    distributed_init("file:///nowhere", 1, 0)
    assert not dist.is_initialized() and world_size() == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed_init("127.0.0.1:1", 2, 1)
        assert not dist.is_initialized()
    backends.set_process_device("cpu")
    try:
        assert backends.resolve_device(None) == torch.device("cpu")
        root.common.engine.backend = "cpu"
        assert backends.resolve_device(None) == torch.device("cpu")
    finally:
        backends.set_process_device(None)
        delattr(root.common.engine, "backend")
    assert backends.process_device() is None


def _run(tmp_path, mesh=None):
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_to_numpy

    wf = port_sample("mnist", tmp_path)
    trainer = FusedTrainer(wf, mesh=mesh)
    trainer.run()
    return list(wf.decision.train_losses), params_to_numpy(wf), trainer


def test_train_shard_mesh_1x1_is_bitexact_single_device(engine_mesh,
                                                        tmp_path):
    """``train_shard`` on with a 1 × 1 mesh resolves to None: the same
    losses and weights bit for bit, captured as one device is, through
    ``FusedTrainer`` and through ``engine.train``."""
    from znicz_torch import engine
    from znicz_torch.parallel.mesh import train_mesh_from_config
    from znicz_torch.weights import params_to_numpy

    with sample_config("mnist", **MNIST):
        l_off, w_off, t_off = _run(tmp_path / "off")
        engine_mesh(1, 1)
        mesh = train_mesh_from_config()
        assert mesh is None
        l_on, w_on, t_on = _run(tmp_path / "on", mesh)
        wf = port_sample("mnist", tmp_path / "engine")
        engine.train(wf, fused=True)
    assert t_on.mesh is None and t_on.mesh_shape is None
    assert t_on.uncaptured_reason is None
    assert l_on == l_off == list(wf.decision.train_losses)
    for w in (w_on, params_to_numpy(wf)):
        for name, leaves in w_off.items():
            for k, a in leaves.items():
                assert np.array_equal(w[name][k], a), f"{name}.{k}"
    assert t_on.stats["collectives"] == 0


def test_engine_refusals_on_one_process(engine_mesh, tmp_path):
    """``engine.train`` under ``train_shard`` with two data ranks in a
    world of one is refused naming ``distributed_init``, before anything
    trains; the unit engine refuses a mesh."""
    from znicz_torch import engine

    with sample_config("mnist", **MNIST):
        wf = port_sample("mnist", tmp_path)
        engine_mesh(2, 1)
        with pytest.raises(ValueError, match="distributed_init"):
            engine.train(wf, fused=True)
        engine_mesh(1, 1, shard=False)
        with pytest.raises(ValueError, match="unit engine"):
            engine.train(wf, fused=False, mesh=stub_mesh(2, 1))
    assert not list(wf.decision.train_losses)


def test_rank_rows_of_global_draws(tmp_path):
    """A trainer at data coordinate 1 of 2 over a batch of 5 (3 rows a
    rank, the last padding): a mask drawn at the global shape gives rows
    3 and 4 and a padded row of ones, a column-sharded one its columns
    too; offsets' padding is 0; this rank's rows sit at their global
    positions of a draw's input."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **MNIST):
        trainer = FusedTrainer(port_sample("mnist", tmp_path))
    trainer._dp, trainer._d, trainer._global_batch = 2, 1, 5
    full = torch.arange(5 * 8.0).reshape(5, 8)
    drawn = []

    def masks(step, index, shape, ratio):
        drawn.append(tuple(shape))
        return full[:, :shape[1]]
    rank_mask = trainer._rank_masks(masks)
    got = rank_mask(0, 1, (3, 8), 0.5)
    assert drawn[-1] == (5, 8)
    assert torch.equal(got, torch.cat([full[3:], torch.ones(1, 8)]))
    got = rank_mask(0, 1, (3, 4), 0.5, cols=(4, 8, 8))
    assert torch.equal(got, torch.cat([full[3:, 4:], torch.ones(1, 4)]))
    off = trainer._own_rows(torch.arange(5)[:, None], 3, fill=0)
    assert off[:, 0].tolist() == [3, 4, 0]
    placed = trainer._at_global_rows(torch.full((3, 2), 7.0))
    assert placed.shape == (5, 2)
    assert (placed[3:] == 7).all() and (placed[:3] == 1).all()
