"""The port's unit graph (``core/mutable``, ``core/units``,
``core/workflow``) against the reference's, scenario by scenario.

Each scenario runs on both packages' classes (the reference's core is
JAX-free) and must give the same observations:

  - ``Bool``: ``~``, ``&`` and ``|`` are evaluated when read; ``set``
    detaches an expression;
  - ``Array``: host and device halves kept coherent through
    ``map_read``, ``map_write``, ``map_invalidate`` and ``devmem``;
  - ``link_attrs``: reads alias the source; writing a one-way link
    detaches it; a two-way link forwards the write;
  - ``gate_skip`` (run nothing, propagate) and ``gate_block`` (propagate
    nothing); ``Repeater``'s ``gate_any`` fires once a wave when two
    predecessors fire in it; names are made unique; ``initialize``
    retries a unit whose links were not ready and chains a second
    failure to the first;
  - ``generate_graph()`` of the MNIST and CIFAR10 samples: the same unit
    names and edges in both packages.
"""

import importlib
import re

import numpy as np
import pytest

from test_torch_layers import jax_sample, port_sample, sample_config
from test_torch_samples import REDUCED

PKGS = ["znicz_torch", "znicz_tpu"]


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.core.mutable"),
            importlib.import_module(f"{pkg}.core.units"),
            importlib.import_module(f"{pkg}.core.workflow"))


@pytest.mark.parametrize("pkg", PKGS)
def test_bool_expressions_are_live(pkg):
    Bool = _mods(pkg)[0].Bool
    a, b = Bool(False), Bool(True)
    na, both, either = ~a, a & b, a | b
    assert [bool(na), bool(both), bool(either)] == [True, False, True]
    a.set(True)
    assert [bool(na), bool(both), bool(either)] == [False, True, True]
    b.set(False)
    assert [bool(both), bool(either), bool(~(a & b))] == [False, True, True]
    assert na.derived and not a.derived
    na.set(False)                     # a concrete value detaches
    a.set(False)
    assert not bool(na) and not na.derived


@pytest.mark.parametrize("pkg", PKGS)
def test_array_keeps_its_halves_coherent(pkg):
    Array = importlib.import_module(f"{pkg}.memory").Array
    a = Array()
    assert not a and a.shape == ()
    with pytest.raises(RuntimeError):
        a.map_read()
    a.mem = np.arange(6, dtype=np.float32).reshape(2, 3)
    a.initialize(None)
    assert a and a.shape == (2, 3) and a.dtype == np.float32
    dev = a.devmem                            # host -> device
    np.testing.assert_array_equal(np.asarray(dev), a.map_read())
    a.map_write()[0, 0] = 7.0                 # the host half is newer
    assert float(np.asarray(a.devmem)[0, 0]) == 7.0
    a.devmem = a.devmem * 2                   # the device half is newer
    np.testing.assert_array_equal(a.map_read()[0], [14.0, 2.0, 4.0])
    a.map_invalidate()[...] = -1.0            # overwritten whole
    assert (np.asarray(a.devmem) == -1.0).all() and a.dtype == np.float32


@pytest.mark.parametrize("pkg", PKGS)
def test_link_attrs_alias_detach_and_two_way(pkg):
    Unit = _mods(pkg)[1].Unit
    src, dst = Unit(name="src"), Unit(name="dst")
    src.x = 1
    dst.link_attrs(src, "x", ("y", "x"))
    src.x = 2
    assert (dst.x, dst.y) == (2, 2) and dst.has_linked_attr("y")
    dst.x = 5                         # one-way: the write detaches
    src.x = 3
    assert (dst.x, dst.y, src.x) == (5, 3, 3)
    dst.link_attrs(src, ("z", "x"), two_way=True)
    dst.z = 7
    assert (src.x, dst.y, dst.z) == (7, 7, 7)
    with pytest.raises(AttributeError, match="'dst'.*'nope'"):
        dst.nope


def _recorder(units_mod, log):
    class Rec(units_mod.TrivialUnit):
        def run(self):
            log.append(self.name)

    return Rec


@pytest.mark.parametrize("pkg", PKGS)
def test_gate_skip_propagates_and_gate_block_stops(pkg):
    mutable, units, workflow = _mods(pkg)
    log = []
    Rec = _recorder(units, log)
    wf = workflow.Workflow(name="wf")
    a, b, c = Rec(wf, name="a"), Rec(wf, name="b"), Rec(wf, name="c")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(b)
    wf.end_point.link_from(c)
    wf.initialize(device=None)
    b.gate_skip = mutable.Bool(True)
    wf.run()
    assert log == ["a", "c"] and bool(wf.stopped)
    assert (a.run_count, b.run_count, c.run_count) == (1, 0, 1)
    log.clear()
    b.gate_skip = mutable.Bool(False)
    b.gate_block = mutable.Bool(True)
    wf.run()
    assert log == ["a"] and not bool(wf.stopped)


@pytest.mark.parametrize("pkg", PKGS)
def test_repeater_fires_once_a_wave(pkg):
    """start -> repeater -> (a, b) -> repeater: a and b fire in one wave,
    the repeater once after them; the end point opens on a's third run."""
    mutable, units, workflow = _mods(pkg)
    done = mutable.Bool(False)

    class Counter(units.TrivialUnit):
        def run(self):
            done.set(self.run_count + 1 >= 3)

    wf = workflow.Workflow(name="wf")
    rep = workflow.Repeater(wf, name="repeater")
    a, b = Counter(wf, name="a"), units.TrivialUnit(wf, name="b")
    rep.link_from(wf.start_point)
    a.link_from(rep)
    b.link_from(rep)
    rep.link_from(a, b)
    wf.end_point.link_from(a)
    wf.end_point.gate_block = ~done
    wf.initialize(device=None)
    wf.run()
    assert (rep.run_count, a.run_count, b.run_count) == (4, 3, 3)
    assert wf.end_point.run_count == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_names_are_made_unique(pkg):
    _, units, workflow = _mods(pkg)
    wf = workflow.Workflow(name="wf")
    made = [units.Unit(wf, name="x") for _ in range(3)]
    assert [u.name for u in made] == ["x", "x_2", "x_3"]
    assert [u.name for u in wf] == ["start_point", "end_point", "x", "x_2",
                                    "x_3"]


@pytest.mark.parametrize("pkg", PKGS)
def test_initialize_retries_once_then_chains(pkg):
    _, units, workflow = _mods(pkg)

    class Src(units.Unit):
        def initialize(self, **kwargs):
            self.value = 42
            super().initialize(**kwargs)

    class Needs(units.Unit):
        def initialize(self, **kwargs):
            self.seen = self.linked     # AttributeError until src is set
            super().initialize(**kwargs)

    wf = workflow.Workflow(name="wf")
    needs = Needs(wf, name="needs")
    src = Src(wf, name="src")
    needs.link_attrs(src, ("linked", "value"))
    wf.initialize(device=None)
    assert needs.seen == 42 and needs.is_initialized

    broken = workflow.Workflow(name="broken")
    Needs(broken, name="never")
    with pytest.raises(AttributeError) as err:
        broken.initialize(device=None)
    assert isinstance(err.value.__cause__, AttributeError)


def _graph(dot):
    names = set(re.findall(r'^  "([^"]+)" \[shape=box\];$', dot, re.M))
    edges = set(re.findall(r'^  "([^"]+)" -> "([^"]+)";$', dot, re.M))
    return names, edges


@pytest.mark.parametrize("sample", ["mnist", "cifar"])
def test_sample_graphs_match_reference(sample, tmp_path):
    with sample_config(sample, **REDUCED[sample]):
        jwf = jax_sample(sample, tmp_path)
        twf = port_sample(sample, tmp_path)
    t_names, t_edges = _graph(twf.generate_graph())
    j_names, j_edges = _graph(jwf.generate_graph())
    assert t_names == j_names and t_edges == j_edges
    assert ("decision", "snapshotter") in t_edges
    assert ("gd0" if sample == "mnist" else "gd_conv_strict_relu_0",
            "repeater") in t_edges
    assert len(t_edges) == {"mnist": 11, "cifar": 25}[sample]
