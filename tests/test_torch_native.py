"""The port's native join of the graph of relations
(``ultra_tpu_torch/native``) and ``tasks.build_relation_graph_arrays``
against the port's numpy join and the JAX package's two joins
(``ultra_tpu/native`` and the numpy one of ``ultra_tpu/tasks.py``).

The four must give equal int64 arrays, element for element and in order
(``tasks.RelGraphMasker`` and the query trainer rely on the order), with and
without a ``live`` mask, on random KGs with inverses and on the repo's
BetaE query graph (``query-datasets-synth-held``). A compiler that is found
but fails raises with its output; only a missing ``g++`` takes the numpy
join.
"""

import os
import threading

import numpy as np
import pytest

import ultra_tpu.native as jnative
from ultra_tpu import tasks as jtasks
from ultra_tpu.data.synthetic import random_kg_triples, with_inverses
from ultra_tpu_torch import native, tasks
from ultra_tpu_torch.query.datasets import build_query_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_graph(num_nodes, num_rel, num_triples, seed):
    ei, et = with_inverses(random_kg_triples(num_nodes, num_rel, num_triples, seed=seed), num_rel)
    return ei, et, num_nodes, 2 * num_rel


@pytest.fixture(scope="module")
def graphs():
    qg = build_query_dataset("FB15k237LogicalQuery",
                             os.path.join(REPO, "query-datasets-synth-held")).load().graphs[2]
    return {
        "small": random_graph(60, 7, 250, seed=4),
        # nodes no edge touches and relations no edge has
        "sparse": random_graph(500, 40, 120, seed=1),
        "dense": random_graph(300, 20, 6000, seed=2),
        "query": (qg.edge_index, qg.edge_type, qg.num_nodes, qg.num_relations),
    }


def jax_numpy_join(ei, et, v, r, live, monkeypatch):
    monkeypatch.setattr(jnative, "relgraph_build_native", lambda *a, **k: None)
    out = jtasks.build_relation_graph_arrays(ei, et, v, r, live)
    monkeypatch.undo()
    return out


def assert_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == np.int64 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["small", "sparse", "dense", "query"])
def test_four_joins_agree_in_order(graphs, name, masked, monkeypatch):
    ei, et, v, r = graphs[name]
    live = np.random.default_rng(0).random(ei.shape[1]) >= 0.25 if masked else None
    assert native.available()
    want = tasks.relation_graph_arrays_numpy(ei, et, v, r, live)
    assert want[0].shape[1] > 0
    assert_equal(native.relgraph_build_native(ei, et, v, r, live), want)
    assert_equal(tasks.build_relation_graph_arrays(ei, et, v, r, live), want)
    jax_native = jnative.relgraph_build_native(ei, et, v, r, live)
    assert jax_native is not None, "the JAX package's native join did not build"
    assert_equal(jax_native, want)
    assert_equal(jax_numpy_join(ei, et, v, r, live, monkeypatch), want)


def test_masker_order_on_the_native_join(graphs):
    """RelGraphMasker's base edges are the native join's, and a dropout
    round's weights keep exactly the edges of the join of the live edges."""
    ei, et, v, r = graphs["small"]
    masker = tasks.RelGraphMasker(ei, et, v, r)
    dropped = np.random.default_rng(3).choice(ei.shape[1], 60, replace=False)
    live = np.ones(ei.shape[1], bool)
    live[dropped] = False
    kept = masker.edge_weights(dropped) > 0
    rei, ret = native.relgraph_build_native(ei, et, v, r, live)
    base = np.stack([masker.rel_type, masker.rel_src, masker.rel_dst])
    np.testing.assert_array_equal(base[:, kept], np.stack([ret, rei[0], rei[1]]))


def test_threads_share_the_library(graphs):
    """The library stages each result in buffers shared between its two
    calls, and ctypes drops the GIL: 16 threads on 4 graphs at once each
    get their own graph's arrays."""
    names = ["small", "sparse", "dense", "small"]
    want = {n: tasks.relation_graph_arrays_numpy(*graphs[n]) for n in set(names)}
    errors = []

    def work(name):
        try:
            for _ in range(5):
                assert_equal(native.relgraph_build_native(*graphs[name]), want[name])
        except AssertionError as exc:  # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(names[i % 4],)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


def test_out_of_range_edges_are_refused(graphs):
    ei, et, v, r = graphs["small"]
    with pytest.raises(ValueError, match="out of range"):
        native.relgraph_build_native(ei, et, v - 1, r)
    with pytest.raises(ValueError, match="out of range"):
        native.relgraph_build_native(ei, et, v, r - 1)
    with pytest.raises(ValueError, match="live"):
        native.relgraph_build_native(ei, et, v, r, live=np.ones(3, bool))


def fresh_build(monkeypatch, tmp_path, path):
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", path)


def test_a_failing_compiler_raises(graphs, tmp_path, monkeypatch):
    """A ``g++`` that is found but fails raises with its output (the JAX
    package's loader falls back to numpy silently)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text('#!/bin/sh\n[ "$1" = --version ] && { echo "g++ 0.0"; exit 0; }\n'
                   'echo "relgraph.cpp:1: error: broken compiler" >&2\nexit 1\n')
    gxx.chmod(0o755)
    fresh_build(monkeypatch, tmp_path, str(bin_dir))
    with pytest.raises(RuntimeError, match="broken compiler"):
        tasks.build_relation_graph_arrays(*graphs["small"])
    assert not list((tmp_path / "build").glob("*"))  # no half-built library left


def test_no_compiler_takes_numpy(graphs, tmp_path, monkeypatch):
    fresh_build(monkeypatch, tmp_path, str(tmp_path / "empty"))
    assert not native.available()
    assert native.relgraph_build_native(*graphs["small"]) is None
    assert_equal(tasks.build_relation_graph_arrays(*graphs["small"]),
                 tasks.relation_graph_arrays_numpy(*graphs["small"]))


def test_the_library_is_built_once_into_the_checkout(tmp_path, monkeypatch):
    fresh_build(monkeypatch, tmp_path, os.environ["PATH"])
    assert native.available()
    built = list((tmp_path / "build").glob("librelgraph-*.so"))
    assert len(built) == 1
    monkeypatch.setattr(native, "_LIB", None)
    mtime = built[0].stat().st_mtime_ns
    assert native.available()
    assert built[0].stat().st_mtime_ns == mtime  # loaded, not rebuilt
