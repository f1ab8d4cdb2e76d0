"""The port's inductive dataset families (``ultra_tpu_torch/data/kg.py``)
against the JAX package's, on toy raw files written to a temporary
directory: InGram's layout, ILPC2022, HM, GraIL and MTDEA. Every comparison
is exact: the loaders are integer and string work.
"""

import os

import numpy as np
import pytest
import torch

from ultra_tpu.data import kg as jkg
from ultra_tpu_torch.data import kg
from ultra_tpu_torch.ops.rspmm_cuda import rspmm_sum_fwd
from ultra_tpu_torch.train import runner

from tests.test_torch_data import assert_same_dataset


def _lines(rng, n, ent, num_ent, rel_names):
    """``n`` (h, r, t) token triples over entities ``<ent><i>``, i < num_ent."""
    return [(f"{ent}{rng.integers(num_ent)}", str(rng.choice(rel_names)),
             f"{ent}{rng.integers(num_ent)}") for _ in range(n)]


def _save(path, lines, sep):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(sep.join(line) + "\n" for line in lines))


def write_inductive(ds, seed=0, sep="\t", extra_test_rel=False):
    """Raw files for ``ds`` in its own layout. InductiveDataset families:
    a training graph over entities ``a*`` and relations r0-r3, an inference
    graph over ``b*`` and r0-r4, and validation and test triples with a few
    entities and (but for HM) a relation their graph lacks (a new
    vocabulary entry, or a dropped triple under MTDEA's ``limit_vocab``). GraIL: tab-separated
    transductive files over ``a*`` and inductive ones over ``b*`` with the
    transductive relations, or one more (``extra_test_rel``), which the
    loader refuses."""
    rng = np.random.default_rng(seed)
    paths = ds.raw_paths()
    rels = [f"r{i}" for i in range(4)]
    if isinstance(ds, kg.GrailInductiveDataset):
        test_rels = rels + ["rX"] if extra_test_rel else rels[:3]
        for path, lines in zip(paths, (
                _lines(rng, 30, "b", 10, rels[:3]), _lines(rng, 5, "b", 10, rels[:3]),
                _lines(rng, 6, "b", 12, test_rels), _lines(rng, 40, "a", 12, rels),
                _lines(rng, 6, "a", 13, rels))):
            _save(path, lines, "\t")
        return
    valid_ent = "b" if ds.valid_on_inf else "a"
    # HM validates on the training graph with its relations only: a new one
    # would have no relation vector there (in either package)
    valid_rels = rels if isinstance(ds, kg.HM) else rels + ["r5"]
    for path, lines in zip(paths, (
            _lines(rng, 40, "a", 12, rels), _lines(rng, 36, "b", 10, rels + ["r4"]),
            _lines(rng, 8, valid_ent, 14, valid_rels), _lines(rng, 8, "b", 12, rels))):
        _save(path, lines, sep)


FAMILIES = [
    ("FBIngram", {"version": "v1"}),
    ("NLIngram", {"version": 2}),
    ("ILPC2022", {"version": "small"}),
    ("HM", {"version": "1k"}),
    ("FB15k237Inductive", {"version": "v1"}),
    ("NELLInductive", {"version": "v3", "merge_valid_test": False}),
    ("FBNELL", {}),
    ("Metafam", {}),
    ("WikiTopicsMT2", {"version": "org"}),
]


@pytest.mark.parametrize("cls_name,keys", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_inductive_family_matches_jax(tmp_path, cls_name, keys):
    """All four splits of each family equal the JAX package's, array for
    array, from the same raw files; then each package reads the other's
    cache as its own."""
    root = str(tmp_path)
    port = kg.build_dataset(cls_name, root, **keys)
    ref = jkg.build_dataset(cls_name, root, **keys)
    assert port.raw_paths() == ref.raw_paths() and port.processed_path == ref.processed_path
    write_inductive(port, seed=len(cls_name), sep=" " if cls_name == "ILPC2022" else "\t")
    want = ref.process()
    assert_same_dataset(port.process(), want)
    assert_same_dataset(port.load(), want)  # processes and writes the cache
    assert_same_dataset(jkg._load_dataset(port.processed_path), want)
    os.unlink(port.processed_path)
    assert_same_dataset(ref.load(), want)  # the JAX package writes it
    assert_same_dataset(port.load(), want)


def test_inductive_splits_have_the_families_graphs(tmp_path):
    """What the families differ by, on the toys: InGram validates on the
    inference graph; HM on the training graph with the validation
    vocabulary's node count; MTDEA drops the validation triples with unseen
    tokens; GraIL merges the inductive validation and test triples."""
    root = str(tmp_path)
    ds = {}
    for name, keys in (("FBIngram", {"version": "v1"}), ("HM", {"version": "1k"}),
                       ("FBNELL", {}), ("FB15k237Inductive", {"version": "v1"})):
        port = kg.build_dataset(name, root, **keys)
        write_inductive(port)
        ds[name] = port.load()
    ingram, hm, mtdea, grail = (ds[n] for n in ds)
    np.testing.assert_array_equal(ingram.valid.edge_index, ingram.test.edge_index)
    # r0-r3 with inverses; r0-r4 and the validation file's r5
    assert ingram.train.num_relations == 8 and ingram.test.num_relations == 12
    np.testing.assert_array_equal(hm.valid.edge_index, hm.train.edge_index)
    assert hm.valid.num_nodes > hm.train.num_nodes
    assert mtdea.valid.num_nodes == mtdea.train.num_nodes
    assert mtdea.valid.target_edge_index.shape[1] < 8
    assert mtdea.valid.target_edge_type.max() < mtdea.train.num_relations // 2
    assert grail.test.target_edge_index.shape[1] == 5 + 6
    assert grail.name == "IndFB15k237-v1" and hm.name == "hm-Hamaguchi-BM_both-1000"


def test_unknown_relation_and_versions_raise(tmp_path):
    """GraIL's inductive files may not add a relation: the port raises
    ValueError where the JAX package raises AssertionError. An unknown
    version raises ValueError too (the JAX package asserts or looks it up)."""
    root = str(tmp_path)
    port = kg.FB15k237Inductive(root, "v2")
    write_inductive(port, extra_test_rel=True)
    with pytest.raises(AssertionError, match="unknown relation 'rX'"):
        jkg.FB15k237Inductive(root, "v2").process()
    with pytest.raises(ValueError, match="unknown relation 'rX'"):
        port.process()
    for cls, bad in ((kg.FB15k237Inductive, "v9"), (kg.HM, "2k"), (kg.WikiTopicsMT1, "org")):
        with pytest.raises(ValueError, match="unknown"):
            cls(root, bad)


def test_hm_validation_graph_rows_without_edges_are_zero(tmp_path):
    """HM's validation graph is the training graph with the validation
    vocabulary's extra nodes, which no edge touches: their CSR rows are
    empty, each one piece of no edges that writes its own output row, and
    the sum rspmm gives them 0, exactly."""
    port = kg.HM(str(tmp_path), "1k")
    write_inductive(port)
    split = port.load().valid
    graph = runner.prepare_graph(split, device="cpu")
    extra = torch.arange(int(split.edge_index.max()) + 1, split.num_nodes)
    assert len(extra) > 0 and graph.num_nodes == split.num_nodes
    counts = graph.csr.rowptr.diff()
    assert (counts[extra] == 0).all() and (counts > 0).any()
    pieces = torch.isin(graph.csr.piece_row, extra)
    assert int(pieces.sum()) == len(extra)
    assert (graph.csr.piece_ptr.diff()[pieces] == 0).all()
    assert (graph.csr.piece_slot[pieces] == -1).all()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(graph.num_nodes, 16, generator=gen)
    rel = torch.randn(graph.num_relations, 16, generator=gen)
    out = rspmm_sum_fwd(graph.csr, graph.edge_weight, rel, x, "mul")
    assert out.shape == x.shape and (out[extra] == 0).all() and (out != 0).any()
