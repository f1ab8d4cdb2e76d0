"""The port's dataset loaders, config reader and command-line helpers
(``ultra_tpu_torch/data``, ``utils/config.py``, ``train/runner.py``,
``utils/ckpt.py``) against the JAX package's, on raw toy files written to a
temporary directory and on the rule-KG caches in the repo's
``kg-datasets/``, which are only read. Every comparison is exact: the
loaders are integer and string work.
"""

import os
import sys

import jax
import numpy as np
import pytest

from ultra_tpu.data import kg as jkg
from ultra_tpu.data import synthetic as jsynthetic
from ultra_tpu.train import runner as jrunner
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu.utils import config as jconfig
from ultra_tpu.utils.torch_ckpt import export_ultra_checkpoint
from ultra_tpu_torch.data import kg, synthetic
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.train import runner
from ultra_tpu_torch.utils import ckpt, config
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the in-repo rule-KG with the most edges, and its constructor keys
SYNTHRULE = dict(num_nodes=5000, num_base_rel=12, num_comp_rel=6, num_base_triples=45000,
                 seed=3)


def assert_same_dataset(got, want):
    assert got.name == want.name
    for split in ("train", "valid", "test"):
        a, b = getattr(got, split), getattr(want, split)
        assert a.num_nodes == b.num_nodes and a.num_relations == b.num_relations, split
        for field in ("edge_index", "edge_type", "target_edge_index", "target_edge_type"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, (split, field)
            np.testing.assert_array_equal(x, y, err_msg=f"{split}.{field}")


def _write(raw, names, lines, sep):
    raw.mkdir(parents=True)
    cuts = np.linspace(0, len(lines), len(names) + 1).astype(int)
    for name, lo, hi in zip(names, cuts[:-1], cuts[1:]):
        (raw / name).write_text("".join(sep.join(l) + "\n" for l in lines[lo:hi]))


def _toy_lines(seed, n=90, hrt=True):
    """Triples over a vocabulary that grows in valid and test (new entities
    and a new relation late in the file)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        h, t = f"e{rng.integers(10 + i // 6)}", f"e{rng.integers(10 + i // 6)}"
        r = f"r{rng.integers(3 + i // 40)}"
        lines.append((h, r, t) if hrt else (h, t, r))
    return lines


@pytest.mark.parametrize("cls_name", ["FB15k237", "ConceptNet100k", "NELL23k", "NELL995"])
def test_transductive_loaders_match_jax(tmp_path, cls_name):
    """Each family's processing of the same raw files: whitespace (FB15k237),
    tab (ConceptNet100k), (h, t, r) columns (the SparserKG family) and facts
    merged into train (NELL995). Then ``load`` caches, and the JAX package
    reads the port's cache as its own."""
    port, jax_cls = kg.DATASETS[cls_name](str(tmp_path)), jkg.DATASETS[cls_name]
    raw = tmp_path / os.path.relpath(port.raw_dir, tmp_path)
    sep = "\t" if port.delimiter == "\t" else " "
    _write(raw, port.raw_file_names, _toy_lines(len(cls_name), hrt=port.col_order == "hrt"),
           sep)
    want = jax_cls(str(tmp_path)).process()
    assert_same_dataset(port.process(), want)
    assert not os.path.exists(port.processed_path)
    assert_same_dataset(port.load(), want)
    assert_same_dataset(jkg._load_dataset(port.processed_path), want)
    assert_same_dataset(port.load(), want)  # from the cache


def test_synthrule_cache_in_the_repo_is_read_as_jax_reads_it():
    """``SyntheticRuleKG.load`` on the repo's cache: the JAX package's
    arrays, and nothing under kg-datasets/ is written."""
    root = os.path.join(REPO, "kg-datasets")
    before = {p: os.stat(os.path.join(d, p)).st_mtime_ns
              for d, _, files in os.walk(root) for p in files}
    ds = kg.build_dataset("SyntheticRuleKG", root, **SYNTHRULE)
    assert ds.name == "synthrule-v5000-b12-c6-e45000-s3"
    got = ds.load()
    want = jkg.build_dataset("SyntheticRuleKG", root, **SYNTHRULE).load()
    assert_same_dataset(got, want)
    # 4,326 of the 5,000 entities appear in a triple; 136,010 train triples
    assert got.train.num_nodes == 4326 and got.train.edge_index.shape[1] == 272020
    after = {p: os.stat(os.path.join(d, p)).st_mtime_ns
             for d, _, files in os.walk(root) for p in files}
    assert after == before


def test_rule_kg_splits_match_jax():
    args = (300, 6, 3, 2000)
    for seed in (0, 5):
        got = synthetic.rule_kg_splits(*args, seed=seed, categories=4)
        want = jsynthetic.rule_kg_splits(*args, seed=seed, categories=4)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]


def test_synthetic_rule_kg_download_and_process_match_jax(tmp_path):
    """A rule-KG made from scratch: the raw files the port writes, and the
    dataset it processes from them, are the JAX package's."""
    keys = dict(num_nodes=300, num_base_rel=6, num_comp_rel=3, num_base_triples=2000,
                seed=2, categories=4)
    port = kg.SyntheticRuleKG(str(tmp_path / "port"), **keys)
    ref = jkg.SyntheticRuleKG(str(tmp_path / "jax"), **keys)
    port.download()
    ref.download()
    for a, b in zip(port.raw_paths(), ref.raw_paths()):
        assert open(a).read() == open(b).read()
    assert_same_dataset(port.load(), ref.load())


def test_unported_dataset_classes_raise():
    """Every dataset class of the JAX package is ported, the pretraining
    mixture too: ``build_dataset`` gives a ``JointDataset`` of the named
    members, as the JAX package's does (its loading is
    ``test_torch_pretrain.py::test_joint_dataset_matches_jax``)."""
    assert not hasattr(kg, "UNPORTED")
    assert set(kg.DATASETS) == set(jkg.DATASETS)
    members = ["FB15k237", {"class": "SyntheticRuleKG", "seed": 3}]
    got = kg.build_dataset("JointDataset", "unused", graphs=members)
    want = jkg.build_dataset("JointDataset", "unused", graphs=members)
    assert isinstance(got, kg.JointDataset)
    assert (got.root, got.graph_names) == (want.root, want.graph_names)
    assert set(kg.JointDataset.datasets_map) == set(jkg.JointDataset.datasets_map)


@pytest.mark.parametrize("limit_vocab,require_known_rel",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_load_file_flags_match_jax(tmp_path, limit_vocab, require_known_rel):
    """``load_file`` into vocabularies that a first file made: MTDEA's
    ``limit_vocab`` drops the triples with an unseen token, GraIL's
    ``require_known_rel`` refuses an unseen relation (the port with
    ValueError, the JAX package with AssertionError); the triples and the
    grown vocabularies are the JAX package's."""
    first, second = tmp_path / "first.txt", tmp_path / "second.txt"
    first.write_text("a\tr0\tb\nb\tr1\tc\n")
    second.write_text("a\tr1\tc\nq\tr0\ta\nc\tr2\ta\nb\tr0\tz\n")

    def read(load_file):
        vocab = load_file(str(first), {}, {}, "\t")
        return load_file(str(second), vocab["inv_entity_vocab"], vocab["inv_rel_vocab"], "\t",
                         limit_vocab=limit_vocab, require_known_rel=require_known_rel)

    if require_known_rel and not limit_vocab:  # r2 is new
        with pytest.raises(AssertionError, match="unknown relation 'r2'"):
            read(jkg.load_file)
        with pytest.raises(ValueError, match="unknown relation 'r2'"):
            read(kg.load_file)
        return
    got, want = read(kg.load_file), read(jkg.load_file)
    assert got == want
    assert len(got["triplets"]) == (1 if limit_vocab else 4)


def test_config_renders_as_jax(tmp_path, monkeypatch):
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text(
        "dataset:\n  class: {{ dataset }}\n  root: ./kg-datasets/\n"
        "model:\n  entity_model: {hidden_dims: [8, 8], layer_norm: yes}\n"
        "train:\n  num_epoch: {{ epochs }}\n  batch_per_epoch: {{ bpe }}\n"
        "checkpoint: {{ ckpt }}\n")
    assert config.detect_variables(str(cfg_file)) == jconfig.detect_variables(str(cfg_file))
    for argv, optional in ((["--dataset", "FB15k237", "--epochs", "2", "--bpe", "null",
                             "--ckpt", "m.pth"], False),
                           (["--dataset", "CoDExSmall"], True)):
        monkeypatch.setattr(sys, "argv", ["prog", "-c", str(cfg_file), "-s", "7", *argv])
        args, vars_ = config.parse_args(optional_vars=optional)
        jargs, jvars = jconfig.parse_args(optional_vars=optional)
        assert vars(args) == vars(jargs) and vars_ == jvars
        cfg = config.load_config(str(cfg_file), vars_)
        assert cfg == jconfig.load_config(str(cfg_file), jvars)
        assert cfg.model.entity_model.hidden_dims == [8, 8]


def test_model_config_and_checkpoint_load_as_jax(tmp_path):
    """``model_config_from_dict`` gives the JAX package's configuration, and
    ``load_model_checkpoint`` reads a .pth that the JAX package exported into
    the port's model; anything but a .pth is refused."""
    model_cfg = {
        "class": "Ultra",
        "relation_model": {"class": "RelNBFNet", "input_dim": 8, "hidden_dims": [8, 8],
                           "message_func": "transe", "aggregate_func": "pna",
                           "precision": "highest"},
        "entity_model": {"class": "EntityNBFNet", "input_dim": 8, "hidden_dims": [8],
                         "short_cut": False, "num_mlp_layer": 3, "concat_hidden": True},
    }
    got, want = runner.model_config_from_dict(model_cfg), jrunner.model_config_from_dict(model_cfg)
    for model in ("relation_model", "entity_model"):
        a, b = getattr(got, model), getattr(want, model)
        for field in a.__dataclass_fields__:
            assert getattr(a, field) == getattr(b, field), (model, field)
    bf16 = {"relation_model": {"compute_dtype": "bfloat16"},
            "entity_model": {"compute_dtype": "bfloat16"}}
    got16, want16 = runner.model_config_from_dict(bf16), jrunner.model_config_from_dict(bf16)
    for model in ("relation_model", "entity_model"):
        assert getattr(got16, model).compute_dtype == getattr(want16, model).compute_dtype
        assert getattr(got16, model).compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        runner.model_config_from_dict(
            {"relation_model": {"compute_dtype": "float16"}, "entity_model": {}})

    params = jax.tree.map(np.asarray, jax_init_ultra_params(want, jax.random.key(2)))
    path = tmp_path / "model.pth"
    export_ultra_checkpoint(params, str(path))
    sd = ckpt.load_model_checkpoint(str(path))
    model = Ultra(got)
    model.load_state_dict(sd)
    expected = params_from_jax(params)
    assert sd.keys() == expected.keys()
    assert all(np.array_equal(sd[k].numpy(), expected[k].numpy()) for k in sd)
    (tmp_path / "orbax").mkdir()
    for bad in (tmp_path / "orbax", tmp_path / "model.npz"):
        with pytest.raises(ValueError, match="orbax"):
            ckpt.load_model_checkpoint(str(bad))


@pytest.mark.parametrize("flag", [None, False, True])
def test_model_config_carries_remove_one_hop_as_jax(flag):
    """``entity_model.remove_one_hop`` reaches the port's configuration as it
    reaches the JAX package's: absent is False, and the relation model
    keeps its own value."""
    entity = {"input_dim": 8, "hidden_dims": [8]}
    if flag is not None:
        entity["remove_one_hop"] = flag
    model_cfg = {"relation_model": {"input_dim": 8, "hidden_dims": [8]}, "entity_model": entity}
    got, want = runner.model_config_from_dict(model_cfg), jrunner.model_config_from_dict(model_cfg)
    assert got.entity_model.remove_one_hop is want.entity_model.remove_one_hop is bool(flag)
    assert got.relation_model.remove_one_hop is want.relation_model.remove_one_hop is False


def test_prepare_graph_pads_as_jax():
    split = kg.build_dataset("SyntheticRuleKG", os.path.join(REPO, "kg-datasets"),
                             num_nodes=1500, num_base_rel=40, num_comp_rel=20,
                             num_base_triples=14000, seed=4).load().test
    jsplit = jkg.KGSplit(*split)
    graph = runner.prepare_graph(split, device="cpu")
    jgraph = jrunner.prepare_graph(jsplit, with_plans=False)
    for a, b in ((graph, jgraph), (graph.relation_graph, jgraph.relation_graph)):
        np.testing.assert_array_equal(a.edge_index.numpy(), np.asarray(b.edge_index))
        np.testing.assert_array_equal(a.edge_type.numpy(), np.asarray(b.edge_type))
        np.testing.assert_array_equal(a.edge_weight.numpy(), np.asarray(b.edge_weight))
        assert a.num_nodes == b.num_nodes and a.num_relations == b.num_relations
