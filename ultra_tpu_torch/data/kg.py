"""Knowledge-graph datasets: the transductive loaders, the split and
dataset records, and their device graphs.

Counterpart of ``ultra_tpu/data/kg.py`` (numpy and the standard library, a
copy of the JAX package's code rather than an import of it). A split's
message graph carries explicit inverse edges (type + num_rel); its targets
do not. Processed datasets are cached as ``<root>/<name>/processed_tpu/
data.npz`` in the JAX package's format, so both packages read one cache; a
cache that exists is only read.

Ported families: :class:`TransductiveDataset` and its datasets (FB15k237,
WN18RR, CoDEx, NELL995, ConceptNet100k, DBpedia100k, YAGO310, Hetionet,
AristoV4), the :class:`SparserKG` family, :class:`SyntheticRuleKG`, and the
inductive families: :class:`InductiveDataset` (four files, a training graph
and an inference graph with vocabularies of their own; InGram's FB, WK and
NL, ILPC2022 and HM), :class:`GrailInductiveDataset` (FB15k237, WN18RR and
NELL's GraIL splits) and :class:`MTDEAInductive` (FBNELL, Metafam and
WikiTopics MT1-MT4). The pretraining mixture (``JointDataset``) is ROADMAP
A9: :func:`build_dataset` raises for it. Downloads use urllib and fail with
a clear message with no network; raw files placed under the dataset's
``raw`` directory are used as they are.
"""

from __future__ import annotations

import logging
import os
import shutil
import urllib.request
import zipfile
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ultra_tpu_torch import tasks
from ultra_tpu_torch.graph import Graph, make_graph, pad_bucket


class KGSplit(NamedTuple):
    edge_index: np.ndarray  # (2, E) message graph WITH inverses
    edge_type: np.ndarray  # (E,)
    num_nodes: int
    num_relations: int  # including inverses (2x raw)
    target_edge_index: np.ndarray  # (2, T) supervision edges, no inverses
    target_edge_type: np.ndarray  # (T,)


class KGDataset(NamedTuple):
    name: str
    train: KGSplit
    valid: KGSplit
    test: KGSplit


def download(url: str, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        print(f"downloading {url} -> {path}")
        urllib.request.urlretrieve(url, path)
    except Exception as exc:  # noqa: BLE001
        raise RuntimeError(
            f"Could not download {url} ({exc}). This environment may have no "
            f"network access — place the file at {path} manually."
        ) from exc


def load_file(
    path: str,
    inv_entity_vocab: dict,
    inv_rel_vocab: dict,
    delimiter: Optional[str] = None,
    col_order: str = "hrt",  # 'hrt' standard | 'htr' SparserKG dumps
    limit_vocab: bool = False,
    require_known_rel: bool = False,
):
    """Vocab-accumulating triple reader; returns the (u, v, r) int triples
    in file order and the grown vocabularies (``datasets.py:258-285``).

    ``limit_vocab`` drops every triple with a token the vocabularies do not
    hold (MTDEA's validation files); ``require_known_rel`` raises
    ``ValueError`` on a relation they do not hold (GraIL's inductive
    files)."""
    triplets = []
    with open(path, "r", encoding="utf-8") as fin:
        for line in fin:
            parts = line.split() if delimiter is None else line.strip().split(delimiter)
            if not parts:
                continue
            if col_order == "hrt":
                u, r, v = parts
            else:
                u, v, r = parts
            if limit_vocab and (
                u not in inv_entity_vocab or v not in inv_entity_vocab or r not in inv_rel_vocab
            ):
                continue
            if u not in inv_entity_vocab:
                inv_entity_vocab[u] = len(inv_entity_vocab)
            if v not in inv_entity_vocab:
                inv_entity_vocab[v] = len(inv_entity_vocab)
            if r not in inv_rel_vocab:
                if require_known_rel:
                    raise ValueError(f"unknown relation {r!r} in {path}")
                inv_rel_vocab[r] = len(inv_rel_vocab)
            triplets.append((inv_entity_vocab[u], inv_entity_vocab[v], inv_rel_vocab[r]))
    return {
        "triplets": triplets,
        "num_node": len(inv_entity_vocab),
        "num_relation": len(inv_rel_vocab),
        "inv_entity_vocab": inv_entity_vocab,
        "inv_rel_vocab": inv_rel_vocab,
    }


def _edges(triplets: Sequence[Tuple[int, int, int]]):
    if len(triplets) == 0:
        return np.zeros((2, 0), np.int64), np.zeros(0, np.int64)
    arr = np.asarray(triplets, dtype=np.int64)
    return arr[:, :2].T.copy(), arr[:, 2].copy()


def with_inverses(edge_index, edge_type, num_raw_relations):
    """Append (t, h, r + R) inverse edges (``datasets.py:318-319``)."""
    ei = np.concatenate([edge_index, edge_index[::-1]], axis=1)
    et = np.concatenate([edge_type, edge_type + num_raw_relations])
    return ei, et


def _save_dataset(path: str, ds: KGDataset):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"name": np.asarray(ds.name)}
    for split_name, split in zip(("train", "valid", "test"), (ds.train, ds.valid, ds.test)):
        payload[f"{split_name}_edge_index"] = split.edge_index
        payload[f"{split_name}_edge_type"] = split.edge_type
        payload[f"{split_name}_num_nodes"] = np.asarray(split.num_nodes)
        payload[f"{split_name}_num_relations"] = np.asarray(split.num_relations)
        payload[f"{split_name}_target_edge_index"] = split.target_edge_index
        payload[f"{split_name}_target_edge_type"] = split.target_edge_type
    np.savez_compressed(path, **payload)


def _load_dataset(path: str) -> KGDataset:
    z = np.load(path, allow_pickle=False)
    splits = [
        KGSplit(
            edge_index=z[f"{s}_edge_index"],
            edge_type=z[f"{s}_edge_type"],
            num_nodes=int(z[f"{s}_num_nodes"]),
            num_relations=int(z[f"{s}_num_relations"]),
            target_edge_index=z[f"{s}_target_edge_index"],
            target_edge_type=z[f"{s}_target_edge_type"],
        )
        for s in ("train", "valid", "test")
    ]
    return KGDataset(str(z["name"]), *splits)


class RawDataset:
    """What every family shares: raw files under ``<dataset_dir>/raw``
    (downloaded when missing) and one processed cache,
    ``<dataset_dir>/processed_tpu/data.npz``, which is read when it exists
    and never rewritten."""

    name: str = ""
    urls: Sequence[str] = ()
    raw_file_names: Sequence[str] = ()

    @property
    def dataset_dir(self):
        return os.path.join(self.root, self.name)

    @property
    def raw_dir(self):
        return os.path.join(self.dataset_dir, "raw")

    @property
    def processed_path(self):
        return os.path.join(self.dataset_dir, "processed_tpu", "data.npz")

    def raw_paths(self):
        return [os.path.join(self.raw_dir, f) for f in self.raw_file_names]

    def address(self, url: str) -> str:
        """The address of one of ``urls`` for this dataset."""
        return url

    def download(self):
        for url, path in zip(self.urls, self.raw_paths()):
            if not os.path.exists(path):
                download(self.address(url), path)

    def load(self) -> KGDataset:
        """The cached dataset if there is one; else the raw files
        (downloaded if missing) processed and cached."""
        if os.path.exists(self.processed_path):
            return _load_dataset(self.processed_path)
        if not all(os.path.exists(p) for p in self.raw_paths()):
            self.download()
        ds = self.process()
        _save_dataset(self.processed_path, ds)
        return ds

    def process(self) -> KGDataset:
        raise NotImplementedError


class TransductiveDataset(RawDataset):
    """3 splits sharing the train message graph (``datasets.py:240-353``)."""

    delimiter: Optional[str] = None
    col_order: str = "hrt"
    raw_file_names = ("train.txt", "valid.txt", "test.txt")

    def __init__(self, root: str, **kwargs):
        self.root = os.path.expanduser(root)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _load_split_files(self):
        paths = self.raw_paths()
        train = load_file(paths[0], {}, {}, self.delimiter, self.col_order)
        valid = load_file(paths[1], train["inv_entity_vocab"], train["inv_rel_vocab"],
                          self.delimiter, self.col_order)
        test = load_file(paths[2], train["inv_entity_vocab"], train["inv_rel_vocab"],
                         self.delimiter, self.col_order)
        return train, valid, test

    def process(self) -> KGDataset:
        train, valid, test = self._load_split_files()
        # vocab accumulated across splits; test holds the final counts
        # (datasets.py:298-303: YAGO/Aristo grow vocab in valid/test)
        num_node = test["num_node"]
        num_rel = test["num_relation"]
        if num_rel > max(num_node, 4096):
            # almost certainly a mis-parsed file (wrong col_order or
            # delimiter): every entity token in the relation column mints a
            # relation, and the relation graph grows toward its 4*R^2 bound
            logging.getLogger("ultra_tpu_torch").warning(
                "dataset %r parsed %d relation types > %d entities — check col_order "
                "(%r) and delimiter (%r); proceeding, but the relation graph may be "
                "enormous", self.name, num_rel, num_node, self.col_order, self.delimiter,
            )
        tr_ei, tr_et = _edges(train["triplets"])
        va_ei, va_et = _edges(valid["triplets"])
        te_ei, te_et = _edges(test["triplets"])
        msg_ei, msg_et = with_inverses(tr_ei, tr_et, num_rel)

        def split(target_ei, target_et):
            return KGSplit(msg_ei, msg_et, num_node, num_rel * 2, target_ei, target_et)

        return KGDataset(
            self.name, split(tr_ei, tr_et), split(va_ei, va_et), split(te_ei, te_et)
        )


class FB15k237(TransductiveDataset):
    """The MichSchli/RelationPrediction dumps (tab-separated h r t) that the
    reference reads through PyG's RelLinkPredDataset (``datasets.py:186-205``)."""

    name = "fb15k237"
    urls = [
        "https://raw.githubusercontent.com/MichSchli/RelationPrediction/master/data/FB-Toutanova/train.txt",
        "https://raw.githubusercontent.com/MichSchli/RelationPrediction/master/data/FB-Toutanova/valid.txt",
        "https://raw.githubusercontent.com/MichSchli/RelationPrediction/master/data/FB-Toutanova/test.txt",
    ]


class WN18RR(TransductiveDataset):
    """The villmow/datasets_knowledge_embedding dumps the reference reads
    through PyG's WordNet18RR (``datasets.py:207-237``)."""

    name = "wn18rr"
    urls = [
        "https://raw.githubusercontent.com/villmow/datasets_knowledge_embedding/master/WN18RR/original/train.txt",
        "https://raw.githubusercontent.com/villmow/datasets_knowledge_embedding/master/WN18RR/original/valid.txt",
        "https://raw.githubusercontent.com/villmow/datasets_knowledge_embedding/master/WN18RR/original/test.txt",
    ]


class CoDEx(TransductiveDataset):
    @property
    def urls(self):
        return [
            f"https://raw.githubusercontent.com/tsafavi/codex/master/data/triples/{self.name}/{f}"
            for f in ("train.txt", "valid.txt", "test.txt")
        ]


class CoDExSmall(CoDEx):
    name = "codex-s"


class CoDExMedium(CoDEx):
    name = "codex-m"


class CoDExLarge(CoDEx):
    name = "codex-l"


class NELL995(TransductiveDataset):
    """facts + train files merged into the training graph
    (``datasets.py:412-471``)."""

    name = "nell995"
    urls = [
        "https://raw.githubusercontent.com/LARS-research/RED-GNN/main/transductive/data/nell/facts.txt",
        "https://raw.githubusercontent.com/LARS-research/RED-GNN/main/transductive/data/nell/train.txt",
        "https://raw.githubusercontent.com/LARS-research/RED-GNN/main/transductive/data/nell/valid.txt",
        "https://raw.githubusercontent.com/LARS-research/RED-GNN/main/transductive/data/nell/test.txt",
    ]
    raw_file_names = ("facts.txt", "train.txt", "valid.txt", "test.txt")

    def process(self) -> KGDataset:
        paths = self.raw_paths()
        facts = load_file(paths[0], {}, {}, self.delimiter, self.col_order)
        train = load_file(paths[1], facts["inv_entity_vocab"], facts["inv_rel_vocab"],
                          self.delimiter)
        valid = load_file(paths[2], train["inv_entity_vocab"], train["inv_rel_vocab"],
                          self.delimiter)
        test = load_file(paths[3], train["inv_entity_vocab"], train["inv_rel_vocab"],
                         self.delimiter)

        num_node = valid["num_node"]  # datasets.py:439
        num_rel = train["num_relation"]
        tr_ei, tr_et = _edges(facts["triplets"] + train["triplets"])
        va_ei, va_et = _edges(valid["triplets"])
        te_ei, te_et = _edges(test["triplets"])
        msg_ei, msg_et = with_inverses(tr_ei, tr_et, num_rel)

        def split(tei, tet):
            return KGSplit(msg_ei, msg_et, num_node, num_rel * 2, tei, tet)

        return KGDataset(self.name, split(tr_ei, tr_et), split(va_ei, va_et),
                         split(te_ei, te_et))


class ConceptNet100k(TransductiveDataset):
    name = "cnet100k"
    delimiter = "\t"
    urls = [
        "https://raw.githubusercontent.com/guojiapub/BiQUE/master/src_data/conceptnet-100k/train",
        "https://raw.githubusercontent.com/guojiapub/BiQUE/master/src_data/conceptnet-100k/valid",
        "https://raw.githubusercontent.com/guojiapub/BiQUE/master/src_data/conceptnet-100k/test",
    ]


class DBpedia100k(TransductiveDataset):
    name = "dbp100k"
    urls = [
        "https://raw.githubusercontent.com/iieir-km/ComplEx-NNE_AER/master/datasets/DB100K/_train.txt",
        "https://raw.githubusercontent.com/iieir-km/ComplEx-NNE_AER/master/datasets/DB100K/_valid.txt",
        "https://raw.githubusercontent.com/iieir-km/ComplEx-NNE_AER/master/datasets/DB100K/_test.txt",
    ]


class YAGO310(TransductiveDataset):
    name = "yago310"
    urls = [
        "https://raw.githubusercontent.com/DeepGraphLearning/KnowledgeGraphEmbedding/master/data/YAGO3-10/train.txt",
        "https://raw.githubusercontent.com/DeepGraphLearning/KnowledgeGraphEmbedding/master/data/YAGO3-10/valid.txt",
        "https://raw.githubusercontent.com/DeepGraphLearning/KnowledgeGraphEmbedding/master/data/YAGO3-10/test.txt",
    ]


class Hetionet(TransductiveDataset):
    name = "hetionet"
    urls = [
        "https://www.dropbox.com/s/y47bt9oq57h6l5k/train.txt?dl=1",
        "https://www.dropbox.com/s/a0pbrx9tz3dgsff/valid.txt?dl=1",
        "https://www.dropbox.com/s/4dhrvg3fyq5tnu4/test.txt?dl=1",
    ]


class AristoV4(TransductiveDataset):
    name = "aristov4"
    delimiter = "\t"
    url = "https://zenodo.org/record/5942560/files/aristo-v4.zip"

    def download(self):
        zip_path = os.path.join(self.raw_dir, "aristo-v4.zip")
        download(self.url, zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(self.raw_dir)
        os.unlink(zip_path)
        for old, new in zip(["train", "valid", "test"], self.raw_paths()):
            os.rename(os.path.join(self.raw_dir, old), new)


class SparserKG(TransductiveDataset):
    """DacKGR sparse KGs; the dumps are (h, t, r) ordered
    (``datasets.py:529-582``). Tail-only metrics apply at evaluation time."""

    url = "https://raw.githubusercontent.com/THU-KEG/DacKGR/master/data.zip"
    delimiter = "\t"
    col_order = "htr"
    base_name = "SparseKG"

    @property
    def dataset_dir(self):
        return os.path.join(self.root, self.base_name, self.name)

    def download(self):
        base = os.path.join(self.root, self.base_name)
        zip_path = os.path.join(base, "data.zip")
        download(self.url, zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(base)
        for dsname in ["NELL23K", "WD-singer", "FB15K-237-10", "FB15K-237-20", "FB15K-237-50"]:
            for old, new in zip(["train.triples", "dev.triples", "test.triples"],
                                self.raw_file_names):
                src = os.path.join(base, "data", dsname, old)
                dst = os.path.join(base, dsname, "raw", new)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.move(src, dst)
        shutil.rmtree(os.path.join(base, "data"))
        os.unlink(zip_path)


class WDsinger(SparserKG):
    name = "WD-singer"


class NELL23k(SparserKG):
    name = "NELL23K"


class FB15k237_10(SparserKG):
    name = "FB15K-237-10"


class FB15k237_20(SparserKG):
    name = "FB15K-237-20"


class FB15k237_50(SparserKG):
    name = "FB15K-237-50"


class InductiveDataset(RawDataset):
    """Four files: the training graph, the inference graph, and the
    validation and test triples (``datasets.py:600-719``). The two graphs
    have vocabularies of their own. ``valid_on_inf`` says whether validation
    runs on the inference graph (the default) or on the training graph (HM,
    MTDEA); the test triples run on the inference graph."""

    delimiter: Optional[str] = None
    valid_on_inf = True
    raw_file_names = (
        "transductive_train.txt", "inference_graph.txt", "inf_valid.txt", "inf_test.txt",
    )

    def __init__(self, root: str, version, **kwargs):
        self.root = os.path.expanduser(root)
        self.version = str(version)
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def dataset_dir(self):
        return os.path.join(self.root, self.name, self.version)

    def address(self, url: str) -> str:
        return url % self.version

    def _read(self):
        paths = self.raw_paths()
        train = load_file(paths[0], {}, {}, self.delimiter)
        inference = load_file(paths[1], {}, {}, self.delimiter)
        base = inference if self.valid_on_inf else train
        valid = load_file(paths[2], base["inv_entity_vocab"], base["inv_rel_vocab"],
                          self.delimiter)
        test = load_file(paths[3], inference["inv_entity_vocab"], inference["inv_rel_vocab"],
                         self.delimiter)
        return train, inference, valid, test

    def process(self) -> KGDataset:
        train, inference, valid, test = self._read()
        num_train_nodes, num_train_rels = train["num_node"], train["num_relation"]
        # the test file reads into the inference vocabulary, so its counts
        # are the inference graph's final ones
        inf_nodes, inf_rels = test["num_node"], test["num_relation"]

        tr_ei, tr_et = _edges(train["triplets"])
        msg_tr_ei, msg_tr_et = with_inverses(tr_ei, tr_et, num_train_rels)
        inf_ei, inf_et = _edges(inference["triplets"])
        msg_inf_ei, msg_inf_et = with_inverses(inf_ei, inf_et, inf_rels)
        va_ei, va_et = _edges(valid["triplets"])
        te_ei, te_et = _edges(test["triplets"])

        train_split = KGSplit(msg_tr_ei, msg_tr_et, num_train_nodes, num_train_rels * 2,
                              tr_ei, tr_et)
        if self.valid_on_inf:
            valid_split = KGSplit(msg_inf_ei, msg_inf_et, inf_nodes, inf_rels * 2, va_ei, va_et)
        else:
            valid_split = KGSplit(msg_tr_ei, msg_tr_et, self._valid_num_nodes(train, valid),
                                  num_train_rels * 2, va_ei, va_et)
        test_split = KGSplit(msg_inf_ei, msg_inf_et, inf_nodes, inf_rels * 2, te_ei, te_et)
        return KGDataset(f"{self.name}-{self.version}", train_split, valid_split, test_split)

    def _valid_num_nodes(self, train, valid):
        """Nodes of the validation graph when it is the training graph: the
        training graph's here; HM and MTDEA take the validation vocabulary's,
        whose new entities then have no edge."""
        return train["num_node"]


class IngramInductive(InductiveDataset):
    @property
    def dataset_dir(self):
        return os.path.join(self.root, "ingram", self.name, self.version)


def _ingram_urls(prefix):
    return [
        f"https://raw.githubusercontent.com/bdi-lab/InGram/master/data/{prefix}-%s/{f}"
        for f in ("train.txt", "msg.txt", "valid.txt", "test.txt")
    ]


class FBIngram(IngramInductive):
    name = "fb"
    urls = _ingram_urls("FB")


class WKIngram(IngramInductive):
    name = "wk"
    urls = _ingram_urls("WK")


class NLIngram(IngramInductive):
    name = "nl"
    urls = _ingram_urls("NL")


class ILPC2022(InductiveDataset):
    name = "ilpc2022"
    urls = [
        "https://raw.githubusercontent.com/pykeen/ilpc2022/master/data/%s/train.txt",
        "https://raw.githubusercontent.com/pykeen/ilpc2022/master/data/%s/inference.txt",
        "https://raw.githubusercontent.com/pykeen/ilpc2022/master/data/%s/inference_validation.txt",
        "https://raw.githubusercontent.com/pykeen/ilpc2022/master/data/%s/inference_test.txt",
    ]


class HM(InductiveDataset):
    """The Hamaguchi and INDIGO benchmarks: validation on the training graph,
    with a few hundred new entities (``datasets.py:802-850``). ``version``
    is one of :attr:`versions`' keys."""

    name = "hm"
    valid_on_inf = False
    urls = [
        "https://raw.githubusercontent.com/shuwen-liu-ox/INDIGO/master/data/%s/train/train.txt",
        "https://raw.githubusercontent.com/shuwen-liu-ox/INDIGO/master/data/%s/test/test-graph.txt",
        "https://raw.githubusercontent.com/shuwen-liu-ox/INDIGO/master/data/%s/train/valid.txt",
        "https://raw.githubusercontent.com/shuwen-liu-ox/INDIGO/master/data/%s/test/test-fact.txt",
    ]
    versions = {
        "1k": "Hamaguchi-BM_both-1000",
        "3k": "Hamaguchi-BM_both-3000",
        "5k": "Hamaguchi-BM_both-5000",
        "indigo": "INDIGO-BM",
    }

    def __init__(self, root, version, **kwargs):
        if str(version) not in self.versions:
            raise ValueError(f"unknown HM version {version!r}, available: {list(self.versions)}")
        super().__init__(root, self.versions[str(version)], **kwargs)

    def _valid_num_nodes(self, train, valid):
        return valid["num_node"]  # datasets.py:836-838


class GrailInductiveDataset(RawDataset):
    """GraIL's splits (``datasets.py:11-139``): a transductive graph and an
    inductive one with entity vocabularies of their own and one relation
    vocabulary, which the inductive files may not grow. The test split's
    targets are the inductive validation and test triples merged
    (``merge_valid_test``, the default) or the test triples alone."""

    raw_file_names = ("train_ind.txt", "valid_ind.txt", "test_ind.txt", "train.txt",
                      "valid.txt")
    versions = ("v1", "v2", "v3", "v4")

    def __init__(self, root, version, merge_valid_test=True, **kwargs):
        if version not in self.versions:
            raise ValueError(f"unknown GraIL version {version!r}, available: {self.versions}")
        self.root = os.path.expanduser(root)
        self.version = version
        self.merge_valid_test = merge_valid_test

    @property
    def dataset_dir(self):
        return os.path.join(self.root, "grail", self.name, self.version)

    def address(self, url: str) -> str:
        return url % self.version

    def process(self) -> KGDataset:
        paths = self.raw_paths()
        inv_train, inv_test, inv_rel = {}, {}, {}
        # the transductive files first (they make the relation vocabulary),
        # then the inductive ones: train, valid, train_ind, valid_ind, test_ind
        chunks = [load_file(p, inv_train, inv_rel, delimiter="\t")["triplets"]
                  for p in paths[3:]]
        chunks += [load_file(p, inv_test, inv_rel, delimiter="\t",
                             require_known_rel=True)["triplets"] for p in paths[:3]]
        train_t, valid_t, train_ind_t, valid_ind_t, test_ind_t = chunks
        num_rel = len(inv_rel)

        tr_ei, tr_et = _edges(train_t)
        msg_tr_ei, msg_tr_et = with_inverses(tr_ei, tr_et, num_rel)
        ti_ei, ti_et = _edges(train_ind_t)
        msg_ti_ei, msg_ti_et = with_inverses(ti_ei, ti_et, num_rel)
        va_ei, va_et = _edges(valid_t)
        te_ei, te_et = _edges(valid_ind_t + test_ind_t if self.merge_valid_test
                              else test_ind_t)

        train_split = KGSplit(msg_tr_ei, msg_tr_et, len(inv_train), num_rel * 2, tr_ei, tr_et)
        valid_split = KGSplit(msg_tr_ei, msg_tr_et, len(inv_train), num_rel * 2, va_ei, va_et)
        test_split = KGSplit(msg_ti_ei, msg_ti_et, len(inv_test), num_rel * 2, te_ei, te_et)
        return KGDataset(f"{self.name}-{self.version}", train_split, valid_split, test_split)


def _grail_urls(prefix):
    return [
        f"https://raw.githubusercontent.com/kkteru/grail/master/data/{prefix}_%s_ind/train.txt",
        f"https://raw.githubusercontent.com/kkteru/grail/master/data/{prefix}_%s_ind/valid.txt",
        f"https://raw.githubusercontent.com/kkteru/grail/master/data/{prefix}_%s_ind/test.txt",
        f"https://raw.githubusercontent.com/kkteru/grail/master/data/{prefix}_%s/train.txt",
        f"https://raw.githubusercontent.com/kkteru/grail/master/data/{prefix}_%s/valid.txt",
    ]


class FB15k237Inductive(GrailInductiveDataset):
    name = "IndFB15k237"
    urls = _grail_urls("fb237")


class WN18RRInductive(GrailInductiveDataset):
    name = "IndWN18RR"
    urls = _grail_urls("WN18RR")


class NELLInductive(GrailInductiveDataset):
    name = "IndNELL"
    urls = _grail_urls("nell")


class MTDEAInductive(InductiveDataset):
    """The MTDEA datasets (``datasets.py:895-970``): validation on the
    training graph; the validation file drops every triple with a token the
    training graph lacks (``limit_vocab``), and the validation graph's node
    count is the validation vocabulary's. All six families come in one zip,
    which ``download`` unpacks into each one's raw directory."""

    valid_on_inf = False
    url = "https://reltrans.s3.us-east-2.amazonaws.com/MTDEA_data.zip"
    base_name = "mtdea"
    prefix = "%s"
    versions: Sequence[str] = ()
    raw_file_names = (
        "transductive_train.txt", "inference_graph.txt", "transductive_valid.txt", "inf_test.txt",
    )

    def __init__(self, root, version, **kwargs):
        if version not in self.versions:
            raise ValueError(f"unknown version {version!r}, available: {self.versions}")
        super().__init__(root, version, **kwargs)

    @property
    def dataset_dir(self):
        return os.path.join(self.root, self.base_name, self.name, self.version)

    def download(self):
        base = os.path.join(self.root, self.base_name)
        zip_path = os.path.join(base, "MTDEA_data.zip")
        download(self.url, zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(base)
        for cls in (FBNELL, Metafam, WikiTopicsMT1, WikiTopicsMT2, WikiTopicsMT3, WikiTopicsMT4):
            for version in cls.versions:
                for old, new in zip(["train.txt", "observe.txt", "valid.txt", "test.txt"],
                                    self.raw_file_names):
                    folder = cls.prefix % version + ("-trans" if "transductive" in new else "-ind")
                    src = os.path.join(base, "MTDEA_datasets", cls.name, folder, old)
                    dst = os.path.join(base, cls.name, version, "raw", new)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.move(src, dst)
        shutil.rmtree(os.path.join(base, "MTDEA_datasets"))
        os.unlink(zip_path)

    def _read(self):
        paths = self.raw_paths()
        train = load_file(paths[0], {}, {}, self.delimiter)
        inference = load_file(paths[1], {}, {}, self.delimiter)
        valid = load_file(paths[2], train["inv_entity_vocab"], train["inv_rel_vocab"],
                          self.delimiter, limit_vocab=True)  # datasets.py:943
        test = load_file(paths[3], inference["inv_entity_vocab"], inference["inv_rel_vocab"],
                         self.delimiter)
        return train, inference, valid, test

    def _valid_num_nodes(self, train, valid):
        return valid["num_node"]  # datasets.py:970


class FBNELL(MTDEAInductive):
    name = "FBNELL"
    versions = ["FBNELL_v1"]

    def __init__(self, root, version=None, **kwargs):
        super().__init__(root, self.versions[0], **kwargs)


class Metafam(MTDEAInductive):
    name = "Metafam"
    versions = ["Metafam"]

    def __init__(self, root, version=None, **kwargs):
        super().__init__(root, self.versions[0], **kwargs)


class WikiTopicsMT1(MTDEAInductive):
    name = "WikiTopics-MT1"
    prefix = "wikidata_%sv1"
    versions = ["mt", "health", "tax"]


class WikiTopicsMT2(MTDEAInductive):
    name = "WikiTopics-MT2"
    prefix = "wikidata_%sv1"
    versions = ["mt2", "org", "sci"]


class WikiTopicsMT3(MTDEAInductive):
    name = "WikiTopics-MT3"
    prefix = "wikidata_%sv2"
    versions = ["mt3", "art", "infra"]


class WikiTopicsMT4(MTDEAInductive):
    name = "WikiTopics-MT4"
    prefix = "wikidata_%sv2"
    versions = ["mt4", "sci", "health"]


class SyntheticRuleKG(TransductiveDataset):
    """A deterministic offline rule-KG (``data/synthetic.py::rule_kg_splits``).
    Its parameters are constructor keys (the YAML's dataset keys), its name
    encodes them, and ``download`` writes the raw split files instead of
    fetching them; the rest is the :class:`TransductiveDataset` path."""

    urls = ()
    num_nodes = 2000
    num_base_rel = 16
    num_comp_rel = 8
    num_base_triples = 12000
    seed = 0
    categories = 8
    rule_keep = 0.75

    def __init__(self, root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.name = (
            f"synthrule-v{self.num_nodes}-b{self.num_base_rel}"
            f"-c{self.num_comp_rel}-e{self.num_base_triples}-s{self.seed}"
        )

    def download(self):
        from ultra_tpu_torch.data.synthetic import rule_kg_splits

        train, valid, test, _ = rule_kg_splits(
            self.num_nodes, self.num_base_rel, self.num_comp_rel, self.num_base_triples,
            seed=self.seed, categories=self.categories, rule_keep=self.rule_keep,
        )
        os.makedirs(self.raw_dir, exist_ok=True)
        for path, trip in zip(self.raw_paths(), (train, valid, test)):
            with open(path, "w", encoding="utf-8") as f:
                for h, t, r in trip:
                    f.write(f"e{h}\tr{r}\te{t}\n")


DATASETS: Dict[str, type] = {
    cls.__name__: cls for cls in (
        FB15k237, WN18RR, CoDExSmall, CoDExMedium, CoDExLarge, NELL995, ConceptNet100k,
        DBpedia100k, YAGO310, Hetionet, AristoV4, WDsinger, NELL23k, FB15k237_10,
        FB15k237_20, FB15k237_50, FB15k237Inductive, WN18RRInductive, NELLInductive,
        ILPC2022, HM, FBIngram, WKIngram, NLIngram, FBNELL, Metafam, WikiTopicsMT1,
        WikiTopicsMT2, WikiTopicsMT3, WikiTopicsMT4, SyntheticRuleKG,
    )
}

# the JAX package's other dataset classes, and the ROADMAP item that ports them
UNPORTED = {"JointDataset": "A9"}

# datasets whose evaluation protocol is tail-only (README.md:264; run.py:133)
TAIL_ONLY_EVAL = {"WDsinger", "NELL23k", "FB15k237_10", "FB15k237_20", "FB15k237_50"}

# inductive datasets whose filtering graph is the inference graph with every
# split's targets (run.py:263-288)
INDUCTIVE_FILTER_WITH_INFERENCE = {"ILPC2022", "FBIngram", "WKIngram", "NLIngram"}


def build_dataset(name: str, root: str, **kwargs):
    """Name-and-keys dataset factory (``util.py:144-164``)."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"dataset class {name!r} is not ported yet (ROADMAP {UNPORTED[name]})")
    return DATASETS[name](root, **kwargs)


def split_to_graph(split: KGSplit, device="cuda", pad_edges_to: Optional[int] = None,
                   pad_rel_edges_bucket: Optional[int] = None) -> Graph:
    """KGSplit -> Graph with its relation graph attached; the edge layouts
    of both are built here, once. ``pad_edges_to`` pads the message graph
    with weight-0 edges; ``pad_rel_edges_bucket`` pads the relation graph's
    edge count up to a multiple of it (``graph.py::pad_bucket``)."""
    rel_ei, rel_et = tasks.build_relation_graph_arrays(
        split.edge_index, split.edge_type, split.num_nodes, split.num_relations)
    rel_pad = (None if pad_rel_edges_bucket is None
               else pad_bucket(max(rel_ei.shape[1], 64), pad_rel_edges_bucket))
    rel_graph = make_graph(rel_ei, rel_et, num_nodes=split.num_relations, num_relations=4,
                           pad_to=rel_pad, device=device)
    return make_graph(
        split.edge_index,
        split.edge_type,
        num_nodes=split.num_nodes,
        num_relations=split.num_relations,
        pad_to=pad_edges_to,
        relation_graph=rel_graph,
        device=device,
    )
