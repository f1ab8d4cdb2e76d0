"""Logical-query datasets in the BetaE pickle format.

Counterpart of ``ultra_tpu/query/datasets.py`` (numpy and the standard
library, a copy rather than an import; the reference's
``datasets_query.py``). Families:

- :class:`LogicalQueryDataset`: the transductive BetaE dumps (FB15k,
  FB15k-237, NELL995), whose graph triples already hold the inverse
  relations (``inv_rel = rel + 1``, ``datasets_query.py:106-109``);
- :class:`InductiveFB15k237Query`: 9 node-id-partitioned versions and
  wikikg; the graph grows with the validation and test inference edges,
  ``restrict_nodes`` masks evaluation's scoring, and training keeps 10
  patterns; :class:`InductiveFB15k237QueryExtendedEval` re-answers the
  training queries on the larger graphs;
- :class:`WikiTopicsQuery`: 11 topics, a test graph disjoint from training.

The pretraining mixture (``JointQueryDataset``) belongs to query training,
ROADMAP A10: :func:`build_query_dataset` raises for it. Query programs
become padded postfix int64 arrays (``query/ops.py``) at load time.
Downloads go through ``data/kg.py::download`` and fail with a clear message
with no network; raw files placed under the dataset's directory are used as
they are.
"""


from __future__ import annotations

import os
import pickle
import zipfile
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ultra_tpu_torch.data.kg import download
from ultra_tpu_torch.query import ops

STRUCT2TYPE = {
    ("e", ("r",)): "1p",
    ("e", ("r", "r")): "2p",
    ("e", ("r", "r", "r")): "3p",
    (("e", ("r",)), ("e", ("r",))): "2i",
    (("e", ("r",)), ("e", ("r",)), ("e", ("r",))): "3i",
    ((("e", ("r",)), ("e", ("r",))), ("r",)): "ip",
    (("e", ("r", "r")), ("e", ("r",))): "pi",
    (("e", ("r",)), ("e", ("r", "n"))): "2in",
    (("e", ("r",)), ("e", ("r",)), ("e", ("r", "n"))): "3in",
    ((("e", ("r",)), ("e", ("r", "n"))), ("r",)): "inp",
    (("e", ("r", "r")), ("e", ("r", "n"))): "pin",
    (("e", ("r", "r", "n")), ("e", ("r",))): "pni",
    (("e", ("r",)), ("e", ("r",)), ("u",)): "2u-DNF",
    ((("e", ("r",)), ("e", ("r",)), ("u",)), ("r",)): "up-DNF",
    ((("e", ("r", "n")), ("e", ("r", "n"))), ("n",)): "2u-DM",
    ((("e", ("r", "n")), ("e", ("r", "n"))), ("n", "r")): "up-DM",
}

DEFAULT_TRAIN_PATTERNS = ("1p", "2p", "3p", "2i", "3i", "2in", "3in", "inp", "pni", "pin")


class QueryGraph(NamedTuple):
    edge_index: np.ndarray  # (2, E) — already includes inverse relations
    edge_type: np.ndarray
    num_nodes: int
    num_relations: int
    inverse_rel_plus_one: bool
    restrict_nodes: Optional[np.ndarray] = None


class QueryDataset(NamedTuple):
    name: str
    graphs: Tuple[QueryGraph, QueryGraph, QueryGraph]  # train/valid/test
    queries: np.ndarray  # (N, L) packed int64 postfix
    types: np.ndarray  # (N,)
    easy_answers: List[np.ndarray]
    hard_answers: List[np.ndarray]
    num_samples: Tuple[int, int, int]
    num_entity_for_sample: np.ndarray  # (N,)
    id2type: List[str]

    def split_ranges(self):
        offsets = np.cumsum([0] + list(self.num_samples))
        return [(offsets[i], offsets[i + 1]) for i in range(3)]


def _set_query_types(query_types, union_type):
    query_types = query_types or list(STRUCT2TYPE.values())
    out = []
    for qt in query_types:
        if "u" in qt:
            if "-" not in qt:
                qt = f"{qt}-{union_type}"
            elif qt[qt.find("-") + 1 :] != union_type:
                continue
        out.append(qt)
    id2type = sorted(set(out))
    return id2type, {t: i for i, t in enumerate(id2type)}


def _download_zip(url, root):
    zpath = os.path.join(root, os.path.basename(url))
    download(url, zpath)
    with zipfile.ZipFile(zpath) as zf:
        zf.extractall(root)


class LogicalQueryDataset:
    """Transductive BetaE datasets (datasets_query.py:20-206)."""

    name = ""
    url = "http://snap.stanford.edu/betae/KG_data.zip"

    def __init__(self, root, query_types=None, union_type="DNF", train_patterns=None, **kw):
        self.root = os.path.expanduser(root)
        self.id2type, self.type2id = _set_query_types(query_types, union_type)
        self.train_patterns = train_patterns

    @property
    def raw_dir(self):
        return os.path.join(self.root, self.name)

    def load(self) -> QueryDataset:
        path = self.raw_dir
        if not os.path.exists(os.path.join(path, "train.txt")):
            _download_zip(self.url, self.root)

        with open(os.path.join(path, "id2ent.pkl"), "rb") as f:
            entity_vocab = pickle.load(f)
        with open(os.path.join(path, "id2rel.pkl"), "rb") as f:
            relation_vocab = pickle.load(f)

        triplets = []
        for split in ("train", "valid", "test"):
            with open(os.path.join(path, f"{split}.txt")) as f:
                n = 0
                for line in f:
                    h, r, t = (int(x) for x in line.split())
                    triplets.append((h, t, r))
                    n += 1
                if split == "train":
                    n_train = n

        train = np.asarray(triplets[:n_train], dtype=np.int64)
        graph = QueryGraph(
            edge_index=train[:, :2].T.copy(),
            edge_type=train[:, 2].copy(),
            num_nodes=len(entity_vocab),
            num_relations=len(relation_vocab),
            inverse_rel_plus_one=True,  # datasets_query.py:106-109
        )

        queries, types, easy, hard, num_samples = [], [], [], [], []
        for split in ("train", "valid", "test"):
            with open(os.path.join(path, f"{split}-queries.pkl"), "rb") as f:
                struct2queries = pickle.load(f)
            type2queries = {
                STRUCT2TYPE[k]: v for k, v in struct2queries.items() if STRUCT2TYPE[k] in self.type2id
            }
            if split == "train":
                with open(os.path.join(path, f"{split}-answers.pkl"), "rb") as f:
                    q2easy = pickle.load(f)
                q2hard = defaultdict(set)
            else:
                with open(os.path.join(path, f"{split}-easy-answers.pkl"), "rb") as f:
                    q2easy = pickle.load(f)
                with open(os.path.join(path, f"{split}-hard-answers.pkl"), "rb") as f:
                    q2hard = pickle.load(f)
            n = 0
            for qtype in type2queries:
                for query in sorted(type2queries[qtype]):
                    easy.append(np.fromiter(q2easy[query], dtype=np.int64))
                    hard.append(np.fromiter(q2hard[query], dtype=np.int64))
                    queries.append(ops.from_nested(query))
                    types.append(self.type2id[qtype])
                    n += 1
            num_samples.append(n)

        max_len = max(len(q) for q in queries)
        return QueryDataset(
            name=self.name,
            graphs=(graph, graph, graph),
            queries=ops.pad_queries(queries, max_len),
            types=np.asarray(types, dtype=np.int64),
            easy_answers=easy,
            hard_answers=hard,
            num_samples=tuple(num_samples),
            num_entity_for_sample=np.full(len(queries), graph.num_nodes, np.int64),
            id2type=self.id2type,
        )


class FB15kLogicalQuery(LogicalQueryDataset):
    name = "FB15k-betae"


class FB15k237LogicalQuery(LogicalQueryDataset):
    name = "FB15k-237-betae"


class NELL995LogicalQuery(LogicalQueryDataset):
    name = "NELL-betae"


class InductiveFB15k237Query(LogicalQueryDataset):
    """Inductive query datasets (datasets_query.py:230-429): node-ID-range
    partitioned graphs; restrict_nodes for eval; training filtered to 10
    query patterns."""

    url = "https://zenodo.org/record/7306046/files/%s.zip"
    versions = [550, 300, 217, 175, 150, 134, 122, 113, 106, "wikikg"]

    def __init__(self, root, version, query_types=None, union_type="DNF",
                 train_patterns=DEFAULT_TRAIN_PATTERNS, **kw):
        super().__init__(root, query_types, union_type, train_patterns)
        self.version = version

    @property
    def name(self):
        return f"{self.version}"

    @property
    def raw_dir(self):
        return os.path.join(self.root, str(self.version))

    def _load_triples(self, path):
        triplets = []
        with open(path) as f:
            for line in f:
                h, r, t = (int(x) for x in line.split())
                triplets.append((h, t, r))
        return triplets

    def _load_query_pickles(self, path, graphs):
        """Shared pickle-reading loop (datasets_query.py:325-380)."""
        type2struct = {v: k for k, v in STRUCT2TYPE.items()}
        train_structs = {type2struct[t] for t in self.train_patterns}

        queries, types, easy, hard, num_samples, num_ent = [], [], [], [], [], []
        for si, split in enumerate(("train", "valid", "test")):
            with open(os.path.join(path, f"{split}_queries.pkl"), "rb") as f:
                struct2queries = pickle.load(f)
            if split == "train":
                with open(os.path.join(path, f"{split}_answers_hard.pkl"), "rb") as f:
                    q2easy = pickle.load(f)
                q2hard = defaultdict(lambda: defaultdict(set))
            else:
                with open(os.path.join(path, f"{split}_answers_easy.pkl"), "rb") as f:
                    q2easy = pickle.load(f)
                with open(os.path.join(path, f"{split}_answers_hard.pkl"), "rb") as f:
                    q2hard = pickle.load(f)
            n = 0
            structs = sorted(struct2queries.keys(), key=lambda st: STRUCT2TYPE[st])
            for struct in structs:
                qtype = STRUCT2TYPE[struct]
                if qtype not in self.type2id:
                    continue
                if split == "train" and struct not in train_structs:
                    continue
                for query in sorted(struct2queries[struct]):
                    easy.append(np.fromiter(q2easy[struct][query], dtype=np.int64))
                    hard.append(np.fromiter(q2hard[struct][query], dtype=np.int64))
                    queries.append(ops.from_nested(query))
                    types.append(self.type2id[qtype])
                    n += 1
            num_samples.append(n)
            num_ent += [graphs[si].num_nodes] * n
        return queries, types, easy, hard, num_samples, num_ent

    def load(self) -> QueryDataset:
        path = self.raw_dir
        if not os.path.exists(os.path.join(path, "train_graph.txt")):
            _download_zip(self.url % self.version, self.root)

        train_trip = self._load_triples(os.path.join(path, "train_graph.txt"))
        val_inf = self._load_triples(os.path.join(path, "val_inference.txt"))
        test_inf = self._load_triples(os.path.join(path, "test_inference.txt"))

        all_trip = np.asarray(train_trip + val_inf + test_inf, dtype=np.int64)
        num_node = int(all_trip[:, :2].max()) + 1
        num_rel = int(all_trip[:, 2].max()) + 1
        tr = np.asarray(train_trip, dtype=np.int64)
        va = np.asarray(train_trip + val_inf, dtype=np.int64)
        te = np.asarray(train_trip + test_inf, dtype=np.int64)
        train_nodes = np.unique(tr[:, :2])
        val_nodes = np.unique(va[:, :2])
        test_nodes = np.unique(te[:, :2])

        def graph(trip, nodes, restrict):
            return QueryGraph(
                edge_index=trip[:, :2].T.copy(),
                edge_type=trip[:, 2].copy(),
                num_nodes=nodes,
                num_relations=num_rel,
                inverse_rel_plus_one=True,
                restrict_nodes=restrict,
            )

        graphs = (
            graph(tr, len(train_nodes), None),
            graph(va, num_node, val_nodes),
            graph(te, num_node, test_nodes),
        )

        queries, types, easy, hard, num_samples, num_ent = self._load_query_pickles(path, graphs)
        max_len = max(len(q) for q in queries)
        return QueryDataset(
            name=f"fb_{self.version}",
            graphs=graphs,
            queries=ops.pad_queries(queries, max_len),
            types=np.asarray(types, dtype=np.int64),
            easy_answers=easy,
            hard_answers=hard,
            num_samples=tuple(num_samples),
            num_entity_for_sample=np.asarray(num_ent, dtype=np.int64),
            id2type=self.id2type,
        )


class WikiTopicsQuery(InductiveFB15k237Query):
    """WikiTopics QE (11 topics): train/valid share the training graph, the
    test graph is fully disjoint with its own vocab (datasets_query.py:451-528)."""

    url = "https://reltrans.s3.us-east-2.amazonaws.com/WikiTopics_QE.zip"
    versions = ["art", "award", "edu", "health", "infra", "loc", "org", "people",
                "sci", "sport", "tax"]

    @property
    def raw_dir(self):
        return os.path.join(self.root, "WikiTopics_QE", str(self.version))

    def load(self) -> QueryDataset:
        path = self.raw_dir
        if not os.path.exists(os.path.join(path, "train_graph.txt")):
            _download_zip(self.url, self.root)

        train_trip = np.asarray(self._load_triples(os.path.join(path, "train_graph.txt")), dtype=np.int64)
        test_inf = np.asarray(self._load_triples(os.path.join(path, "test_inference.txt")), dtype=np.int64)
        train_nodes = np.unique(train_trip[:, :2])
        test_nodes = np.unique(test_inf[:, :2])

        def graph(trip, nodes, restrict):
            return QueryGraph(
                edge_index=trip[:, :2].T.copy(),
                edge_type=trip[:, 2].copy(),
                num_nodes=len(nodes),
                num_relations=int(trip[:, 2].max()) + 1,
                inverse_rel_plus_one=True,
                restrict_nodes=restrict,
            )

        graphs = (
            graph(train_trip, train_nodes, None),
            graph(train_trip, train_nodes, train_nodes),
            graph(test_inf, test_nodes, test_nodes),
        )
        queries, types, easy, hard, num_samples, num_ent = self._load_query_pickles(path, graphs)
        max_len = max(len(q) for q in queries)
        return QueryDataset(
            name=f"wikitopics_{self.version}",
            graphs=graphs,
            queries=ops.pad_queries(queries, max_len),
            types=np.asarray(types, dtype=np.int64),
            easy_answers=easy,
            hard_answers=hard,
            num_samples=tuple(num_samples),
            num_entity_for_sample=np.asarray(num_ent, dtype=np.int64),
            id2type=self.id2type,
        )


class InductiveFB15k237QueryExtendedEval(InductiveFB15k237Query):
    """Faithfulness eval: train queries re-answered on the larger valid/test
    graphs; all answers loaded as hard (datasets_query.py:559-633). Use with
    num_epoch=0 (inference only)."""

    def load(self) -> QueryDataset:
        path = self.raw_dir
        if not os.path.exists(os.path.join(path, "train_graph.txt")):
            _download_zip(self.url % self.version, self.root)
        # reuse the graph construction from the parent by loading it fully
        parent = super().load()
        graphs = parent.graphs

        with open(os.path.join(path, "train_queries.pkl"), "rb") as f:
            struct2queries = pickle.load(f)

        queries, types, easy, hard, num_samples, num_ent = [], [], [], [], [], []
        for si, split in enumerate(("train", "valid", "test")):
            fname = "train_answers_hard.pkl" if split == "train" else f"train_answers_{split}.pkl"
            with open(os.path.join(path, fname), "rb") as f:
                q2hard = pickle.load(f)
            n = 0
            structs = sorted(struct2queries.keys(), key=lambda st: STRUCT2TYPE[st])
            for struct in structs:
                qtype = STRUCT2TYPE[struct]
                if qtype not in self.type2id:
                    continue
                for i, query in enumerate(struct2queries[struct]):
                    q_index = i if split != "train" else query
                    hard.append(np.fromiter(q2hard[struct][q_index], dtype=np.int64))
                    easy.append(np.zeros(0, dtype=np.int64))
                    queries.append(ops.from_nested(query))
                    types.append(self.type2id[qtype])
                    n += 1
            num_samples.append(n)
            num_ent += [graphs[si].num_nodes] * n

        max_len = max(len(q) for q in queries)
        return QueryDataset(
            name=f"fb_{self.version}-extended",
            graphs=graphs,
            queries=ops.pad_queries(queries, max_len),
            types=np.asarray(types, dtype=np.int64),
            easy_answers=easy,
            hard_answers=hard,
            num_samples=tuple(num_samples),
            num_entity_for_sample=np.asarray(num_ent, dtype=np.int64),
            id2type=self.id2type,
        )


QUERY_DATASETS = {
    "FB15kLogicalQuery": FB15kLogicalQuery,
    "FB15k237LogicalQuery": FB15k237LogicalQuery,
    "NELL995LogicalQuery": NELL995LogicalQuery,
    "InductiveFB15k237Query": InductiveFB15k237Query,
    "InductiveFB15k237QueryExtendedEval": InductiveFB15k237QueryExtendedEval,
    "WikiTopicsQuery": WikiTopicsQuery,
}

# the JAX package's other query dataset classes, and the ROADMAP item that
# ports them
UNPORTED = {"JointQueryDataset": "A10 (query training; the mixture of A9)"}


def build_query_dataset(name: str, root: str, **kwargs):
    """Name-and-keys factory of the query datasets."""
    if name in UNPORTED:
        raise NotImplementedError(
            f"query dataset class {name!r} is not ported yet (ROADMAP {UNPORTED[name]})")
    return QUERY_DATASETS[name](root, **kwargs)
