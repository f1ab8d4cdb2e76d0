"""The evaluation zoo: dataset groups and the expansion of target lists,
which the parity command lines (``scripts/torch_parity_run.py`` and
``scripts/torch_parity_run_query.py``) read.

Counterpart of ``ultra_tpu/data/zoo.py``, over the port's registries
(``data/kg.py::DATASETS`` and ``query/datasets.py::QUERY_DATASETS``).
Groups mirror the reference's run_many tables (run_many.py:25-115) and the
README zero-shot aggregates (README.md:104-145): ``inductive_e`` = the 18
inductive-entity graphs (GraIL 12 + ILPC 2 + HM 4), ``inductive_er`` = the
23 inductive-entity+relation graphs (Ingram 13 + MTDEA 10),
``pretrain3g``/``pretrain4g`` = the pretraining mixtures, ``transductive``
= the 16-graph transductive eval set incl. FB15k237/WN18RR; the query
groups are the 23 BetaE-format query datasets of UltraQuery's tables.

The JAX package's ``stage_query`` is not ported: it downloads an archive,
and the port fetches nothing; stage the files by hand (DATA_MANIFEST.md).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

from ultra_tpu_torch.data import kg
from ultra_tpu_torch.query import datasets as qds

GROUPS = {
    "pretrain3g": [("FB15k237", None), ("WN18RR", None), ("CoDExMedium", None)],
    "pretrain4g": [
        ("FB15k237", None), ("WN18RR", None), ("CoDExMedium", None),
        ("NELL995", None),
    ],
    "transductive": [
        ("FB15k237", None), ("WN18RR", None),
        ("CoDExSmall", None), ("CoDExMedium", None), ("CoDExLarge", None),
        ("NELL995", None), ("YAGO310", None), ("ConceptNet100k", None),
        ("DBpedia100k", None), ("AristoV4", None), ("Hetionet", None),
        ("WDsinger", None), ("NELL23k", None), ("FB15k237_10", None),
        ("FB15k237_20", None), ("FB15k237_50", None),
    ],
    "inductive_e": (
        [("FB15k237Inductive", v) for v in ("v1", "v2", "v3", "v4")]
        + [("WN18RRInductive", v) for v in ("v1", "v2", "v3", "v4")]
        + [("NELLInductive", v) for v in ("v1", "v2", "v3", "v4")]
        + [("ILPC2022", v) for v in ("small", "large")]
        + [("HM", v) for v in ("1k", "3k", "5k", "indigo")]
    ),
    "inductive_er": (
        [("FBIngram", v) for v in ("25", "50", "75", "100")]
        + [("WKIngram", v) for v in ("25", "50", "75", "100")]
        + [("NLIngram", v) for v in ("0", "25", "50", "75", "100")]
        + [("FBNELL", None), ("Metafam", None)]
        + [("WikiTopicsMT1", v) for v in ("health", "tax")]
        + [("WikiTopicsMT2", v) for v in ("org", "sci")]
        + [("WikiTopicsMT3", v) for v in ("art", "infra")]
        + [("WikiTopicsMT4", v) for v in ("sci", "health")]
    ),
}
GROUPS["all"] = [
    pair
    for g in ("transductive", "inductive_e", "inductive_er")
    for pair in GROUPS[g]
]

# classes whose zero-shot eval uses the inductive config
INDUCTIVE_CLASSES = {
    "FB15k237Inductive", "WN18RRInductive", "NELLInductive", "ILPC2022",
    "HM", "FBIngram", "WKIngram", "NLIngram", "FBNELL", "Metafam",
    "WikiTopicsMT1", "WikiTopicsMT2", "WikiTopicsMT3", "WikiTopicsMT4",
}


# ---------------------------------------------------------------------------
# CLQA (UltraQuery) zoo: the 23 BetaE-format query datasets of
# the reference's README.md:361-431 (3 transductive + 9 inductive(e) +
# 11 WikiTopics). Query datasets download whole archives (shared across
# members) and are checked by each class's own sentinel file.
# ---------------------------------------------------------------------------

QUERY_GROUPS = {
    "query_transductive": [
        ("FB15k237LogicalQuery", None), ("FB15kLogicalQuery", None),
        ("NELL995LogicalQuery", None),
    ],
    "query_inductive_e": [
        ("InductiveFB15k237Query", str(v))
        for v in (550, 300, 217, 175, 150, 134, 122, 113, 106)
    ],
    "query_inductive_er": [
        ("WikiTopicsQuery", t)
        for t in ("art", "award", "edu", "health", "infra", "loc", "org",
                  "people", "sci", "sport", "tax")
    ],
}
QUERY_GROUPS["query_all"] = [
    p for g in ("query_transductive", "query_inductive_e", "query_inductive_er")
    for p in QUERY_GROUPS[g]
]

# sentinel file (relative to raw_dir) whose presence marks a staged dataset —
# the same file each class's load() checks before downloading
QUERY_SENTINEL = {
    "FB15k237LogicalQuery": "train.txt",
    "FB15kLogicalQuery": "train.txt",
    "NELL995LogicalQuery": "train.txt",
    "InductiveFB15k237Query": "train_graph.txt",
    "WikiTopicsQuery": "train_graph.txt",
}


def instantiate_query(name: str, version: Optional[str], root: str):
    cls = qds.QUERY_DATASETS[name]
    return cls(root, version=version) if version is not None else cls(root)


def query_is_staged(name: str, version: Optional[str], root: str) -> bool:
    ds = instantiate_query(name, version, root)
    return os.path.exists(os.path.join(ds.raw_dir, QUERY_SENTINEL[name]))


def query_archive_url(name: str, version: Optional[str], root: str) -> str:
    ds = instantiate_query(name, version, root)
    return ds.url % ds.version if "%s" in ds.url else ds.url


def target_name(name: str, version: Optional[str]) -> str:
    return f"{name}:{version}" if version else name


def iter_targets(spec: str) -> Iterator[Tuple[str, Optional[str]]]:
    """Expand a comma list of group names (KG or query) and Name[:version]
    targets."""
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok in GROUPS:
            yield from GROUPS[tok]
        elif tok in QUERY_GROUPS:
            yield from QUERY_GROUPS[tok]
        elif ":" in tok:
            n, v = tok.split(":", 1)
            yield (n, v)
        else:
            yield (tok, None)


def is_query_dataset(name: str) -> bool:
    return name in qds.QUERY_DATASETS


def instantiate(name: str, version: Optional[str], root: str):
    cls = kg.DATASETS[name]
    return cls(root, version=version) if version is not None else cls(root)


def is_staged(name: str, version: Optional[str], root: str) -> bool:
    ds = instantiate(name, version, root)
    return os.path.exists(ds.processed_path) or all(
        os.path.exists(p) for p in ds.raw_paths()
    )
