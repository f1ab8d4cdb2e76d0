"""Native (C++) host join of the graph of relations, compiled with ``g++``
at first use and loaded through ``ctypes``.

Counterpart of ``ultra_tpu/native``. The source ``relgraph.cpp`` is built
with ``g++ -O3 -shared -fPIC`` into ``build/ultra_tpu_torch/`` of the
checkout, as the CUDA kernels are (``ops/build.py``); the file name carries
a hash of the source, the flags and the compiler's version, so an edited
source or another compiler is rebuilt and a stale library is never loaded.

Without ``g++`` on the ``PATH`` :func:`relgraph_build_native` returns
``None`` and ``tasks.build_relation_graph_arrays`` takes the numpy join. A
compiler that is found but fails raises, with its output.
:func:`available` says which of the two a caller gets.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_SOURCE = Path(__file__).resolve().parent / "relgraph.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "ultra_tpu_torch"
_LIB: Optional[ctypes.CDLL] = None
# the library stages its result between build and fetch in shared buffers,
# and ctypes releases the GIL during a call
_LOCK = threading.Lock()


def library_path(gxx: str) -> Path:
    version = subprocess.run([gxx, "--version"], check=True, capture_output=True,
                             text=True).stdout
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode() + version.encode()).hexdigest()[:16]
    return _BUILD / f"librelgraph-{digest}.so"


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; ``None`` when no ``g++``
    is on the ``PATH``. A failing build raises ``RuntimeError``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    path = library_path(gxx)
    if not path.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(_SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {_SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: another process never loads half a file
    lib = ctypes.CDLL(str(path))
    lib.relgraph_build.restype = ctypes.c_int64
    lib.relgraph_build.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
    lib.relgraph_fetch.restype = None
    lib.relgraph_fetch.argtypes = [ctypes.c_void_p] * 3
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the native join runs (builds the library if needed)."""
    return load_library() is not None


def relgraph_build_native(
    edge_index, edge_type, num_nodes: int, num_relations: int, live=None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The graph of relations of the edges ``edge_index`` (2, E) with types
    ``edge_type`` (E,), as ``tasks.relation_graph_arrays_numpy`` computes
    it, element for element and in its order: (edge_index (2, M), edge_type
    (M,)), int64. ``live``: an optional boolean mask over the edges.
    ``None`` when the library is unavailable (no ``g++``)."""
    lib = load_library()
    if lib is None:
        return None
    edge_index = np.asarray(edge_index)
    heads = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    tails = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    types = np.ascontiguousarray(edge_type, dtype=np.int64)
    num_edges = heads.size
    if edge_index.shape != (2, num_edges) or types.shape != (num_edges,):
        raise ValueError(f"edge_index {edge_index.shape} and edge_type {types.shape} "
                         "must be (2, E) and (E,)")
    if num_edges and (min(heads.min(), tails.min(), types.min()) < 0
                      or max(heads.max(), tails.max()) >= num_nodes
                      or types.max() >= num_relations):
        raise ValueError("an edge names a node or a relation out of range")
    live_arr = None
    if live is not None:
        live_arr = np.ascontiguousarray(live, dtype=bool).view(np.uint8)
        if live_arr.shape != (num_edges,):
            raise ValueError(f"live {live_arr.shape} must be ({num_edges},)")
    with _LOCK:
        n = lib.relgraph_build(heads.ctypes.data, tails.ctypes.data, types.ctypes.data,
                               None if live_arr is None else live_arr.ctypes.data,
                               num_edges, int(num_nodes), int(num_relations))
        out = np.empty((3, n), dtype=np.int64)
        lib.relgraph_fetch(out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data)
    return out[:2], out[2]
