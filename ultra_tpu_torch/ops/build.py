"""Build the CUDA kernels of ``ultra_tpu_torch/csrc`` with ``nvcc`` and load
them with ``ctypes``.

A kernel ``name`` is the source ``csrc/<name>.cu``, compiled on its own into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into ``build/ultra_tpu_torch/`` of the
checkout. The file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.
:func:`build_all` builds several sources at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "ultra_tpu_torch"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        _DEFAULT_NVCC,
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are compiled from "
        "ultra_tpu_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Build the libraries of ``names`` that are not built yet, one ``nvcc``
    per source, all started together; returns each build's compiler output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
