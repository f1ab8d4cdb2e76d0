"""The binding layer of the port's CUDA kernels: it builds the sources of
``ultra_tpu_torch/csrc``, binds, launches and counts their C entry points.

A kernel ``name`` is the source ``csrc/<name>.cu``, compiled on its own into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into ``build/ultra_tpu_torch/`` of the
checkout. The file name carries a hash of the source, the headers of
``csrc`` (``*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.
:func:`build_all` builds several sources at once, one ``nvcc`` each.

The module that launches a kernel (``ops/*_cuda.py``) declares its C
signature beside its wrappers (:func:`declare`) and registers their launch
counters (:func:`counted`); adding a kernel touches its source and that
module. Every launch goes through :func:`launch`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import importlib
import os
import pkgutil
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "ultra_tpu_torch"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel -> (its source, its C argument types with the stream)
_SIGNATURES: Dict[str, tuple] = {}
# every declared entry point -> (its kernel, its instance: "" for the kernel's own)
ENTRY_POINTS: Dict[str, tuple] = {}
_BOUND: Dict[str, object] = {}  # entry point -> bound at first use
_COUNTERS: Dict[str, collections.Counter] = {}  # wrapper name -> its launches

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
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
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


def ptxas_usage(log: str) -> list:
    """Each kernel's resources from a build's compiler output (``-Xptxas
    -v``): "<entry>: <registers, barriers>; <stack and spills>"."""
    usage, entry, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            usage.append(f"{entry}: {line.split('Used', 1)[1].strip()}; {spills}")
            entry = None
    return usage


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def entry_point(kernel: str, instance: str = "") -> str:
    """The C entry point of ``kernel``'s ``instance``: the kernel's own name
    for ``""``, else the name with the instance as a suffix
    (``rspmm_sum_fwd_bf16_bf16``)."""
    return f"{kernel}_{instance}" if instance else kernel


def declare(kernel: str, argtypes: Sequence, instances: Sequence[str] = ("",),
            source: str | None = None):
    """Declare ``kernel``'s C signature: its arguments' ``ctypes`` types
    before the stream, which :func:`launch` appends; every entry point
    returns a CUDA status. Each of ``instances`` (:func:`entry_point`) takes
    that signature. ``source`` is the kernel's file in ``csrc/`` where that
    is not ``<kernel>.cu``. A kernel is declared once, by the module that
    launches it."""
    if kernel in _SIGNATURES:
        raise ValueError(f"{kernel} is declared twice")
    _SIGNATURES[kernel] = (source or kernel, [*argtypes, ctypes.c_void_p])
    ENTRY_POINTS.update({entry_point(kernel, i): (kernel, i) for i in instances})


def bind(entry: str, library: ctypes.CDLL | None = None):
    """The declared C entry point ``entry`` typed by its kernel's signature
    (the module that declares it imported first): from ``library`` where
    given (another build of the source, as the sweeps under ``scripts/``
    make), else from its source's library, built and loaded at first use
    and then cached."""
    fn = None if library is not None else _BOUND.get(entry)
    if fn is None:
        source, argtypes = _SIGNATURES[ENTRY_POINTS[entry][0]]
        fn = getattr(library if library is not None else load(source), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        if library is None:
            _BOUND[entry] = fn
    return fn


@contextlib.contextmanager
def swapped(fns: Dict[str, object]):
    """Launch ``fns`` ({entry point: a function :func:`bind` took from
    another build's library}) in place of the source's entry points inside
    the block."""
    own = {entry: bind(entry) for entry in fns}
    _BOUND.update(fns)
    try:
        yield
    finally:
        _BOUND.update(own)


def launch(kernel, op: str, device, *args):
    """Launch ``kernel`` (:func:`bind`) on the CUDA ``device`` with the C
    arguments ``args`` and the device's current stream; a nonzero CUDA
    status raises ``RuntimeError`` naming ``op``."""
    with torch.cuda.device(device):
        status = kernel(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{op} launch failed with CUDA error {status}")


def check_device(op: str, device, tensors: dict, cuda: bool = True):
    """Every tensor of ``tensors`` ({name: tensor}) on ``device``, a CUDA
    device unless ``cuda`` is false, and contiguous, as the kernels read
    their operands; anything else raises ``ValueError`` naming ``op`` and
    the tensor."""
    for name, t in tensors.items():
        if t.device != device or (cuda and not t.is_cuda):
            want = f"the CUDA device {device}" if cuda else device
            raise ValueError(f"{op}: {name} is on {t.device}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def counted(wrapper):
    """Give ``wrapper`` its launch counter, ``wrapper.launches``, registered
    under its name; returns the wrapper."""
    name = wrapper.__name__
    if name in _COUNTERS:
        raise ValueError(f"a launch counter named {name} is registered twice")
    wrapper.launches = _COUNTERS[name] = collections.Counter()
    return wrapper


def launch_counters() -> Dict[str, collections.Counter]:
    """Every wrapper's launch counter by the wrapper's name, each wrapper
    module (``ops/*_cuda.py``, which registers its counters when it is
    imported) imported first so that none is missing."""
    for module in pkgutil.iter_modules([str(Path(__file__).resolve().parent)]):
        if module.name.endswith("_cuda"):
            importlib.import_module(f"{__package__}.{module.name}")
    return dict(_COUNTERS)


def clear_launch_counters():
    """Clear every wrapper's launch counter."""
    for counter in launch_counters().values():
        counter.clear()
