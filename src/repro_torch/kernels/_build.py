"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use every source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` with a plain C interface (no PyTorch
headers), and the objects are linked into one shared library that
``ctypes`` loads.  The library lands in ``build/repro_torch/<hash>/`` at the
root of the checkout, keyed by a hash of the sources, the headers they
include (``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads at once.

``KERNEL_LAUNCHES`` counts, per kernel, the wrapper calls that launched
CUDA work — and nothing else: the plain versions never touch it.
``SHAPE_LAUNCHES`` counts the same launches by (kernel, the shape key its
wrapper passes), for the wrappers that pass one.

``ptxas -v`` reports each kernel's registers, shared memory and spills as
it compiles; the build keeps what it printed beside the library
(``ptxas.log``, read back by ``ptxas_log()``).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-gencode", "arch=compute_90a,code=sm_90a")
PTXAS_LOG = "ptxas.log"

KERNEL_LAUNCHES: collections.Counter = collections.Counter()
SHAPE_LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_VARIANTS: set = set()
build_seconds: float | None = None   # wall of the build that loaded _LIB


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], target: Path):
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed, logs = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            text = out.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{text}")
            logs.append(f"== {src.name}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = Path(tmp, target.name)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        Path(tmp, PTXAS_LOG).write_text("".join(logs))
        os.replace(Path(tmp, PTXAS_LOG), target.with_name(PTXAS_LOG))
        os.replace(lib, target)


def ptxas_log() -> str:
    """What ``ptxas -v`` printed when the loaded library was built (its
    compile of every kernel: registers, shared memory, spills)."""
    path = Path(library()._name).with_name(PTXAS_LOG)
    return path.read_text() if path.is_file() else ""


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            sources = sorted(CSRC.glob("*.cu"))
            headers = sorted(CSRC.glob("*.cuh"))
            target = (BUILD_ROOT / _digest(sources + headers)
                      / "libreprokernels.so")
            if not target.is_file():
                _compile(sources, target)
            lib = ctypes.CDLL(str(target))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
            build_seconds = time.perf_counter() - t0
        return _LIB


def entry(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A launch entry point of the library with its C signature set; every
    entry returns the ``cudaGetLastError()`` of its launches."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(kernel: str, code: int, shape: str | None = None):
    """Raise on a refused or failed launch; count one launch otherwise,
    also under ``shape`` where the wrapper gives one."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({code}: {msg})")
    KERNEL_LAUNCHES[kernel] += 1
    if shape is not None:
        SHAPE_LAUNCHES[kernel, shape] += 1


def note_variant(kernel: str, key) -> int:
    """1 the first time this process launches ``kernel`` as variant ``key``
    (the port's counterpart of a jit retrace), else 0."""
    if (kernel, key) in _VARIANTS:
        return 0
    _VARIANTS.add((kernel, key))
    return 1
