"""Build and load the package's CUDA kernels.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. Libraries go to
``kernels/build/`` (or the directory :func:`set_build_dir` names, the
launcher's ``--compile-cache-dir``) under a name that carries a digest
of the source and the flags, so an edited source never loads a stale
library and a restarted process loads what an earlier one built.
Nothing is built at import time: a kernel builds at its first launch,
or all of them at once through :func:`build` (one ``nvcc`` process per
source, started together). Builds and loads of an already-built library
are counted in ``compile_cache_misses_total`` and
``compile_cache_hits_total`` (``utils/devprof.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from sdnmpi_tpu_torch.utils import devprof

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent / "build"

#: kernel name -> its CUDA source in csrc/
SOURCES = {"bfs": "bfs.cu", "pack": "pack.cu", "ring": "ring.cu",
           "sampler": "sampler.cu", "scan": "scan.cu"}

#: no --use_fast_math: the sampler's logf must round like torch.log, and
#: the scanner's and the packer's adds and comparisons like the CPU's
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
#: kernels this process compiled
_built: set[str] = set()
#: ptxas report (registers, shared memory, spills) of each kernel built
#: by this process, for the build log of chip_smoke.py
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "sdnmpi_tpu_torch build from source at first use"
        )
    return found


def set_build_dir(path) -> None:
    """Build and load the kernels' libraries under ``path`` (created if
    missing) from now on; libraries already loaded stay loaded."""
    global _BUILD
    _BUILD = pathlib.Path(path).resolve()
    _BUILD.mkdir(parents=True, exist_ok=True)


def library_path(name: str) -> pathlib.Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + "\0".join(FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def build(*names: str) -> float:
    """Compile the named kernels (all when none are named) that are not
    built yet, one nvcc process per source started together. Returns
    the wall seconds spent; raises with nvcc's output on a failure."""
    names = names or tuple(SOURCES)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    compiler = nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, proc, tmp, target))
    failed = []
    for name, proc, tmp, target in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        _built.add(name)
        devprof.note_kernel_build()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        if name not in _built:
            devprof.note_kernel_load()
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def load_all(*names: str) -> None:
    """Load the named kernels (all when none are named), building the
    missing ones together first."""
    names = names or tuple(SOURCES)
    build(*[n for n in names if n not in _libs])
    for name in names:
        load(name)


def function(name: str, symbol: str, argtypes: list):
    """``symbol`` of kernel ``name``'s library with its C signature
    (``argtypes``, an int return) set once."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on the CUDA error code a launcher returned."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device``."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
