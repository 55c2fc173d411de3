"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes``. Libraries are
built from the repository's sources at first use, into
``build/torch_kernels/`` beside the package, under a name keyed on a hash
of the source and the compiler flags: an edited source rebuilds, an
unchanged one loads as it is. :func:`build` starts one ``nvcc`` per
missing source, all together, and waits for every one of them.

Nothing here runs at import time: the CPU tests import every module on a
machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

#: kernel name -> source file under csrc/
SOURCES = {
    "conv3x3_bn_relu": "conv3x3_bn_relu.cu",
    "conv1x1": "conv1x1.cu",
    "deproject_edge_stats": "deproject_edge_stats.cu",
    "bspline_design": "bspline_design.cu",
    "bspline_curvature": "bspline_curvature.cu",
    "bitpack_mask": "bitpack_mask.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # register / shared-memory / spill report, kept in build_logs
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # guarded_by: _lock
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}  # guarded_by: _lock
#: kernel name -> nvcc's output from the build that made its library
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build on a machine "
            "with the CUDA toolkit (set CUDA_HOME)"
        )
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives for the current source."""
    source = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(
        source + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> float:
    """Compile every kernel library in ``names`` (default: all) that is not
    built yet; returns the seconds spent. Raises with nvcc's output when a
    source does not compile."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    with _lock:
        missing = [n for n in names if not library_path(n).is_file()]
        if not missing:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        jobs = []
        try:
            for name in missing:
                final = library_path(name)
                tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
                proc = subprocess.Popen(
                    [compiler, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                jobs.append((name, proc, tmp, final))
            failed = []
            for name, proc, tmp, final in jobs:
                out, _ = proc.communicate()
                build_logs[name] = out
                if proc.returncode != 0:
                    failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, final)
        finally:
            for _, proc, tmp, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                    tmp.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of kernel ``name``'s library, typed with
    ``argtypes`` (``ctypes.c_void_p`` for pointers and the stream) and an
    int return: the launch's cudaError_t."""
    key = (name, symbol)
    with _lock:
        fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with _lock:
            fn = _fns.setdefault(key, fn)
    return fn


def check(name: str, err: int) -> None:
    """Raise when a launch function returned an error (it returns -1 for
    sizes past the kernel's limits, else the cudaError_t)."""
    if err:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
