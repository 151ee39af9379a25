"""Build the port's CUDA sources with nvcc at first use and load them.

Each source under ``csrc/`` exposes a plain C function and is compiled
alone into a shared library (``nvcc -shared``), which ``ctypes`` loads: no
PyTorch headers, so a build takes seconds, and several sources build in
parallel, one nvcc each. The library's file name carries
a hash of the source, the ``*.cuh`` headers beside it and the flags, so an
edited source or header rebuilds; the
libraries land in ``kernels/build/``, which git ignores. A missing ``nvcc``
or a failed build raises: there is no fallback on the CUDA path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# per source file name: seconds nvcc took, and its ptxas report (registers,
# shared memory, spills); empty when the library was already on disk
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels of repro_torch are built at first use")


def _lib_path(source: Path) -> Path:
    # the headers beside a source are part of what it builds from
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def load_libraries(sources: Sequence[Path]) -> List[ctypes.CDLL]:
    """The loaded libraries built from `sources`, building the missing ones
    at once: one nvcc per source, all started together."""
    sources = [Path(s) for s in sources]
    builds = []
    for source in sources:
        lib_path = _lib_path(source)
        if str(source.resolve()) in _LIBS or lib_path.exists():
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        builds.append((source, lib_path, tmp, proc, time.perf_counter()))
    failed = []
    for source, lib_path, tmp, proc, t0 in builds:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {source}:\n{out}\n{err}")
            continue
        os.replace(tmp, lib_path)      # atomic: concurrent builds agree
        build_seconds[source.name] = time.perf_counter() - t0
        build_log[source.name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = []
    for source in sources:
        key = str(source.resolve())
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(str(_lib_path(source)))
        libs.append(_LIBS[key])
    return libs


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library built from `source`, building it if needed."""
    return load_libraries([source])[0]
