"""Builds the port's CUDA sources and loads them with ctypes.

Each ``repro_torch/csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into its own
shared library with a plain C interface (``-Xptxas -v`` adds the
register and spill report, kept beside the library), on first use, under
``<repo>/build/repro_torch/<hash>/`` keyed by a hash of the sources, the
shared headers and the flags: an edit rebuilds, an unchanged tree reuses
the libraries.  All missing libraries are built at once, one ``nvcc``
per source started together.  Nothing is fetched and no binary is
committed.  Pointers and the CUDA stream cross as ``c_void_p``; each C
entry point returns ``cudaGetLastError()`` and the wrappers raise on a
nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}     # source stem -> loaded library


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {stem: library path}.  The compiler's report (registers,
    shared memory, spills) is kept beside each library; see ``report``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
    procs = []
    for src in sources():
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = out_dir / f".tmp-{src.stem}-{os.getpid()}-{threading.get_ident()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)     # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def report() -> Dict[str, str]:
    """{stem: the compiler's ``-Xptxas -v`` output} of the current build,
    built or reused."""
    return {stem: lib.with_suffix(".log").read_text()
            for stem, lib in build().items()}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building on first use.
    The caller declares its functions' argtypes and restype."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build()[name]))
        return _libs[name]
