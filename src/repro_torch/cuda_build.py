"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at
the repository root, where the hash is that of the source together with
every shared header ``csrc/*.cuh``, so an edited source or header is
rebuilt and an unchanged one is not. The compiler's output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``.log``. Nothing is built when a module is imported: the
first kernel launch builds its library, or `build` builds several at
once, one ``nvcc`` each, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA toolkit is needed to build the kernels")
    return str(path)


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """The library of ``<csrc>/<name>.cu``, named by a hash of that source
    and of every ``<csrc>/*.cuh`` header (names and contents)."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict:
    """Compile the named sources that are not built yet, one nvcc each,
    in parallel. Returns {name: library path}; raises on any failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in jobs:
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failed.append(f"{name}: nvcc timed out\n{out}")
            continue
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)       # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    return ctypes.CDLL(str(build([name])[name]))
