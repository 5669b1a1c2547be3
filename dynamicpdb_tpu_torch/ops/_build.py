"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and includes
no PyTorch or CUTLASS header, so one ``nvcc`` call compiles it into a shared
library in seconds; ``ctypes`` loads it. Libraries are cached in ``build/``
inside the package under a digest of the source, of every ``csrc/`` header
it includes (directly or through another header) and of the flags, so an
edit to any of them rebuilds and an unchanged source is compiled once per
checkout. Several sources build in parallel, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600


@dataclass(frozen=True)
class Built:
    name: str
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (register and shared-memory use per kernel)


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[str]:
    """``<name>.cu`` and the ``csrc/`` headers it includes, directly or
    through another header, each once, in the order they are reached."""
    order, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        path = os.path.join(CSRC_DIR, rel)
        if rel in order or not os.path.exists(path):
            continue
        order.append(rel)
        with open(path, "rb") as f:
            todo.extend(m.decode() for m in _INCLUDE.findall(f.read()))
    return order


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for rel in sources(name):
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(names) -> dict[str, Built]:
    """Compile every named source that is not built yet, all at once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = Built(name, path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (path, tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"nvcc timed out on {name}.cu") from None
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
        out[name] = Built(name, path, time.perf_counter() - t0, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if it is not yet."""
    return ctypes.CDLL(build([name])[name].path)
