"""Where the CUDA kernels' compiled libraries are kept.

Port of ``dynamicpdb_tpu/utils/compile_cache.py``. The JAX package points
XLA's persistent compilation cache at a directory; the port's compiled
artifacts are the kernel libraries ``ops/_build.py`` writes, keyed by a
digest of each kernel's sources and nvcc flags, into ``BUILD_DIR`` (the
package's ``build/``, which ``.gitignore`` lists). ``enable_persistent_cache``
points that directory elsewhere, a disk that outlives the checkout, so the
kernels are compiled once per toolchain rather than once per checkout.

The digest does not cover the toolchain: a library that another nvcc built
would still load. A ``MANIFEST.json`` in the directory records
``{"toolchain": {"nvcc": ..., "torch": ...}}`` (written on first use when
absent); a directory whose manifest records other versions is warned
about, as ``_warn_if_stale`` of the JAX module does for jax and jaxlib.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess

from dynamicpdb_tpu_torch.ops import _build

log = logging.getLogger(__name__)

MANIFEST = "MANIFEST.json"


def nvcc_version() -> str | None:
    """nvcc's release string (e.g. 'V12.4.131'), or None without nvcc."""
    try:
        out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    tokens = out.split()
    return tokens[-1] if tokens else None


def toolchain() -> dict:
    import torch

    return {"nvcc": nvcc_version(), "torch": torch.__version__}


def _warn_if_stale(path: str, current: dict) -> None:
    manifest = os.path.join(path, MANIFEST)
    try:
        with open(manifest) as f:
            recorded = json.load(f).get("toolchain", {})
    except FileNotFoundError:
        with open(manifest, "w") as f:
            json.dump({"toolchain": current}, f)
        return
    except (OSError, ValueError) as e:  # a bad manifest never blocks a build
        log.warning("kernel-cache manifest check failed for %s: %s", path, e)
        return
    stale = {k: (v, current.get(k)) for k, v in recorded.items()
             if current.get(k) is not None and v != current[k]}
    if stale:
        log.warning(
            "STALE kernel cache %s: libraries recorded under %s, running %s: "
            "they were built by another toolchain; empty the directory to "
            "rebuild them", path, recorded, current)


def enable_persistent_cache(path: str | None = None) -> str:
    """Build and load the kernels from ``path`` (made if absent); with no
    path the package's ``build/`` stays. Returns the directory in use."""
    if path:
        _build.BUILD_DIR = os.path.abspath(path)
    path = _build.BUILD_DIR
    os.makedirs(path, exist_ok=True)
    _warn_if_stale(path, toolchain())
    log.info("kernel cache: %s", path)
    return path
