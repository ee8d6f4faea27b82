"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, and bound with ``ctypes``;
the ``csrc/*.cuh`` headers are shared between them. The library lands in
``arkflow_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused. Nothing builds at import time: the first launch (or
``build_all``) builds, and a missing ``nvcc`` raises instead of falling back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: every kernel source of ``csrc/``: K1 ragged, K2 segment, K3 paged and K4
#: dense flash attention
KERNEL_SOURCES = ("ragged_attention", "segment_attention", "paged_attention",
                  "flash_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of arkflow_tpu_torch are compiled for sm_90a at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its source, the shared
    headers of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, verbose: bool) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, Path(tmp), out


def build_all(names: list[str], verbose: bool = False) -> dict[str, dict]:
    """Compile every named kernel source at once (one ``nvcc`` each, all
    started together) and wait for all of them. Returns, per name, the
    seconds its build took (0 when the library was already built) and the
    compiler's output. Raises if any build fails."""
    t0 = time.perf_counter()
    started = {n: _start(n, verbose) for n in names}
    report: dict[str, dict] = {}
    failures = []
    for name, job in started.items():
        if job is None:
            report[name] = {"seconds": 0.0, "output": "", "library": str(library_path(name))}
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "output": text,
                        "library": str(out)}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


class KernelLibrary:
    """One kernel source's shared library, built and loaded at first use."""

    def __init__(self, name: str):
        self.name = name
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                build_all([self.name])
                self._lib = ctypes.CDLL(str(library_path(self.name)))
            return self._lib
