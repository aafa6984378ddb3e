"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel source ``ops/csrc/<name>.cu`` exposes a plain C interface (no
PyTorch headers, so ``nvcc`` takes seconds, not minutes) and is compiled
for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so

into ``build/torch_kernels/`` at the root of the checkout, keyed by a hash
of the source, the shared headers ``csrc/*.cuh`` and the flags, under a
file lock so two processes never build the same library at once.
Nothing is built at import: the first call that needs a kernel builds it
(a unit's construction, which probes its kernel, or a launch).
``build_all`` starts one nvcc per source, all at once.  Only sources in
this package are built.  Each library's first load reports to the flight
recorder (``utils/telemetry.py``), the port's counterpart of the JAX
package's compile-cache listener: ``record_compile_cache("hit")`` when the
library keyed by the source hash was already on disk, ``"miss"`` and
``record_compile_seconds`` with nvcc's wall when it was built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "BUILD_INFO", "load_library", "build_all", "find_nvcc"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in BUILD_INFO
    "-Xptxas", "-v",
]

#: name -> {"path", "seconds" (0.0 when the library was already built),
#: "ptxas" (the compiler's resource report)}
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()               # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME / CUDA_PATH, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from source at first use"
        )
    return found


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed.
    Raises RuntimeError when the build fails."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:  # one build per library; other libraries build alongside
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib


def build_all(names: Sequence[str]) -> None:
    """Build and load several libraries at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(load_library, names))


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    # the shared headers are part of every library's key: an edit to one
    # rebuilds each source that may include it
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    info = {"path": str(out), "seconds": 0.0, "ptxas": ""}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not out.exists():  # another process may have built it
                    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                    t0 = time.perf_counter()
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                    info["seconds"] = time.perf_counter() - t0
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(
                            f"nvcc failed to build {src.name} "
                            f"(exit {proc.returncode}):\n{proc.stderr}"
                        )
                    info["ptxas"] = proc.stderr
                    os.replace(tmp, out)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    BUILD_INFO[name] = info
    from seldon_core_tpu_torch.utils.telemetry import RECORDER

    if info["seconds"] > 0.0:
        RECORDER.record_compile_cache("miss")
        RECORDER.record_compile_seconds(info["seconds"])
    else:
        RECORDER.record_compile_cache("hit")
    return out
