"""Build the package's host C++ libraries (``native/csrc/*.cpp``) with g++.

The same rules as the kernels' ``ops/_build.py``: a library is built at
first use into ``build/native/`` at the root of the checkout, named by a
hash of its sources and flags, under a file lock so two processes never
build the same library at once, and a failed build raises with the
compiler's stderr (the caller decides what to serve instead, and says
so).  Only sources in this package are built:

* ``fastcodec``: ``fastcodec.cpp`` as a plain-C shared library (ctypes);
* ``fastcodec_pymod``: the CPython extension ``fastcodec_pymod.cpp``, which
  includes ``fastcodec.cpp`` (needs ``Python.h`` and numpy's headers);
* ``dataplane``: ``dataplane.cpp`` linked with ``fastcodec.cpp``;
* ``loadgen``: the closed-loop load generator ``loadgen.cpp``, an
  executable (``chip_smoke.py``'s throughput step drives the lanes with it).
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["CSRC", "BUILD_DIR", "BUILD_INFO", "build"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17"]
_SHARED = ["-fPIC", "-shared"]

#: name -> {"path", "seconds" (0.0 when the library was already built)}
BUILD_INFO: Dict[str, dict] = {}


def _recipe(name: str) -> Tuple[List[Path], List[str], str]:
    """(sources hashed, compiler arguments after the flags, output file)."""
    codec = CSRC / "fastcodec.cpp"
    if name == "fastcodec":
        return [codec], [*_SHARED, str(codec)], "libfastcodec.so"
    if name == "dataplane":
        src = CSRC / "dataplane.cpp"
        return [src, codec], [*_SHARED, "-pthread", str(src), str(codec)], "libdataplane.so"
    if name == "fastcodec_pymod":
        import numpy as np

        src = CSRC / "fastcodec_pymod.cpp"
        includes = ["-I", sysconfig.get_paths()["include"], "-I", np.get_include(),
                    "-I", str(CSRC)]
        return [src, codec], [*_SHARED, *includes, str(src)], "_fastcodec.so"
    if name == "loadgen":
        src = CSRC / "loadgen.cpp"
        return [src], [str(src)], "loadgen"
    raise ValueError(f"unknown native library {name!r}")


def build(name: str) -> Path:
    """The path of the built library ``name``, building it if needed.
    Raises RuntimeError (with g++'s stderr) when it cannot be built."""
    srcs, args, filename = _recipe(name)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native plane and codec are built "
                           "from source at first use")
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(_FLAGS + args).encode()).hexdigest()[:16]
    stem, dot, ext = filename.partition(".")
    out = BUILD_DIR / f"{stem}-{digest}{dot}{ext}"
    info = {"path": str(out), "seconds": 0.0}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not out.exists():  # another process may have built it
                    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                    t0 = time.perf_counter()
                    proc = subprocess.run([gxx, *_FLAGS, "-o", str(tmp), *args],
                                          capture_output=True, text=True)
                    info["seconds"] = time.perf_counter() - t0
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(f"g++ failed to build {name} "
                                           f"(exit {proc.returncode}):\n{proc.stderr}")
                    os.replace(tmp, out)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    BUILD_INFO[name] = info
    return out
