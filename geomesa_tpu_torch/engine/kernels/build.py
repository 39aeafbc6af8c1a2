"""Build and load the port's CUDA kernels.

Each `<name>.cu` beside this file is compiled at first use with `nvcc`
for `sm_90a` into a shared library with a plain C interface, which is
loaded with `ctypes` (no PyTorch headers, so a build takes seconds). The
library lands in `.torch_kernels/` at the root of the checkout, keyed by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. Importing this module builds nothing.

A build on first use is a compile stall: it is noted through
`compilecache.tracker.note_build` (the serve window that paid it carries
it; a warm-up manifest records the library and its entry points).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

from geomesa_tpu_torch.errors import KernelBuildError

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[2] / ".torch_kernels"
ARCH = "sm_90a"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# build seconds and ptxas report per kernel source (read by chip_smoke.py)
build_log: Dict[str, dict] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `<name>.cu` unless the keyed library already exists."""
    out = library_path(name)
    if out.exists():
        build_log.setdefault(name, {"seconds": 0.0, "cached": True,
                                    "ptxas": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    seconds = time.perf_counter() - t0
    build_log[name] = {"seconds": seconds, "cached": False,
                       "ptxas": proc.stderr}
    from geomesa_tpu_torch.compilecache.tracker import note_build

    note_build(name, seconds, entry_points(name))
    return out


def entry_points(name: str) -> List[str]:
    """The C entry points (`extern "C"` functions) of `<name>.cu`."""
    src = (SRC_DIR / f"{name}.cu").read_text()
    return re.findall(r'extern "C"\s+\w+\s+(\w+)\s*\(', src)


def loaded() -> List[str]:
    """Names of the libraries this process has loaded."""
    with _lock:
        return sorted(_libs)


def sources() -> List[str]:
    """Names of every kernel source (`<name>.cu`) beside this file."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build_all() -> List[Path]:
    """Build every kernel source, one nvcc process each, all at once."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
