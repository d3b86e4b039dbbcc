"""Build and load the port's hand-written CUDA kernels.

Each library is compiled with `nvcc` from the package's `csrc/` sources
into a shared object with a plain C interface and loaded with ctypes.  The
build is keyed by a hash of the sources and the flags and cached under
`build/somar_tpu_torch/` at the repository root (git-ignored), so the first
use in a fresh checkout compiles and later uses load.  Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "somar_tpu_torch"

#: Hopper target; `-fmad=false` keeps every multiply and add separately
#: rounded, as the plain PyTorch versions of the kernels compute them.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, Path] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (once per source hash) and load `lib<name>.so`.  The
    compiler's output, including ptxas register and spill counts, is kept
    beside the library as `<lib>.log`.  Raises RuntimeError with the
    compiler's output when the build fails."""
    if name in _loaded:
        return _loaded[name]
    paths = [CSRC_DIR / s for s in sources]
    so = BUILD_DIR / f"lib{name}-{_digest(paths)}.so"
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _logs[name] = so.with_suffix(".log")
    _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler output of the loaded library's build ('' if none)."""
    log = _logs.get(name)
    return log.read_text() if log is not None and log.is_file() else ""
