"""Build and load the port's hand-written CUDA kernels.

Each library (`somar_ctu`: the CTU kernels K1-K4; `somar_gsrb`: the GSRB
kernels K5-K6; `somar_stencil`: the probed-stencil kernels K7-K8) is
compiled with `nvcc` from the package's `csrc/` sources into a shared
object with a plain C interface and loaded with ctypes.  The build is
keyed by a hash of the sources, the headers there and the flags and
cached under
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
from typing import Dict, Mapping, Sequence

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
    """Hash of the flags, the sources and every header under csrc/ (the
    sources include them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _library_path(name: str, sources: Sequence[str]) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest([CSRC_DIR / s for s in sources])}.so"


def build_libraries(libs: Mapping[str, Sequence[str]]) -> None:
    """Compile every library of {name: sources} that is not built yet, one
    `nvcc` per library, all started together.  The compiler's output,
    including ptxas register and spill counts, is kept beside each library
    as `<lib>.log`.  Raises RuntimeError with the compiler's output when a
    build fails."""
    running = []
    for name, sources in libs.items():
        so = _library_path(name, sources)
        if so.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, so, tmp, cmd, proc))
    failed = []
    for name, so, tmp, cmd, proc in running:
        out, err = proc.communicate()
        so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}:\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (once per source hash) and load `lib<name>.so`."""
    if name in _loaded:
        return _loaded[name]
    build_libraries({name: sources})
    so = _library_path(name, sources)
    lib = ctypes.CDLL(str(so))
    _logs[name] = so.with_suffix(".log")
    _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler output of the loaded library's build ('' if none)."""
    log = _logs.get(name)
    return log.read_text() if log is not None and log.is_file() else ""
