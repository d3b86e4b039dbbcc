"""Native (C++) regrid-time clustering, loaded with ctypes (the port's
copy of `somar_tpu.native`, with the same C ABI).

`clustering.cpp` (Berger-Rigoutsos clustering and the tag bounding box)
is compiled with `g++` at first use into `build/somar_tpu_torch/` at the
repository root (git-ignored), keyed by a hash of the source and the
flags, as `cuda_build.py` keys the CUDA libraries.  Nothing is built at
import.  There is no fallback: without a compiler, or when the build
fails, the functions raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from somar_tpu_torch.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "clustering.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsomar_native-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the clustering library;
    raises RuntimeError when g++ is missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the AMR clustering library "
                               f"({SOURCE.name}) cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.br_cluster.restype = ctypes.c_int
    lib.br_cluster.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.tag_bounding_box.restype = ctypes.c_int
    lib.tag_bounding_box.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def _as3d(tags: np.ndarray):
    t = np.ascontiguousarray(tags.astype(np.uint8))
    if t.ndim == 2:
        t = t[:, :, None]
    if t.ndim != 3:
        raise ValueError(f"tags must be 2D or 3D, not {tags.ndim}D")
    return t


def berger_rigoutsos(tags: np.ndarray, fill_ratio: float = 0.7,
                     max_boxes: int = 64, min_side: int = 4) -> np.ndarray:
    """Cluster a boolean tag field into boxes: an (nboxes, 2, ndim) int
    array of [lo, hi] (hi inclusive) in the tag array's axis order."""
    t = _as3d(tags)
    out = np.zeros((max_boxes, 6), dtype=np.int32)
    n = load().br_cluster(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t.shape[0], t.shape[1], t.shape[2], float(fill_ratio),
        int(max_boxes), int(min_side),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    boxes = out[:n].reshape(n, 2, 3)
    return boxes[:, :, :2] if tags.ndim == 2 else boxes


def tag_bounding_box(tags: np.ndarray):
    """Bounding box [lo, hi] (hi inclusive) of all tags, or None."""
    t = _as3d(tags)
    out = np.zeros(6, dtype=np.int32)
    ok = load().tag_bounding_box(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t.shape[0], t.shape[1], t.shape[2],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if not ok:
        return None
    box = out.reshape(2, 3)
    return box[:, :2] if tags.ndim == 2 else box
