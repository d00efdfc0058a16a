"""Build-on-first-use loader for the port's native host library (ctypes,
no pybind11): copies of segclip_tpu/native/{felzenszwalb,records}.cc.

The library is compiled by `g++` with the flags of the JAX package's build
(segclip_tpu/native/build.py), so that both give the same superpixel labels,
into `build/native/` at the root of the checkout, named by a hash of the
sources, the flags and the host CPU's instruction set: a changed source, or
another CPU, gives a new name and so a rebuild. The
JAX package keeps its own library next to its sources; this one never
writes there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Sequence

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("felzenszwalb.cc", "records.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _host_cpu() -> bytes:
    """The host's instruction-set flags: `-march=native` compiles for this
    CPU, so a library built on one machine is not loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def library_path(src_dir: Path = SRC_DIR, sources: Sequence[str] = SOURCES,
                 stem: str = "libsegclip_native") -> Path:
    """`<BUILD_DIR>/<stem>_<hash>.so` for `sources` (names in `src_dir`)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_cpu())
    for name in sources:
        digest.update(name.encode())
        digest.update((src_dir / name).read_bytes())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"


def build(src_dir: Path = SRC_DIR, sources: Sequence[str] = SOURCES,
          stem: str = "libsegclip_native") -> Path:
    """Compile the library if it is not built yet; return its path. The
    result is moved into place atomically, so processes that build at the
    same time (spawned data workers) never load half a file. Other host
    libraries of the port (checkpoint/zstd.py) build through it too."""
    lib = library_path(src_dir, sources, stem)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(out), *(str(src_dir / s) for s in sources)],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(out, lib)
    return lib


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.felzenszwalb_segment.restype = ctypes.c_int
    lib.felzenszwalb_segment.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.sgr_open.restype = ctypes.c_void_p
    lib.sgr_open.argtypes = [ctypes.c_char_p]
    lib.sgr_count.restype = ctypes.c_uint64
    lib.sgr_count.argtypes = [ctypes.c_void_p]
    lib.sgr_record.restype = ctypes.c_int
    lib.sgr_record.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.sgr_close.restype = None
    lib.sgr_close.argtypes = [ctypes.c_void_p]
    return lib
