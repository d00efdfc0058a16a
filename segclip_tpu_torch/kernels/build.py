"""Build-on-first-use loader for the port's CUDA kernels (ctypes, no torch
headers).

Each source under `segclip_tpu_torch/csrc/` (`*.cu`, with the headers
`*.cuh` they include) is compiled by its own `nvcc`, all started together,
and the objects are linked into one shared library with a plain C
interface, named by a hash of the sources, headers and flags, in
`build/kernels/` at the root of the checkout. A changed source gives a new
name and so a rebuild. Each kernel module binds its own entry point with
`ctypes` (pointers and the stream as `c_void_p`).

Nothing here runs at import: the build happens at the first launch, on a
machine with `nvcc` (compute capability 9.0a, Hopper).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built on the GPU machine")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsegclip_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path. One
    `nvcc -c` per source runs in parallel, then one link. The compilers'
    output (register and shared-memory use per kernel, from `-Xptxas -v`)
    is kept beside the library as `<name>.log`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        logs = [Path(tmp) / f"{src.stem}.log" for src in sources()]
        procs = []
        for src, obj, log in zip(sources(), objs, logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=out, stderr=subprocess.STDOUT))
        codes = [proc.wait() for proc in procs]
        output = "".join(log.read_text() for log in logs)
        if not any(codes):
            link = subprocess.run(
                [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(Path(tmp) / "lib.so"),
                 *map(str, objs)], capture_output=True, text=True)
            output += link.stdout + link.stderr
            codes.append(link.returncode)
        lib.with_suffix(".log").write_text(output)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({max(codes)}):\n{output}")
        os.replace(Path(tmp) / "lib.so", lib)   # atomic: a reader never sees half a file
    return lib


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.segclip_error_string.argtypes = [ctypes.c_int]
    lib.segclip_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = load().segclip_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
