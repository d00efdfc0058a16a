"""Zstandard decoding and the two checksums of an Orbax directory, from the
port's own C++ (checkpoint/native/zstd_decode.cc, RFC 8878), bound through
ctypes.

The library is compiled by `g++` at first use into `build/native/`, named
by a hash of its source, the flags and the host CPU (native/build.py).
There is no fallback: a failed build raises, and so does a corrupt frame.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

from segclip_tpu_torch.native import build as native_build

SRC_DIR = Path(__file__).resolve().parent / "native"
SOURCES = ("zstd_decode.cc",)
STEM = "libsegclip_zstd"
ERROR_BYTES = 256


def library_path() -> Path:
    return native_build.library_path(SRC_DIR, SOURCES, STEM)


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_build.build(SRC_DIR, SOURCES, STEM)))
    lib.zstd_decode.restype = ctypes.c_int
    lib.zstd_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    lib.zstd_free.restype = None
    lib.zstd_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.zstd_crc32c.restype = ctypes.c_uint32
    lib.zstd_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    return lib


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in `data`, concatenated. Raises
    ValueError on a malformed frame or a content checksum that disagrees."""
    lib = load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(ERROR_BYTES)
    if lib.zstd_decode(bytes(data), len(data), ctypes.byref(out), ctypes.byref(size),
                       err, ERROR_BYTES):
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.zstd_free(out)


def crc32c(data: bytes) -> int:
    return load().zstd_crc32c(bytes(data), len(data))
