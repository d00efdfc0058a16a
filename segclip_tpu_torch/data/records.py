"""SGR record files (a copy of segclip_tpu/data/records.py; held equal to it
by tests/test_torch_data.py): the indexed record format of the training
shards.

Layout (little-endian): magic "SGRECv1\\0", u64 record count N, N × (u64
offset, u64 length), then the records, each [u32 key length][key][payload].
The writer is Python (offline packing); the reader uses the port's native
mmap reader (segclip_tpu_torch/native/records.cc) and falls back to Python's
mmap when the library cannot be built or the file cannot be opened by it.
"""
from __future__ import annotations

import ctypes
import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = b"SGRECv1\x00"


class SgrWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._records: List[Tuple[bytes, int, int]] = []  # key, off, len
        self._tmp = path + ".blobs.tmp"
        self._blob = open(self._tmp, "wb")
        self._pos = 0

    def add(self, key: bytes | str, payload: bytes) -> None:
        if isinstance(key, str):
            key = key.encode("utf-8")
        rec = struct.pack("<I", len(key)) + key + payload
        self._blob.write(rec)
        self._records.append((key, self._pos, len(rec)))
        self._pos += len(rec)

    def close(self) -> None:
        self._blob.close()
        n = len(self._records)
        header_size = 16 + n * 16
        with open(self.path, "wb") as out:
            out.write(MAGIC)
            out.write(struct.pack("<Q", n))
            for _, off, length in self._records:
                out.write(struct.pack("<QQ", header_size + off, length))
            with open(self._tmp, "rb") as blob:
                while True:
                    chunk = blob.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
        os.remove(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SgrReader:
    """Zero-copy record access. Tries the native reader, falls back to
    Python mmap (`native=False` asks for the mmap path)."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self._lib = None
        self._handle = None
        try:
            if not native:
                raise OSError("the mmap path was asked for")
            from segclip_tpu_torch.native.build import load
            self._lib = load()
            self._handle = self._lib.sgr_open(path.encode())
            if not self._handle:
                raise OSError(f"native reader failed to open {path}")
            self._count = int(self._lib.sgr_count(self._handle))
        except Exception:
            self._lib = None
            self._open_python()
        self._key_index: Optional[Dict[bytes, int]] = None

    def _open_python(self):
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:8] != MAGIC:
            raise ValueError(f"{self.path}: bad SGR magic")
        (self._count,) = struct.unpack_from("<Q", self._mm, 8)
        self._index = struct.unpack_from(f"<{2 * self._count}Q", self._mm, 16)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __len__(self) -> int:
        return self._count

    def record(self, i: int) -> Tuple[bytes, bytes]:
        if self._lib is not None:
            key_p = ctypes.POINTER(ctypes.c_uint8)()
            key_len = ctypes.c_uint32()
            pay_p = ctypes.POINTER(ctypes.c_uint8)()
            pay_len = ctypes.c_uint64()
            rc = self._lib.sgr_record(self._handle, i,
                                      ctypes.byref(key_p),
                                      ctypes.byref(key_len),
                                      ctypes.byref(pay_p),
                                      ctypes.byref(pay_len))
            if rc != 0:
                raise IndexError(i)
            key = ctypes.string_at(key_p, key_len.value)
            payload = ctypes.string_at(pay_p, pay_len.value)
            return key, payload
        if not 0 <= i < self._count:
            raise IndexError(i)
        off, length = self._index[2 * i], self._index[2 * i + 1]
        rec = self._mm[off:off + length]
        (kl,) = struct.unpack_from("<I", rec, 0)
        return bytes(rec[4:4 + kl]), bytes(rec[4 + kl:])

    def get(self, key: bytes | str) -> bytes:
        if isinstance(key, str):
            key = key.encode("utf-8")
        if self._key_index is None:
            self._key_index = {self.record(i)[0]: i
                               for i in range(self._count)}
        return self.record(self._key_index[key])[1]

    def keys(self) -> Iterator[bytes]:
        for i in range(self._count):
            yield self.record(i)[0]

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.sgr_close(self._handle)
            self._handle = None
        elif self._lib is None and hasattr(self, "_mm"):
            self._mm.close()
            self._file.close()


def write_json_sidecar(path: str, meta: dict) -> None:
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def read_json_sidecar(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)
