"""The OCDBT key-value store that Orbax writes through tensorstore, read and
written in plain Python (no tensorstore): the port's counterpart of what
segclip_tpu/checkpoint/orbax_io.py reaches through orbax.

A store is a directory: `manifest.ocdbt` at its root, and data files under
`d/` (or under `ocdbt.process_N/d/`, which a multi-process save writes and
the root manifest points into). Every manifest, B-tree node and version-tree
node is encoded as

    magic u32 (big-endian) · length u64 · version varint · compression
    varint (0 none, 1 zstd) · body · CRC-32C u32 of all that precedes it

(integers little-endian unless said). The manifest's body holds the config
(uuid, manifest kind, the inline-value and node-size limits, the version
tree's arity, the compression), a data-file table, the newest versions
(generation, the B-tree root's height and location, statistics, commit
time) and references to version-tree nodes that hold the older ones. Lists
are stored column by column. A B-tree node holds its height, a data-file
table and its entries' keys, each key relative to the prefix its parent
entries share (a length shared with the previous key, then the rest);
interior entries name a child node, leaf entries hold a value inline or as
(data file, offset, length). A data file's path is relative to the base
path of the file that names it, so nodes under `ocdbt.process_0/` name
their files as `d/...`.

`read_store` returns the newest version's {key: bytes}; `OcdbtStore` reads
values on demand. `write_store` writes one version whose values lie in one
data file beside an uncompressed leaf node, which is what tensorstore reads
back.
"""
from __future__ import annotations

import os
import secrets
import struct
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from segclip_tpu_torch.checkpoint import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
MANIFEST_FILE = "manifest.ocdbt"
MISSING = (1 << 64) - 1               # offset and length of an empty tree's root
FORMAT_VERSION = 0
# what orbax configures (its ocdbt defaults in tensorstore_utils)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class Reader:
    """A cursor over a node's decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self.need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self.need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def decode(encoded: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, its header, length and
    checksum verified."""
    if len(encoded) < 18:
        raise ValueError(f"{what}: {len(encoded)} bytes, too short")
    got_magic, length = struct.unpack_from(">I", encoded)[0], struct.unpack_from("<Q", encoded, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(encoded):
        raise ValueError(f"{what}: header says {length} bytes, has {len(encoded)}")
    crc = struct.unpack_from("<I", encoded, len(encoded) - 4)[0]
    if zstd.crc32c(encoded[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = Reader(encoded[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{what}: format version {version}")
    body = encoded[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return body


def encode(body: bytes, magic: int) -> bytes:
    """An uncompressed manifest or node around `body`."""
    head = struct.pack(">I", magic)
    n = 4 + 8 + 2 + len(body) + 4
    out = head + struct.pack("<Q", n) + bytes([FORMAT_VERSION, 0]) + body
    return out + struct.pack("<I", zstd.crc32c(out))


@dataclass(frozen=True)
class Ref:
    """A range of a data file: its path from the store's root, and the base
    path that the files named inside it are relative to."""
    path: str
    base: str
    offset: int
    length: int


@dataclass(frozen=True)
class Version:
    generation: int
    height: int
    root: Optional[Ref]           # None: the empty tree
    num_keys: int
    commit_time: int


def read_file_table(r: Reader, base: str) -> List[Tuple[str, str]]:
    """A data-file table: [(path from the store's root, base path of the
    file's own references)]."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], ""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data-file path prefix past the previous path")
        path = prev[:prefix[i]] + r.raw(suffix[i]).decode()
        if base_len[i] > len(path):
            raise ValueError(f"{r.what}: data-file base path past its path")
        out.append((base + path, base + path[:base_len[i]]))
        prev = path
    return out


def ref(files, index: int, offset: int, length: int, what: str) -> Optional[Ref]:
    if offset == MISSING and length == MISSING:
        return None
    if index >= len(files):
        raise ValueError(f"{what}: data file {index} of {len(files)}")
    return Ref(files[index][0], files[index][1], offset, length)


def read_versions(r: Reader, files) -> List[Version]:
    n = r.varint()
    gen, height = r.varints(n), [r.byte() for _ in range(n)]
    index, offset, length = r.varints(n), r.varints(n), r.varints(n)
    num_keys, _tree_bytes, _indirect_bytes = r.varints(n), r.varints(n), r.varints(n)
    commit = r.u64s(n)
    return [Version(gen[i], height[i], ref(files, index[i], offset[i], length[i], r.what),
                    num_keys[i], commit[i]) for i in range(n)]


def read_version_refs(r: Reader, files, manifest: bool) -> List[Tuple[Ref, int, int]]:
    """References to version-tree nodes: [(ref, last generation, height)];
    the manifest stores each one's height, a node's children are one lower."""
    n = r.varint()
    gen = r.varints(n)
    index, offset, length = r.varints(n), r.varints(n), r.varints(n)
    _num_generations, _commit = r.varints(n), r.u64s(n)
    height = [r.byte() for _ in range(n)] if manifest else [None] * n
    return [(ref(files, index[i], offset[i], length[i], r.what), gen[i], height[i])
            for i in range(n)]


class OcdbtStore:
    """The newest version of the store at `root`: `keys()`, `store[key]`
    (the value's bytes, read on demand), `len(store)`."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, object] = {}
        try:
            self._open()
        except BaseException:
            self.close()
            raise

    def _open(self) -> None:
        root = self.root
        manifest = self._read_file(MANIFEST_FILE)
        r = Reader(decode(manifest, MANIFEST_MAGIC, MANIFEST_FILE), MANIFEST_FILE)
        self.uuid = r.raw(16)
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{root}: numbered manifests (kind {kind}) are not read")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.byte()
        self.compression = r.varint()
        if self.compression == 1:
            self.zstd_level = struct.unpack("<i", r.raw(4))[0]
        elif self.compression != 0:
            raise ValueError(f"{root}: unknown compression method {self.compression}")
        files = read_file_table(r, "")
        self.versions = read_versions(r, files)
        if not self.versions:
            raise ValueError(f"{root}: a manifest with no version")
        pending = read_version_refs(r, files, manifest=True)
        r.end()
        # Older versions sit in the version tree; each node is read and
        # verified, and the newest generation must be the manifest's last.
        while pending:
            node_ref, last_gen, height = pending.pop()
            if node_ref is None:
                raise ValueError(f"{root}: a version-tree node without a location")
            what = f"version-tree node {node_ref.path}@{node_ref.offset}"
            vr = Reader(decode(self._read(node_ref), VERSION_TREE_MAGIC, what), what)
            if vr.byte() != self.version_tree_arity_log2:
                raise ValueError(f"{what}: arity differs from the manifest's")
            got_height = vr.byte()
            if height is not None and got_height != height:
                raise ValueError(f"{what}: height {got_height}, expected {height}")
            node_files = read_file_table(vr, node_ref.base)
            if got_height == 0:
                older = read_versions(vr, node_files)
                if not older or older[-1].generation != last_gen:
                    raise ValueError(f"{what}: generations do not end at {last_gen}")
                self.versions = older + self.versions
            else:
                pending += [(c, g, got_height - 1)
                            for c, g, _ in read_version_refs(vr, node_files, manifest=False)]
            vr.end()
        self.versions.sort(key=lambda v: v.generation)
        newest = self.versions[-1]
        self.generation = newest.generation
        self._values: Dict[str, object] = {}
        if newest.root is not None:
            self._walk(newest.root, newest.height, b"")
        if len(self._values) != newest.num_keys:
            raise ValueError(f"{root}: {len(self._values)} keys, the manifest counts "
                             f"{newest.num_keys}")

    def _read_file(self, path: str) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            return f.read()

    def _read(self, r: Ref) -> bytes:
        f = self._files.get(r.path)
        if f is None:
            f = self._files[r.path] = open(os.path.join(self.root, r.path), "rb")
        f.seek(r.offset)
        data = f.read(r.length)
        if len(data) != r.length:
            raise ValueError(f"{r.path}: {r.length} bytes at {r.offset} past its end")
        return data

    def _walk(self, node_ref: Ref, height: int, prefix: bytes) -> None:
        what = f"B-tree node {node_ref.path}@{node_ref.offset}"
        r = Reader(decode(self._read(node_ref), BTREE_MAGIC, what), what)
        got = r.byte()
        if got != height:
            raise ValueError(f"{what}: height {got}, expected {height}")
        files = read_file_table(r, node_ref.base)
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        rest = r.varints(n)
        subtree = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise ValueError(f"{what}: key prefix past the previous key")
            prev = prev[:shared[i]] + r.raw(rest[i])
            keys.append(prev)
        if height:
            index, offset, length = r.varints(n), r.varints(n), r.varints(n)
            r.varints(n), r.varints(n), r.varints(n)    # statistics
            r.end()
            for i in range(n):
                child = ref(files, index[i], offset[i], length[i], what)
                if child is None or subtree[i] > len(keys[i]):
                    raise ValueError(f"{what}: entry {i} has no child")
                self._walk(child, height - 1, prefix + keys[i][:subtree[i]])
            return
        value_len = r.varints(n)
        kind = [r.byte() for _ in range(n)]
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            raise ValueError(f"{what}: unknown value kind")
        index, offset = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(index, offset)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in refs:
                self._values[key] = ref(files, refs[i][0], refs[i][1], value_len[i], what)
            else:
                self._values[key] = r.raw(value_len[i])
        r.end()

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __getitem__(self, key: str) -> bytes:
        value = self._values[key]
        return self._read(value) if isinstance(value, Ref) else value

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_store(root: str) -> Dict[str, bytes]:
    """The newest version of the OCDBT store at `root` as {key: bytes}."""
    with OcdbtStore(root) as store:
        return {k: store[k] for k in store.keys()}


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def write_store(root: str, values: Dict[str, bytes]) -> int:
    """Write `values` as a new OCDBT store at `root` (which must not hold
    one): one generation whose B-tree is a single uncompressed leaf node,
    values longer than MAX_INLINE_VALUE_BYTES in one data file under `d/`
    before the node. Returns the bytes written."""
    if os.path.exists(os.path.join(root, MANIFEST_FILE)):
        raise FileExistsError(f"{root} already holds an OCDBT store")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_name = "d/" + secrets.token_hex(16)
    keys = sorted(k.encode() for k in values)
    written = 0
    offsets: Dict[bytes, int] = {}
    with open(os.path.join(root, data_name), "wb") as f:
        for k in keys:
            v = values[k.decode()]
            if len(v) > MAX_INLINE_VALUE_BYTES:
                offsets[k] = written
                f.write(v)
                written += len(v)
        table = _varints([1, len(data_name), 0]) + data_name.encode()
        n = len(keys)
        shared = [_shared(keys[i - 1], keys[i]) for i in range(1, n)]
        full = [0] + shared
        node = (bytes([0]) + table + _varint(n) + _varints(shared)
                + _varints(len(k) - s for k, s in zip(keys, full))
                + b"".join(k[s:] for k, s in zip(keys, full))
                + _varints(len(values[k.decode()]) for k in keys)
                + bytes(int(k in offsets) for k in keys)
                + _varints(0 for k in keys if k in offsets)
                + _varints(offsets[k] for k in keys if k in offsets)
                + b"".join(values[k.decode()] for k in keys if k not in offsets))
        node = encode(node, BTREE_MAGIC)
        node_offset = written
        f.write(node)
        written += len(node)
    indirect = sum(len(values[k.decode()]) for k in offsets)
    config = (secrets.token_bytes(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0))
    manifest = (config + table
                + _varints([1, 1]) + bytes([0])          # one version: generation 1, a leaf root
                + _varints([0, node_offset, len(node), n, len(node), indirect])
                + struct.pack("<Q", time.time_ns())
                + _varint(0))                            # no version-tree nodes
    manifest = encode(manifest, MANIFEST_MAGIC)
    with open(os.path.join(root, MANIFEST_FILE), "wb") as f:
        f.write(manifest)
    return written + len(manifest)
