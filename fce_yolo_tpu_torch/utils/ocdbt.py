"""A read-only OCDBT key-value store (tensorstore's "optionally-cooperative
distributed B-tree"), as orbax writes every checkpoint's ``tree/``.

A database is a directory: ``manifest.ocdbt`` and data files (``d/<hex>``,
or a sub-database's, as orbax's ``ocdbt.process_0/d/<hex>``). Every encoded
piece (the manifest, a version tree node, a B-tree node) is

    magic (u32 big-endian) | length (u64) | version (varint, 0)
    | compression (u8: 0 none, 1 zstd) | body | CRC-32C (u32) of all before

and every integer in a body is a little-endian base-128 varint unless
named otherwise. The manifest holds the config (uuid, manifest kind,
inline and node size limits, version tree arity, compression), a data file
table, the newest versions inline and the version tree's node references;
each version names the root B-tree node of the key space by (data file,
offset, length). A B-tree node holds its height, a data file table and its
entries column by column: keys prefix-compressed against the entry before,
then for a leaf each value's length and kind (inline, or indirect by data
file and offset), for an interior node each child's common key prefix and
reference. A data file table lists paths as (bytes shared with the path
before, suffix length, base path length) columns, then the suffixes; a path
is relative to the database's directory.

Node bodies decompress through ``utils/zstd.py`` on the caller's
``device`` (the C++ decoder for ``cuda``, Python for ``cpu``). Each piece's
CRC-32C is checked: a mismatch raises naming the file. Values are read as
they are stored (orbax's array chunks carry their own zstd frames; see
``utils/zarr.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.utils import zstd

__all__ = ["OcdbtStore", "crc32c"]

MANIFEST_MAGIC, VERSION_NODE_MAGIC, BTREE_NODE_MAGIC = 0x0CDB3A2A, 0x0CDB1234, 0x0CDB20DE
EMPTY = (1 << 64) - 1  # the offset of an empty version's root


def _crc_table() -> np.ndarray:
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ poly, t >> 1).astype(np.uint32)
    return t


_CRC = _crc_table().tolist()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tab = _CRC
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Sequential reads of a decoded body; running past its end raises."""

    def __init__(self, buf: bytes, name: str):
        self.buf, self.pos, self.name = buf, 0, name

    def _short(self) -> ValueError:
        return ValueError(f"{self.name}: an OCDBT body cut short at byte {self.pos}")

    def u8(self) -> int:
        if self.pos >= len(self.buf):
            raise self._short()
        self.pos += 1
        return self.buf[self.pos - 1]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.name}: a varint longer than 64 bits at byte {self.pos}")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise self._short()
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def u64s(self, n: int) -> list[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]


def _data_files(r: _Reader) -> list[str]:
    """A data file table -> the relative path of each file."""
    n = r.varint()
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the base is part of the path, relative to the database
    paths: list[str] = []
    for i in range(n):
        if i and shared[i] > len(paths[-1]):
            raise ValueError(f"{r.name}: a data file path sharing more than the path before it")
        prev = paths[-1].encode() if i else b""
        paths.append((prev[:shared[i]] + r.take(suffix[i])).decode())
    return paths


def _refs(r: _Reader, n: int, files: list[str]) -> list[tuple[str, int, int]]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    if any(i >= len(files) for i in ids):
        raise ValueError(f"{r.name}: a data file id past its table")
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


class OcdbtStore:
    """The newest version of the OCDBT database in directory ``root``:
    ``list()`` its keys, ``read(key)`` a value's bytes."""

    def __init__(self, root: str | Path, device="cpu"):
        import torch

        self.root = Path(root).resolve()
        self.device = torch.device(device)
        self.nodes_read = 0
        self._values: dict[bytes, tuple] = {}
        root_ref = self._latest_root()
        if root_ref is not None:
            self._walk(root_ref, b"")

    # ------------------------------------------------------------------ pieces
    def _path(self, rel: str) -> Path:
        p = (self.root / rel).resolve()
        if self.root not in p.parents:
            raise ValueError(f"{self.root}: data file {rel!r} lies outside the database")
        return p

    def _piece(self, name: str, data: bytes, magic: int) -> _Reader:
        """Check and decode one encoded piece; returns a reader of its body."""
        if len(data) < 18:
            raise ValueError(f"{name}: {len(data)} bytes is too short for an OCDBT piece")
        got = int.from_bytes(data[:4], "big")
        if got != magic:
            raise ValueError(f"{name}: magic {got:#010x} where an OCDBT piece has {magic:#010x}")
        if int.from_bytes(data[4:12], "little") != len(data):
            raise ValueError(f"{name}: its length field says {int.from_bytes(data[4:12], 'little')} bytes, "
                             f"the piece has {len(data)}")
        want = int.from_bytes(data[-4:], "little")
        if crc32c(data[:-4]) != want:
            raise ValueError(f"{name}: CRC-32C mismatch (the file is corrupt)")
        r = _Reader(data[:-4], name)
        r.pos = 12
        if r.varint() != 0:
            raise ValueError(f"{name}: an OCDBT format version other than 0")
        comp = r.u8()
        body = data[r.pos:-4]
        if comp == 1:
            try:
                body = zstd.decompress(body, self.device)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
        elif comp != 0:
            raise ValueError(f"{name}: compression format {comp} is neither none (0) nor zstd (1)")
        return _Reader(body, name)

    def _read_ref(self, ref: tuple[str, int, int], magic: int) -> _Reader:
        rel, offset, length = ref
        path = self._path(rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked for, the file ends first")
        self.nodes_read += 1
        return self._piece(f"{path} at {offset}", data, magic)

    # ------------------------------------------------------------------ versions
    @staticmethod
    def _versions(r: _Reader, files: list[str]) -> list[tuple[int, int, tuple]]:
        """Version entries -> [(generation, root height, root reference)]."""
        n = r.varint()
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        refs = _refs(r, n, files)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        r.u64s(n)  # commit times
        return list(zip(gens, heights, refs))

    @staticmethod
    def _version_nodes(r: _Reader, files: list[str], with_height: bool) -> list[tuple[int, int, tuple]]:
        """Version tree node references -> [(generation, height or -1, reference)]."""
        n = r.varint()
        gens = r.varints(n)
        refs = _refs(r, n, files)
        r.varints(n)  # generations under each
        r.u64s(n)  # commit times
        heights = [r.u8() for _ in range(n)] if with_height else [-1] * n
        return list(zip(gens, heights, refs))

    def _latest_root(self) -> tuple | None:
        name = str(self.root / "manifest.ocdbt")
        try:
            data = (self.root / "manifest.ocdbt").read_bytes()
        except FileNotFoundError:
            raise ValueError(f"{self.root}: no manifest.ocdbt (not an OCDBT database)") from None
        r = self._piece(name, data, MANIFEST_MAGIC)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{name}: manifest kind {kind} (numbered manifests) is not supported, only a single "
                             "manifest.ocdbt")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.u8()  # version tree arity log2
        if r.varint() == 1:
            r.take(4)  # the zstd level
        files = _data_files(r)
        inline = self._versions(r, files)
        nodes = self._version_nodes(r, files, with_height=True)
        if inline:
            gen, height, ref = max(inline)
            return height, ref
        while nodes:  # the newest generation lies under the node with the highest one
            _, height, ref = max(nodes)
            vr = self._read_ref(ref, VERSION_NODE_MAGIC)
            vr.u8()  # arity log2
            h = vr.u8()
            vfiles = _data_files(vr)
            if h == 0:
                gen, height, ref = max(self._versions(vr, vfiles))
                return height, ref
            nodes = self._version_nodes(vr, vfiles, with_height=False)
        return None

    # ------------------------------------------------------------------ B-tree
    def _walk(self, root: tuple, prefix: bytes) -> None:
        height, ref = root
        if ref[1] == EMPTY:  # a version with no keys
            return
        r = self._read_ref(ref, BTREE_NODE_MAGIC)
        h = r.u8()
        if h != height:
            raise ValueError(f"{r.name}: a B-tree node of height {h} where its parent says {height}")
        files = _data_files(r)
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if h else []
        keys: list[bytes] = []
        for i in range(n):
            if i and shared[i] > len(keys[-1]):
                raise ValueError(f"{r.name}: a key sharing more than the key before it")
            keys.append((keys[-1][:shared[i]] if i else b"") + r.take(suffix[i]))
        if h:
            children = _refs(r, n, files)
            r.varints(3 * n)  # statistics
            for key, c, child in zip(keys, common, children):
                self._walk((h - 1, child), prefix + key[:c])
            return
        lengths = r.varints(n)
        kinds = [r.u8() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise ValueError(f"{r.name}: a value kind other than inline (0) or indirect (1)")
        indirect = sum(kinds)
        ids, offsets = r.varints(indirect), r.varints(indirect)
        if any(i >= len(files) for i in ids):
            raise ValueError(f"{r.name}: a data file id past its table")
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            if kind:
                self._values[prefix + key] = ("file", files[ids[j]], offsets[j], length)
                j += 1
            else:
                self._values[prefix + key] = ("inline", r.take(length))

    # ------------------------------------------------------------------ public
    def list(self) -> list[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        """The stored bytes of ``key``; a missing key raises ``KeyError``."""
        v = self._values.get(key.encode())
        if v is None:
            raise KeyError(f"{self.root}: no key {key!r}")
        if v[0] == "inline":
            return v[1]
        _, rel, offset, length = v
        path = self._path(rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: the value of {key!r} ({length} bytes at {offset}) runs past the file's end")
        return data
