"""Pure-Python read-only LMDB parser (the port's own copy of
diffpure_tpu/data/lmdb_reader.py, which imports no JAX: the port imports
nothing of the JAX package).

The reference caches ImageNet val images in an LMDB keyed by file path
(ref data/datasets.py:261-306: ``txn.get(path.encode('ascii'))`` returns the
raw image bytes). The ``lmdb`` C binding is not available in this
environment, so this module parses the standard LMDB on-disk format
directly: a copy-on-write B+tree of 4 KiB pages behind two alternating
meta pages. Read path only — enough for ``get``/iteration/``stat`` over an
existing environment; no locks are taken (equivalent to the reference's
``lmdb.open(..., readonly=True, lock=False)``).

Format summary (public LMDB file format, 64-bit layout):
  page header   pgno:u64  pad:u16  flags:u16  lower:u16  upper:u16
  meta page     header(flags=META) + magic:u32=0xBEEFC0DE version:u32=1
                address:u64 mapsize:u64 dbs[2]:48B each last_pg:u64 txnid:u64
  MDB_db        pad:u32 flags:u16 depth:u16 branch:u64 leaf:u64
                overflow:u64 entries:u64 root:u64
  node          lo:u16 hi:u16 flags:u16 ksize:u16 key[ksize] data...
    leaf:   datasize = lo | hi<<16; F_BIGDATA => data is u64 overflow pgno
    branch: child pgno = lo | hi<<16 | flags<<32
Keys compare as unsigned bytes (memcmp). The newer of the two meta pages
(higher txnid) is authoritative.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
NODESZ = 8

_PAGEHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_META = struct.Struct("<IIQQ")              # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")            # pad,flags,depth,branch,leaf,ovf,entries,root
_NODEHDR = struct.Struct("<HHHH")           # lo, hi, flags, ksize


class LMDBFormatError(ValueError):
    pass


class LMDBReader:
    """Read-only view of an LMDB environment (main DB, default comparator).

    ``path`` may be the environment directory (containing ``data.mdb``) or
    the data file itself. Duplicate-key (DUPSORT) and fixed-key (LEAF2)
    databases are out of scope — the reference writes a plain map.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self._psize, _db_flags, self._depth, _b, _l, _o,
         self._entries, self._root) = meta

    # -- meta ---------------------------------------------------------------

    def _read_meta(self, off: int) -> Tuple[int, tuple]:
        """-> (txnid, (psize, main_db fields...)) or raises."""
        _, _, flags, _, _ = _PAGEHDR.unpack_from(self._mm, off)
        if not flags & P_META:
            raise LMDBFormatError("expected meta page")
        magic, version, _addr, _mapsize = _META.unpack_from(
            self._mm, off + PAGEHDRSZ)
        if magic != MAGIC:
            raise LMDBFormatError(f"bad magic 0x{magic:x}")
        if version != VERSION:
            raise LMDBFormatError(f"unsupported version {version}")
        dbs_off = off + PAGEHDRSZ + _META.size
        free_db = _DB.unpack_from(self._mm, dbs_off)
        main_db = _DB.unpack_from(self._mm, dbs_off + _DB.size)
        txnid = struct.unpack_from(
            "<Q", self._mm, dbs_off + 2 * _DB.size + 8)[0]
        psize = free_db[0] or 4096          # mm_psize lives in FREE_DBI.md_pad
        return txnid, (psize,) + main_db[1:]

    def _pick_meta(self) -> tuple:
        # Meta pages are at pgno 0 and 1; page size is only known from the
        # meta itself, but both live within the first 8 KiB for any psize
        # >= 4096 written by stock LMDB (meta1 at offset psize).
        txn0, m0 = self._read_meta(0)
        psize = m0[0]
        try:
            txn1, m1 = self._read_meta(psize)
        except (LMDBFormatError, struct.error):
            return m0
        return m1 if txn1 > txn0 else m0

    # -- pages --------------------------------------------------------------

    def _page(self, pgno: int) -> int:
        off = pgno * self._psize
        if off + PAGEHDRSZ > len(self._mm):
            raise LMDBFormatError(f"page {pgno} out of range")
        return off

    def _page_flags(self, off: int) -> int:
        return _PAGEHDR.unpack_from(self._mm, off)[2]

    def _num_keys(self, off: int) -> int:
        lower = _PAGEHDR.unpack_from(self._mm, off)[3]
        return (lower - PAGEHDRSZ) >> 1

    def _node_off(self, page_off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._mm,
                                 page_off + PAGEHDRSZ + 2 * i)[0]
        return page_off + ptr

    def _node_key(self, node_off: int) -> bytes:
        _, _, _, ksize = _NODEHDR.unpack_from(self._mm, node_off)
        return self._mm[node_off + NODESZ:node_off + NODESZ + ksize]

    def _leaf_value(self, node_off: int) -> bytes:
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._mm, node_off)
        if flags & (F_SUBDATA | F_DUPDATA):
            raise LMDBFormatError("DUPSORT databases are not supported")
        dsize = lo | (hi << 16)
        data_off = node_off + NODESZ + ksize
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", self._mm, data_off)[0]
            start = self._page(ovf_pgno) + PAGEHDRSZ
            return self._mm[start:start + dsize]
        return self._mm[data_off:data_off + dsize]

    def _branch_child(self, node_off: int) -> int:
        lo, hi, flags, _ = _NODEHDR.unpack_from(self._mm, node_off)
        return lo | (hi << 16) | (flags << 32)

    # -- public API ----------------------------------------------------------

    def get(self, key: bytes, default: Optional[bytes] = None
            ) -> Optional[bytes]:
        if self._root == P_INVALID:
            return default
        pgno = self._root
        while True:
            off = self._page(pgno)
            flags = self._page_flags(off)
            n = self._num_keys(off)
            if flags & P_LEAF2:
                raise LMDBFormatError("LEAF2 pages are not supported")
            if flags & P_BRANCH:
                # node 0's key is implicit -inf; pick last child whose
                # separator key <= target (mdb_page_search_root semantics)
                lo_i, hi_i = 1, n
                while lo_i < hi_i:          # first i with key(i) > key
                    mid = (lo_i + hi_i) >> 1
                    if self._node_key(self._node_off(off, mid)) <= key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid
                pgno = self._branch_child(self._node_off(off, lo_i - 1))
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    noff = self._node_off(off, mid)
                    k = self._node_key(noff)
                    if k == key:
                        return self._leaf_value(noff)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return default
            else:
                raise LMDBFormatError(f"unexpected page flags 0x{flags:x}")

    def __getitem__(self, key: bytes) -> bytes:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key: bytes) -> bool:
        return self.get(key) is not None

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order (cursor-forward equivalent)."""
        if self._root == P_INVALID:
            return
        stack = [self._root]
        while stack:
            off = self._page(stack.pop())
            flags = self._page_flags(off)
            n = self._num_keys(off)
            if flags & P_BRANCH:
                stack.extend(
                    self._branch_child(self._node_off(off, i))
                    for i in reversed(range(n)))
            else:
                for i in range(n):
                    noff = self._node_off(off, i)
                    yield self._node_key(noff), self._leaf_value(noff)

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k

    def __len__(self) -> int:
        return self._entries

    def stat(self) -> dict:
        """Mirror of lmdb's Environment.stat() fields."""
        return dict(psize=self._psize, depth=self._depth,
                    entries=self._entries)

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self) -> "LMDBReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
