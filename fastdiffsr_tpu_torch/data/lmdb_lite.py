"""Dependency-free LMDB (Lightning Memory-Mapped DB) file reader/writer.

Counterpart of ``fastdiffsr_tpu/data/lmdb_lite.py``, a copy of its own
(the port imports nothing of the JAX package): the same on-disk format,
so each package reads the other's files, and ``write_lmdb`` writes the
same bytes for the same entries.

Parity target: the reference's ``datatype: "lmdb"`` paths —
``data/LRHR_dataset.py:18-27`` (``lmdb.open(readonly)`` + ``txn.get`` of
``length`` and ``{lr,hr,sr}_..._{idx:05d}`` keys holding TIFF-encoded
bytes), ``data/prepare_data_mfe_dm.py:113,82-93`` (``--lmdb`` write path),
and EDiffSR's lmdb autodetect (``options.py:44-55``).

The ``lmdb`` package is not needed: this module implements the stable
LMDB 0.9 data format directly (magic 0xBEEFC0DE, data version 1; struct
layout per lmdb.h / mdb.c of the OpenLDAP LMDB distribution). Scope =
exactly what the reference uses: the single unnamed main DB, byte-string
keys/values, no dupsort. Files written by :func:`write_lmdb` are plain
single-B+tree databases readable by liblmdb; :class:`LmdbReader` reads
any LMDB file that stays within that scope and rejects sub-DBs
(F_SUBDATA) and dupsort leaves (P_LEAF2 / F_DUPDATA) with a clear error.

Everything is little-endian (LMDB files are host-endian; all practically
relevant hosts are LE) with 64-bit ``pgno_t``/``size_t``. Host code only.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

# --- format constants (lmdb.h) ---------------------------------------------
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
PAGEHDRSZ = 16
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04
P_INVALID = (1 << 64) - 1
NODESZ = 8                      # offsetof(MDB_node, mn_data)
MAXKEYSIZE = 511                # liblmdb compile-time default

_u16 = struct.Struct("<H")
_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")


def _even(n: int) -> int:
    return (n + 1) & ~1


def _nodemax(psize: int) -> int:
    """Largest in-leaf node size before data spills to overflow pages
    (mdb.c me_nodemax: ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2, minus
    one indx_t for the mp_ptrs slot)."""
    return (((psize - PAGEHDRSZ) // 2) & ~1) - 2


def _ovpages(size: int, psize: int) -> int:
    """Overflow-chain page count (mdb.c OVPAGES)."""
    return (PAGEHDRSZ - 1 + size) // psize + 1


class LmdbError(RuntimeError):
    pass


class LmdbReader:
    """Read-only access to an LMDB environment's main database.

    ``path`` may be the environment directory (containing ``data.mdb``,
    the lmdb ``subdir=True`` default the reference uses) or a ``.mdb``
    file directly. The file is mmap'd; ``get`` walks the B+tree exactly
    like mdb_page_search/mdb_node_search (node 0 of a branch page is the
    -inf sentinel; leaf lookup is exact-match binary search).
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0,
                             access=mmap.ACCESS_READ)
        m = self._mm
        if _u32.unpack_from(m, PAGEHDRSZ)[0] != MDB_MAGIC:
            raise LmdbError(f"{path}: not an LMDB data file (bad magic)")
        # page size lives in meta->mm_dbs[0].md_pad (mdb.h: #define
        # mm_psize mm_dbs[0].md_pad); meta 0 is always at offset 0
        self.psize = _u32.unpack_from(m, PAGEHDRSZ + 24)[0]
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(1)
        meta = meta1 if meta1["txnid"] > meta0["txnid"] else meta0
        self.root: int = meta["root"]
        self.entries: int = meta["entries"]
        self.depth: int = meta["depth"]
        self.last_pgno: int = meta["last_pg"]

    def _read_meta(self, pgno: int) -> dict:
        base = pgno * self.psize + PAGEHDRSZ
        m = self._mm
        magic, version = struct.unpack_from("<II", m, base)
        if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
            raise LmdbError(f"meta page {pgno}: bad magic/version "
                            f"({magic:#x}/{version})")
        # main DB record = mm_dbs[1] at meta+72
        _pad, _flags, depth = struct.unpack_from("<IHH", m, base + 72)
        branch, leaf, overflow, entries, root = struct.unpack_from(
            "<QQQQQ", m, base + 80)
        last_pg, txnid = struct.unpack_from("<QQ", m, base + 120)
        return {"depth": depth, "entries": entries, "root": root,
                "last_pg": last_pg, "txnid": txnid,
                "branch": branch, "leaf": leaf, "overflow": overflow}

    # -- page/node decoding --
    def _page(self, pgno: int) -> Tuple[int, int, int]:
        """-> (byte offset, flags, numkeys)."""
        off = pgno * self.psize
        flags = _u16.unpack_from(self._mm, off + 10)[0]
        lower = _u16.unpack_from(self._mm, off + 12)[0]
        return off, flags, (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, i: int) -> Tuple[int, int, int, bytes]:
        """-> (node offset, lo|hi<<16 word, flags, key)."""
        ptr = _u16.unpack_from(self._mm, page_off + PAGEHDRSZ + 2 * i)[0]
        noff = page_off + ptr
        lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._mm, noff)
        key = bytes(self._mm[noff + NODESZ:noff + NODESZ + ksize])
        return noff, lo | (hi << 16), nflags, key

    def _leaf_value(self, noff: int, word: int, nflags: int,
                    ksize: int) -> bytes:
        dstart = noff + NODESZ + ksize
        if nflags & (F_SUBDATA | F_DUPDATA):
            raise LmdbError("named sub-DBs / dupsort data are outside the "
                            "reference's LMDB usage and unsupported")
        if nflags & F_BIGDATA:
            ovpg = _u64.unpack_from(self._mm, dstart)[0]
            start = ovpg * self.psize + PAGEHDRSZ
            return bytes(self._mm[start:start + word])
        return bytes(self._mm[dstart:dstart + word])

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("utf-8")
        pgno = self.root
        if pgno == P_INVALID:
            return None
        while True:
            poff, flags, n = self._page(pgno)
            if flags & P_LEAF2:
                raise LmdbError("P_LEAF2 (dupfixed) pages unsupported")
            if flags & P_BRANCH:
                # rightmost child whose separator <= key; node 0 = -inf
                lo_i, hi_i, best = 1, n - 1, 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    _, _, _, k = self._node(poff, mid)
                    if k <= key:
                        best, lo_i = mid, mid + 1
                    else:
                        hi_i = mid - 1
                # 48-bit child pgno: mn_lo | mn_hi<<16 | mn_flags<<32
                _, word, nf, _ = self._node(poff, best)
                pgno = word | (nf << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) >> 1
                    noff, word, nf, k = self._node(poff, mid)
                    if k == key:
                        return self._leaf_value(noff, word, nf, len(k))
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise LmdbError(f"page {pgno}: unexpected flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order (key-sorted) iteration over the main DB."""
        if self.root == P_INVALID:
            return
        stack: List[int] = [self.root]
        while stack:
            pgno = stack.pop()
            poff, flags, n = self._page(pgno)
            if flags & P_BRANCH:
                children = []
                for i in range(n):
                    _, word, nf, _ = self._node(poff, i)
                    children.append(word | (nf << 32))
                stack.extend(reversed(children))
            elif flags & P_LEAF:
                for i in range(n):
                    noff, word, nf, k = self._node(poff, i)
                    yield k, self._leaf_value(noff, word, nf, len(k))
            else:
                raise LmdbError(f"page {pgno}: unexpected flags {flags:#x}")

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def __len__(self) -> int:
        return self.entries

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# Writer: bulk-build a single-version B+tree file bottom-up.
# --------------------------------------------------------------------------

class _PageBuf:
    def __init__(self, pgno: int, psize: int, flags: int):
        self.pgno = pgno
        self.psize = psize
        self.flags = flags
        self.ptrs: List[int] = []
        self.nodes: List[bytes] = []   # node i lives at page offset ptrs[i]
        self.upper = psize

    def free(self) -> int:
        return self.upper - (PAGEHDRSZ + 2 * len(self.ptrs))

    def add(self, node: bytes) -> None:
        self.upper -= _even(len(node))
        self.ptrs.append(self.upper)
        self.nodes.append(node)

    def render(self) -> bytes:
        out = bytearray(self.psize)
        _u64.pack_into(out, 0, self.pgno)
        _u16.pack_into(out, 10, self.flags)
        _u16.pack_into(out, 12, PAGEHDRSZ + 2 * len(self.ptrs))
        _u16.pack_into(out, 14, self.upper)
        for i, (p, node) in enumerate(zip(self.ptrs, self.nodes)):
            _u16.pack_into(out, PAGEHDRSZ + 2 * i, p)
            out[p:p + len(node)] = node
        return bytes(out)


def _leaf_node(key: bytes, dsize: int, flags: int, payload: bytes) -> bytes:
    return struct.pack("<HHHH", dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                       flags, len(key)) + key + payload


def _branch_node(key: bytes, pgno: int) -> bytes:
    return struct.pack("<HHHH", pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                       (pgno >> 32) & 0xFFFF, len(key)) + key


def write_lmdb(path: str, items, psize: int = 4096,
               subdir: bool = True) -> dict:
    """Write ``{key: value}`` (or iterable of byte-string pairs) as an
    LMDB environment at ``path`` (directory holding ``data.mdb`` when
    ``subdir``, matching the reference's ``lmdb.open(out_path)``).

    Bulk loader: keys are sorted, leaves packed greedily left-to-right,
    branch levels built bottom-up, both meta pages written identically
    with txnid 1. Returns {"entries", "depth", "pages"} for tests/logs.
    """
    if isinstance(items, dict):
        pairs = sorted((k.encode() if isinstance(k, str) else bytes(k),
                        bytes(v)) for k, v in items.items())
    else:
        dedup: Dict[bytes, bytes] = {}
        for k, v in items:
            dedup[k.encode() if isinstance(k, str) else bytes(k)] = bytes(v)
        pairs = sorted(dedup.items())
    for k, _ in pairs:
        if not k or len(k) > MAXKEYSIZE:
            raise LmdbError(f"key length {len(k)} outside [1, {MAXKEYSIZE}]")

    nodemax = _nodemax(psize)
    pages: Dict[int, bytes] = {}       # pgno -> rendered page
    next_pgno = 2                      # 0/1 = meta
    counts = {"leaf": 0, "branch": 0, "overflow": 0}

    def alloc(n: int = 1) -> int:
        nonlocal next_pgno
        pg = next_pgno
        next_pgno += n
        return pg

    # ---- leaves (+ overflow chains) ----
    # NOTE a 1-node tail leaf can occur (3 max-size nodes -> 2+1); that is
    # read-valid for liblmdb (MDB_MINKEYS only constrains its own
    # insert/rebalance paths, not lookups) and rebalances away on the
    # first write txn a real lmdb performs on the file.
    level: List[Tuple[bytes, int]] = []   # (first key, pgno) per page
    buf: Optional[_PageBuf] = None
    buf_first: Optional[bytes] = None

    def flush():
        nonlocal buf
        if buf is not None:
            pages[buf.pgno] = buf.render()
            level.append((buf_first, buf.pgno))
            buf = None

    for key, value in pairs:
        if NODESZ + len(key) + len(value) > nodemax:
            npg = _ovpages(len(value), psize)
            ovpg = alloc(npg)
            counts["overflow"] += npg
            chain = bytearray(npg * psize)
            _u64.pack_into(chain, 0, ovpg)
            _u16.pack_into(chain, 10, P_OVERFLOW)
            _u32.pack_into(chain, 12, npg)
            chain[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
            for j in range(npg):
                pages[ovpg + j] = bytes(chain[j * psize:(j + 1) * psize])
            node = _leaf_node(key, len(value), F_BIGDATA,
                              _u64.pack(ovpg))
        else:
            node = _leaf_node(key, len(value), 0, value)
        need = 2 + _even(len(node))
        if buf is None or buf.free() < need:
            flush()
            buf = _PageBuf(alloc(), psize, P_LEAF)
            counts["leaf"] += 1
            buf_first = key
        buf.add(node)
    flush()

    depth = 0
    if level:
        depth = 1
    # ---- branch levels ----
    while len(level) > 1:
        depth += 1
        parent: List[Tuple[bytes, int]] = []
        b: Optional[_PageBuf] = None
        bfirst: Optional[bytes] = None
        for i, (first_key, child) in enumerate(level):
            # node 0 of each branch page carries no key (the -inf
            # sentinel, as liblmdb writes them)
            pending_new = b is None
            key = b"" if pending_new else first_key
            node = _branch_node(key, child)
            need = 2 + _even(len(node))
            if b is not None and b.free() < need:
                pages[b.pgno] = b.render()
                parent.append((bfirst, b.pgno))
                b = None
                node = _branch_node(b"", child)
                need = 2 + _even(len(node))
            if b is None:
                b = _PageBuf(alloc(), psize, P_BRANCH)
                counts["branch"] += 1
                bfirst = first_key
            b.add(node)
        if b is not None:
            pages[b.pgno] = b.render()
            parent.append((bfirst, b.pgno))
        level = parent

    root = level[0][1] if level else P_INVALID
    last_pg = next_pgno - 1 if next_pgno > 2 else 1
    file_size = (last_pg + 1) * psize
    mapsize = max(10 * 1024 * 1024, file_size)
    mapsize = -(-mapsize // psize) * psize

    def meta_page(pgno: int) -> bytes:
        out = bytearray(psize)
        _u64.pack_into(out, 0, pgno)
        _u16.pack_into(out, 10, P_META)
        b = PAGEHDRSZ
        _u32.pack_into(out, b + 0, MDB_MAGIC)
        _u32.pack_into(out, b + 4, MDB_DATA_VERSION)
        _u64.pack_into(out, b + 8, 0)              # mm_address
        _u64.pack_into(out, b + 16, mapsize)
        # mm_dbs[0] (FREE_DBI): md_pad holds the page size
        _u32.pack_into(out, b + 24, psize)
        struct.pack_into("<HH", out, b + 28, 0, 0)
        struct.pack_into("<QQQQQ", out, b + 32, 0, 0, 0, 0, P_INVALID)
        # mm_dbs[1] (MAIN_DBI)
        _u32.pack_into(out, b + 72, 0)
        struct.pack_into("<HH", out, b + 76, 0, depth)
        struct.pack_into("<QQQQQ", out, b + 80, counts["branch"],
                         counts["leaf"], counts["overflow"], len(pairs),
                         root)
        _u64.pack_into(out, b + 120, last_pg)
        _u64.pack_into(out, b + 128, 1)            # mm_txnid
        return bytes(out)

    if subdir:
        os.makedirs(path, exist_ok=True)
        out_file = os.path.join(path, "data.mdb")
    else:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        out_file = path
    with open(out_file, "wb") as f:
        f.write(meta_page(0))
        f.write(meta_page(1))
        for pg in range(2, next_pgno):
            f.write(pages[pg])
    return {"entries": len(pairs), "depth": depth, "pages": next_pgno}
