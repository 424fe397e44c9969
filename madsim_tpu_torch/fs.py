"""Simulated filesystem (reference: madsim/src/sim/fs.rs).

Per-node in-memory inode map with positional read/write, metadata and
read-only enforcement. Write durability is modeled with a working copy
(page cache) and a durable copy per inode: all mutations (including
create-truncate) hit the working copy, `sync_all`/`sync_data` snapshot
it durable, and a node kill/restart triggers `power_fail`, restoring the
working copy from durable — the behavior the reference marks TODO
(fs.rs:50-53,:205-207) but whose hook it already wires to reset_node.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import _context
from .errors import SimError
from .plugin import Simulator


class FsError(SimError):
    pass


class INode:
    """Reference: fs.rs:125 `INode`.

    Two copies model durability: `working` is what the running node
    reads/writes (a page cache), `durable` is what survives power
    failure. `sync_all` snapshots working -> durable; `power_fail`
    restores working <- durable. All mutations — content writes,
    truncation, and the namespace ops create/unlink — are working-level
    until synced: an unsynced create vanishes on power failure and an
    unsynced unlink rolls back."""

    __slots__ = ("durable", "working", "readonly", "exists_durable", "removed")

    def __init__(self) -> None:
        self.durable = bytearray()
        self.working = bytearray()
        self.readonly = False
        self.exists_durable = False  # creation not yet fsynced
        self.removed = False  # unlinked in the working view

    def sync(self) -> None:
        self.durable = bytearray(self.working)
        if not self.removed:
            self.exists_durable = True

    def power_fail(self) -> None:
        self.working = bytearray(self.durable)
        self.removed = False  # an unsynced unlink rolls back


class FsSim(Simulator):
    """Reference: fs.rs:24 `FsSim`."""

    def __init__(self, rng, time, config):
        super().__init__(rng, time, config)
        self._nodes: Dict[int, Dict[str, INode]] = {}

    def create_node(self, node_id: int) -> None:
        self._nodes.setdefault(node_id, {})

    def reset_node(self, node_id: int) -> None:
        """Node kill/restart: trigger power-fail semantics
        (reference: fs.rs:38-40 — TODO in the reference as well)."""
        self.power_fail(node_id)

    def power_fail(self, node_id: int) -> None:
        """Drop all unsynced state — content AND namespace ops
        (reference: fs.rs:50-53 marks this TODO; implemented here).
        Synced data survives."""
        files = self._nodes.get(node_id, {})
        for path in [p for p, ino in files.items() if not ino.exists_durable]:
            del files[path]  # unsynced creations vanish
        for inode in files.values():
            inode.power_fail()

    def fs_of(self, node_id: int) -> Dict[str, INode]:
        return self._nodes.setdefault(node_id, {})


def _current_fs() -> Dict[str, INode]:
    from .plugin import simulator
    from .task import current_node_id

    return simulator(FsSim).fs_of(current_node_id())


class Metadata:
    def __init__(self, size: int, readonly: bool):
        self._size = size
        self._readonly = readonly

    def len(self) -> int:
        return self._size

    def is_readonly(self) -> bool:
        return self._readonly


class File:
    """Positional-I/O file handle (reference: fs.rs:68 `FsNodeHandle`/File)."""

    def __init__(self, inode: INode, writable: bool):
        self._inode = inode
        self._writable = writable

    @staticmethod
    async def open(path: str) -> "File":
        fs = _current_fs()
        inode = fs.get(path)
        if inode is None or inode.removed:
            raise FsError(f"file not found: {path}")
        return File(inode, writable=not inode.readonly)

    @staticmethod
    async def create(path: str) -> "File":
        fs = _current_fs()
        inode = fs.get(path)
        if inode is None:
            inode = INode()
            fs[path] = inode
        if inode.readonly:
            raise FsError(f"file is read-only: {path}")
        inode.working = bytearray()  # truncate is unsynced like any write
        inode.removed = False  # re-creating an unlinked name (unsynced)
        return File(inode, writable=True)

    async def read_at(self, buf_len: int, offset: int) -> bytes:
        return bytes(self._inode.working[offset : offset + buf_len])

    async def read_all(self) -> bytes:
        return bytes(self._inode.working)

    async def write_all_at(self, data: bytes, offset: int) -> None:
        """Working-copy write: lost on power_fail until sync_all."""
        if not self._writable or self._inode.readonly:
            raise FsError("file is read-only")
        buf = self._inode.working
        end = offset + len(data)
        if len(buf) < end:
            buf.extend(b"\x00" * (end - len(buf)))
        buf[offset:end] = data

    async def set_len(self, size: int) -> None:
        if not self._writable or self._inode.readonly:
            raise FsError("file is read-only")
        buf = self._inode.working
        if len(buf) > size:
            del buf[size:]
        else:
            buf.extend(b"\x00" * (size - len(buf)))

    async def sync_all(self) -> None:
        """Flush to durable storage (reference: fsync)."""
        self._inode.sync()

    sync_data = sync_all

    async def metadata(self) -> Metadata:
        return Metadata(len(self._inode.working), self._inode.readonly)


async def read(path: str) -> bytes:
    f = await File.open(path)
    return await f.read_all()


async def write(path: str, data: bytes) -> None:
    """Convenience write: durable on return (create + write + sync)."""
    f = await File.create(path)
    await f.write_all_at(data, 0)
    await f.sync_all()


async def remove_file(path: str) -> None:
    """Unlink: working-level until power failure or durable GC — an
    unsynced unlink rolls back on crash."""
    fs = _current_fs()
    inode = fs.get(path)
    if inode is None or inode.removed:
        raise FsError(f"file not found: {path}")
    if inode.exists_durable:
        inode.removed = True
    else:
        del fs[path]  # never durable: gone outright


async def metadata(path: str) -> Metadata:
    fs = _current_fs()
    inode = fs.get(path)
    if inode is None or inode.removed:
        raise FsError(f"file not found: {path}")
    return Metadata(len(inode.working), inode.readonly)


def set_readonly(path: str, readonly: bool = True) -> None:
    """Test helper mirroring the reference's read-only enforcement."""
    fs = _current_fs()
    if path not in fs:
        raise FsError(f"file not found: {path}")
    fs[path].readonly = readonly
