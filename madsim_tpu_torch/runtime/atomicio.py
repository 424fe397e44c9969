"""Crash-safe atomic file writes: one discipline for every artifact.
The port's copy of `madsim_tpu/runtime/atomicio.py`, chaos hooks
included, so a store root is written the same way by either package.

Every durable artifact (hunt checkpoints, fleet job documents,
StatsEmitter snapshots, the corpus, port files) writes through here. A
plain tmp + rename is atomic against process death but not against
power loss or a kernel crash: the rename can be journaled while the tmp
file's data blocks are still in the page cache. The full discipline
is::

    write tmp -> flush -> fsync(tmp fd) -> rename -> fsync(directory)

The directory fsync persists the rename itself (the directory entry is
data too). `fsync=False` keeps the plain tmp+rename behavior for
artifacts that are throwaway-on-crash (e.g. per-batch stats snapshots
written many times a second).

Chaos hook (the fleet-chaos harness's injection point): when
``MADSIM_TPU_FLEET_CHAOS`` holds a JSON plan, writes whose absolute
path contains the plan's ``match`` substring are counted, and the
scheduled one dies deterministically:

* ``{"kill_at_write": K}`` — SIGKILL this process *instead of* the K-th
  write. Rename atomicity means the previous file version must survive.
* ``{"sigterm_at_write": K}`` — SIGTERM at the K-th write (once-only:
  the plan disarms itself before delivering, so the victim's handler —
  the worker's partial-span flush — can write through this same
  module on its way out). The claim under test is that a gracefully
  killed worker leaves a non-empty span dump behind.
* ``{"torn_at_write": [K, B]}`` — the kill lands mid-write: B bytes of
  the K-th payload reach the TMP file, the rename never runs, the
  process dies. The claim "atomic" makes is exactly that the final
  path still holds its previous version afterwards; `fleet fsck`
  sweeps the stale tmp.
* ``{"sigstop_at_write": K}`` — SIGSTOP self at the K-th write
  (once-only, like sigterm: the plan disarms itself first, so the
  resumed process writes on normally). This is the zombie fixture:
  the stopped worker's lease expires, a new holder takes the job,
  and when the harness SIGCONTs the zombie its writes must be
  fenced, never merged. The harness must only match paths written
  OUTSIDE the store's file locks (e.g. ``.ckpt``) — a process
  stopped while holding a flock would wedge every other worker.

The plan is parsed once per process (the harness sets the env var
before spawning the victim); `_reset_chaos_for_tests` re-arms it.

Pure stdlib, no torch, no wall-clock reads — safe to import from the
fleet control plane on a box with no card.
"""

from __future__ import annotations

import fcntl
import json
import os
import signal
from typing import Optional

_CHAOS: Optional[dict] = None
_WRITE_COUNT = 0


def _chaos_plan() -> dict:
    global _CHAOS
    if _CHAOS is None:
        raw = os.environ.get("MADSIM_TPU_FLEET_CHAOS")
        _CHAOS = json.loads(raw) if raw else {}
    return _CHAOS


def _reset_chaos_for_tests() -> None:
    global _CHAOS, _WRITE_COUNT
    _CHAOS, _WRITE_COUNT = None, 0


def _chaos_tick(path: str, text: str) -> None:
    """Count this write against the armed plan; die if it is the
    scheduled one. No-op (one dict read) when chaos is unarmed."""
    plan = _chaos_plan()
    if not plan:
        return
    match = plan.get("match")
    if match and match not in os.path.abspath(path):
        return
    global _WRITE_COUNT
    _WRITE_COUNT += 1
    n = _WRITE_COUNT
    if plan.get("kill_at_write") == n:
        os.kill(os.getpid(), signal.SIGKILL)
    if plan.get("sigterm_at_write") == n:
        # graceful-kill variant: fire ONCE and disarm before
        # delivering, because the victim's SIGTERM handler (the
        # worker's partial-span flush) appends through this same
        # writer and must go through
        plan.pop("sigterm_at_write", None)
        os.kill(os.getpid(), signal.SIGTERM)
    if plan.get("sigstop_at_write") == n:
        plan.pop("sigstop_at_write", None)  # once-only; see module doc
        os.kill(os.getpid(), signal.SIGSTOP)
    torn = plan.get("torn_at_write")
    if torn and int(torn[0]) == n:
        with open(f"{path}.tmp", "w") as f:
            f.write(text[: int(torn[1])])
        os.kill(os.getpid(), signal.SIGKILL)


def _chaos_tick_append(path: str, text: str) -> None:
    """The append-path twin of `_chaos_tick`, sharing the same write
    counter so one armed plan schedules across both disciplines. The
    torn variant differs on purpose: an append has no tmp file, so the
    partial payload lands in the REAL file — exactly the torn tail the
    jsonl readers and `fleet fsck` must tolerate."""
    plan = _chaos_plan()
    if not plan:
        return
    match = plan.get("match")
    if match and match not in os.path.abspath(path):
        return
    global _WRITE_COUNT
    _WRITE_COUNT += 1
    n = _WRITE_COUNT
    if plan.get("kill_at_write") == n:
        os.kill(os.getpid(), signal.SIGKILL)
    if plan.get("sigterm_at_write") == n:
        plan.pop("sigterm_at_write", None)  # once-only; see _chaos_tick
        os.kill(os.getpid(), signal.SIGTERM)
    if plan.get("sigstop_at_write") == n:
        plan.pop("sigstop_at_write", None)  # once-only; see _chaos_tick
        os.kill(os.getpid(), signal.SIGSTOP)
    torn = plan.get("torn_at_write")
    if torn and int(torn[0]) == n:
        with open(path, "a") as f:
            f.write(text[: int(torn[1])])
            f.flush()
            os.fsync(f.fileno())
        os.kill(os.getpid(), signal.SIGKILL)


def fsync_dir(dirpath: str) -> None:
    """Persist a just-performed rename in `dirpath`. Best-effort: some
    filesystems refuse O_RDONLY directory fsync — that degrades back to
    rename-without-dir-sync, never to an error on the write path."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str, *, fsync: bool = True) -> None:
    """Atomically replace `path` with `text` (tmp + fsync + rename +
    dir-fsync). A reader never observes a torn or partial file at
    `path`; a crash at any instant leaves either the old version or the
    new one."""
    _chaos_tick(path, text)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(os.path.abspath(path)))


def append_text(path: str, text: str, *, fsync: bool = True) -> None:
    """Append `text` to `path` (create if absent), fsync'd by default.

    Appends are NOT atomic — a crash mid-append leaves a torn tail in
    the real file, and that is a documented property, not a bug: the
    jsonl feeds written this way (event logs, span dumps) pair with
    readers that skip unparseable lines and an fsck verdict
    (`torn-tail`) that reports without quarantining. To keep one torn
    record from corrupting its successor, an append onto a file whose
    last byte is not a newline first heals the boundary with ``"\\n"``
    so the damage stays confined to its own line.

    Concurrent appenders (N workers sharing one queue/event log) rely
    on one more property: the heal byte and the record go down in a
    SINGLE ``os.write`` on an ``O_APPEND`` descriptor, so two processes
    appending at once interleave whole records, never bytes of one
    record inside another. The heal check and the write hold an
    exclusive ``flock`` on the file: a record that crosses a page
    boundary is copied in by pages, so without it another appender's
    last-byte read can see a record half written and heal a boundary
    that is not torn (a blank line in the log).
    """
    _chaos_tick_append(path, text)
    fd = os.open(path, os.O_RDWR | os.O_APPEND | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        size = os.fstat(fd).st_size
        heal = size > 0 and os.pread(fd, 1, size - 1) != b"\n"
        os.write(fd, (("\n" if heal else "") + text).encode())
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)  # releases the lock


def create_exclusive(path: str, text: str, *, fsync: bool = True) -> bool:
    """Create `path` with `text` iff it does not already exist
    (``O_CREAT|O_EXCL``) — the kernel arbitrates, so exactly one of N
    racing processes wins. Returns True for the winner, False when the
    file already existed (the loser backs off; nothing is written).
    This is the fleet claim-file primitive: claim creates go through
    the chaos write counter like every other durable write, so a plan
    matched on ``.claim`` can kill a contender at its k-th claim."""
    _chaos_tick(path, text)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
    except FileExistsError:
        return False
    try:
        os.write(fd, text.encode())
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)
    if fsync:
        fsync_dir(os.path.dirname(os.path.abspath(path)))
    return True


def atomic_write_json(path: str, doc, *, indent: int = 1,
                      sort_keys: bool = True, fsync: bool = True) -> None:
    text = json.dumps(doc, indent=indent, sort_keys=sort_keys) + "\n"
    atomic_write_text(path, text, fsync=fsync)
