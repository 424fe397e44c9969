"""The ranks of one command: `--devices N` runs its streams over N ranks.

The calling process is rank 0 and runs the command as it would alone.
`spawn_mesh(n)` starts the other N - 1 ranks as follower processes
(`python -m madsim_tpu_torch.parallel.ranks`), which join rank 0's
process group and then only serve its meshed engine calls. Every such
call goes through `Ranks.call`: it sends the call (the machine, the
config, the method and its arguments, pickled) down every follower's
stdin, then enters it itself; each follower enters the same call on its
own lanes, so the collectives pair up. The engine knows nothing of the
followers. Followers print nothing and write no file: what a command
prints and writes, rank 0 does.

On the card rank r takes card r, N may not exceed the visible cards
(refused before anything starts) and the group runs NCCL; on the CPU
(`cpu=True`) the ranks run over gloo. Rendezvous is a file in a fresh
temporary directory, so concurrent commands cannot collide.

Failure ends the run: a follower that raises exits non-zero, which
fails rank 0's next collective, and `spawn_mesh` raises on leaving when
a follower did not exit 0; a follower that dies while rank 0 waits on a
collective that cannot notice (NCCL) ends rank 0 after a grace period;
a follower whose rank 0 is gone exits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import torch

from . import Mesh, make_mesh
from .multihost import TIMEOUT, default_backend

_ENV_RANK = "MADSIM_TPU_RANK"
_ENV_WORLD = "MADSIM_TPU_WORLD"
_ENV_INIT = "MADSIM_TPU_RANK_INIT"
_ENV_CPU = "MADSIM_TPU_RANK_CPU"

# seconds rank 0 waits, after a follower died, for the failure to reach
# it through a collective before it ends itself
_GRACE_S = 10.0


def devices_line(n: int, visible: int) -> str:
    """The one line of a `--devices N` that asks for more cards than the
    machine has (the reference's `--devices` refusal, in the port's
    terms)."""
    return f"--devices {n}: only {visible} devices visible (on the CPU, pass --device cpu to run {n} ranks over gloo)"


def check_devices(n: int, cpu: bool) -> None:
    """Refuse, with one line, more ranks than cards on the card."""
    if n > 1 and not cpu and torch.cuda.is_available() and n > torch.cuda.device_count():
        raise SystemExit(devices_line(n, torch.cuda.device_count()))


def _devices(n: int, cpu: bool) -> list:
    """Each rank's device: the CPU, or rank r on card r."""
    return ["cpu"] * n if cpu else [f"cuda:{r}" for r in range(n)]


def _write_frame(pipe, payload: bytes) -> None:
    pipe.write(struct.pack("<Q", len(payload)) + payload)
    pipe.flush()


def _read_frame(pipe):
    head = pipe.read(8)
    if len(head) < 8:
        return None
    (n,) = struct.unpack("<Q", head)
    return pipe.read(n)


class Followers:
    """Rank 0's channel to the follower processes."""

    def __init__(self, procs):
        self.procs = procs
        self.closed = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def send(self, engine, method: str, kwargs: dict) -> None:
        """Have every follower enter `engine.method(mesh=..., **kwargs)`."""
        payload = pickle.dumps((engine.machine, engine.config, method, kwargs))
        for p in self.procs:
            _write_frame(p.stdin, payload)

    def _watch(self) -> None:
        while not self.closed.wait(0.5):
            dead = [p for p in self.procs if p.poll() not in (None, 0)]
            if dead and not self.closed.wait(_GRACE_S):
                sys.stderr.write(f"rank {self.procs.index(dead[0]) + 1} exited with {dead[0].returncode}; "
                                 f"ending the job\n")
                sys.stderr.flush()
                os._exit(1)

    def close(self) -> None:
        """End the followers (EOF on their stdin) and raise unless every
        one exited 0."""
        self.closed.set()
        for p in self.procs:
            with contextlib.suppress(OSError):
                p.stdin.close()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        bad = [(r + 1, c) for r, c in enumerate(codes) if c != 0]
        if bad:
            raise RuntimeError(f"mesh ranks failed: " + ", ".join(f"rank {r} exited {c}" for r, c in bad))


@dataclasses.dataclass(frozen=True)
class Ranks:
    """The N ranks of one command, seen from rank 0: its mesh and the
    channel to the followers."""

    mesh: Mesh
    followers: Followers

    def call(self, engine, method: str, **kwargs):
        """`engine.method(mesh=self.mesh, **kwargs)` on every rank: the
        followers are sent the call first, then this rank enters it, and
        its result (the same on every rank) is returned."""
        self.followers.send(engine, method, kwargs)
        return getattr(engine, method)(mesh=self.mesh, **kwargs)


@contextlib.contextmanager
def spawn_mesh(n: int, cpu: bool):
    """The `Ranks` of a mesh of `n` ranks for the duration of the block:
    this process is rank 0, the others are followers started here and
    ended on leaving."""
    import torch.distributed as dist

    check_devices(n, cpu)
    backend = default_backend(n, cpu)
    tmp = tempfile.mkdtemp(prefix="madsim-ranks-")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    # the followers import this package from where this process did
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    procs = []
    followers = None
    ok = False
    try:
        for r in range(1, n):
            env = dict(os.environ, **{_ENV_RANK: str(r), _ENV_WORLD: str(n), _ENV_INIT: init,
                                      _ENV_CPU: "1" if cpu else "", "PYTHONPATH": path})
            procs.append(subprocess.Popen([sys.executable, "-m", "madsim_tpu_torch.parallel.ranks"],
                                          stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env))
        for r, p in enumerate(procs, start=1):
            # each follower says it is alive before the rendezvous, so one
            # that failed to start fails here, not at a rendezvous timeout
            if p.stdout.readline().strip() != b"ready":
                raise RuntimeError(f"mesh rank {r} did not start (exit {p.wait()})")
        if not cpu:
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, world_size=n, rank=0, timeout=TIMEOUT)
        followers = Followers(procs)
        yield Ranks(make_mesh(_devices(n, cpu)), followers)
        ok = True
    finally:
        try:
            if ok:
                followers.close()
            else:
                if followers is not None:
                    followers.closed.set()
                for p in procs:
                    p.kill()
                    p.wait()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)


def _parent_watch(parent: int) -> None:
    # rank 0 gone (its pipes closed or not): a follower never outlives it
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(1)


def follow() -> int:
    """A follower's life: join rank 0's group, then serve its calls until
    its stdin closes."""
    import torch.distributed as dist

    from ..engine import Engine

    rank, world = int(os.environ[_ENV_RANK]), int(os.environ[_ENV_WORLD])
    cpu = bool(os.environ.get(_ENV_CPU))
    threading.Thread(target=_parent_watch, args=(os.getppid(),), daemon=True).start()
    if not cpu:
        torch.cuda.set_device(rank)
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    dist.init_process_group(default_backend(world, cpu), init_method=os.environ[_ENV_INIT], world_size=world,
                            rank=rank, timeout=TIMEOUT)
    mesh = make_mesh(_devices(world, cpu))
    engines = {}
    try:
        while True:
            frame = _read_frame(sys.stdin.buffer)
            if frame is None:
                return 0
            machine, config, method, kwargs = pickle.loads(frame)
            key = pickle.dumps((machine, config))
            if key not in engines:
                engines[key] = Engine(machine, config, device=mesh.device)
            getattr(engines[key], method)(mesh=mesh, **kwargs)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(follow())
