"""Digest trails and the first divergent checkpoint.

The port of `madsim_tpu/engine/audit.py`. The flight recorder folds
every popped event and the step's RNG words into a rolling per-lane
digest and checkpoints it every `fr_digest_every` steps. Two executions
of one (machine, config, seed) agree on a checkpoint exactly as far as
their event streams agree, and once apart they stay apart, so the first
divergent checkpoint, found by bisection, puts a determinism break in
one `fr_digest_every`-step segment. Corpus entries carry the trail they
were recorded with (`CorpusEntry.digests`, `digest_final`, and the
environment `engine_meta` in `meta`); `record_entry` records them, and
`audit_entry` replays an entry with the recorder on and bisects against
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .core import Engine

DEFAULT_DIGEST_EVERY = 64


@dataclasses.dataclass(frozen=True)
class DigestTrail:
    """One execution's digest trail: checkpoints at exact step multiples
    of `every`, plus the final (step, digest) when the lane stopped."""

    every: int
    checkpoints: Tuple[Tuple[int, int, int], ...]  # (step, d0, d1), ascending
    final_step: int
    final: Tuple[int, int]  # (d0, d1) at the stopping step
    failed: bool
    fail_code: int

    def to_lists(self) -> Tuple[List[List[int]], List[int]]:
        """(digests, digest_final) in the corpus JSON shape."""
        return (
            [[s, d0, d1] for s, d0, d1 in self.checkpoints],
            [self.final_step, *self.final],
        )


def _flat(x) -> np.ndarray:
    """One lane's leaf (a tensor or an array, [R] or [1, R]) as a flat
    numpy array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x).reshape(-1)


def _u32(x) -> np.ndarray:
    """A digest leaf of int32 bit patterns as flat uint32 values."""
    a = _flat(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def decode_checkpoint_ring(lane_fr) -> List[Tuple[int, int, int]]:
    """Decode one lane's checkpoint ring (its `fr` leaves, [R] or
    [1, R]) into (step, d0, d1) tuples, oldest first. Slots with
    step < 0 are unused."""
    steps = _flat(lane_fr["ck_step"])
    order = np.argsort(steps, kind="stable")
    order = order[steps[order] >= 0]
    d0, d1 = _u32(lane_fr["ck_d0"]), _u32(lane_fr["ck_d1"])
    return [(int(steps[i]), int(d0[i]), int(d1[i])) for i in order]


def fr_variant(engine: Engine, every: int, ring: int) -> Engine:
    """An Engine identical to `engine`, on its device, with the flight
    recorder on at the given checkpoint cadence. The recorder changes no
    result, so the trail is a property of the run, not of the
    recording."""
    cfg = dataclasses.replace(
        engine.config, flight_recorder=True, fr_digest_every=every, fr_digest_ring=ring,
    )
    return Engine(engine.machine, cfg, device=engine.device)


def collect_trail(engine: Engine, seed: int, max_steps: int, every: int = DEFAULT_DIGEST_EVERY) -> DigestTrail:
    """Replay one seed as a single lane with the recorder on, keeping
    EVERY checkpoint (the ring is sized past max_steps, so it never
    wraps)."""
    from .replay import replay

    eng = engine
    if (
        not engine.config.flight_recorder
        or engine.config.fr_digest_every != every
        or engine.config.fr_digest_ring * every <= max_steps
    ):
        eng = fr_variant(engine, every, max_steps // every + 2)
    rp = replay(eng, seed, max_steps=max_steps, trace=False)
    fr = rp.state.fr
    return DigestTrail(
        every=every,
        checkpoints=tuple(decode_checkpoint_ring(fr)),
        final_step=int(rp.state.step),
        final=(int(_u32(fr["d0"])[0]), int(_u32(fr["d1"])[0])),
        failed=bool(rp.state.failed),
        fail_code=int(rp.state.fail_code),
    )


@dataclasses.dataclass(frozen=True)
class Divergence:
    """First point where a replayed trail leaves the recorded one."""

    step: int  # recorded checkpoint (or final) step that mismatched
    expected: Tuple[int, int]
    got: Optional[Tuple[int, int]]  # None: replay never reached that step
    segment: Tuple[int, int]  # (last agreeing step, first divergent step]
    at_final: bool  # divergence surfaced only at the final digest

    def __str__(self) -> str:
        got = (
            f"got {self.got[0]:#010x}:{self.got[1]:#010x}"
            if self.got is not None
            else "replay never reached that step"
        )
        where = "final digest" if self.at_final else "checkpoint"
        return (
            f"first divergent {where} at step {self.step} (segment "
            f"({self.segment[0]}, {self.segment[1]}]): expected "
            f"{self.expected[0]:#010x}:{self.expected[1]:#010x}, {got}"
        )


def first_divergence(
    recorded: Sequence[Sequence[int]],
    recorded_final: Optional[Sequence[int]],
    replayed: DigestTrail,
) -> Optional[Divergence]:
    """Binary-search the recorded checkpoint list for the first entry the
    replayed trail contradicts (divergence is monotone along a trail,
    so "checkpoint i mismatches" is a sorted predicate). Returns None
    when every checkpoint and the final digest agree."""
    rep = {s: (d0, d1) for s, d0, d1 in replayed.checkpoints}
    rec = [(int(s), int(d0), int(d1)) for s, d0, d1 in recorded]

    def bad(i: int) -> bool:
        s, d0, d1 = rec[i]
        return rep.get(s) != (d0, d1)

    first_bad = len(rec)
    lo, hi = 0, len(rec) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        if bad(mid):
            first_bad = mid
            hi = mid - 1
        else:
            lo = mid + 1
    if first_bad < len(rec):
        s, d0, d1 = rec[first_bad]
        prev = rec[first_bad - 1][0] if first_bad else 0
        return Divergence(step=s, expected=(d0, d1), got=rep.get(s), segment=(prev, s), at_final=False)
    if recorded_final is not None:
        fs, fd0, fd1 = (int(x) for x in recorded_final)
        if (fs, fd0, fd1) != (replayed.final_step, *replayed.final):
            prev = rec[-1][0] if rec else 0
            return Divergence(step=fs, expected=(fd0, fd1), got=replayed.final, segment=(prev, fs),
                              at_final=True)
    return None


def engine_meta(config) -> dict:
    """The environment a digest trail was recorded under, kept beside it:
    when an audit later reports a divergence, this says what the trail
    was recorded with. `digest` names the trail format, which the JAX
    package shares."""
    import platform

    import torch

    import madsim_tpu_torch

    return {
        "madsim_tpu_torch": getattr(madsim_tpu_torch, "__version__", "?"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "rng_stream": config.rng_stream,
        "digest": "fr-v1",
    }


@dataclasses.dataclass
class AuditOutcome:
    entry: object  # CorpusEntry
    status: str  # "match" | "diverged" | "no-digests"
    divergence: Optional[Divergence]
    trail: DigestTrail
    verdict: str

    @property
    def ok(self) -> bool:
        return self.status != "diverged"


def audit_entry(entry, build_machine: Callable[[str, int], object], device=None) -> AuditOutcome:
    """Replay one corpus entry with the recorder on and bisect its
    recorded digest trail; the verdict also says whether the fail code
    survived. `device` as `Engine`'s: the card unless the CPU is asked
    for."""
    eng = Engine(build_machine(entry.machine, entry.nodes), entry.config, device=device)
    every = entry.digest_every or DEFAULT_DIGEST_EVERY
    trail = collect_trail(eng, entry.seed, entry.max_steps, every=every)
    behavior = (
        f"replay {'fails with code ' + str(trail.fail_code) if trail.failed else 'passes'}"
        f" at step {trail.final_step} (entry expects code {entry.fail_code})"
    )
    if not entry.digests and not entry.digest_final:
        return AuditOutcome(entry, "no-digests", None, trail, f"no recorded digests; {behavior}")
    div = first_divergence(entry.digests, entry.digest_final or None, trail)
    if div is None:
        return AuditOutcome(
            entry, "match", None, trail,
            f"digest trail matches ({len(entry.digests)} checkpoints); {behavior}",
        )
    return AuditOutcome(entry, "diverged", div, trail, f"{div}; {behavior}")


def record_entry(entry, build_machine: Callable[[str, int], object], every: int = DEFAULT_DIGEST_EVERY, device=None):
    """Record one corpus entry's digest trail and environment. Returns
    (updated entry, trail); the trail carries the outcome (failed,
    fail_code), so a caller can check the entry's status contract before
    saving. The entry's `meta` is merged into, not replaced: keys a
    caller filed survive, and the environment wins on a collision.
    `device` as `Engine`'s."""
    eng = Engine(build_machine(entry.machine, entry.nodes), entry.config, device=device)
    trail = collect_trail(eng, entry.seed, entry.max_steps, every=every)
    digests, final = trail.to_lists()
    new = dataclasses.replace(entry, digest_every=every, digests=digests, digest_final=final,
                              meta={**entry.meta, **engine_meta(entry.config)})
    return new, trail
