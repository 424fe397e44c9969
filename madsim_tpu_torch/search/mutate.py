"""Deterministic seed mutation — the AFL "havoc" stage, shrunk to ints.

The port's copy of `madsim_tpu/search/mutate.py`, constants and all: a
child seed the port derives is the one the JAX package derives, so a
guided hunt chooses the same seeds on either.

A lane's entire behavior is a pure function of its uint32 seed (the
determinism contract), so a "mutation" of a parent scenario is just a
deterministically derived child seed. The mutator below is keyed off
(parent seed, operator, batch, slot, candidate): the same guided hunt
always proposes the same children in the same order, which is what lets
a checkpointed hunt resume — or replay on a replacement fleet worker —
and produce a byte-identical seed schedule.

Children are derived with a splitmix32-style avalanche mix, so a child
schedule shares no structure with its parent; the *guidance* comes from
the selection layer (`search/bias.py` scores every candidate's
re-derived fault schedule and keeps the one the bias state likes).
Operator ids exist so the selection layer can label what a chosen child
actually changed relative to its parent (kind flip / delay-era nudge /
target rotation) — the labels feed the recorded trail, not the RNG.

Pure stdlib integer arithmetic: no torch, no numpy, no floats.
"""

from __future__ import annotations

from typing import List

_M32 = 0xFFFFFFFF

#: mutation operators — labels for the candidate streams. Each operator
#: salts the mix differently, so the three streams never collide for
#: one parent; what a chosen child *did* (vs its parent's schedule) is
#: classified after the fact by `classify_child`.
OP_KIND_FLIP = 0      # aim: a schedule drawing different fault kinds
OP_DELAY_NUDGE = 1    # aim: same kinds, shifted fault eras
OP_TARGET_ROTATE = 2  # aim: same kinds/eras, different target nodes
OP_NAMES = ("kind-flip", "delay-nudge", "target-rotate")


def mix32(x: int, salt: int) -> int:
    """Deterministic 32-bit avalanche (splitmix32 finalizer over
    x + golden-ratio * (salt+1)). Pinned by fixtures in
    tests/test_torch_search.py — changing these constants re-keys every
    recorded guided seed schedule, so don't."""
    z = (x + ((salt + 1) * 0x9E3779B9)) & _M32
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return (z ^ (z >> 16)) & _M32


def child_seed(parent: int, op: int, batch: int, slot: int, cand: int) -> int:
    """The candidate seed for (parent, operator, batch, slot, cand).
    One mix per coordinate keeps every stream independent; the final
    value is a full-entropy uint32, never 0 (seed 0 is the conventional
    sequential-scan origin — keep mutants out of its way)."""
    z = mix32(parent & _M32, op)
    z = mix32(z ^ (batch & _M32), 3 + slot)
    z = mix32(z, 7 + cand)
    return z or 1


def children(parent: int, batch: int, slot: int, per_op: int = 1) -> List[tuple]:
    """All candidate (op, seed) pairs for one corpus parent at one
    batch slot, operator-major, deterministic order."""
    out = []
    for op in (OP_KIND_FLIP, OP_DELAY_NUDGE, OP_TARGET_ROTATE):
        for c in range(per_op):
            out.append((op, child_seed(parent, op, batch, slot, c)))
    return out


def classify_child(parent_feats: dict, child_feats: dict) -> str:
    """Label what a chosen child actually changed relative to its
    parent, from the two re-derived schedules (`search/features.py`
    dicts with "kinds" / "t_apply" / "targets" int lists). Purely
    descriptive — feeds the recorded trail so operators can see which
    mutation classes are paying."""
    if tuple(parent_feats["kinds"]) != tuple(child_feats["kinds"]):
        return OP_NAMES[OP_KIND_FLIP]
    if tuple(parent_feats["t_apply"]) != tuple(child_feats["t_apply"]):
        return OP_NAMES[OP_DELAY_NUDGE]
    return OP_NAMES[OP_TARGET_ROTATE]
