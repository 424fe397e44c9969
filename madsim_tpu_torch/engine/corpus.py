"""The failing-seed corpus: found bugs kept as regression entries.

The port of `madsim_tpu/engine/corpus.py` (reading and checking; the
hunt that writes entries is not ported yet). An entry names its machine
(the `models.build_machine` registry), node count, seed, expected fail
code, engine config and step budget. An "open" entry must keep failing
with its code; a "fixed" one must keep passing. `check` replays an entry
as a single lane and judges it against that contract.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List

from .core import Engine, EngineConfig, FaultPlan
from .replay import replay

STATUS_OPEN = "open"    # bug reproduces: entry must keep failing with its code
STATUS_FIXED = "fixed"  # bug resolved: entry must keep passing


def config_from_dict(d: dict) -> EngineConfig:
    d = dict(d)
    faults = d.pop("faults", None)
    return EngineConfig(**d, faults=FaultPlan(**faults) if faults else FaultPlan())


@dataclasses.dataclass
class CorpusEntry:
    machine: str
    seed: int
    fail_code: int
    status: str  # STATUS_OPEN | STATUS_FIXED
    config: EngineConfig
    max_steps: int
    nodes: int = 0
    note: str = ""
    # the digest trail recorded with the entry: checkpoints every
    # `digest_every` steps as [step, d0, d1], and the final [step, d0, d1]
    digest_every: int = 0
    digests: list = dataclasses.field(default_factory=list)
    digest_final: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> tuple:
        return (self.machine, self.nodes, self.seed, self.fail_code)

    @staticmethod
    def from_dict(d: dict) -> "CorpusEntry":
        return CorpusEntry(
            machine=d["machine"],
            nodes=int(d.get("nodes", 0)),
            seed=int(d["seed"]),
            fail_code=int(d["fail_code"]),
            status=d.get("status", STATUS_OPEN),
            max_steps=int(d["max_steps"]),
            note=d.get("note", ""),
            config=config_from_dict(d["config"]),
            digest_every=int(d.get("digest_every", 0)),
            digests=[[int(x) for x in ck] for ck in d.get("digests", [])],
            digest_final=[int(x) for x in d.get("digest_final", [])],
            meta=dict(d.get("meta", {})),
        )


def load(path: str) -> List[CorpusEntry]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    return [CorpusEntry.from_dict(d) for d in data.get("entries", [])]


@dataclasses.dataclass
class RegressOutcome:
    entry: CorpusEntry
    failed: bool  # did the replay fail
    fail_code: int
    ok: bool  # outcome matches the entry's status contract
    verdict: str  # human-readable disposition


def check(entry: CorpusEntry, build_machine: Callable[[str, int], object], device=None) -> RegressOutcome:
    """Replay one entry as a single lane and judge it against its status
    contract. `build_machine(name, nodes)` resolves the machine; a
    machine or config the port lacks raises NotImplementedError naming
    it. `device` as `Engine`'s: the card unless the CPU is asked for."""
    eng = Engine(build_machine(entry.machine, entry.nodes), entry.config, device=device)
    rp = replay(eng, entry.seed, max_steps=entry.max_steps, trace=False)
    failed, code = rp.failed, rp.fail_code
    if entry.status == STATUS_OPEN:
        if failed and code == entry.fail_code:
            return RegressOutcome(entry, failed, code, True, "still open (reproduces)")
        if failed:
            return RegressOutcome(entry, failed, code, False,
                                  f"DRIFT: fails with code {code}, expected {entry.fail_code}")
        return RegressOutcome(entry, failed, code, False, "appears FIXED (no longer reproduces)")
    if not failed:
        return RegressOutcome(entry, failed, code, True, "fixed (still passes)")
    return RegressOutcome(entry, failed, code, False, f"REGRESSION: fails again with code {code}")
