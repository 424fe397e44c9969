"""The failing-seed corpus: found bugs kept as regression entries.

The port of `madsim_tpu/engine/corpus.py`. An entry names its machine
(the `models.build_machine` registry), node count, seed, expected fail
code, engine config and step budget. An "open" entry must keep failing
with its code; a "fixed" one must keep passing. `check` replays an entry
as a single lane and judges it against that contract; `add` and `save`
write the corpus file in the JAX package's format, byte for byte.
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


def config_to_dict(cfg: EngineConfig) -> dict:
    """The config as a corpus entry records it: without the knobs that
    change no result (the compile cache, the kernel gate, the flight
    recorder, coverage, provenance), so an entry replays with or without
    them, on any machine."""
    d = dataclasses.asdict(cfg)
    for k in ("compile_cache_dir", "pallas_megakernel", "flight_recorder", "fr_digest_every", "fr_digest_ring",
              "coverage", "cov_slots_log2", "cov_band_bits_min", "cov_buffer", "provenance"):
        d.pop(k, None)
    return d


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

    def to_dict(self) -> dict:
        d = {
            "machine": self.machine,
            "nodes": self.nodes,
            "seed": self.seed,
            "fail_code": self.fail_code,
            "status": self.status,
            "max_steps": self.max_steps,
            "note": self.note,
            "config": config_to_dict(self.config),
        }
        if self.digest_every:
            d["digest_every"] = self.digest_every
            d["digests"] = [[int(x) for x in ck] for ck in self.digests]
            d["digest_final"] = [int(x) for x in self.digest_final]
        if self.meta:
            d["meta"] = dict(self.meta)
        return d

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


def save(path: str, entries: List[CorpusEntry]) -> None:
    from ..runtime.atomicio import atomic_write_json

    atomic_write_json(path, {"version": 1, "entries": [e.to_dict() for e in entries]}, indent=2, sort_keys=False)


def add(path: str, entry: CorpusEntry) -> bool:
    """Append `entry` unless one with the same (machine, nodes, seed,
    code) is there. Returns True if it was added."""
    entries = load(path)
    if any(e.key == entry.key for e in entries):
        return False
    entries.append(entry)
    save(path, entries)
    return True


@dataclasses.dataclass
class RegressOutcome:
    entry: CorpusEntry
    failed: bool  # did the replay fail
    fail_code: int
    ok: bool  # outcome matches the entry's status contract
    verdict: str  # human-readable disposition


def check(entry: CorpusEntry, build_machine: Callable[[str, int], object], device=None) -> RegressOutcome:
    """Replay one entry as a single lane and judge it against its status
    contract. `build_machine(name, nodes)` resolves the machine (an
    unknown name raises ValueError naming it; a config gate the port has
    not lifted, NotImplementedError). `device` as `Engine`'s: the card
    unless the CPU is asked for."""
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
