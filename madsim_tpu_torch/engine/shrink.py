"""Failing-seed shrinking: minimize the configuration a flagged seed
needs to reproduce.

The port of `madsim_tpu/engine/shrink.py`. Starting from the engine's
config, each candidate below is verified by a full replay that must
fail with the same code; only such candidates are kept:

  * fewer faults (fault i is drawn from its own key-chain position, so a
    plan of f faults keeps the first f faults as they were: candidates
    are honest prefixes);
  * packet loss off;
  * each enabled chaos flag off, in `ABLATION_ORDER` (turning a
    scheduled kind off redraws the remaining faults, which is fine:
    every candidate is replayed, never assumed);
  * the horizon cut to just past the failure time;
  * the failing step count reported as a sufficient step budget.

Every candidate engine is built on the device of the engine it shrinks.

With a violation provenance word (`prov_word`, or the base replay's when
the engine's `provenance` gate is on), attribution orders the
candidates: the fault-count scan first tries the smallest prefix that
holds every implicated fault, and the kind ablation first drops every
kind the word does not implicate in one candidate. Attribution
over-approximates, so it is never trusted: every candidate is still
verified by a replay, and the shrunk config is the unguided one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..kinds import FLAG_BY_KIND
from .core import Engine, EngineConfig
from .replay import ReplayResult, replay

# Ablation order: the newest, most exotic kinds first, so the reported
# minimal set leans on the legacy vocabulary when it can. Each entry is
# (report name, FaultPlan field).
ABLATION_ORDER = (
    "torn", "heal-asym", "delay", "storm", "group", "dir",
    "pause", "skew", "dup", "strict-restart", "kill", "pair",
)
ABLATABLE_KINDS = tuple((name, FLAG_BY_KIND[name]) for name in ABLATION_ORDER)


@dataclasses.dataclass
class ShrinkResult:
    seed: int
    fail_code: int
    original: EngineConfig
    shrunk: EngineConfig
    steps: int  # events to failure under the shrunk config (itself a sufficient step budget)
    fail_time_us: int
    attempts: int  # replays spent shrinking
    kinds_removed: tuple = ()  # chaos flags ablated off (honest replays)
    guided: bool = False  # provenance attribution steered the order
    prov_kinds: tuple = ()  # kinds the violation's provenance implicated

    def summary(self) -> str:
        o, s = self.original, self.shrunk
        parts = []
        if s.faults.n_faults != o.faults.n_faults:
            parts.append(f"faults {o.faults.n_faults} -> {s.faults.n_faults}")
        if s.packet_loss_rate != o.packet_loss_rate:
            parts.append(f"loss {o.packet_loss_rate} -> 0")
        if self.kinds_removed:
            parts.append("kinds -" + ",-".join(self.kinds_removed))
        if s.horizon_us != o.horizon_us:
            parts.append(f"horizon {o.horizon_us}us -> {s.horizon_us}us")
        changed = "; ".join(parts) if parts else "config already minimal"
        guided = f", provenance-guided by [{','.join(self.prov_kinds)}]" if self.guided else ""
        return (
            f"seed {self.seed} fails with code {self.fail_code} in "
            f"{self.steps} events (t={self.fail_time_us}us); {changed} "
            f"[{self.attempts} verification replays{guided}]"
        )


def _fails_same(engine: Engine, seed: int, max_steps: int, code: int) -> Optional[ReplayResult]:
    rp = replay(engine, seed, max_steps=max_steps, trace=False)
    if rp.failed and rp.fail_code == code:
        return rp
    return None


def shrink(engine: Engine, seed: int, max_steps: int = 10_000, prov_word: Optional[int] = None) -> ShrinkResult:
    """Minimize the failing configuration of `seed`, the candidates in
    the order its provenance word suggests when there is one. Raises
    ValueError if the seed does not fail under `engine`."""
    base = replay(engine, seed, max_steps=max_steps, trace=False)
    if not base.failed:
        raise ValueError(
            f"seed {seed} does not fail under this config (within {max_steps} steps) — nothing to shrink"
        )
    code = base.fail_code
    attempts = 1
    cfg = engine.config
    best = base

    def attempt(cand_cfg):
        nonlocal attempts
        attempts += 1
        return _fails_same(Engine(engine.machine, cand_cfg, device=engine.device), seed, max_steps, code)

    # attribution, when there is a word: the implicated faults and kinds
    if prov_word is None and cfg.provenance:
        prov_word = base.fail_prov
    att = None
    if prov_word:
        from .provenance import implicated

        att = implicated(engine, seed, prov_word)
    guided = att is not None
    imp_kinds = set(att.kinds) if att else set()

    def with_faults(f):
        return dataclasses.replace(cfg, faults=dataclasses.replace(cfg.faults, n_faults=f))

    # 1. the fewest faults whose prefix plan still reproduces (a linear
    #    scan from zero: the smallest candidate first). Guided: a prefix
    #    reproduces only if it holds the implicated faults, so the
    #    smallest such prefix goes first; on a miss the full scan follows.
    guessed = False
    tried_guess = None
    if att and att.faults and not att.aliased:
        guess = max(f.index for f in att.faults) + 1
        if guess < cfg.faults.n_faults:
            tried_guess = guess
            cand_cfg = with_faults(guess)
            rp = attempt(cand_cfg)
            if rp is not None:
                cfg, best = cand_cfg, rp
                guessed = True
    if not guessed:
        for f in range(cfg.faults.n_faults):
            if f == tried_guess:
                continue  # replayed above
            cand_cfg = with_faults(f)
            rp = attempt(cand_cfg)
            if rp is not None:
                cfg, best = cand_cfg, rp
                break

    # 2. packet loss off
    if cfg.packet_loss_rate > 0:
        cand_cfg = dataclasses.replace(cfg, packet_loss_rate=0.0)
        rp = attempt(cand_cfg)
        if rp is not None:
            cfg, best = cand_cfg, rp

    # 3. chaos-flag ablation: each enabled flag off; a flag whose removal
    #    changes the outcome stays. A scheduled plan keeps at least one
    #    kind (the engine refuses n_faults > 0 with none). Guided: every
    #    kind the word does not implicate goes off in one candidate
    #    first; on a hit only the implicated kinds are left to try.
    kinds_removed = []
    enabled = [(name, field) for name, field in ABLATABLE_KINDS if getattr(cfg.faults, field)]
    scan = enabled
    if guided:
        non_imp = [(n, f) for n, f in enabled if n not in imp_kinds]
        if len(non_imp) >= 2:
            bulk_faults = dataclasses.replace(cfg.faults, **{f: False for _n, f in non_imp})
            if bulk_faults.n_faults == 0 or bulk_faults.enabled_kinds():
                cand_cfg = dataclasses.replace(cfg, faults=bulk_faults)
                rp = attempt(cand_cfg)
                if rp is not None:
                    cfg, best = cand_cfg, rp
                    kinds_removed.extend(n for n, _f in non_imp)
                    scan = [(n, f) for n, f in enabled if n in imp_kinds]
    for kind_name, field in scan:
        if not getattr(cfg.faults, field):
            continue
        cand_faults = dataclasses.replace(cfg.faults, **{field: False})
        if cand_faults.n_faults > 0 and not cand_faults.enabled_kinds():
            continue
        cand_cfg = dataclasses.replace(cfg, faults=cand_faults)
        rp = attempt(cand_cfg)
        if rp is not None:
            cfg, best = cand_cfg, rp
            kinds_removed.append(kind_name)

    # 4. the horizon just past the failure (sound by construction: events
    #    before the horizon do not see its value; verified all the same)
    fail_t = int(best.state.now_us)
    if fail_t + 1 < cfg.horizon_us:
        cand_cfg = dataclasses.replace(cfg, horizon_us=fail_t + 1)
        rp = attempt(cand_cfg)
        if rp is not None:
            cfg, best = cand_cfg, rp

    # 5. the failing step count is itself a sufficient step budget
    return ShrinkResult(
        seed=seed,
        fail_code=code,
        original=engine.config,
        shrunk=cfg,
        steps=int(best.state.step),
        fail_time_us=int(best.state.now_us),
        attempts=attempts,
        kinds_removed=tuple(kinds_removed),
        guided=guided,
        prov_kinds=tuple(att.kinds) if att else (),
    )
