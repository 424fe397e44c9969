"""Host-side bias state — the coverage/provenance feedback distilled to
per-kind draw weights, plus the recorded fault-vocabulary escalation
ladder.

The port's copy of `madsim_tpu/search/bias.py`: the ladder, `THIN_GAIN`
and the update arithmetic are the JAX package's, so a guided hunt's
weight trail is the same on either package.

The guided hunt never touches the kernels' RNG layout: every lane still
derives its schedule from its seed exactly as an unguided hunt's does
(guidance off is bit-identical). What the bias state perturbs is the
*host-side choice of which seeds run next*: `search/guided.py` proposes
candidate seeds, re-derives each candidate's fault schedule with the
same `init_batch` derivation the lanes run (`search/features.py`), and keeps the candidates whose
schedules this state scores highest — thin-coverage-band kinds and
kinds that appear in failure lineages (`fail_prov`) score high.

Two feedback signals, one pure update per batch:

  * coverage thinness — the live map's per-band marginals (the banded
    `[band|phase|mix]` coverage layout makes per-fault-kind counts
    directly decodable): the emptier a kind's band, the more the next
    batch should draw it;
  * failure lineage — the provenance words, decoded to per-kind
    implication counts: kinds that actually cause failures get hunted
    harder.

`update()` is a pure deterministic function of its inputs (fixed
iteration order, no wall clock, no entropy), and `to_dict`/`from_dict`
round-trip exactly — a guided hunt checkpointed mid-run and resumed
recomputes the identical weight trail. Pinned with hand-computed
fixtures in tests/test_torch_search.py.

Stdlib only: it needs neither torch nor a card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# The port's fault-kind vocabulary (kinds.py). The escalation ladder
# below binds these tables rather than keeping a mirror of them.
from ..kinds import CLI_KIND_TO_FLAG, FAULT_KIND_NAMES, band_name

#: The recorded escalation ladder: when a guided hunt plateaus, the
#: fault vocabulary widens to the next rung instead of stopping —
#: core scheduled kinds, then the window kinds (pause/skew), then the
#: storage kinds (torn/heal-asym), then the full 11-kind palette
#: (adding per-delivery duplication). Each rung is a slice of the K_*
#: index space, so a rung never reorders recorded schedule semantics;
#: the hunt's *base* vocabulary (whatever the operator asked for) is
#: always unioned in.
ESCALATION_LADDER = (
    FAULT_KIND_NAMES[:6],
    FAULT_KIND_NAMES[:8],
    FAULT_KIND_NAMES[:10],
    FAULT_KIND_NAMES + ("dup",),
)

#: thinness gain: how hard an empty band pulls vs a saturated one
#: (weight factor spans [1.0, 1.0 + THIN_GAIN])
THIN_GAIN = 1.0

_CLI_ORDER = tuple(name for name, _field in CLI_KIND_TO_FLAG)


def vocabulary_for(base_kinds: Sequence[str], escalation: int) -> Tuple[str, ...]:
    """The fault-kind vocabulary at escalation step `escalation`:
    step 0 is the hunt's base vocabulary; step e >= 1 unions rung e-1
    of the ladder. Rendered in the CLI's historical print order so
    recorded `--fault-kinds` strings stay canonical."""
    if not 0 <= escalation <= len(ESCALATION_LADDER):
        raise ValueError(
            f"escalation step {escalation} out of range "
            f"[0, {len(ESCALATION_LADDER)}]"
        )
    kinds = set(base_kinds)
    if escalation:
        kinds |= set(ESCALATION_LADDER[escalation - 1])
    return tuple(k for k in _CLI_ORDER if k in kinds)


def next_escalation(base_kinds: Sequence[str], escalation: int) -> Optional[int]:
    """The next ladder step that actually WIDENS the vocabulary, or
    None when the ladder is exhausted (the hunt should then honestly
    plateau). Steps that add nothing over the current vocabulary are
    skipped — a hunt already running the full palette has nowhere to
    escalate."""
    cur = set(vocabulary_for(base_kinds, escalation))
    for step in range(escalation + 1, len(ESCALATION_LADDER) + 1):
        if set(vocabulary_for(base_kinds, step)) - cur:
            return step
    return None


@dataclasses.dataclass
class BiasState:
    """Per-kind draw weights + the escalation cursor. `weights` covers
    the SCHEDULED kinds of the current vocabulary (dup is per-delivery
    chaos, not a schedule draw — it has no weight), normalized to sum
    1.0; a fresh state is uniform."""

    kinds: Tuple[str, ...]          # current vocabulary (CLI names)
    weights: Dict[str, float]
    escalation: int = 0
    updates: int = 0

    @staticmethod
    def fresh(kinds: Sequence[str], escalation: int = 0) -> "BiasState":
        sched = [k for k in kinds if k in FAULT_KIND_NAMES]
        n = max(1, len(sched))
        return BiasState(
            kinds=tuple(kinds),
            weights={k: 1.0 / n for k in sched},
            escalation=escalation,
        )

    def update(self, band_fractions: Dict[str, float],
               prov_counts: Dict[str, int]) -> None:
        """One batch's feedback fold: weight_k proportional to
        (1 + lineage implications of k) * (1 + THIN_GAIN * (1 - the
        fill fraction of k's coverage band)), renormalized. Iteration
        order is the kinds-table order — the update is bit-deterministic
        for identical inputs (pinned by hand-computed fixtures)."""
        sched = [k for k in FAULT_KIND_NAMES if k in self.kinds]
        raw = {}
        for k in sched:
            frac = float(band_fractions.get(band_name(k), 0.0))
            frac = min(max(frac, 0.0), 1.0)
            raw[k] = (1.0 + float(prov_counts.get(k, 0))) * (
                1.0 + THIN_GAIN * (1.0 - frac)
            )
        total = sum(raw.values())
        if total > 0.0:
            self.weights = {k: raw[k] / total for k in sched}
        self.updates += 1

    def score_kinds(self, kind_names: Sequence[str]) -> float:
        """Score one candidate schedule: the sum of its drawn kinds'
        weights (a schedule drawing three thin-band kinds outranks one
        drawing three saturated ones)."""
        return sum(self.weights.get(k, 0.0) for k in kind_names)

    def escalate(self, base_kinds: Sequence[str]) -> Optional[Tuple[str, ...]]:
        """Advance to the next widening ladder step, re-seeding weights
        uniformly over the new vocabulary (fresh kinds have no history;
        the next update() re-learns from the live map). Returns the new
        vocabulary, or None when the ladder is exhausted."""
        step = next_escalation(base_kinds, self.escalation)
        if step is None:
            return None
        vocab = vocabulary_for(base_kinds, step)
        old = self.weights
        fresh = BiasState.fresh(vocab, escalation=step)
        # carry learned weight mass for kinds that survive the widening
        carried = {
            k: old.get(k, fresh.weights[k]) for k in fresh.weights
        }
        total = sum(carried.values()) or 1.0
        self.kinds = vocab
        self.weights = {k: v / total for k, v in carried.items()}
        self.escalation = step
        return vocab

    # -- exact persistence ---------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "kinds": list(self.kinds),
            "weights": {k: self.weights[k] for k in sorted(self.weights)},
            "escalation": self.escalation,
            "updates": self.updates,
        }

    @staticmethod
    def from_dict(d: dict) -> "BiasState":
        return BiasState(
            kinds=tuple(d["kinds"]),
            weights={k: float(v) for k, v in d["weights"].items()},
            escalation=int(d["escalation"]),
            updates=int(d["updates"]),
        )


def band_fractions_from_coverage(cov: dict, slots_log2: int,
                                 band_bits: int) -> Dict[str, float]:
    """Per-band fill fractions from a `coverage_dict`-shaped summary
    (the SAME artifact `madsim_tpu_torch coverage --json` renders and the
    stats feed carries): band hit count / band slot capacity."""
    band_size = (1 << slots_log2) >> band_bits
    return {
        name: hits / band_size for name, hits in cov["by_band"].items()
    }
