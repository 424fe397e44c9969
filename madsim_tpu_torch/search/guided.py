"""The guided hunt — coverage-feedback seed evolution over the batch
loop.

The port of `madsim_tpu/search/guided.py`: the same selection, bias
updates, escalation, trail and checkpoint, so a guided hunt on the port
chooses, runs and records the seeds the JAX package's does, byte for
byte. Escalated engines are built on the base engine's device.

`run_guided(eng, args)` is the `--guided` twin of
`__main__._stream_batches`: same aggregate shape, same checkpoint
file, same StatsEmitter feed, same plateau detector — but instead of
streaming a flat sequential seed range, every batch's seed vector is
CHOSEN:

  * batch 0 bootstraps sequentially (no signal yet);
  * afterwards, half of each batch are mutated children of the live
    seed corpus (parents = seeds that hit new coverage slots), picked
    from three deterministic candidate streams per slot
    (`search/mutate.py`) by scoring each candidate's re-derived fault
    schedule against the bias state (`search/bias.py` x
    `search/features.py`); the other half stays fresh sequential
    exploration;
  * between batches the bias state folds in the live map's per-band
    marginals and the harvested `fail_prov` lineage words;
  * a coverage plateau escalates the fault vocabulary along the
    recorded ladder (new Engine per rung, shared machine/caches)
    instead of stopping; the ladder exhausting is the honest plateau.

Reproducibility contract: the run is completely described by the
(seed schedule, bias state) trail — both are recorded per batch in the
aggregate and the checkpoint. Guidance is pure host-side seed
*selection*: the kernels' RNG layout is untouched, so every chosen seed
replays exactly like a hand-typed `--seed N`, and a hunt interrupted at
any batch boundary recomputes the identical schedule from the
checkpoint.

The per-batch engine runs the explicit seed vector through
`Engine.run_seed_batch` (one lane per seed): guidance-off keeps the
streaming executor path byte-for-byte untouched.
"""

from __future__ import annotations

# madsim: allow-file(D001) — wall-clock reads here go through the
# `import time as wall` alias and only measure host throughput (seeds/s
# heartbeats, elapsed_s); nothing feeds simulation state or the seed
# schedule, which is a pure function of (checkpointed) search state.
# Same contract as __main__'s batch loop.
import dataclasses
import logging
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..engine.core import PROV_BIT_AMNESIA, PROV_BIT_DUP, PROV_FAULT_BITS
from ..kinds import CLI_KIND_TO_FLAG, FAULT_KIND_NAMES
from .bias import BiasState, band_fractions_from_coverage, vocabulary_for
from .features import kind_name_rows, schedule_features
from .mutate import OP_NAMES, children, classify_child

#: fraction of each post-bootstrap batch drawn from mutated corpus
#: children (the rest stays fresh sequential exploration, so guidance
#: can never starve the unexplored seed line)
MUTANT_FRAC = 0.5
#: corpus parents retained (FIFO) — bounds checkpoint size
MAX_PARENTS = 256


def base_kind_names(fp) -> Tuple[str, ...]:
    """A FaultPlan's vocabulary as CLI kind names (the inverse of
    `__main__._fault_kind_flags`, shared table)."""
    return tuple(
        name for name, field in CLI_KIND_TO_FLAG if getattr(fp, field)
    )


def engine_for_escalation(base_eng, escalation: int):
    """The Engine for escalation step `escalation` of a guided hunt
    whose base engine is `base_eng`: same machine (schedule-feature /
    provenance caches accrue), same gates, same device, fault
    vocabulary = base union ladder rung. Step 0 returns the base engine
    itself. Raises ValueError when the rung's vocabulary cannot be
    built for this machine (e.g. torn without a durable_spec) — the
    guided loop skips such rungs."""
    if escalation == 0:
        return base_eng
    cache = base_eng.machine.__dict__.setdefault("_guided_engine_cache", {})
    key = (base_eng.config, escalation, str(base_eng.device))
    if key in cache:
        return cache[key]
    from ..engine.core import Engine

    vocab = set(vocabulary_for(base_kind_names(base_eng.config.faults),
                               escalation))
    fp = dataclasses.replace(
        base_eng.config.faults,
        **{field: name in vocab for name, field in CLI_KIND_TO_FLAG},
    )
    eng = Engine(base_eng.machine, dataclasses.replace(
        base_eng.config, faults=fp
    ), device=base_eng.device)
    cache[key] = eng
    return eng


def _prov_kind_counts(eng, feats_kinds: np.ndarray,
                      words: List[int]) -> Dict[str, int]:
    """Per-kind lineage-implication counts for one batch's finds,
    decoded from the harvested provenance words against the seeds'
    re-derived schedules (vectorized twin of
    `engine/provenance.kind_counts`; a find counts once per kind)."""
    counts: Dict[str, int] = {}
    n_faults = feats_kinds.shape[1]
    for row, word in zip(feats_kinds, words):
        kinds = set()
        for f in range(n_faults):
            if (word >> min(f, PROV_FAULT_BITS - 1)) & 1:
                kinds.add(FAULT_KIND_NAMES[int(row[f])])
        if (word >> PROV_BIT_AMNESIA) & 1:
            kinds.add("strict-restart")
        if (word >> PROV_BIT_DUP) & 1:
            kinds.add("dup")
        for k in kinds:
            counts[k] = counts.get(k, 0) + 1
    return counts


def _select_batch(
    bias: BiasState,
    eng,
    parents: List[int],
    seen: set,
    cursor: int,
    batch_index: int,
    chunk: int,
) -> Tuple[List[int], int, int, Dict[str, int]]:
    """Choose one batch's seed vector. Pure function of its arguments
    (the whole resumable selection state), so a checkpoint resume
    re-derives the identical schedule. Returns (seeds, new_cursor,
    n_mutants, op_label_counts)."""
    seeds: List[int] = []
    op_counts: Dict[str, int] = {}
    n_mut = 0
    if parents and batch_index > 0:
        want_mut = int(chunk * MUTANT_FRAC)
        slots = [
            (j, parents[j % len(parents)]) for j in range(want_mut)
        ]
        # one vectorized feature pass over every candidate AND parent
        cands = [
            children(parent, batch_index, j) for j, parent in slots
        ]
        flat = [s for group in cands for _op, s in group]
        uniq_parents = sorted(set(p for _j, p in slots))
        feats = schedule_features(eng, flat + uniq_parents)
        names = kind_name_rows(eng, feats["kinds"])
        parent_row = {
            p: len(flat) + i for i, p in enumerate(uniq_parents)
        }
        per_slot = len(cands[0]) if cands else 0
        for si, (j, parent) in enumerate(slots):
            best = None  # (score, order) -> candidate index
            for ci in range(per_slot):
                fi = si * per_slot + ci
                seed = cands[si][ci][1]
                if seed in seen or seed in seeds:
                    continue
                score = bias.score_kinds(names[fi])
                if best is None or score > best[0]:
                    best = (score, fi, seed)
            if best is None:
                continue  # every candidate already ran: leave to fresh
            _score, fi, seed = best
            seeds.append(seed)
            n_mut += 1
            pi = parent_row[parent]
            label = classify_child(
                {k: feats[k][pi] for k in ("kinds", "t_apply", "targets")},
                {k: feats[k][fi] for k in ("kinds", "t_apply", "targets")},
            ) if feats["kinds"].shape[1] else OP_NAMES[0]
            op_counts[label] = op_counts.get(label, 0) + 1
    # fresh sequential exploration fills the rest (skipping anything a
    # mutant already claimed)
    while len(seeds) < chunk:
        if cursor not in seen and cursor not in seeds:
            seeds.append(cursor)
        cursor += 1
    return seeds, cursor, n_mut, op_counts


def _guided_heartbeat(bi, planned, completed, n_mut, el, slots_hit,
                      new_slots, failing, escalation, vocab,
                      device_count=1, escalated_to=None):
    """The guided per-batch heartbeat line (format pinned in tests):
    like the unguided one it names the device count the unit spanned,
    plus the mutation tally, coverage delta and the escalation rung the
    batch RAN under."""
    tail = f" -> escalated to step {escalated_to}" if escalated_to else ""
    return (
        f"guided batch {bi}/{planned}: {completed} seeds ({n_mut} mutants) "
        f"in {el:.1f}s ({completed / el:.0f} seeds/s) on {device_count} "
        f"device(s), coverage {slots_hit} slots (+{new_slots}), "
        f"{failing} failing so far, escalation {escalation} "
        f"[{','.join(vocab)}]{tail}"
    )


def run_guided(eng, args, purpose: str = "hunt") -> dict:
    """The guided batch loop. `eng` is the base (escalation step 0)
    engine — coverage gate required (the feedback signal). Returns an
    aggregate shaped like `_stream_batches`' plus a "guided" record:
    {"trail": per-batch (seed schedule, bias state) records,
    "bias": final bias state, "escalation": final step,
    "failing_escalation": {seed: step it was found under}}."""
    import time as wall  # madsim: allow(D001) — host throughput only

    from ..__main__ import _make_emitter
    from ..runtime.coverage import (
        PlateauDetector, cell_table, coverage_dict, decode_map, encode_map,
        unpack_map,
    )

    if not eng.config.coverage:
        sys.exit("--guided needs --coverage: the bias signal IS the live map")

    log = logging.getLogger(f"madsim_tpu.{purpose}")
    emitter = _make_emitter(args)
    plateau_n = int(getattr(args, "stop_on_plateau", 0) or 0)
    # Two plateau signals, two granularities. The ESCALATION trigger
    # watches the coarse (band x phase) CELL grid — "this vocabulary
    # has stopped touching new scenario classes" fires in batches, not
    # hours, because the grid has at most 2^band_bits * 8 cells. The
    # STOP signal keeps `--stop-on-plateau`'s recorded raw-slot
    # semantics: the hunt only ends early when raw slots plateau AND
    # the escalation ladder is exhausted.
    detector = PlateauDetector(plateau_n) if plateau_n else None
    cell_detector = PlateauDetector(plateau_n) if plateau_n else None
    stop_after = int(getattr(args, "stop_after_batches", 0) or 0)

    chunk = min(args.seeds, args.batch)
    planned = -(-args.seeds // chunk)  # ceil

    agg: dict = {
        "completed": 0, "failing": [], "infra": [], "abandoned": [],
        "seeds_consumed": 0, "stats": {}, "provenance": {},
    }
    base_kinds = base_kind_names(eng.config.faults)
    bias = BiasState.fresh(base_kinds)
    parents: List[int] = []
    parent_set: set = set()
    seen: set = set()
    trail: List[dict] = []
    failing_escalation: Dict[int, int] = {}
    prov_counts: Dict[str, int] = {}
    cov_map: Optional[np.ndarray] = None
    cursor = args.seed
    plateaued = False
    start_bi = 0

    ckpt_path = getattr(args, "checkpoint", None)
    if ckpt_path:
        from ..runtime.checkpoint import check_fingerprint, load_checkpoint

        ck = load_checkpoint(ckpt_path)
        if ck is not None:
            err = check_fingerprint(ck, args)
            if err:
                sys.exit(f"--checkpoint {ckpt_path}: {err}")
            g = ck.get("guided") or {}
            agg["completed"] = int(ck["completed"])
            agg["seeds_consumed"] = int(ck["seeds_consumed"])
            agg["failing"] = [tuple(x) for x in ck["failing"]]
            agg["infra"] = [tuple(x) for x in ck["infra"]]
            agg["abandoned"] = list(ck["abandoned"])
            agg["provenance"] = {
                int(k): int(v) for k, v in (ck.get("prov") or {}).items()
            }
            cursor = int(ck["cursor"])
            start_bi = int(ck["batch"])
            plateaued = bool(ck.get("plateau", False))
            if ck.get("cov_b64"):
                cov_map = decode_map(ck["cov_b64"], eng.config.cov_slots_log2)
            if detector is not None and ck.get("detector"):
                d = ck["detector"]
                detector.best = int(d["best"])
                detector.streak = int(d["streak"])
                detector.batches = int(d["batches"])
            if cell_detector is not None and g.get("cell_detector"):
                d = g["cell_detector"]
                cell_detector.best = int(d["best"])
                cell_detector.streak = int(d["streak"])
                cell_detector.batches = int(d["batches"])
            bias = BiasState.from_dict(g["bias"]) if g.get("bias") else bias
            parents = [int(s) for s in g.get("parents", [])]
            parent_set = set(parents)
            trail = list(g.get("trail", []))
            failing_escalation = {
                int(k): int(v)
                for k, v in (g.get("failing_escalation") or {}).items()
            }
            prov_counts = {
                k: int(v) for k, v in (g.get("prov_counts") or {}).items()
            }
            seen = set()
            for rec in trail:
                seen.update(int(s) for s in rec["seeds"])
            if ck.get("done"):
                print(
                    f"checkpoint {ckpt_path}: guided run already complete "
                    f"({start_bi}/{planned} batches, "
                    f"{agg['completed']} seeds) — nothing to resume"
                )
            else:
                print(f"resumed at batch {start_bi + 1}/{planned} "
                      f"({agg['completed']} seeds already completed, "
                      f"escalation step {bias.escalation})")
                log.info("checkpoint %s: guided resume at batch %d/%d",
                         ckpt_path, start_bi + 1, planned)

    def _save_ckpt(bi_done: int, done_flag: bool) -> None:
        if not ckpt_path:
            return
        from ..runtime.checkpoint import (
            fingerprint_from_args, save_checkpoint,
        )

        save_checkpoint(ckpt_path, {
            "fingerprint": fingerprint_from_args(args),
            "batch": bi_done,
            "planned": planned,
            "cursor": cursor,
            "completed": agg["completed"],
            "seeds_consumed": agg["seeds_consumed"],
            "failing": [list(x) for x in agg["failing"]],
            "infra": [list(x) for x in agg["infra"]],
            "abandoned": list(agg["abandoned"]),
            "prov": {str(k): v for k, v in agg["provenance"].items()},
            "cov_b64": encode_map(cov_map) if cov_map is not None else None,
            "detector": (
                {"best": detector.best, "streak": detector.streak,
                 "batches": detector.batches}
                if detector is not None else None
            ),
            "plateau": plateaued,
            "done": done_flag,
            # the (seed schedule, bias state) record: everything a
            # resume — or a replacement worker — needs to recompute the
            # identical remaining schedule, and everything an auditor
            # needs to replay the hunt from nothing
            "guided": {
                "bias": bias.to_dict(),
                "parents": list(parents),
                "prov_counts": dict(sorted(prov_counts.items())),
                "trail": trail,
                "failing_escalation": {
                    str(k): v for k, v in failing_escalation.items()
                },
                "cell_detector": (
                    {"best": cell_detector.best,
                     "streak": cell_detector.streak,
                     "batches": cell_detector.batches}
                    if cell_detector is not None else None
                ),
            },
        })

    t_start = wall.perf_counter()
    bi = start_bi - 1
    for bi in range(start_bi, planned):
        remaining = args.seeds - agg["completed"]
        if remaining <= 0:
            _save_ckpt(bi, True)
            break
        this_chunk = min(chunk, remaining)
        ran_escalation = bias.escalation
        cur_eng = engine_for_escalation(eng, ran_escalation)
        vocab = vocabulary_for(base_kinds, ran_escalation)
        weights_used = dict(bias.weights)
        seeds, cursor, n_mut, op_counts = _select_batch(
            bias, cur_eng, parents, seen, cursor, bi, this_chunk,
        )
        seen.update(seeds)
        t0 = wall.perf_counter()
        out = cur_eng.run_seed_batch(seeds, max_steps=args.max_steps)
        el = max(wall.perf_counter() - t0, 1e-9)

        agg["completed"] += out["completed"]
        agg["seeds_consumed"] += out["seeds_consumed"]
        agg["failing"].extend(out["failing"])
        agg["infra"].extend(out["infra"])
        agg["abandoned"].extend(out["abandoned"])
        agg["provenance"].update(out.get("provenance", {}))
        for s, _c in out["failing"]:
            failing_escalation[int(s)] = ran_escalation

        # corpus evolution: lanes whose map contributed new slots to
        # the cumulative OR become parents of the next batch's mutants
        lane_bits = unpack_map(
            out["cov_lane_words"], eng.config.cov_slots_log2
        )
        prev = (
            np.zeros(lane_bits.shape[1], bool) if cov_map is None else cov_map
        )
        fresh_bits = lane_bits & ~prev[None, :]
        new_parent_mask = fresh_bits.any(axis=1)
        cov_map = prev | lane_bits.any(axis=0)
        slots_hit = int(cov_map.sum())
        new_slots = slots_hit - int(prev.sum())
        for s, is_new in zip(seeds, new_parent_mask):
            if is_new and s not in parent_set:
                parents.append(int(s))
                parent_set.add(int(s))
        if len(parents) > MAX_PARENTS:
            for s in parents[:-MAX_PARENTS]:
                parent_set.discard(s)
            parents = parents[-MAX_PARENTS:]

        # feedback fold: lineage words of this batch's finds + the live
        # map's per-band marginals
        if out.get("provenance"):
            find_seeds = sorted(out["provenance"])
            feats = schedule_features(cur_eng, find_seeds)
            for k, v in _prov_kind_counts(
                cur_eng, feats["kinds"],
                [out["provenance"][s] for s in find_seeds],
            ).items():
                prov_counts[k] = prov_counts.get(k, 0) + v
        cov_sum = coverage_dict(
            cov_map, eng.config.cov_slots_log2, band_bits=eng.cov_band_bits
        )
        bias.update(
            band_fractions_from_coverage(
                cov_sum, eng.config.cov_slots_log2, eng.cov_band_bits
            ),
            prov_counts,
        )

        escalated_to = None
        cells_hit = None
        if detector is not None:
            raw_plateau = detector.update(slots_hit)
            cells_hit = int((cell_table(
                cov_map, eng.config.cov_slots_log2,
                band_bits=eng.cov_band_bits,
            ) > 0).sum())
            cell_plateau = cell_detector.update(cells_hit)
            if cell_plateau or raw_plateau:
                if bias.escalate(base_kinds) is not None:
                    # skip rungs this machine cannot build (e.g. torn
                    # without a durable_spec): keep climbing until an
                    # engine constructs or the ladder exhausts
                    while True:
                        try:
                            engine_for_escalation(eng, bias.escalation)
                            escalated_to = bias.escalation
                            break
                        except ValueError:
                            if bias.escalate(base_kinds) is None:
                                break
                if escalated_to is not None:
                    detector.streak = 0
                    cell_detector.streak = 0
                elif raw_plateau:
                    # ladder exhausted AND raw slots saturated: the
                    # honest early stop --stop-on-plateau promised
                    plateaued = True

        trail.append({
            "batch": bi,
            # the step this batch RAN under (an escalation at the end
            # of this batch applies from the next batch on)
            "escalation": ran_escalation,
            "kinds": ",".join(vocab),
            "seeds": [int(s) for s in seeds],
            "mutants": n_mut,
            "ops": dict(sorted(op_counts.items())),
            "weights": {k: weights_used[k] for k in sorted(weights_used)},
            "slots_hit": slots_hit,
            "new_slots": new_slots,
            "cells_hit": cells_hit,
            "failing": len(agg["failing"]),
            "escalated_to": escalated_to,
        })
        log.info("%s", _guided_heartbeat(
            bi + 1, planned, out["completed"], n_mut, el,
            slots_hit, new_slots, len(agg["failing"]),
            ran_escalation, vocab,
            device_count=int(getattr(args, "devices", 0) or 0) or 1,
            escalated_to=escalated_to,
        ))
        if emitter is not None:
            emitter.emit({
                "kind": f"{purpose}_batch",
                "machine": args.machine,
                "batch": bi + 1,
                "batches": planned,
                "completed": agg["completed"],
                "batch_completed": out["completed"],
                "seeds_per_sec": round(out["completed"] / el, 1),
                "failing": len(agg["failing"]),
                "infra": len(agg["infra"]),
                "abandoned": len(agg["abandoned"]),
                "coverage": {"slots_hit": slots_hit, "new_slots": new_slots},
                "guided": {
                    "escalation": ran_escalation,
                    "kinds": ",".join(vocab),
                    "mutants": n_mut,
                    "parents": len(parents),
                    **({"escalated_to": escalated_to} if escalated_to else {}),
                },
            })
        _save_ckpt(bi + 1, plateaued)
        if plateaued:
            log.info(
                "coverage plateau with the escalation ladder exhausted: "
                "stopping after batch %d/%d", bi + 1, planned,
            )
            break
        if stop_after and bi + 1 >= stop_after:
            log.info(
                "stopping after guided batch %d/%d (--stop-after-batches "
                "%d; resumable via --checkpoint)", bi + 1, planned,
                stop_after,
            )
            break
    else:
        _save_ckpt(planned, True)

    agg["elapsed_s"] = wall.perf_counter() - t_start
    agg["batches_run"] = bi + 1
    agg["batches_planned"] = planned
    agg["plateau"] = plateaued
    if cov_map is not None:
        agg["coverage_map"] = cov_map
        agg["stats"] = dict(agg["stats"])
        agg["stats"]["coverage"] = {
            **coverage_dict(
                cov_map, eng.config.cov_slots_log2,
                band_bits=eng.cov_band_bits,
            ),
            "plateau": plateaued,
            "plateau_patience": plateau_n,
        }
    if agg["provenance"]:
        agg["stats"] = dict(agg["stats"])
        agg["stats"]["fault_attribution"] = dict(sorted(prov_counts.items()))
    guided_rec = {
        "trail": trail,
        "bias": bias.to_dict(),
        "escalation": bias.escalation,
        "parents": len(parents),
        "failing_escalation": dict(failing_escalation),
    }
    agg["guided"] = guided_rec
    agg["stats"] = dict(agg["stats"])
    agg["stats"]["guided"] = {
        "escalation": bias.escalation,
        "parents": len(parents),
        "batches": len(trail),
        "mutants": sum(r["mutants"] for r in trail),
    }
    if emitter is not None:
        emitter.emit({
            "kind": f"{purpose}_summary",
            "machine": args.machine,
            "completed": agg["completed"],
            "failing": len(agg["failing"]),
            "infra": len(agg["infra"]),
            "abandoned": len(agg["abandoned"]),
            "batches_run": agg["batches_run"],
            "batches_planned": planned,
            "plateau": plateaued,
            "elapsed_s": round(agg["elapsed_s"], 2),
            **(
                {"coverage": agg["stats"]["coverage"]}
                if cov_map is not None else {}
            ),
            "guided": agg["stats"]["guided"],
        })
        emitter.close()
    return agg
