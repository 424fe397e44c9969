"""Store fsck — scan every fleet artifact, verdict each file, heal.

The store's crash-safety claim (`runtime/atomicio`: tmp + fsync +
rename + dir-fsync) means the farm itself never produces a torn file —
but disks lie, operators copy half a directory, and pre-fsync-era
artifacts exist. `fleet fsck` is the tool that makes corruption a
*reported, recoverable* condition instead of an uncaught exception
somewhere inside a worker:

* every file under `<root>/jobs/` plus the fleet corpus gets an exact
  per-file verdict — `ok`, `truncated` (JSON ends mid-document),
  `unparseable` (garbage mid-file), `bad-schema` (valid JSON, wrong
  shape), `fingerprint-inconsistent` (a checkpoint whose fingerprint
  does not match its owning job), `drifted` (a job doc whose spec no
  longer hashes to its recorded fingerprint), `stale-tmp` (an
  interrupted atomic write's tmp file), `torn-tail` (a JSONL feed
  whose final line is cut), `stale-claim` (a claim file from a dead
  lease generation — removed; the job flock is the authority),
  `index-stale` (queue.log disagrees with the job docs — rebuilt from
  the docs) or `unknown`;
* with `fix` (the CLI default; `--dry-run` scans only), unreadable
  files are quarantined to `<name>.corrupt` and stale tmp files are
  removed, then the queue's state counts are rebuilt from the
  surviving documents — the directory IS the queue index, so the
  rebuilt counts are the rebuilt index;
* `drifted` job docs are reported but left in place: the worker's
  fingerprint refusal fails them with a message naming every drifted
  field, which keeps the audit trail in the state machine instead of
  a sidecar file;
* `--reclaim` additionally runs the lease-reclamation sweep
  (`store.reclaim_expired`) and `--release-quarantined` re-queues
  quarantined jobs — together they are the full "heal the farm"
  operator verb.

`scan()` (read-only) also backs the control plane's `/healthz`, which
reports store integrity, queue depth, stale-lease count and
quarantined-job count.

Pure host-side stdlib, torch-free by contract (the corpus is validated
structurally from its JSON — `engine.corpus` is deliberately NOT
imported here).
"""

from __future__ import annotations

# madsim: allow-file(D001) — stale-lease detection compares recorded
# lease expiries against the host wall clock; this is supervisor-side
# service code, nothing feeds simulation state.
import json
import os
import time
from typing import List, Optional

from .store import (
    LEASABLE,
    QUARANTINED,
    QUEUED,
    STATES,
    Job,
    JobStore,
    job_fingerprint,
    spec_sha,
)

OK = "ok"
TRUNCATED = "truncated"
UNPARSEABLE = "unparseable"
BAD_SCHEMA = "bad-schema"
FP_INCONSISTENT = "fingerprint-inconsistent"
DRIFTED = "drifted"
STALE_TMP = "stale-tmp"
TORN_TAIL = "torn-tail"
STALE_CLAIM = "stale-claim"
INDEX_STALE = "index-stale"
UNKNOWN = "unknown"

#: verdicts that make a file unreadable — counted as corruption,
#: quarantined to *.corrupt by a fixing fsck
CORRUPT_VERDICTS = frozenset({TRUNCATED, UNPARSEABLE, BAD_SCHEMA,
                              FP_INCONSISTENT})

#: entry keys a corpus record must carry to be replayable
_CORPUS_ENTRY_KEYS = frozenset({"machine", "seed", "fail_code", "config"})


def _classify_json(text: str):
    """(doc, verdict, detail): `truncated` when the decode error sits at
    the end of the data (the tail is missing), `unparseable` when the
    damage is mid-file."""
    try:
        return json.loads(text), OK, ""
    except json.JSONDecodeError as exc:
        tail = exc.pos >= len(text.rstrip())
        return None, (TRUNCATED if tail else UNPARSEABLE), (
            f"{exc.msg} at byte {exc.pos}/{len(text)}"
        )


def _read(path: str):
    try:
        with open(path, "r", errors="replace") as f:
            return f.read(), None
    except OSError as exc:
        return None, str(exc)


def _check_job_doc(path: str, fn: str, finding: dict,
                   jobs_by_id: dict) -> None:
    text, err = _read(path)
    if text is None:
        finding.update(verdict=UNPARSEABLE, detail=err)
        return
    doc, verdict, detail = _classify_json(text)
    if verdict != OK:
        finding.update(verdict=verdict, detail=detail)
        return
    try:
        job = Job.from_dict(doc)
    except TypeError as exc:
        finding.update(verdict=BAD_SCHEMA, detail=str(exc))
        return
    expect_id = fn[: -len(".json")]
    if job.id != expect_id or job.state not in STATES:
        finding.update(
            verdict=BAD_SCHEMA,
            detail=f"id {job.id!r} / state {job.state!r} inconsistent "
                   f"with filename",
        )
        return
    jobs_by_id[job.id] = job
    try:
        drifted = (
            job_fingerprint(job.spec) != job.fingerprint
            or spec_sha(job.spec) != job.fingerprint_sha
        )
    except (KeyError, ValueError, TypeError) as exc:
        finding.update(verdict=BAD_SCHEMA, detail=f"spec: {exc}")
        return
    if drifted:
        finding.update(
            verdict=DRIFTED,
            detail="spec no longer matches its recorded fingerprint — "
                   "left in place; the worker fails it with the "
                   "field-by-field refusal",
        )


def _check_ckpt(path: str, fn: str, finding: dict, jobs_by_id: dict) -> None:
    from ..runtime.checkpoint import CKPT_REQUIRED_KEYS, CKPT_VERSION

    text, err = _read(path)
    if text is None:
        finding.update(verdict=UNPARSEABLE, detail=err)
        return
    doc, verdict, detail = _classify_json(text)
    if verdict != OK:
        finding.update(verdict=verdict, detail=detail)
        return
    if not isinstance(doc, dict) or doc.get("version") != CKPT_VERSION:
        finding.update(
            verdict=BAD_SCHEMA,
            detail=f"checkpoint version {doc.get('version') if isinstance(doc, dict) else doc!r}",
        )
        return
    missing = sorted(CKPT_REQUIRED_KEYS - doc.keys())
    if missing:
        finding.update(verdict=BAD_SCHEMA, detail=f"missing keys {missing}")
        return
    owner = jobs_by_id.get(fn[: -len(".ckpt.json")])
    if owner is not None and doc.get("fingerprint") != owner.fingerprint:
        finding.update(
            verdict=FP_INCONSISTENT,
            detail="checkpoint fingerprint != owning job's — a resume "
                   "would be refused; quarantining restarts the stream "
                   "from batch 0",
        )


def _check_jsonl(path: str, finding: dict,
                 torn_anywhere: bool = False) -> None:
    """`torn_anywhere=False` (stats feeds, rewritten whole): only the
    FINAL line may legitimately be cut — damage anywhere else is real
    corruption. `torn_anywhere=True` (event logs / span dumps, true
    fsync'd appends): a kill mid-append followed by the next append's
    newline-heal leaves torn records mid-file by design, so ANY set of
    bad lines is the reported-never-quarantined torn-tail verdict —
    every reader skips them and the seq chain stays monotonic."""
    text, err = _read(path)
    if text is None:
        finding.update(verdict=UNPARSEABLE, detail=err)
        return
    lines = text.splitlines()
    bad = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            json.loads(line)
        except json.JSONDecodeError:
            bad.append(i)
    if not bad:
        return
    if bad == [len(lines) - 1]:
        # a torn tail is the EXPECTED shape of an append-mode feed cut
        # mid-line; every reader skips it, so it is reported but never
        # quarantined
        finding.update(verdict=TORN_TAIL,
                       detail=f"final line {bad[0] + 1} cut mid-record")
    elif torn_anywhere:
        finding.update(verdict=TORN_TAIL,
                       detail=f"{len(bad)} torn record(s) at lines "
                              f"{[i + 1 for i in bad[:5]]} (append-mode "
                              "log; readers skip them)")
    else:
        finding.update(verdict=UNPARSEABLE,
                       detail=f"unparseable lines {bad[:5]}")


def _check_claim(path: str, fn: str, finding: dict, jobs_by_id: dict,
                 now: float) -> None:
    """A claim file is live iff it names the owning job's CURRENT
    unexpired lease holder (and, when stamped, its generation). Any
    other claim — torn stamp, dead generation, expired hold, no owning
    doc — is advisory garbage a fixing fsck removes. Removal is always
    safe: the per-job flock, not the claim, is the authoritative
    arbiter, so the worst a wrongly-removed claim costs is one extra
    lock round."""
    text, err = _read(path)
    if text is None:
        finding.update(verdict=STALE_CLAIM, detail=err)
        return
    doc, verdict, _detail = _classify_json(text)
    if verdict != OK or not isinstance(doc, dict):
        finding.update(
            verdict=STALE_CLAIM,
            detail="torn claim stamp (crash mid-claim); the job flock "
                   "arbitrates around it",
        )
        return
    job = jobs_by_id.get(fn[: -len(".claim")])
    lease = job.lease if job is not None else None
    live = (
        lease is not None
        and lease.get("worker") == doc.get("worker")
        and (lease.get("expires_ts") or 0) > now
        and doc.get("gen") in (None, lease.get("gen"))
    )
    if not live:
        finding.update(
            verdict=STALE_CLAIM,
            detail=f"claim by {doc.get('worker')!r} gen {doc.get('gen')} "
                   f"does not match a live lease — dead generation",
        )


def _check_corpus(path: str, finding: dict) -> None:
    text, err = _read(path)
    if text is None:
        finding.update(verdict=UNPARSEABLE, detail=err)
        return
    doc, verdict, detail = _classify_json(text)
    if verdict != OK:
        finding.update(verdict=verdict, detail=detail)
        return
    entries = doc.get("entries") if isinstance(doc, dict) else None
    if not isinstance(entries, list):
        finding.update(verdict=BAD_SCHEMA, detail="no entries list")
        return
    bad = [
        i for i, e in enumerate(entries)
        if not (isinstance(e, dict) and _CORPUS_ENTRY_KEYS <= e.keys())
    ]
    if bad:
        finding.update(
            verdict=BAD_SCHEMA,
            detail=f"entries {bad[:5]} missing replay keys "
                   f"{sorted(_CORPUS_ENTRY_KEYS)}",
        )


def scan(store: JobStore) -> dict:
    """Read-only integrity scan: per-file verdicts + farm gauges.
    Never mutates anything — safe to run from `/healthz` on every
    probe."""
    findings: List[dict] = []
    jobs_by_id: dict = {}
    now = time.time()
    names = sorted(os.listdir(store.jobs_dir))
    # job docs first: checkpoint fingerprint checks need their owners
    names.sort(key=lambda fn: 0 if fn.endswith(".json")
               and ".ckpt" not in fn and ".stats" not in fn else 1)
    for fn in names:
        path = os.path.join(store.jobs_dir, fn)
        finding = {"path": path, "file": fn, "verdict": OK, "detail": "",
                   "action": "none"}
        if fn.endswith(".lock") or fn.endswith(".corrupt"):
            continue  # lock files are contentless; .corrupt already swept
        elif fn.endswith(".tmp"):
            finding.update(
                verdict=STALE_TMP,
                detail="interrupted atomic write (rename never ran)",
            )
        elif fn.endswith(".ckpt.json"):
            _check_ckpt(path, fn, finding, jobs_by_id)
        elif fn.endswith(".stats.jsonl"):
            _check_jsonl(path, finding)
        elif fn.endswith(".events.jsonl") or fn.endswith(".spans.jsonl"):
            # append-only observability logs: torn records (even
            # mid-file, from a kill-mid-append + newline-heal) are
            # reported, never quarantined
            _check_jsonl(path, finding, torn_anywhere=True)
        elif fn.endswith(".stats.json"):
            text, err = _read(path)
            if text is None:
                finding.update(verdict=UNPARSEABLE, detail=err)
            else:
                _doc, verdict, detail = _classify_json(text)
                if verdict != OK:
                    finding.update(verdict=verdict, detail=detail)
        elif fn.endswith(".stats.prom"):
            pass  # text exposition; concatenator skips bad lines
        elif fn.endswith(".device.trace.json.gz"):
            pass  # binary profile capture; /profile tolerates garbage
        elif fn.endswith(".vtrace.json"):
            text, err = _read(path)
            if text is None:
                finding.update(verdict=UNPARSEABLE, detail=err)
            else:
                _doc, verdict, detail = _classify_json(text)
                if verdict != OK:
                    finding.update(verdict=verdict, detail=detail)
        elif fn.endswith(".claim"):
            _check_claim(path, fn, finding, jobs_by_id, now)
        elif fn.endswith(".json"):
            _check_job_doc(path, fn, finding, jobs_by_id)
        else:
            finding.update(verdict=UNKNOWN,
                           detail="not a fleet artifact")
        if finding["verdict"] != OK:
            findings.append(finding)
    if os.path.exists(store.corpus_path):
        finding = {"path": store.corpus_path, "file": "corpus.json",
                   "verdict": OK, "detail": "", "action": "none"}
        _check_corpus(store.corpus_path, finding)
        if finding["verdict"] != OK:
            findings.append(finding)
    # the log-structured queue index: torn tail (a crash mid-append —
    # readers already skip it) and index/doc disagreement are both
    # reported here; a fixing fsck rebuilds the log from the job docs,
    # which stay the source of truth
    qlag = 0
    if os.path.exists(store.queue_log_path):
        finding = {"path": store.queue_log_path, "file": "queue.log",
                   "verdict": OK, "detail": "", "action": "none"}
        _check_jsonl(store.queue_log_path, finding, torn_anywhere=True)
        qlag = store.queue_log_lag()
        if qlag:
            lag_detail = (f"{qlag} job(s) misrepresented by the index "
                          f"(doc state differs or row missing)")
            if finding["verdict"] == OK:
                finding.update(verdict=INDEX_STALE, detail=lag_detail)
            else:
                finding["detail"] += f"; {lag_detail}"
        if finding["verdict"] != OK:
            findings.append(finding)

    jobs = list(jobs_by_id.values())
    counts = {s: 0 for s in STATES}
    for j in jobs:
        counts[j.state] = counts.get(j.state, 0) + 1
    return {
        "root": store.root,
        "files_scanned": (len(names) + int(os.path.exists(store.corpus_path))
                          + int(os.path.exists(store.queue_log_path))),
        "findings": findings,
        "corrupt": sum(1 for f in findings
                       if f["verdict"] in CORRUPT_VERDICTS),
        "drifted": sum(1 for f in findings if f["verdict"] == DRIFTED),
        "stale_tmp": sum(1 for f in findings
                         if f["verdict"] == STALE_TMP),
        "torn_tails": sum(1 for f in findings
                          if f["verdict"] == TORN_TAIL),
        "stale_claims": sum(1 for f in findings
                            if f["verdict"] == STALE_CLAIM),
        "queue_log_lag": qlag,
        "counts": {s: n for s, n in counts.items() if n},
        "jobs": len(jobs),
        "queue_depth": counts.get(QUEUED, 0),
        "quarantined": counts.get(QUARANTINED, 0),
        "stale_leases": sum(
            1 for j in jobs
            if j.state in LEASABLE and j.lease
            and j.lease["expires_ts"] <= now
        ),
    }


def fsck(root: str, *, fix: bool = True, reclaim: bool = False,
         release_quarantined: bool = False,
         max_attempts: Optional[int] = None,
         backoff_base_s: Optional[float] = None) -> dict:
    """Scan + heal. With `fix`, unreadable files move to `*.corrupt`
    and stale tmp files are removed; the report's `counts` are then
    re-derived from the surviving documents (the rebuilt queue index).
    `reclaim` runs the lease-reclamation sweep; `release_quarantined`
    re-queues quarantined jobs (attempt counter reset)."""
    store = JobStore(root)
    report = scan(store)
    if fix:
        rebuilt = False
        for finding in report["findings"]:
            if finding["file"] == "queue.log":
                # torn tail or stale index, same repair: rewrite the
                # log from the job documents (the source of truth)
                if not rebuilt:
                    n = store.rebuild_queue_log()
                    rebuilt = True
                    finding["action"] = f"rebuilt from {n} job doc(s)"
            elif finding["verdict"] == STALE_CLAIM:
                os.remove(finding["path"])
                finding["action"] = "removed"
            elif finding["verdict"] in CORRUPT_VERDICTS:
                target = finding["path"] + ".corrupt"
                os.replace(finding["path"], target)
                finding["action"] = f"quarantined -> {target}"
            elif finding["verdict"] == STALE_TMP:
                os.remove(finding["path"])
                finding["action"] = "removed"
    if reclaim:
        kw = {}
        if max_attempts is not None:
            kw["max_attempts"] = max_attempts
        if backoff_base_s is not None:
            kw["backoff_base_s"] = backoff_base_s
        report["reclaimed"] = store.reclaim_expired(**kw)
    if release_quarantined:
        report["released"] = [
            store.release_quarantined(j.id).id
            for j in store.list() if j.state == QUARANTINED
        ]
    if fix:
        report["counts"] = {
            s: n for s, n in store.counts().items() if n
        }
        report["queue_depth"] = report["counts"].get(QUEUED, 0)
        report["quarantined"] = report["counts"].get(QUARANTINED, 0)
    return report


def render(report: dict) -> str:
    """Human-readable fsck report: one line per non-ok file, then the
    farm summary."""
    lines = [f"fleet fsck: {report['root']}"]
    for f in report["findings"]:
        act = f" [{f['action']}]" if f["action"] != "none" else ""
        lines.append(f"  {f['file']}: {f['verdict']} — {f['detail']}{act}")
    if not report["findings"]:
        lines.append("  all files ok")
    for key in ("reclaimed", "released"):
        for act in report.get(key, []):
            if key == "reclaimed":
                lines.append(
                    f"  reclaimed {act['job']} from {act['worker']} -> "
                    f"{act['outcome']} (attempt {act['attempt']})"
                )
            else:
                lines.append(f"  released {act} from quarantine")
    counts = ", ".join(f"{s}={n}" for s, n in report["counts"].items())
    lines.append(
        f"  {report['jobs']} jobs [{counts or 'none'}], "
        f"{report['corrupt']} corrupt, {report['drifted']} drifted, "
        f"{report['stale_tmp']} stale tmp, "
        f"{report['torn_tails']} torn tails, "
        f"{report.get('stale_claims', 0)} stale claims, "
        f"queue-log lag {report.get('queue_log_lag', 0)}, "
        f"{report['stale_leases']} stale leases"
    )
    return "\n".join(lines)
