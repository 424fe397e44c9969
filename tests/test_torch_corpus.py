"""The port's corpus check and digest audit over `corpus.json`: every
entry (five demo-nopromise-multipaxos, demo-giveup-mvcc under delay
spikes, the 33-node demo-dupack-gossip and demo-abortleak-s3, all
recorded on the default v2 stream) reproduces its fail code and its
recorded digest trail on the port; a machine neither registry knows
raises naming it, never skips."""

import dataclasses
import pathlib

import pytest

from madsim_tpu_torch.engine import audit, corpus
from madsim_tpu_torch.models import build_machine

CORPUS = pathlib.Path(__file__).resolve().parents[1] / "corpus.json"
ENTRIES = corpus.load(str(CORPUS))
MULTIPAXOS = [e for e in ENTRIES if e.machine == "demo-nopromise-multipaxos"]
CODES = {"demo-nopromise-multipaxos": 150, "demo-giveup-mvcc": 206, "demo-dupack-gossip": 160,
         "demo-abortleak-s3": 212}


def test_corpus_holds_the_entries_this_checks():
    assert [e.seed for e in MULTIPAXOS] == [3, 5, 6, 26, 29]
    assert sorted({e.machine for e in ENTRIES}) == sorted(CODES) and len(ENTRIES) == 8
    assert all(e.config.rng_stream == 2 for e in ENTRIES)


@pytest.mark.parametrize("entry", ENTRIES, ids=[f"{e.machine}-seed-{e.seed}" for e in ENTRIES])
def test_entry_reproduces_with_its_digest_trail(entry):
    out = corpus.check(entry, build_machine, device="cpu")
    assert out.ok and out.failed and out.fail_code == entry.fail_code == CODES[entry.machine], out.verdict
    result = audit.audit_entry(entry, build_machine, device="cpu")
    assert result.status == "match", result.verdict
    digests, final = result.trail.to_lists()
    assert digests == entry.digests and final == entry.digest_final


def test_unported_machine_raises_naming_it():
    """Every name of the reference's registry is ported, so the entry
    names a machine neither registry knows: the check and the audit
    raise naming it, never skip."""
    from madsim_tpu.__main__ import build_machine as jax_build

    entry = dataclasses.replace(ENTRIES[0], machine="demo-nosuch-raft")
    with pytest.raises(SystemExit, match="'demo-nosuch-raft'"):
        jax_build(entry.machine)
    with pytest.raises(ValueError, match="unknown machine 'demo-nosuch-raft'"):
        corpus.check(entry, build_machine, device="cpu")
    with pytest.raises(ValueError, match="unknown machine 'demo-nosuch-raft'"):
        audit.audit_entry(entry, build_machine, device="cpu")


def test_audit_finds_the_first_divergent_checkpoint():
    """A recorded trail with one checkpoint altered bisects to it."""
    entry = MULTIPAXOS[0]
    trail = audit.audit_entry(entry, build_machine, device="cpu").trail
    recorded = [list(ck) for ck in trail.to_lists()[0]] + [[999, 1, 2]]
    div = audit.first_divergence(recorded, None, trail)
    assert div is not None and div.step == 999 and div.got is None
    assert audit.first_divergence(recorded[:-1], entry.digest_final, trail) is None
