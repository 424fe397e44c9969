"""The port's corpus check and digest audit over `corpus.json`: the five
demo-nopromise-multipaxos entries (recorded on the default v2 stream)
reproduce their fail code and their recorded digest trail on the port;
the entries whose machines or fault kinds are not ported raise
NotImplementedError naming them, never skip."""

import pathlib

import pytest

from madsim_tpu_torch.engine import audit, corpus
from madsim_tpu_torch.models import build_machine

CORPUS = pathlib.Path(__file__).resolve().parents[1] / "corpus.json"
ENTRIES = corpus.load(str(CORPUS))
MULTIPAXOS = [e for e in ENTRIES if e.machine == "demo-nopromise-multipaxos"]
OTHERS = [e for e in ENTRIES if e.machine != "demo-nopromise-multipaxos"]


def test_corpus_holds_the_entries_this_checks():
    assert [e.seed for e in MULTIPAXOS] == [3, 5, 6, 26, 29]
    assert sorted(e.machine for e in OTHERS) == ["demo-abortleak-s3", "demo-dupack-gossip", "demo-giveup-mvcc"]
    assert all(e.config.rng_stream == 2 for e in ENTRIES)


@pytest.mark.parametrize("entry", MULTIPAXOS, ids=[f"seed-{e.seed}" for e in MULTIPAXOS])
def test_multipaxos_entry_reproduces_with_its_digest_trail(entry):
    out = corpus.check(entry, build_machine, device="cpu")
    assert out.ok and out.failed and out.fail_code == entry.fail_code == 150, out.verdict
    result = audit.audit_entry(entry, build_machine, device="cpu")
    assert result.status == "match", result.verdict
    digests, final = result.trail.to_lists()
    assert digests == entry.digests and final == entry.digest_final


@pytest.mark.parametrize("entry", OTHERS, ids=[e.machine for e in OTHERS])
def test_unported_entries_raise(entry):
    with pytest.raises(NotImplementedError, match=entry.machine):
        corpus.check(entry, build_machine, device="cpu")
    with pytest.raises(NotImplementedError, match=entry.machine):
        audit.audit_entry(entry, build_machine, device="cpu")


def test_audit_finds_the_first_divergent_checkpoint():
    """A recorded trail with one checkpoint altered bisects to it."""
    entry = MULTIPAXOS[0]
    trail = audit.audit_entry(entry, build_machine, device="cpu").trail
    recorded = [list(ck) for ck in trail.to_lists()[0]] + [[999, 1, 2]]
    div = audit.first_divergence(recorded, None, trail)
    assert div is not None and div.step == 999 and div.got is None
    assert audit.first_divergence(recorded[:-1], entry.digest_final, trail) is None
