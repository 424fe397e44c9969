"""The port's command line against the JAX package's, on the corpus path a
found bug takes: `hunt` (the batch path) shrinking and recording the
double-grant etcd demo, `regress` with `--promote`, `audit --record`
then a skewed trail, `replay` with `--diff-seed`, `shrink` and `trace
--perfetto --jsonl` with message flows. The sizes are the reference's
own CLI tests' (tests/test_corpus.py:68-112,
tests/test_flight_recorder.py:215-270). Each command runs in both
packages on the same arguments, the port with `--device cpu`: stdout
equal apart from the program name, the same exit code, and the files
byte for byte the reference's (a corpus apart from the `meta` fields
that name the framework)."""

import json
import os
import shutil

import pytest

from torch_port_util import corpus_without_env, run_pair

DOUBLEGRANT = ["--machine", "demo-doublegrant-etcd", "--horizon", "8.0", "--queue", "96", "--faults", "3"]
HUNT = [*DOUBLEGRANT, "--seeds", "8", "--max-steps", "4000"]


@pytest.fixture(scope="module")
def hunted(tmp_path_factory):
    """Both packages' `hunt` (the batch path) of 8 double-grant seeds,
    each into its own corpus file."""
    tmp = tmp_path_factory.mktemp("cli_corpus")
    paths = {"jax": str(tmp / "jax.json"), "port": str(tmp / "port.json")}
    want, got = run_pair(["hunt", *HUNT, "--corpus", paths["jax"], "--limit", "1"],
                         ["hunt", *HUNT, "--corpus", paths["port"], "--limit", "1"])
    return tmp, paths, want, got


def _pair(tmp, source, name, argv):
    """Each package's `argv` on its own copy of the corpus `source`
    (`{corpus}` in argv): the exit codes, the outputs with the port's
    file name put back, and the two files."""
    files = {who: str(tmp / f"{name}_{who}.json") for who in ("jax", "port")}
    for path in files.values():
        if not os.path.exists(path):
            shutil.copy(source, path)
    (rc_j, out_j), (rc_p, out_p) = run_pair([a.format(corpus=files["jax"]) for a in argv],
                                            [a.format(corpus=files["port"]) for a in argv])
    return (rc_j, out_j), (rc_p, out_p.replace(files["port"], files["jax"])), files


def test_hunt_matches_jax(hunted):
    from madsim_tpu_torch.engine import corpus

    _, paths, (rc_jax, out_jax), (rc_port, out_port) = hunted
    assert rc_port == rc_jax == 1
    assert out_port == out_jax.replace(paths["jax"], paths["port"])
    assert "+ corpus: seed 0 fails with code 120" in out_port
    assert corpus_without_env(paths["port"]) == corpus_without_env(paths["jax"])
    [entry] = corpus.load(paths["port"])
    assert entry.status == corpus.STATUS_OPEN and entry.config.horizon_us < 8_000_000
    assert entry.meta["torch"] and entry.digest_final


def test_regress_and_promote_match_jax(hunted):
    tmp, paths, _, _ = hunted

    def both(*argv):
        want, got, files = _pair(tmp, paths["jax"], "regress", ["regress", "--corpus", "{corpus}", *argv])
        assert got == want
        assert open(files["port"]).read() == open(files["jax"]).read()
        return got[0], got[1], files

    rc, out, files = both()
    assert rc == 0 and "still open (reproduces)" in out
    # the entry pointed at the honest machine: "fixed", then promoted
    for path in files.values():
        doc = json.load(open(path))
        doc["entries"][0]["machine"] = "etcd"
        json.dump(doc, open(path, "w"), indent=2)
    assert both()[0] == 1
    rc, out, _ = both("--promote")
    assert rc == 0 and "promoted to fixed" in out and "corpus updated" in out
    assert both()[0] == 0


def test_regress_and_audit_of_an_unknown_machine_match_jax(hunted):
    tmp, paths, _, _ = hunted
    path = str(tmp / "unknown.json")
    doc = json.load(open(paths["jax"]))
    doc["entries"][0]["machine"] = "no-such-machine"
    json.dump(doc, open(path, "w"), indent=2)
    for cmd in ("regress", "audit"):
        want, got = run_pair([cmd, "--corpus", path])
        assert got == want and got[0] == 1
        assert "unknown machine in registry" in got[1] and "0/1 entries satisfied" in got[1]


def test_audit_record_then_skew_matches_jax(hunted):
    tmp, paths, _, _ = hunted
    want, got, files = _pair(tmp, paths["jax"], "audit",
                             ["audit", "--corpus", "{corpus}", "--record", "--digest-every", "4"])
    assert got == want and got[0] == 0
    assert "[rec ]" in got[1] and "checkpoints every 4 steps" in got[1]
    assert corpus_without_env(files["port"]) == corpus_without_env(files["jax"])
    want, got, _ = _pair(tmp, paths["jax"], "audit", ["audit", "--corpus", "{corpus}"])
    assert got == want and got[0] == 0
    # the stream version skewed: both auditors localize the divergence
    for path in files.values():
        doc = json.load(open(path))
        doc["entries"][0]["config"]["rng_stream"] = 3
        json.dump(doc, open(path, "w"), indent=2)
    want, got, _ = _pair(tmp, paths["jax"], "audit", ["audit", "--corpus", "{corpus}"])
    assert got == want and got[0] == 1 and "[DIVG]" in got[1]


REPLAY = ["--machine", "raft", "--seed", "3", "--horizon", "3.0", "--queue", "96", "--faults", "2",
          "--max-steps", "400"]


def test_replay_matches_jax():
    want, got = run_pair(["replay", *REPLAY, "--tail", "5"])
    assert got == want
    assert got[1].count("\n") == 6 and "seed 3: " in got[1]


def test_replay_diff_seed_matches_jax():
    want, got = run_pair(["replay", *REPLAY, "--tail", "5", "--diff-seed", "4", "--diff-context", "2"])
    assert got == want and got[0] == 0
    assert "diverge" in got[1] and "seed 3" in got[1] and "seed 4" in got[1]


def test_shrink_matches_jax():
    want, got = run_pair(["shrink", *DOUBLEGRANT, "--max-steps", "400", "--seed", "1"])
    assert got == want and got[0] == 0
    assert "minimal repro: python -m madsim_tpu replay --machine demo-doublegrant-etcd --seed 1" in got[1]
    # a seed that does not fail: nothing to shrink, exit 2
    want, got = run_pair(["shrink", *REPLAY])
    assert got == want and got[0] == 2 and "nothing to shrink" in got[1]


def test_trace_exports_match_jax(tmp_path):
    argv = ["trace", "--machine", "raft", "--seed", "3", "--max-steps", "200", "--horizon", "1.0"]
    jax_files = [str(tmp_path / "jax.json"), str(tmp_path / "jax.jsonl")]
    port_files = [str(tmp_path / "port.json"), str(tmp_path / "port.jsonl")]
    want, got = run_pair([*argv, "--perfetto", jax_files[0], "--jsonl", jax_files[1]],
                         [*argv, "--perfetto", port_files[0], "--jsonl", port_files[1]])
    assert got[0] == want[0] and got[1] == want[1].replace("jax.json", "port.json")
    for mine, theirs in zip(port_files, jax_files):
        assert open(mine, "rb").read() == open(theirs, "rb").read()
    doc = json.load(open(port_files[0]))
    assert [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
    assert " message flows)" in got[1] and "(0 message flows)" not in got[1]
