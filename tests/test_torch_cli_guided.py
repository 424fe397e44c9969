"""The port's `hunt --guided` on the command line against the JAX
package's: `hunt --stream --coverage --provenance --guided
--stop-on-plateau 1 --checkpoint --stats` of the volatile-commit Raft
demo under strict restarts, at the reference's guided fixture size (96
seeds in batches of 32, 600 steps; tests/test_search.py:247-256). Its
mutants find the bug, the cell grid plateaus and the vocabulary
escalates, and the find is shrunk into the corpus. Stdout is equal
apart from the program name; the checkpoint with its guided trail is
byte for byte the reference's, the stats JSONL is apart from its
wall-clock fields, the corpus apart from the framework's `meta` fields.
A run stopped after one batch resumes to the uninterrupted checkpoint.
Then the two refusals (`--guided` without `--stream` or `--coverage`)."""

import json

import pytest

from torch_port_util import corpus_without_env, run_pair

GUIDED = ["hunt", "--machine", "demo-volatilecommit-raft", "--strict-restart", "--seeds", "96", "--batch", "32",
          "--max-steps", "600", "--horizon", "1.0", "--queue", "64", "--fault-tmax", "600000", "--stream",
          "--coverage", "--provenance", "--guided", "--stop-on-plateau", "1"]


def _stats_rows(base):
    rows = []
    for line in open(base + ".jsonl"):
        row = json.loads(line)
        for key in ("ts", "seeds_per_sec", "elapsed_s"):
            row.pop(key, None)
        rows.append(row)
    return rows


@pytest.fixture(scope="module")
def hunted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_guided")
    files = {who: {kind: str(tmp / f"{who}.{kind}") for kind in ("corpus", "ckpt", "stats")}
             for who in ("jax", "port")}

    def argv(who):
        f = files[who]
        return [*GUIDED, "--corpus", f["corpus"], "--checkpoint", f["ckpt"], "--stats", f["stats"], "--limit", "1"]

    want, got = run_pair(argv("jax"), argv("port"))
    return files, want, got


def test_guided_hunt_matches_jax(hunted):
    files, (rc_j, out_j), (rc_p, out_p) = hunted
    for kind, path in files["port"].items():
        out_p = out_p.replace(path, files["jax"][kind])
    assert rc_p == rc_j == 1 and out_p == out_j
    assert "guided: escalation step 1, " in out_p and "(trail recorded in checkpoint)" in out_p
    assert "fault attribution: [" in out_p and "+ corpus: seed" in out_p
    assert open(files["port"]["ckpt"], "rb").read() == open(files["jax"]["ckpt"], "rb").read()
    assert _stats_rows(files["port"]["stats"]) == _stats_rows(files["jax"]["stats"])
    assert corpus_without_env(files["port"]["corpus"]) == corpus_without_env(files["jax"]["corpus"])
    doc = json.load(open(files["port"]["ckpt"]))
    trail = doc["guided"]["trail"]
    assert doc["done"] is True and [r["batch"] for r in trail] == [0, 1, 2]
    assert all(r["mutants"] > 0 for r in trail[1:]) and trail[-1]["escalated_to"] == 1
    assert doc["prov"] and doc["guided"]["prov_counts"]["kill"] > 0
    seeds = [s for r in trail for s in r["seeds"]]
    assert len(seeds) == len(set(seeds)) == 96


def test_guided_hunt_resumes_to_the_same_checkpoint(hunted, tmp_path):
    files, _, _ = hunted
    ckpt = {who: str(tmp_path / f"{who}.ckpt") for who in ("jax", "port")}

    def argv(who, *extra):
        return [*GUIDED, "--corpus", str(tmp_path / f"{who}.corpus"), "--checkpoint", ckpt[who], "--limit", "0",
                *extra]

    def pair(*extra):
        want, got = run_pair(argv("jax", *extra), argv("port", *extra))
        assert got[0] == want[0] and got[1].replace("port.c", "jax.c") == want[1]
        return got[1]

    pair("--stop-after-batches", "1")
    assert json.load(open(ckpt["port"]))["done"] is False
    assert open(ckpt["port"], "rb").read() == open(ckpt["jax"], "rb").read()
    assert "resumed at batch 2/3 (32 seeds already completed, escalation step 0)" in pair()
    assert open(ckpt["port"], "rb").read() == open(files["port"]["ckpt"], "rb").read()


def test_escalated_find_shrinks_under_its_rung(tmp_path, monkeypatch):
    """A find the guided hunt made under escalation step 1 is shrunk from
    that step's engine (its vocabulary, pair,kill,dir,group,storm,delay,
    ablated from there), as the JAX package's hunt does: the hunt's
    search is stubbed on both sides to report seed 18, which fails 102
    under step 1, so the shrink and the entry are compared alone."""
    import madsim_tpu.__main__ as jax_cli
    import madsim_tpu_torch.__main__ as port_cli

    agg = {"completed": 96, "stats": {}, "provenance": {18: 0x40000003},
           "guided": {"failing_escalation": {18: 1}}}
    for cli in (jax_cli, port_cli):
        monkeypatch.setattr(cli, "_find_failing", lambda eng, args, purpose="hunt": ([(18, 102)], [], 0, agg))

    def argv(who):
        return [*GUIDED, "--corpus", str(tmp_path / f"{who}.corpus"), "--limit", "1"]

    want, got = run_pair(argv("jax"), argv("port"))
    assert got[0] == want[0] == 1 and got[1].replace("port.c", "jax.c") == want[1]
    assert "+ corpus: seed 18 fails with code 102" in got[1]
    entry = corpus_without_env(str(tmp_path / "port.corpus"))
    assert entry == corpus_without_env(str(tmp_path / "jax.corpus"))
    # the kind ablation starts from the escalated vocabulary
    [e] = entry["entries"]
    assert "kinds -delay,-storm,-group,-dir,-pair;" in e["note"] and e["config"]["faults"]["allow_kill"]


@pytest.mark.parametrize("drop,flag", [("--stream", "--stream"), ("--coverage", "--coverage")],
                         ids=["no-stream", "no-coverage"])
def test_guided_refusals_match_jax(drop, flag):
    from madsim_tpu.__main__ import main as jax_main
    from madsim_tpu_torch.__main__ import main

    argv = [a for a in GUIDED if a != drop]
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit, match=flag) as got:
        main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value)
