"""The port's command line against the JAX package's where causal
provenance rides it: `why` (stdout, `--out`, `--json`, `--perfetto`
with the cone's flows highlighted, and a seed that does not fail),
`explore --provenance` on the batch and stream paths, `hunt --stream
--provenance` (the fault-attribution line, the guided shrink in the
corpus note, the checkpoint's "prov" words, the stats summary's
attribution) and `hunt --provenance` on the batch path. Each command
runs in both packages on the same arguments, the port with `--device
cpu`: stdout equal apart from the program name and the file names, the
same exit code, and the files byte for byte the reference's (a corpus
apart from the `meta` fields that name the framework). The why seed is
the pinned volatile-commit find of tests/test_provenance.py."""

import json

import pytest

from torch_port_util import corpus_without_env, run_pair

VOLATILE = ["--machine", "demo-volatilecommit-raft", "--strict-restart"]
# the command line's v3 hunt shape at a few dozen lanes (chip_smoke.py's `cli`)
SHAPE = [*VOLATILE, "--rng-stream", "3", "--queue", "32", "--max-steps", "600"]


def _files(tmp, name, *exts):
    return {who: {ext: str(tmp / f"{name}_{who}.{ext}") for ext in exts} for who in ("jax", "port")}


def _pair(argv, files):
    """Both packages on `argv`, whose `{key}` fields name each one's own
    files; the port's output with the reference's file names put back."""
    want, got = run_pair([a.format(**files["jax"]) for a in argv], [a.format(**files["port"]) for a in argv])
    text = got[1]
    for key, path in files["port"].items():
        text = text.replace(path, files["jax"][key])
    return want, (got[0], text)


def _same_bytes(files, *exts):
    for ext in exts:
        with open(files["jax"][ext], "rb") as a, open(files["port"][ext], "rb") as b:
            assert a.read() == b.read(), ext


def test_why_matches_jax(tmp_path):
    files = _files(tmp_path, "why", "txt", "json", "perfetto")
    want, got = _pair(["why", "5", *VOLATILE, "--max-steps", "3000", "--tail", "5", "--out", "{txt}",
                       "--json", "{json}", "--perfetto", "{perfetto}"], files)
    assert got == want and got[0] == 0
    assert "violation provenance word: 0x40000002" in got[1] and "implicated kinds: kill,strict-restart" in got[1]
    _same_bytes(files, "txt", "json", "perfetto")
    doc = json.load(open(files["port"]["json"]))
    assert doc["prov_word"] == 0x40000002 and doc["implicated_kinds"] == ["kill", "strict-restart"]
    trace = json.load(open(files["port"]["perfetto"]))["traceEvents"]
    assert any(e["ph"] == "s" for e in trace) and any(e.get("args", {}).get("cone") for e in trace)


def test_why_of_a_passing_seed_exits_2_as_the_reference():
    want, got = run_pair(["why", "--seed", "1", *VOLATILE, "--max-steps", "400", "--horizon", "0.5"])
    assert got == want and got[0] == 2 and "nothing to explain" in got[1]


@pytest.mark.parametrize("stream", [False, True], ids=["batch", "stream"])
def test_explore_with_provenance_matches_jax(stream):
    argv = ["explore", *SHAPE, "--seeds", "24", "--provenance"] + (["--stream", "--batch", "24"] if stream else [])
    want, got = run_pair(argv)
    assert got == want and got[0] == 1 and "failure codes: [102]" in got[1]
    assert ("fault attribution: [" in got[1]) == stream


def test_stream_hunt_with_provenance_matches_jax(tmp_path):
    files = _files(tmp_path, "hunt", "corpus", "ckpt", "stats")
    want, got = _pair(["hunt", "--stream", *SHAPE, "--seeds", "48", "--batch", "24", "--provenance", "--corpus",
                       "{corpus}", "--checkpoint", "{ckpt}", "--stats", "{stats}", "--limit", "1"], files)
    assert got == want and got[0] == 1
    assert "fault attribution: [kill=5, pair=1, strict-restart=5]" in got[1]
    assert "provenance-guided by [kill,pair,strict-restart]" in got[1]
    assert corpus_without_env(files["port"]["corpus"]) == corpus_without_env(files["jax"]["corpus"])
    ckpt = {who: json.load(open(files[who]["ckpt"])) for who in ("jax", "port")}
    assert ckpt["port"]["prov"] == ckpt["jax"]["prov"] and len(ckpt["port"]["prov"]) == 5

    def summary(who):
        [row] = [json.loads(line) for line in open(files[who]["stats"] + ".jsonl")
                 if json.loads(line)["kind"] == "hunt_summary"]
        return {k: v for k, v in row.items() if k not in ("ts", "elapsed_s")}

    assert summary("port") == summary("jax") and summary("port")["fault_attribution"]["kill"] == 5


def test_batch_hunt_with_provenance_matches_jax(tmp_path):
    files = _files(tmp_path, "bhunt", "corpus")
    want, got = _pair(["hunt", *VOLATILE, "--seeds", "12", "--queue", "48", "--max-steps", "600", "--provenance",
                       "--corpus", "{corpus}", "--limit", "1"], files)
    assert got == want and got[0] == 1
    assert "fault attribution: [" in got[1] and "provenance-guided by [kill,strict-restart]" in got[1]
    assert corpus_without_env(files["port"]["corpus"]) == corpus_without_env(files["jax"]["corpus"])
