"""The port's guided loop (`madsim_tpu_torch.search.guided.run_guided`)
held against the JAX package's at the reference's fixture sizes
(tests/test_search.py:269-447: a 3-node Raft, 96 seeds in batches of 32,
600 steps): a checkpointed hunt resumed to the identical (seed schedule,
bias state) trail, which equals the JAX package's; the refusal of an
unguided resume; the command line's refusals. The cell-grid plateau's
escalation is in tests/test_torch_search.py."""

import json

import pytest

from torch_port_util import guided_args as _guided_args
from torch_port_util import guided_engines
from torch_port_util import trail_key as _trail_key


@pytest.fixture(scope="module")
def raft_engines():
    return guided_engines()


def test_guided_resume_byte_identical(raft_engines, tmp_path, capsys):
    """A guided hunt interrupted at a batch boundary and resumed
    recomputes the IDENTICAL (seed schedule, bias state) trail and
    final aggregates, and both equal the JAX package's hunt."""
    from madsim_tpu.search.guided import run_guided as jax_run_guided
    from madsim_tpu_torch.search.guided import run_guided

    jax_eng, eng = raft_engines
    ck = str(tmp_path / "guided.ck.json")
    full = run_guided(eng, _guided_args(), purpose="hunt")
    assert full["batches_run"] == 3
    assert full["guided"]["trail"][1]["mutants"] > 0  # corpus engaged
    assert _trail_key(full) == _trail_key(jax_run_guided(jax_eng, _guided_args(), purpose="hunt"))

    part = run_guided(
        eng, _guided_args(checkpoint=ck, stop_after_batches=1),
        purpose="hunt",
    )
    assert part["batches_run"] == 1
    capsys.readouterr()
    resumed = run_guided(
        eng, _guided_args(checkpoint=ck), purpose="hunt"
    )
    assert "resumed at batch 2/3" in capsys.readouterr().out
    assert _trail_key(resumed) == _trail_key(full)
    # the checkpoint records the done flag + the full guided state
    doc = json.load(open(ck))
    assert doc["done"] is True
    assert doc["guided"]["bias"] == resumed["guided"]["bias"]
    assert [r["seeds"] for r in doc["guided"]["trail"]] == [
        r["seeds"] for r in resumed["guided"]["trail"]
    ]


def test_guided_checkpoint_refuses_unguided_resume(raft_engines, tmp_path):
    from madsim_tpu_torch.__main__ import _stream_batches
    from madsim_tpu_torch.search.guided import run_guided

    _, eng = raft_engines
    ck = str(tmp_path / "guided.ck.json")
    run_guided(
        eng, _guided_args(seeds=32, checkpoint=ck, stop_after_batches=1),
        purpose="hunt",
    )
    with pytest.raises(SystemExit, match="guided"):
        _stream_batches(
            eng, _guided_args(seeds=32, checkpoint=ck, guided=False)
        )


def test_guided_cli_validation():
    from madsim_tpu.__main__ import cmd_hunt as jax_cmd_hunt
    from madsim_tpu_torch.__main__ import cmd_hunt

    for over, flag in (({"stream": False}, "--stream"), ({"coverage": False}, "--coverage")):
        with pytest.raises(SystemExit, match=flag) as got:
            cmd_hunt(_guided_args(device="cpu", **over))
        with pytest.raises(SystemExit) as want:
            jax_cmd_hunt(_guided_args(**over))
        assert str(got.value) == str(want.value)
