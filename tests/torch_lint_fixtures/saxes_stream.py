"""S-rule fixture (torch twin): a miniature streaming executor for lane-axis tracking.

Each `seg_*` method is walked as its own entry context by
tests/test_torch_lint_v2.py with a fixture-local registry/axis-table
binding (mini-done-any / mini-count; FakeCarry.state lane, .count
global). Lines tagged `S00x expected` must be flagged with exactly that
rule; untagged lines must stay clean. Never imported, only parsed; its
loops are python loops, whose bodies are walked.
"""

import torch

# `torch.where` on mixed-axis operands stays lane-parallel (seg_clean)


class FakeCarry:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class MiniStream:
    def seg_clean(self, c):
        """Scan-carry threading + `where` on mixed-axis operands: the
        lane mask rides a python loop's carry, keeps its axis through the
        thread, and every cross-lane fold is annotated."""

        def cond(carry):
            s, it = carry
            # madsim: collective(mini-done-any, reduce=any)
            return (it < 4) & torch.any(~s.done)

        def body(carry):
            s, it = carry
            return s, it + 1

        final, it = c.state, torch.tensor(0)
        while cond((final, it)):
            final, it = body((final, it))
        mixed = torch.where(final.done, final.step, torch.tensor(0))
        # madsim: collective(mini-count, reduce=sum)
        return mixed.sum()

    def seg_unannotated_sum(self, c):
        return c.state.step.sum()  # S001 expected

    def seg_scan_carry_leak(self, c):
        """A cross-lane fold smuggled into the per-event loop body: the
        carry threading keeps `s.done` lane-axis, so the fold inside
        the per-event loop is both undeclared and misplaced."""

        def body(carry):
            s, it = carry
            bad = s.done.to(torch.int32).sum()  # S001 expected S004 expected
            return s, it + bad

        final, it = c.state, torch.tensor(0)
        while it < 2:
            final, it = body((final, it))
        # the walk enters this method in the `step` region
        return final

    def seg_reshape_drops_lane(self, c):
        return c.state.step.reshape((-1,))  # S001 expected

    def seg_rebuild_leaf(self, c):
        done = c.state.done
        return FakeCarry(
            state=c.state,
            count=done,  # S002 expected
        )

    def seg_host_if(self, c):
        if c.state.done:  # S003 expected
            return 1
        return 0

    def seg_unregistered(self, c):
        # madsim: collective(no-such-entry, reduce=sum)
        return c.state.done.sum()  # S001 expected
