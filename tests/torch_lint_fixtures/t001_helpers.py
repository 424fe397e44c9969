"""T001 fixture (torch twin): tensor sinks inside handler-CALLED helpers
— the scope D006's file-local taint cannot see (the while/ternary gap).
Expected lines carry a trailing expectation tag discovered by
tests/test_torch_lint_v2.py."""

import torch


def spin_helper(value, budget):
    # a tensor `value` in a while condition: D006 never looks here
    while value > 0:  # T001 expected
        budget -= 1
    return budget


def pick_helper(flag, a, b):
    # ternary test on a tensor inside a helper
    return a if flag else b  # T001 expected


def item_helper(word):
    return word.item()  # T001 expected


def clean_helper(x):
    return torch.where(x > 0, x, -x)  # masked select: the honest idiom


class Machine:  # stands in for the real base so the AST pass engages
    pass


class HelperMachine(Machine):
    MAX_MSGS = 4

    def _tally(self, votes):
        # self-method helper: while on a tensor argument
        while votes != 0:  # T001 expected
            votes = votes >> 1
        return votes

    def on_message(self, nodes, src, dst, payload, now_us, rand_u32):
        spin_helper(payload, 3)
        pick_helper(nodes, 1, 2)
        item_helper(rand_u32)
        self._tally(payload)
        clean_helper(nodes)
        return nodes
