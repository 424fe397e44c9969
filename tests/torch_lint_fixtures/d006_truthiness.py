"""Lint fixture (torch twin): D006 python truthiness on tensors.

Machine-like by name only — never imported, never simulated.
"""

import torch


class Machine:  # stand-in base so the file is self-contained
    pass


class TruthyMachine(Machine):
    def on_message(self, nodes, node, src, payload, now_us, rand_u32):
        if payload[0] == 1:  # LINT: D006 line 15
            return nodes, None
        flag = torch.any(nodes.acked)
        while flag:  # LINT: D006 line 18
            break
        ok = bool(nodes.done[node])  # LINT: D006 line 20
        return nodes, ok

    def invariant(self, nodes, now_us):
        if self.STRICT:  # ok: self.* is static config
            return True, 0
        assert nodes.commit[0] >= 0  # LINT: D006 line 26
        return True, 0

    def helper(self, nodes):
        # ok: not an engine-traced method name
        if nodes:
            return 1
