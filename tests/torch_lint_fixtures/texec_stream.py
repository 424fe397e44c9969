"""T-rule executor fixture (torch twin): a miniature run_stream with the
idioms of the port's executor — a dispatch wrapper, a bound `.cpu` as the
designed fetch; the donating factory keeps `jax.jit(..., donate_argnums)`,
the only form T003 reads — plus one of each hazard. Expected lines are
tagged `T00x expected`; the `clean` entrypoint must find nothing."""

import jax
import numpy as np
import torch


def _retry(fn, *args):
    return fn(*args)


class MiniEngine:
    def _stream_fns(self, donate):
        def init_carry(seeds):
            return seeds * torch.tensor(2)

        def segment(carry):
            return carry + torch.tensor(1)

        donate_kw = {"donate_argnums": (0,)} if donate else {}
        fns = (jax.jit(init_carry), jax.jit(segment, **donate_kw))
        return fns

    def run_clean(self, n):
        """The honest executor: async dispatches in the loop, one
        designed blocking fetch after it."""
        init_carry, segment = self._stream_fns(True)
        seeds = torch.arange(n, dtype=torch.int64)
        carry = _retry(init_carry, seeds)
        for _ in range(3):
            carry = _retry(segment, carry)
        counters = _retry(carry.cpu).numpy()
        return int(counters[0])

    def run_item_sink(self, n):
        init_carry, segment = self._stream_fns(True)
        carry = init_carry(torch.arange(n, dtype=torch.int64))
        while True:
            carry = _retry(segment, carry)
            done = carry[0].item()  # T001 expected
            if done >= n:
                return done

    def run_truthy_sink(self, n):
        init_carry, segment = self._stream_fns(True)
        carry = init_carry(torch.arange(n, dtype=torch.int64))
        if carry[0]:  # T001 expected
            return 1
        return 0

    def run_hidden_fetch(self, n):
        init_carry, segment = self._stream_fns(True)
        carry = init_carry(torch.arange(n, dtype=torch.int64))
        done = 0
        while done < n:
            carry = _retry(segment, carry)
            snap = carry.cpu()  # T002 expected
            done = int(np.asarray(snap)[0])
        return done

    def run_use_after_donate(self, n):
        init_carry, segment = self._stream_fns(True)
        carry = init_carry(torch.arange(n, dtype=torch.int64))
        advanced = _retry(segment, carry)  # donates `carry`...
        stale = carry + torch.tensor(1)  # T003 expected
        return advanced, stale
