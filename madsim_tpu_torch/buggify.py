"""FoundationDB-style cooperative fault injection.

Reference: madsim/src/sim/buggify.rs + sim/rand.rs:119-135.
`buggify()` fires with probability 25% at enabled buggify points; the
framework itself calls it on chaos-relevant paths (e.g. NetSim delays).
"""

from __future__ import annotations

from . import _context

DEFAULT_PROB = 0.25


def enable() -> None:
    _context.current_rng().buggify_enabled = True


def disable() -> None:
    _context.current_rng().buggify_enabled = False


def is_enabled() -> bool:
    return _context.current_rng().buggify_enabled


def buggify() -> bool:
    """True with 25% probability when buggify is enabled."""
    return _context.current_rng().buggify_with_prob(DEFAULT_PROB)


def buggify_with_prob(p: float) -> bool:
    return _context.current_rng().buggify_with_prob(p)
