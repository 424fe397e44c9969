"""Shared helper of the tests that mirror a JAX-package test file on the
port's host services (`madsim_tpu_torch.services`) case for case.

`load_pair(name)` loads `tests/<name>.py` twice: as it stands, and as
the port's copy, the same source with the package renamed to
`madsim_tpu_torch` (imports at module level and inside the cases, and
the scripts a case hands to a subprocess). `run_both(pair, case)` runs
the case on each, with every request a service client sends (and every
watch event, observation and consumed message it reads) recorded, and
holds the two records equal (`torch_host_util.both`): the port's
clients see the responses the JAX package's see, in the same order, at
the same virtual times."""

from __future__ import annotations

import contextlib
import enum
import functools
import importlib
import inspect
import os
import random
import re
import sys
import types

from torch_host_util import both

TESTS = os.path.dirname(os.path.abspath(__file__))

# the service clients' choke points: (module under `<pkg>.services`, class, method)
_RECORDED = (
    ("etcd", "Client", "_call"),
    ("etcd", "Watcher", "__anext__"),
    ("etcd", "Watcher", "progress"),
    ("etcd", "Observer", "__anext__"),
    ("kafka", "_Conn", "call"),
    ("kafka", "BaseConsumer", "poll"),
    ("kafka", "StreamConsumer", "recv"),
    ("s3", "Client", "_call"),
    ("kafka.real_client", "RealKafkaConn", "call"),
    ("s3.real_client", "RealS3Backend", "call"),
)


def port_source(src: str, renames=()) -> str:
    """A test file's source as the port's copy: the package renamed,
    then each (pattern, replacement) of `renames` applied."""
    src = re.sub(r"\bmadsim_tpu\b", "madsim_tpu_torch", src)
    for pattern, repl in renames:
        src = re.sub(pattern, repl, src)
    return src


def _load(name: str, path: str, src: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__file__ = path
    sys.modules[name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


@functools.lru_cache(maxsize=None)
def load_pair(stem: str, renames=()):
    """(JAX module, port module) of `tests/<stem>.py`."""
    path = os.path.join(TESTS, stem + ".py")
    with open(path) as fh:
        src = fh.read()
    return {"jax": _load(f"_jax_{stem}", path, src), "port": _load(f"_port_{stem}", path, port_source(src, renames))}


def case_names(mod) -> list:
    return sorted(n for n, v in vars(mod).items() if n.startswith("test_") and inspect.isfunction(v))


_ADDR = re.compile(r" at 0x[0-9a-f]+")


def norm(x, depth: int = 0, wall=()):
    """`x` as plain values with no package name and no address in it:
    a service's result object becomes (class name, its fields). The
    values of the dict keys in `wall` (wall-clock stamps) are masked."""
    rec = functools.partial(norm, depth=depth + 1, wall=wall)
    if depth > 6:
        return "..."
    if x is None or isinstance(x, (bool, int, float, bytes)):
        return x
    if isinstance(x, str):
        return _ADDR.sub("", x.replace("madsim_tpu_torch", "madsim_tpu"))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, BaseException):
        return ("raise", type(x).__name__, rec(str(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(rec(v) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(rec(v)) for v in x)))
    if isinstance(x, dict):
        return ("dict", tuple((rec(k), "<wall clock>" if k in wall else rec(v)) for k, v in x.items()))
    cls = type(x)
    if not cls.__module__.startswith("madsim_tpu"):
        return cls.__name__
    slots = [s for c in cls.__mro__ for s in getattr(c, "__slots__", ())]
    fields = {s: getattr(x, s, None) for s in slots}
    fields.update({k: v for k, v in getattr(x, "__dict__", {}).items() if not k.startswith("_")})
    return (cls.__name__, rec(fields))


@contextlib.contextmanager
def recording(m, wall=()):
    """Record every call of package `m`'s service client choke points:
    (class.method, arguments, result or exception, virtual ns)."""
    log = []
    rec = functools.partial(norm, wall=wall)

    def now():
        try:
            return m.time.now_ns()
        except Exception:  # noqa: BLE001 - real mode has no virtual clock
            return None

    def wrap(qual, fn):
        @functools.wraps(fn)
        async def recorded(self, *args, **kwargs):
            try:
                out = await fn(self, *args, **kwargs)
            except BaseException as exc:
                log.append((qual, rec(args), rec(kwargs), rec(exc), now()))
                raise
            log.append((qual, rec(args), rec(kwargs), rec(out), now()))
            return out

        return recorded

    saved = []
    for mod_name, cls_name, meth in _RECORDED:
        cls = getattr(importlib.import_module(f"{m.__name__}.services.{mod_name}"), cls_name)
        fn = cls.__dict__[meth]
        saved.append((cls, meth, fn))
        setattr(cls, meth, wrap(f"{mod_name}.{cls_name}.{meth}", fn))
    try:
        yield log
    finally:
        for cls, meth, fn in saved:
            setattr(cls, meth, fn)


def run_both(pair, case: str, wall=(), **kwargs):
    """Run test `case` of the JAX module and of its port copy (with
    `kwargs`, its fixtures). Both pass or both raise alike, and their
    client records are equal, the values of the keys in `wall` masked.
    Returns the port's record."""

    def work(m):
        mod = pair["port" if m.__name__ == "madsim_tpu_torch" else "jax"]
        # the real-wire gateways draw lease and request ids from `random`
        random.seed(0)
        with recording(m, wall) as log:
            getattr(mod, case)(**kwargs)
        return log

    return both(work)
