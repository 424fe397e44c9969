"""The port's hand-written CUDA kernels, their plain PyTorch twins and
their launch counters (the counterpart of `madsim_tpu/ops/pallas_pop.py`).

  * `step_megakernel`: pop + gather + the v3 RNG word block + the
    flight-recorder digest, the model-independent prefix of a v3 event
    step (`csrc/step_megakernel.cu`; twin `step_prefix_plain`).
  * `pop_gather_batch`: pop + gather, the step prefix whenever the
    megakernel does not run (`csrc/pop_gather.cu`; twin
    `pop_gather_plain`).
  * `pop_earliest_batch`: the pop alone, for the single-lane replay
    (`csrc/pop_gather.cu`; twin `pop_earliest_plain`).
  * `cov_flush_batch`: the buffered coverage fold
    (`csrc/cov_flush.cu`; twin `cov_flush_plain`).

Each wrapper takes the twin only for tensors on the CPU. For CUDA
tensors it checks device, dtype, shape and contiguity, allocates the
outputs, launches the kernel on PyTorch's current stream and adds one
to `launches[name]`; anything else raises. Nothing falls back.

`launch_floor` launches an empty kernel with a kernel's grid and block
(`kernel_geometry`, `csrc/launch_floor.cu`): it serves chip_smoke.py's
measurements and counts no launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import pop_earliest
from .build import load
from .coverage import cov_flush as cov_flush_plain
from .step_rng import counter_words
from .u32 import to_i32

launches = {"step_megakernel": 0, "cov_flush": 0, "pop_gather": 0, "pop_earliest": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: device pointers and the stream as void*, sizes as int
_ARGTYPES = {
    "step_megakernel_launch": [_P] * 11 + [_I] * 4 + [_P] * 11,
    "cov_flush_launch": [_P] * 3 + [_I] * 3 + [_P],
    "pop_gather_launch": [_P] * 7 + [_I] * 3 + [_P] * 8,
    "pop_earliest_launch": [_P] * 3 + [_I] * 2 + [_P] * 3,
    "launch_floor_launch": [_I] * 2 + [_P],
}
# the library that reports each kernel's launch geometry, and its C function
_GEOMETRY = {
    "step_megakernel": ("launch_floor", "lane_group_geometry"),
    "pop_gather": ("launch_floor", "lane_group_geometry"),
    "pop_earliest": ("launch_floor", "lane_group_geometry"),
    "cov_flush": ("cov_flush", "cov_flush_geometry"),
}


def _lib(stem: str, fn: str):
    """The C entry point `fn` of library `stem`, built at first use."""
    f = getattr(load()[stem], fn)
    f.argtypes = _ARGTYPES[fn]
    f.restype = ctypes.c_int
    return f


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _on_card(name: str, device) -> bool:
    """True for CUDA tensors, False for CPU ones (the twin runs);
    anything else is refused."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {device}")
    return True


def _check_queue(device, **planes):
    """The [L, Q] queue planes of a pop kernel, by name: `eq_valid` bool,
    the others int32. Returns (L, Q)."""
    lanes, q = planes["eq_time"].shape
    for name, t in planes.items():
        _check(name, t, torch.bool if name == "eq_valid" else torch.int32, (lanes, q), device)
    return lanes, q


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# -- the pop kernels ----------------------------------------------------------


def pop_earliest_plain(eq_time, eq_seq, eq_valid):
    """The plain twin of the pop: (idx [L] int32, any [L] bool)."""
    idx, any_valid = pop_earliest(eq_time, eq_seq, eq_valid)
    return idx.to(torch.int32), any_valid


def pop_gather_plain(eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload):
    """The plain twin of pop + gather: `pop_earliest` and
    `take_along_dim` gathers. Returns (idx [L] int32, any [L] bool,
    (time, kind, node, src) [L] int32, payload [L, P] int32); an
    all-invalid lane gathers slot 0."""
    idx, any_valid = pop_earliest(eq_time, eq_seq, eq_valid)
    at = idx[:, None]

    def take(plane):
        return torch.take_along_dim(plane, at, dim=1)[:, 0]

    popped = (take(eq_time), take(eq_kind), take(eq_node), take(eq_src))
    payload = torch.take_along_dim(eq_payload, at[:, :, None], dim=1)[:, 0]
    return idx.to(torch.int32), any_valid, popped, payload


def pop_earliest_batch(eq_time, eq_seq, eq_valid):
    """The pop of every lane, a group of threads per lane on the card;
    the twin for CPU tensors. Inputs [L, Q] int32 time/seq and bool
    valid; outputs as `pop_earliest_plain`."""
    device = eq_time.device
    if not _on_card("pop_earliest", device):
        return pop_earliest_plain(eq_time, eq_seq, eq_valid)
    lanes, q = _check_queue(device, eq_time=eq_time, eq_seq=eq_seq, eq_valid=eq_valid)
    idx = torch.empty(lanes, dtype=torch.int32, device=device)
    any_valid = torch.empty(lanes, dtype=torch.bool, device=device)
    fn = _lib("pop_gather", "pop_earliest_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(eq_time), _ptr(eq_seq), _ptr(eq_valid), lanes, q, _ptr(idx), _ptr(any_valid),
                 _stream(device))
    _raise_on(err, "pop_earliest")
    launches["pop_earliest"] += 1
    return idx, any_valid


def pop_gather_batch(eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload):
    """Pop + gather the popped event of every lane, a group of threads
    per lane on the card; the twin for CPU tensors. Inputs: the [L, Q]
    int32 planes, the bool valid plane and payload [L, Q, P] int32;
    outputs as `pop_gather_plain`."""
    device = eq_time.device
    if not _on_card("pop_gather", device):
        return pop_gather_plain(eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload)
    lanes, q = _check_queue(device, eq_time=eq_time, eq_seq=eq_seq, eq_valid=eq_valid,
                            eq_kind=eq_kind, eq_node=eq_node, eq_src=eq_src)
    p = eq_payload.shape[2] if eq_payload.dim() == 3 else -1
    _check("eq_payload", eq_payload, torch.int32, (lanes, q, p), device)
    new = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=device)  # noqa: E731
    idx, any_valid = new(lanes), new(lanes, dtype=torch.bool)
    popped = (new(lanes), new(lanes), new(lanes), new(lanes))
    payload = new(lanes, p)
    fn = _lib("pop_gather", "pop_gather_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(eq_time), _ptr(eq_seq), _ptr(eq_valid), _ptr(eq_kind), _ptr(eq_node), _ptr(eq_src),
                 _ptr(eq_payload), lanes, q, p, _ptr(idx), _ptr(any_valid), *(_ptr(t) for t in popped),
                 _ptr(payload), _stream(device))
    _raise_on(err, "pop_gather")
    launches["pop_gather"] += 1
    return idx, any_valid, popped, payload


# -- the step megakernel ----------------------------------------------------


def step_prefix_plain(
    eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload,
    rng_key, step, total_words: int, d0=None, d1=None,
):
    """The plain twin: `pop_gather_plain` + the v3 word block +
    `digest_fold`. Returns (idx[L] int32, any[L] bool,
    (time, kind, node, src)[L] int32, payload[L, P] int32,
    words[L, W] int32 bit patterns, digest) where digest is
    (nd0, nd1)[L] int32 bit patterns, or () without d0/d1."""
    from ..engine.core import digest_fold

    idx, any_valid, popped, payload = pop_gather_plain(
        eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload
    )
    words = counter_words(rng_key, step, total_words)
    digest = ()
    if d0 is not None:
        folded = list(popped) + list(payload.unbind(1)) + list(words.unbind(1))
        nd0, nd1 = digest_fold(d0, d1, folded)
        digest = (to_i32(nd0), to_i32(nd1))
    return idx, any_valid, popped, payload, to_i32(words), digest


def step_megakernel(
    eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload,
    rng_key, step, total_words: int, d0=None, d1=None,
):
    """Pop + gather + v3 word block (+ digest when d0/d1 are given), a
    group of threads per lane on the card; the twin for CPU tensors.
    Inputs: the [L, Q] int32 queue planes and bool valid plane, payload
    [L, Q, P] int32, rng_key [L, 2], step [L], d0/d1 [L], all int32
    (uint32 words as bit patterns). Outputs as `step_prefix_plain`."""
    device = eq_time.device
    if not _on_card("step_megakernel", device):
        return step_prefix_plain(
            eq_time, eq_seq, eq_valid, eq_kind, eq_node, eq_src, eq_payload,
            rng_key, step, total_words, d0, d1,
        )
    lanes, q = _check_queue(device, eq_time=eq_time, eq_seq=eq_seq, eq_valid=eq_valid,
                            eq_kind=eq_kind, eq_node=eq_node, eq_src=eq_src)
    p = eq_payload.shape[2] if eq_payload.dim() == 3 else -1
    i32 = torch.int32
    for name, t, dtype, shape in (
        ("eq_payload", eq_payload, i32, (lanes, q, p)), ("rng_key", rng_key, i32, (lanes, 2)),
        ("step", step, i32, (lanes,)),
    ):
        _check(name, t, dtype, shape, device)
    if (d0 is None) != (d1 is None):
        raise ValueError("pass both d0 and d1, or neither")
    if d0 is not None:
        _check("d0", d0, i32, (lanes,), device)
        _check("d1", d1, i32, (lanes,), device)
    if not 1 <= total_words <= 256:
        raise ValueError(f"total_words={total_words}: the kernel takes 1..256 words")
    new = lambda *shape, dtype=i32: torch.empty(shape, dtype=dtype, device=device)  # noqa: E731
    idx, any_valid = new(lanes), new(lanes, dtype=torch.bool)
    popped = (new(lanes), new(lanes), new(lanes), new(lanes))
    payload, words = new(lanes, p), new(lanes, total_words)
    nd0, nd1 = (new(lanes), new(lanes)) if d0 is not None else (None, None)
    fn = _lib("step_megakernel", "step_megakernel_launch")
    with torch.cuda.device(device):
        err = fn(
            _ptr(eq_time), _ptr(eq_seq), _ptr(eq_valid), _ptr(eq_kind), _ptr(eq_node),
            _ptr(eq_src), _ptr(eq_payload), _ptr(rng_key), _ptr(step), _ptr(d0), _ptr(d1),
            lanes, q, p, total_words,
            _ptr(idx), _ptr(any_valid), *(_ptr(t) for t in popped), _ptr(payload),
            _ptr(words), _ptr(nd0), _ptr(nd1), _stream(device),
        )
    _raise_on(err, "step_megakernel")
    launches["step_megakernel"] += 1
    digest = (nd0, nd1) if d0 is not None else ()
    return idx, any_valid, popped, payload, words, digest


# -- the coverage flush -----------------------------------------------------


def cov_flush_batch(cov_map, buf, n):
    """Fold each lane's live buffered slots buf[:, :n] into its packed
    map, IN PLACE (the reference returns a new array; here the map
    tensor itself is updated on either device), and return the map.
    cov_map [L, W], buf [L, C], n [L], all int32."""
    device = cov_map.device
    if not _on_card("cov_flush", device):
        return cov_map.copy_(cov_flush_plain(cov_map, buf, n))
    lanes, w = cov_map.shape
    c = buf.shape[1]
    _check("cov_map", cov_map, torch.int32, (lanes, w), device)
    _check("buf", buf, torch.int32, (lanes, c), device)
    _check("n", n, torch.int32, (lanes,), device)
    fn = _lib("cov_flush", "cov_flush_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(cov_map), _ptr(buf), _ptr(n), lanes, c, w, _stream(device))
    _raise_on(err, "cov_flush")
    launches["cov_flush"] += 1
    return cov_map


# -- the launch floor ---------------------------------------------------------


def kernel_geometry(name: str, lanes: int, entries: int = 0):
    """(grid, block) of kernel `name`'s launch at `lanes` lanes (the flush:
    of `entries` buffered entries each), as the built sources define it."""
    stem, fn_name = _GEOMETRY[name]
    fn = getattr(load()[stem], fn_name)
    sizes = [lanes, entries] if name == "cov_flush" else [lanes]
    fn.argtypes = [_I] * len(sizes) + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None
    grid, block = ctypes.c_int(), ctypes.c_int()
    fn(*sizes, ctypes.byref(grid), ctypes.byref(block))
    return grid.value, block.value


def launch_floor(grid: int, block: int, device) -> None:
    """Launch an empty kernel of `grid` blocks of `block` threads on the
    current stream of `device` (a CUDA device): the least time a launch
    of that shape takes."""
    fn = _lib("launch_floor", "launch_floor_launch")
    with torch.cuda.device(device):
        err = fn(grid, block, _stream(device))
    _raise_on(err, "launch_floor")
