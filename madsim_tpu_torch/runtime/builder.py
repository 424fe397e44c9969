"""Env-driven multi-seed test harness (reference: madsim/src/sim/runtime/builder.rs).

Reads the same `MADSIM_TEST_*` environment variables as the reference
(:64-120) so existing madsim workflows translate directly:

  MADSIM_TEST_SEED                first seed (default 1... here: 1)
  MADSIM_TEST_NUM                 number of seeds to run (default 1)
  MADSIM_TEST_JOBS                seeds run concurrently (default 1)
  MADSIM_TEST_CONFIG              path to a TOML Config file
  MADSIM_TEST_TIME_LIMIT          virtual-seconds limit per run
  MADSIM_TEST_CHECK_DETERMINISM   run every seed twice + compare RNG logs

On failure it prints the reproduction hint, like the reference's
"MADSIM_TEST_SEED={seed}" message (sim/runtime/mod.rs:205-210).
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import sys
import threading
import warnings
from typing import Any, Callable, Coroutine, List, Optional

from ..config import Config
from . import Runtime


class Builder:
    """Reference: sim/runtime/builder.rs:7-22 `Builder`."""

    def __init__(
        self,
        seed: int = 1,
        count: int = 1,
        jobs: int = 1,
        config: Optional[Config] = None,
        time_limit: Optional[float] = None,
        check: bool = False,
    ):
        self.seed = seed
        self.count = count
        self.jobs = jobs
        self.config = config
        self.time_limit = time_limit
        self.check = check

    @staticmethod
    def from_env() -> "Builder":
        """Reference: builder.rs:64-120 `from_env`."""
        config = None
        config_path = os.environ.get("MADSIM_TEST_CONFIG")
        if config_path:
            with open(config_path, "r", encoding="utf-8") as f:
                config = Config.from_toml(f.read())
        time_limit_s = os.environ.get("MADSIM_TEST_TIME_LIMIT")
        return Builder(
            seed=int(os.environ.get("MADSIM_TEST_SEED", "1")),
            count=int(os.environ.get("MADSIM_TEST_NUM", "1")),
            jobs=int(os.environ.get("MADSIM_TEST_JOBS", "1")),
            config=config,
            time_limit=float(time_limit_s) if time_limit_s else None,
            check=os.environ.get("MADSIM_TEST_CHECK_DETERMINISM", "") not in ("", "0", "false"),
        )

    def _run_one(self, seed: int, factory: Callable[[], Coroutine]) -> Any:
        if self.check:
            return Runtime.check_determinism(
                seed, factory, self.config, time_limit=self.time_limit
            )
        rt = Runtime(seed, self.config)
        if self.time_limit is not None:
            rt.set_time_limit(self.time_limit)
        return rt.block_on(factory())

    def run(self, factory: Callable[[], Coroutine]) -> Any:
        """Run `count` seeds, `jobs` at a time. Returns the result of the
        last seed.

        Parallelism is real: each concurrent seed gets its own OS
        *process* (reference runs one runtime per OS thread,
        builder.rs:121-160 — genuinely parallel in Rust; Python threads
        would serialize CPU-bound sims on the GIL, so `fork` is the
        faithful equivalent). Falls back to threads where fork is
        unavailable."""
        seeds = list(range(self.seed, self.seed + self.count))
        result: Any = None
        if self.jobs <= 1:
            for seed in seeds:
                result = self._run_in_thread(seed, factory)
            return result
        # fork only on linux: macOS fork() is unsafe once threads/frameworks
        # are up (CPython's own default there is spawn for this reason)
        if sys.platform.startswith("linux"):
            return self._run_parallel_processes(seeds, factory)
        return self._run_parallel_threads(seeds, factory)

    def _run_parallel_processes(
        self, seeds: List[int], factory: Callable[[], Coroutine]
    ) -> Any:
        """fork one child per seed, at most `jobs` alive at once. The
        factory closure and `self` are inherited through fork (no
        pickling of the workload); only results/errors cross the pipe."""
        import multiprocessing as mp
        import pickle
        import traceback
        from queue import Empty

        ctx = mp.get_context("fork")
        queue: Any = ctx.Queue()

        def child(seed: int) -> None:
            code = 0
            try:
                value = self._run_one(seed, factory)
                try:
                    pickle.dumps(value)
                except Exception:  # unpicklable result: drop the value only
                    value = None
                queue.put((seed, None, value))
            except BaseException:  # noqa: BLE001
                queue.put((seed, traceback.format_exc(), None))
                code = 1
            # flush the queue's feeder thread BEFORE the hard exit, or the
            # result can die buffered in the child
            queue.close()
            queue.join_thread()
            # _exit skips atexit hooks (a forked runtime's teardown can hang)
            os._exit(code)

        pending = list(seeds)
        procs: dict[int, Any] = {}
        last_result: List[Any] = [None]
        errors: dict[int, str] = {}

        def launch_up_to_jobs() -> None:
            while pending and len(procs) < self.jobs:
                seed = pending.pop(0)
                p = ctx.Process(target=child, args=(seed,), name=f"madsim-seed-{seed}")
                with warnings.catch_warnings():
                    # CPython warns that forking a multi-threaded process
                    # (torch's pools) can deadlock the child. Children here
                    # run only the pure-Python host sim — never torch —
                    # and leave via os._exit, so inherited torch locks are
                    # never acquired.
                    warnings.simplefilter("ignore", DeprecationWarning)
                    warnings.simplefilter("ignore", RuntimeWarning)
                    p.start()
                procs[seed] = p

        def record(seed: int, err: Any, value: Any) -> None:
            if err is None:
                if seed == seeds[-1]:
                    last_result[0] = value
            else:
                errors[seed] = err
            p = procs.pop(seed, None)
            if p is not None:
                p.join()

        launch_up_to_jobs()
        while procs:
            try:
                record(*queue.get(timeout=0.5))
            except Empty:
                # a message can still be in flight for a child that already
                # exited — drain everything available before declaring any
                # dead child result-less
                while True:
                    try:
                        record(*queue.get_nowait())
                    except Empty:
                        break
                for seed, p in list(procs.items()):
                    if not p.is_alive():
                        p.join()
                        errors[seed] = (
                            f"simulation process died (exit code {p.exitcode}) "
                            f"without reporting a result"
                        )
                        del procs[seed]
            launch_up_to_jobs()

        if errors:
            for seed in sorted(errors):
                print(
                    f"note: run with `MADSIM_TEST_SEED={seed}` environment "
                    f"variable to reproduce this failure",
                    file=sys.stderr,
                )
            first = min(errors)
            raise RuntimeError(
                f"seed {first} failed:\n{errors[first]}"
                + (f"\n({len(errors)} seeds failed in total)" if len(errors) > 1 else "")
            )
        return last_result[0]

    def _run_parallel_threads(
        self, seeds: List[int], factory: Callable[[], Coroutine]
    ) -> Any:
        """Thread fallback for platforms without safe fork (GIL-serialized)."""
        last_result: Any = None
        with concurrent.futures.ThreadPoolExecutor(max_workers=self.jobs) as pool:
            futs = {pool.submit(self._run_one, seed, factory): seed for seed in seeds}
            for fut in concurrent.futures.as_completed(futs):
                seed = futs[fut]
                try:
                    value = fut.result()
                    if seed == seeds[-1]:
                        last_result = value
                except BaseException:
                    print(
                        f"note: run with `MADSIM_TEST_SEED={seed}` environment "
                        f"variable to reproduce this failure",
                        file=sys.stderr,
                    )
                    raise
        return last_result

    def _run_in_thread(self, seed: int, factory: Callable[[], Coroutine]) -> Any:
        """One runtime per fresh thread, like the reference harness."""
        box: List[Any] = [None, None]

        def target() -> None:
            try:
                box[0] = self._run_one(seed, factory)
            except BaseException as exc:  # noqa: BLE001
                box[1] = exc

        t = threading.Thread(target=target, name=f"madsim-seed-{seed}")
        t.start()
        t.join()
        if box[1] is not None:
            print(
                f"note: run with `MADSIM_TEST_SEED={seed}` environment "
                f"variable to reproduce this failure",
                file=sys.stderr,
            )
            raise box[1]
        return box[0]


def main(fn: Callable[..., Coroutine]) -> Callable[..., Any]:
    """`#[madsim::main]` equivalent (reference: madsim-macros/src/lib.rs:115-152):
    decorate an async fn so calling it runs `Builder.from_env().run`."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        return Builder.from_env().run(lambda: fn(*args, **kwargs))

    return wrapper


# `#[madsim::test]` equivalent — usable directly under pytest.
test = main
