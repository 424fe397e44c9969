"""The deterministic single-threaded executor — heart of the host engine.

Reference parity (madsim/src/sim/task/mod.rs):
  * run-to-quiescence loop: drain the ready queue in *random order*
    (schedule chaos, :263-323 + utils/mpsc.rs:73-83 `try_recv_random`),
    then jump virtual time to the next timer
  * the clock advances a random 50-100 ns per task poll (:320), so time
    strictly progresses and timer ordering is fuzzed
  * node model: every task belongs to a `NodeInfo` (simulated process)
    with killed/paused flags; killing a node drops its futures
    (:87,:133-140); restart re-runs the stored init closure (:374-401);
    pause parks tasks until resume (:404-424)
  * a panicking task either triggers `restart_on_panic` with a random
    1-10 s backoff (:296-314) or fails the whole simulation

The entire simulation runs on ONE OS thread (reference :220-260);
concurrency is cooperative coroutines only. Multiple seeds parallelize
at the harness level (one runtime per thread/process).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Coroutine, Dict, List, Optional, Set

from .. import _context
from ..errors import Deadlock, JoinError, TimeLimitExceeded
from ..future import OneShotCell
from ..rand import GlobalRng
from ..time import SEC, TimeHandle, to_ns

logger = logging.getLogger("madsim_tpu")

MAIN_NODE_ID = 1


async def _drive_awaitable(aw):
    return await aw


class NodeInfo:
    """A simulated process (reference: sim/task/mod.rs:87 `NodeInfo`)."""

    def __init__(self, node_id: int, name: str):
        self.id = node_id
        self.name = name
        self.ip: Optional[str] = None
        self.cores = 1
        self.killed = False
        self.paused = False
        self.tasks: Set["TaskEntry"] = set()
        self.paused_tasks: List["TaskEntry"] = []
        self.init: Optional[Callable[[], Coroutine]] = None
        self.restart_on_panic = False
        self.restart_on_panic_matching: Optional[Callable[[BaseException], bool]] = None
        # ctrl-c subscribers (reference: sim/task/mod.rs:106-111)
        self.ctrl_c_watchers: List[OneShotCell] = []

    def __repr__(self) -> str:  # pragma: no cover
        return f"NodeInfo(id={self.id}, name={self.name!r})"


class TaskEntry:
    """One spawned task (the Python analogue of an `async-task` Runnable)."""

    __slots__ = (
        "__weakref__",
        "id",
        "coro",
        "node",
        "name",
        "scheduled",
        "finished",
        "kill_requested",
        "cell",
        "pending_on",
        "location",
        "executor",
        "waker",
    )

    def __init__(self, task_id: int, coro: Coroutine, node: NodeInfo, executor: "Executor", location: str, name: str = ""):
        self.id = task_id
        self.coro = coro
        self.node = node
        self.name = name
        self.scheduled = False
        self.finished = False
        self.kill_requested = False
        self.cell = OneShotCell()  # (value, exc) on completion
        self.pending_on = None  # Pollable currently awaited (set by future._Await)
        self.location = location
        self.executor = executor

        mod = executor._native_mod
        if mod is not None:
            # native wake callable — also fired C-internally by timers
            self.waker = mod.TaskWaker(self, executor.ready)
        else:
            def waker(task: "TaskEntry" = self) -> None:
                if task.finished or task.scheduled:
                    return
                task.scheduled = True
                task.executor.ready.append(task)

            self.waker = waker

    def cancel(self) -> None:
        """Drop the future (reference: kill path sim/task/mod.rs:133-140)."""
        if self.finished:
            return
        if self.executor.running_task is self:
            # Cannot close a coroutine from inside itself; the executor
            # closes it as soon as this poll returns.
            self.kill_requested = True
            return
        self._close()

    def _close(self) -> None:
        self.finished = True
        try:
            self.coro.close()  # raises GeneratorExit inside -> finally blocks run
        except RuntimeError:  # pragma: no cover - coroutine ignored GeneratorExit
            logger.warning("task %s ignored cancellation", self.id)
        except Exception:  # noqa: BLE001 - errors during unwind are swallowed like Rust drop
            logger.exception("error while dropping task %s", self.id)
        self.node.tasks.discard(self)
        self.cell.set((None, JoinError("task was cancelled", cancelled=True)))

    def __repr__(self) -> str:  # pragma: no cover
        return f"TaskEntry(id={self.id}, node={self.node.id}, finished={self.finished})"


class Executor:
    """Reference: sim/task/mod.rs `Executor` + `TaskHandle`."""

    def __init__(self, rng: GlobalRng, time: TimeHandle):
        self.rng = rng
        self.time = time
        # draw-hash observation folds in the virtual clock (the native
        # twin of _context.try_time_ns in GlobalRng._record)
        if rng._core is not None and time._core is not None:
            rng._core.bind_time(time._core)
        self.ready: List[TaskEntry] = []
        self.nodes: Dict[int, NodeInfo] = {}
        self._next_node_id = MAIN_NODE_ID
        self._next_task_id = 1
        self.running_task: Optional[TaskEntry] = None
        self.panic: Optional[BaseException] = None
        self.time_limit_ns: Optional[int] = None
        self._time_limit_hit = False
        # simulator reset hooks, registered by Runtime.add_simulator
        self.reset_hooks: List[Callable[[int], None]] = []
        self.create_hooks: List[Callable[[int], None]] = []
        # task census for metrics (reference: sim/runtime/metrics.rs)
        self.spawn_counts: Dict[int, Dict[str, int]] = {}
        # Native poll loop (hostcore.run_all_ready): used when the RNG +
        # clock cores are native and the determinism log/check is off
        # (the log must observe every draw). Draw-for-draw identical to
        # the Python loop, so either path replays the other's seeds.
        from .. import _native

        self._native_mod = _native.get_mod()
        self.main_node = self.create_node("madsim-main")  # reference 0.2.34 rename

    # -- nodes --------------------------------------------------------------

    def create_node(self, name: str = "") -> NodeInfo:
        node_id = self._next_node_id
        self._next_node_id += 1
        node = NodeInfo(node_id, name or f"madsim-node-{node_id}")
        self.nodes[node_id] = node
        for hook in self.create_hooks:
            hook(node_id)
        return node

    def kill(self, node_id: int) -> None:
        """Kill a node: drop all its futures, reset simulators
        (reference: sim/task/mod.rs:356-371)."""
        node = self.nodes[node_id]
        if node_id == MAIN_NODE_ID:
            raise ValueError("cannot kill the main node")
        node.killed = True
        node.paused = False
        node.paused_tasks.clear()
        for task in list(node.tasks):
            task.cancel()
        node.tasks = {t for t in node.tasks if not t.finished}
        for hook in self.reset_hooks:
            hook(node_id)

    def restart(self, node_id: int) -> None:
        """Kill then re-run the node's init closure
        (reference: sim/task/mod.rs:374-401)."""
        if node_id == MAIN_NODE_ID:
            raise ValueError("cannot restart the main node")
        node = self.nodes[node_id]
        node.killed = True
        for task in list(node.tasks):
            task.cancel()
        for hook in self.reset_hooks:
            hook(node_id)
        node.killed = False
        node.paused = False
        node.paused_tasks.clear()
        node.ctrl_c_watchers.clear()
        if node.init is not None:
            self.spawn(node.init(), node, location="<node-init>")

    def pause(self, node_id: int) -> None:
        self.nodes[node_id].paused = True

    def resume(self, node_id: int) -> None:
        node = self.nodes[node_id]
        node.paused = False
        # Parked tasks re-enter the ready queue (still marked scheduled).
        self.ready.extend(node.paused_tasks)
        node.paused_tasks.clear()

    def send_ctrl_c(self, node_id: int) -> None:
        """Deliver ctrl-c, or kill if nobody listens
        (reference: sim/task/mod.rs:166-175,:426-441)."""
        node = self.nodes[node_id]
        if node.ctrl_c_watchers:
            watchers, node.ctrl_c_watchers = node.ctrl_c_watchers, []
            for cell in watchers:
                cell.set(None)
        else:
            self.kill(node_id)

    # -- spawning -----------------------------------------------------------

    def spawn(self, coro: Coroutine, node: NodeInfo, location: str, name: str = "") -> TaskEntry:
        if not hasattr(coro, "send"):
            # plain awaitables (e.g. the sleep future) are driven via a
            # coroutine shim — spawn accepts anything awaitable, like
            # tokio::spawn takes any Future
            coro = _drive_awaitable(coro)
        if node.killed:
            coro.close()
            task = TaskEntry(0, coro, node, self, location, name)
            task.finished = True
            task.cell.set((None, JoinError("node is killed", cancelled=True)))
            return task
        task_id = self._next_task_id
        self._next_task_id += 1
        task = TaskEntry(task_id, coro, node, self, location, name)
        node.tasks.add(task)
        self.spawn_counts.setdefault(node.id, {})
        self.spawn_counts[node.id][location] = self.spawn_counts[node.id].get(location, 0) + 1
        task.waker()
        return task

    # -- the loop -----------------------------------------------------------

    def block_on(self, main_coro: Coroutine) -> Any:
        """Reference: sim/task/mod.rs:220-260 `Executor::block_on`.

        Cyclic GC is paused for the duration of the simulation: the
        executor allocates tens of thousands of tracked objects per
        simulated second (tasks, coroutines, pendings), and generational
        scans of the live runtime graph were ~20% of host-engine wall
        time. Virtually all sim garbage is acyclic (refcount-freed
        immediately — the native core's types all carry traverse/clear
        so teardown cycles break); the allocation counters keep
        accumulating while collection is paused, so the NORMAL
        threshold-triggered collections fire in the windows between
        simulations and reclaim the rare surviving cycles (measured:
        flat RSS over thousands of back-to-back seeds). Set
        MADSIM_TPU_GC=1 to keep the collector running inside
        simulations too (e.g. single very long sims on tight memory)."""
        import gc as _gc

        gc_was_enabled = _gc.isenabled() and os.environ.get("MADSIM_TPU_GC") != "1"
        if gc_was_enabled:
            _gc.disable()
        try:
            return self._block_on_inner(main_coro)
        finally:
            if gc_was_enabled:
                _gc.enable()

    def _block_on_inner(self, main_coro: Coroutine) -> Any:
        main_task = self.spawn(main_coro, self.main_node, location="<main>")
        mod = self._native_mod
        rng = self.rng
        while True:
            if (
                mod is not None
                and rng._core is not None
                and self.time._core is not None
                and (not rng.recording or rng.native_observing)
            ):
                # the whole inner loop (drain + timer jump) runs in C;
                # in check mode the core itself hashes every draw
                # (scheduling draws included), so the loop users run is
                # the loop the check validates
                code = mod.drive(
                    self, _context.current(), rng._core, self.time._core, main_task
                )
            else:
                self.run_all_ready()
                if self.panic is not None:
                    code = 1
                elif main_task.finished:
                    code = 0
                elif self._time_limit_hit:
                    code = 2
                elif not self.time.advance_to_next_event():
                    code = 3
                else:
                    continue
            if code == 1:
                panic, self.panic = self.panic, None
                raise panic
            if code == 0:
                value, exc = main_task.cell.peek()
                if exc is not None:
                    raise exc
                return value
            if code == 2:
                raise TimeLimitExceeded(
                    f"time limit ({self.time_limit_ns / SEC}s) exceeded at "
                    f"t={self.time.elapsed()}s"
                )
            if code == 4:
                self.rng.raise_native_mismatch()
            raise Deadlock(
                "all tasks are blocked and no timer is pending — "
                "the simulation would block forever (deadlock)"
            )

    def run_all_ready(self) -> None:
        """Drain the ready queue in random order (reference :263-323)."""
        mod = self._native_mod
        rng = self.rng
        if (
            mod is not None
            and rng._core is not None
            and self.time._core is not None
            and (not rng.recording or rng.native_observing)
        ):
            mod.run_all_ready(self, _context.current(), rng._core, self.time._core)
            return
        ready = self.ready
        while ready:
            # try_recv_random: swap-remove a uniformly random element
            # (reference: sim/utils/mpsc.rs:73-83).
            idx = rng.gen_range(0, len(ready)) if len(ready) > 1 else 0
            task = ready[idx]
            ready[idx] = ready[-1]
            ready.pop()
            task.scheduled = False
            if task.finished or task.node.killed:
                continue
            if task.node.paused:
                task.scheduled = True
                task.node.paused_tasks.append(task)
                continue
            self._poll_task(task)
            if self.panic is not None:
                return
            # Virtual time advances 50-100 ns per poll (reference :319-321).
            self.time.advance_ns(rng.gen_range(50, 101))

    def _poll_task(self, task: TaskEntry) -> None:
        ctx = _context.current()
        prev = ctx.current_task
        ctx.current_task = task
        self.running_task = task
        try:
            task.coro.send(None)
        except StopIteration as stop:
            task.finished = True
            task.node.tasks.discard(task)
            task.cell.set((stop.value, None))
        except Exception as exc:  # noqa: BLE001 - the "panic" path
            task.finished = True
            task.node.tasks.discard(task)
            self._handle_panic(task, exc)
        finally:
            self.running_task = None
            ctx.current_task = prev
        if task.kill_requested and not task.finished:
            task.kill_requested = False
            task._close()

    def _handle_panic(self, task: TaskEntry, exc: BaseException) -> None:
        """Reference: sim/task/mod.rs:284-317 (catch_unwind + restart)."""
        node = task.node
        matcher = node.restart_on_panic_matching
        should_restart = node.restart_on_panic or (matcher is not None and matcher(exc))
        if should_restart and node.id != MAIN_NODE_ID and node.init is not None:
            delay_ns = self.rng.gen_range(1 * SEC, 10 * SEC)
            logger.warning(
                "task panicked on node %s (%s); restarting in %.3fs: %r",
                node.id, node.name, delay_ns / SEC, exc,
            )
            # Joiners of the panicked task observe a JoinError rather than
            # hanging (the task is already out of node.tasks here).
            task.cell.set((None, JoinError(f"task panicked: {exc!r}", cause=exc)))
            node.killed = True
            for t in list(node.tasks):
                t.cancel()
            for hook in self.reset_hooks:
                hook(node.id)
            node_id = node.id

            def do_restart() -> None:
                self.restart(node_id)

            self.time.add_timer_ns(self.time.now_ns() + delay_ns, do_restart)
        else:
            task.cell.set((None, exc))
            self.panic = exc

    def set_time_limit(self, duration) -> None:
        """A timer at the limit raises before any later event runs
        (reference: sim/runtime/mod.rs:148 set_time_limit)."""
        self.time_limit_ns = to_ns(duration)

        def hit() -> None:
            self._time_limit_hit = True

        self.time.add_timer_ns(self.time_limit_ns, hit)
