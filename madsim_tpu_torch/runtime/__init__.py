"""Runtime & supervisor (reference: madsim/src/sim/runtime/mod.rs).

`Runtime` owns the RNG, virtual clock, executor and simulators;
`Handle` is the supervisor API (kill / restart / pause / resume /
ctrl-c per node); `NodeBuilder` creates simulated processes.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Coroutine, Dict, List, Optional, Type, Union

from .. import _context
from ..config import Config
from ..errors import NonDeterminism
from ..plugin import Simulator
from ..rand import GlobalRng
from ..task.executor import Executor, NodeInfo, MAIN_NODE_ID
from ..task.join import JoinHandle
from ..time import TimeHandle
from .metrics import RuntimeMetrics

__all__ = ["Runtime", "Handle", "NodeBuilder", "NodeHandle", "hostname", "init_logger"]


def _default_simulators() -> List[Type[Simulator]]:
    from ..fs import FsSim
    from ..net import NetSim

    return [NetSim, FsSim]


class Runtime:
    """The simulation runtime (reference: sim/runtime/mod.rs:34 `Runtime`).

    One seed => one bit-identical execution of `block_on`.
    """

    def __init__(self, seed: int = 0, config: Optional[Config] = None):
        self.seed = seed
        self.config = config or Config()
        self.rng = GlobalRng(seed)
        self.time = TimeHandle(self.rng)
        self.executor = Executor(self.rng, self.time)
        self.simulators: Dict[type, Simulator] = {}
        self.executor.simulators = self.simulators  # for plugin.simulator()
        self.handle = Handle(self)
        self.executor.runtime_handle = self.handle  # for Handle.current()
        for sim_cls in _default_simulators():
            self.add_simulator(sim_cls)

    @staticmethod
    def with_seed_and_config(seed: int, config: Config) -> "Runtime":
        """Reference: sim/runtime/mod.rs:53 `with_seed_and_config`."""
        return Runtime(seed, config)

    def add_simulator(self, sim_cls: Type[Simulator]) -> None:
        """Reference: sim/runtime/mod.rs:72 `add_simulator`."""
        sim = sim_cls(self.rng, self.time, self.config)
        self.simulators[sim_cls] = sim
        self.executor.create_hooks.append(sim.create_node)
        self.executor.reset_hooks.append(sim.reset_node)
        # Nodes created before this simulator was added (e.g. main).
        for node_id in self.executor.nodes:
            sim.create_node(node_id)

    def set_time_limit(self, duration: Union[int, float]) -> None:
        """Reference: sim/runtime/mod.rs:148."""
        self.executor.set_time_limit(duration)

    def create_node(self) -> "NodeBuilder":
        return NodeBuilder(self.handle)

    def block_on(self, coro: Coroutine) -> Any:
        """Run the simulation until `coro` completes
        (reference: sim/runtime/mod.rs:127-130)."""
        ctx = _context.SimContext(self.executor)
        _context.enter(ctx)
        try:
            return self.executor.block_on(coro)
        finally:
            _context.exit()

    def metrics(self) -> RuntimeMetrics:
        return RuntimeMetrics(self.executor)

    @staticmethod
    def check_determinism(
        seed: int,
        factory: Callable[[], Coroutine],
        config: Optional[Config] = None,
        time_limit: Optional[float] = None,
    ) -> Any:
        """Run a workload twice with the same seed and compare the RNG draw
        logs; raises `NonDeterminism` on divergence
        (reference: sim/runtime/mod.rs:178-203).

        Each run executes on a fresh thread for full isolation, like the
        reference.
        """
        results: List[Any] = [None, None]
        errors: List[Optional[BaseException]] = [None, None]
        log_box: List[Optional[List[int]]] = [None]

        def run(i: int) -> None:
            try:
                rt = Runtime(seed, config)
                if time_limit is not None:
                    rt.set_time_limit(time_limit)
                if i == 0:
                    rt.rng.enable_log()
                else:
                    rt.rng.enable_check(log_box[0])  # type: ignore[arg-type]
                results[i] = rt.block_on(factory())
                if i == 0:
                    log_box[0] = rt.rng.take_log()
                else:
                    rt.rng.finish_check()
            except BaseException as exc:  # noqa: BLE001
                errors[i] = exc

        for i in range(2):
            t = threading.Thread(target=run, args=(i,), name=f"madsim-check-{i}")
            t.start()
            t.join()
            if errors[i] is not None:
                raise errors[i]  # type: ignore[misc]
        return results[1]


class Handle:
    """Supervisor handle (reference: sim/runtime/mod.rs:214 `Handle`)."""

    def __init__(self, runtime: Runtime):
        self._runtime = runtime

    @staticmethod
    def current() -> "Handle":
        """Handle of the simulation running on this thread."""
        executor = _context.current().executor
        return executor.runtime_handle  # type: ignore[attr-defined]

    @property
    def seed(self) -> int:
        return self._runtime.seed

    @property
    def config(self) -> Config:
        return self._runtime.config

    @property
    def time(self) -> TimeHandle:
        return self._runtime.time

    @property
    def rng(self) -> GlobalRng:
        return self._runtime.rng

    def _node_id(self, node: Union[int, "NodeHandle"]) -> int:
        return node.id if isinstance(node, NodeHandle) else node

    def kill(self, node: Union[int, "NodeHandle"]) -> None:
        """Reference: sim/runtime/mod.rs:276."""
        self._runtime.executor.kill(self._node_id(node))

    def restart(self, node: Union[int, "NodeHandle"]) -> None:
        """Reference: sim/runtime/mod.rs:281."""
        self._runtime.executor.restart(self._node_id(node))

    def pause(self, node: Union[int, "NodeHandle"]) -> None:
        """Reference: sim/runtime/mod.rs:286."""
        self._runtime.executor.pause(self._node_id(node))

    def resume(self, node: Union[int, "NodeHandle"]) -> None:
        """Reference: sim/runtime/mod.rs:291."""
        self._runtime.executor.resume(self._node_id(node))

    def send_ctrl_c(self, node: Union[int, "NodeHandle"]) -> None:
        """Reference: sim/runtime/mod.rs:296."""
        self._runtime.executor.send_ctrl_c(self._node_id(node))

    def is_killed(self, node: Union[int, "NodeHandle"]) -> bool:
        return self._runtime.executor.nodes[self._node_id(node)].killed

    def create_node(self) -> "NodeBuilder":
        return NodeBuilder(self)


class NodeBuilder:
    """Builds a simulated process (reference: sim/runtime/mod.rs:325)."""

    def __init__(self, handle: Handle):
        self._handle = handle
        self._name = ""
        self._ip: Optional[str] = None
        self._cores = 1
        self._init: Optional[Callable[[], Coroutine]] = None
        self._restart_on_panic = False
        self._restart_on_panic_matching: Optional[Callable[[BaseException], bool]] = None

    def name(self, name: str) -> "NodeBuilder":
        self._name = name
        return self

    def ip(self, ip: str) -> "NodeBuilder":
        """Reference: sim/runtime/mod.rs:390."""
        self._ip = ip
        return self

    def cores(self, cores: int) -> "NodeBuilder":
        """Reference: sim/runtime/mod.rs:398."""
        self._cores = cores
        return self

    def init(self, factory: Callable[[], Coroutine]) -> "NodeBuilder":
        """Async closure run at node start and at every restart
        (reference: sim/runtime/mod.rs:359)."""
        self._init = factory
        return self

    def restart_on_panic(self) -> "NodeBuilder":
        """Reference: sim/runtime/mod.rs:377."""
        self._restart_on_panic = True
        return self

    def restart_on_panic_matching(self, pred: Callable[[BaseException], bool]) -> "NodeBuilder":
        self._restart_on_panic_matching = pred
        return self

    def build(self) -> "NodeHandle":
        executor = self._handle._runtime.executor
        node = executor.create_node(self._name)
        node.ip = self._ip
        node.cores = self._cores
        node.init = self._init
        node.restart_on_panic = self._restart_on_panic
        node.restart_on_panic_matching = self._restart_on_panic_matching
        if self._ip is not None:
            for sim in self._handle._runtime.simulators.values():
                hook = getattr(sim, "set_node_ip", None)
                if hook is not None:
                    hook(node.id, self._ip)
        if self._init is not None:
            executor.spawn(self._init(), node, location="<node-init>")
        return NodeHandle(self._handle, node)


class NodeHandle:
    """Handle to a simulated process (reference: sim/runtime/mod.rs NodeHandle)."""

    def __init__(self, handle: Handle, node: NodeInfo):
        self._handle = handle
        self._node = node

    @property
    def id(self) -> int:
        return self._node.id

    @property
    def name(self) -> str:
        return self._node.name

    @property
    def ip(self) -> Optional[str]:
        return self._node.ip

    def spawn(self, coro: Coroutine, *, name: str = "") -> JoinHandle:
        """Spawn a task onto this node."""
        import sys

        frame = sys._getframe(1)
        location = f"{frame.f_code.co_filename}:{frame.f_lineno}"
        executor = self._handle._runtime.executor
        task = executor.spawn(coro, self._node, location=location, name=name)
        return JoinHandle(task)


def hostname() -> str:
    """The current node's name (reference 0.2.34: the libc gethostname
    interposition returns the node's name, or `madsim-node-{id}` for
    unnamed nodes — here that default is baked in at node creation, so
    this is simply the name)."""
    from .. import _context

    return _context.current_task().node.name


def init_logger(level: str = "INFO") -> None:
    """Install a basic logging config (reference: sim/runtime/mod.rs:445
    `init_logger` installing tracing-subscriber)."""
    import logging

    logging.basicConfig(
        level=getattr(logging, level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
