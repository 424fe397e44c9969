"""Simulation configuration (reference: madsim/src/sim/config.rs).

TOML-parsable `Config { net, tcp }` with a stable content hash usable as
a cache key (reference: config.rs:9-41). Latency bounds are stored in
integer nanoseconds — float latency arithmetic is forbidden framework-wide
so the host and TPU engines agree bit-for-bit.
"""

from __future__ import annotations

import hashlib
import tomllib
from dataclasses import dataclass, field


@dataclass
class NetConfig:
    """Reference: madsim/src/sim/net/network.rs:66-90 `Config`."""

    packet_loss_rate: float = 0.0
    # Uniform per-packet latency range [min, max) in nanoseconds.
    send_latency_min_ns: int = 1_000_000  # 1 ms
    send_latency_max_ns: int = 10_000_000  # 10 ms
    # Delay-spike window (the runtime-togglable twin of the buggified
    # 1-5 s rand_delay, reference sim/net/mod.rs:287-296): while > 0,
    # each packet independently takes +[spike_min, spike_max) ns of
    # latency with this probability. The device engine's K_DELAY fault
    # kind maps onto these knobs (differential.py).
    delay_spike_prob: float = 0.0
    delay_spike_min_ns: int = 1_000_000_000  # 1 s
    delay_spike_max_ns: int = 5_000_000_000  # 5 s

    def validate(self) -> None:
        if not (0.0 <= self.packet_loss_rate <= 1.0):
            raise ValueError("packet_loss_rate must be in [0, 1]")
        if self.send_latency_max_ns < self.send_latency_min_ns:
            raise ValueError("send_latency_max_ns < send_latency_min_ns")
        if not (0.0 <= self.delay_spike_prob <= 1.0):
            raise ValueError("delay_spike_prob must be in [0, 1]")
        if self.delay_spike_max_ns < self.delay_spike_min_ns:
            raise ValueError("delay_spike_max_ns < delay_spike_min_ns")


@dataclass
class TcpConfig:
    """Placeholder, mirroring the reference's empty TcpConfig
    (reference: madsim/src/sim/net/tcp/config.rs)."""


@dataclass
class Config:
    net: NetConfig = field(default_factory=NetConfig)
    tcp: TcpConfig = field(default_factory=TcpConfig)

    @staticmethod
    def from_toml(text: str) -> "Config":
        data = tomllib.loads(text)
        net = data.get("net", {})
        cfg = Config()
        if "packet_loss_rate" in net:
            cfg.net.packet_loss_rate = float(net["packet_loss_rate"])
        if "send_latency_min_ns" in net:
            cfg.net.send_latency_min_ns = int(net["send_latency_min_ns"])
        if "send_latency_max_ns" in net:
            cfg.net.send_latency_max_ns = int(net["send_latency_max_ns"])
        cfg.net.validate()
        return cfg

    def to_toml(self) -> str:
        return (
            "[net]\n"
            f"packet_loss_rate = {self.net.packet_loss_rate}\n"
            f"send_latency_min_ns = {self.net.send_latency_min_ns}\n"
            f"send_latency_max_ns = {self.net.send_latency_max_ns}\n"
        )

    def stable_hash(self) -> int:
        """Stable content hash (reference: config.rs `hash()`)."""
        digest = hashlib.sha256(self.to_toml().encode()).digest()
        return int.from_bytes(digest[:8], "little")
