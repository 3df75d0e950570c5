"""Fault-tolerance harness: heartbeat monitoring, failure/straggler detection,
evict -> elastic re-mesh -> checkpoint-restore (DESIGN.md SS7).

Hardware failures cannot be produced in this container, so the harness drives
a *virtual cluster*: each virtual host reports heartbeats and per-step
latencies; the monitor implements the production policy (missed-heartbeat
eviction, latency-outlier straggler demotion) and the recovery path is the
real one — rebuild the mesh at the surviving size, restore the latest atomic
checkpoint, resume. The same ``FaultPolicy`` would run against real hosts'
heartbeats on a cluster.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def straggler_outliers(
    samples: Dict[int, float], zscore: float, min_population: int = 4
) -> List[Tuple[int, float]]:
    """Median/MAD robust z-score outliers of ``{key: latency}`` samples.

    Returns ``(key, z)`` for every sample whose modified z-score
    (``0.6745 * (v - median) / MAD``) exceeds ``zscore``.  The median/MAD
    pair stays meaningful when up to half the population misbehaves — a
    mean/stddev test would be dragged toward the stragglers it is hunting.
    Empty below ``min_population``: an outlier needs a population to stand
    out from.  Shared by ``ClusterMonitor`` (slow SPMD hosts) and the chaos
    harness (slow-host request tails, ``benchmarks/chaos_bench.py``).
    """
    if len(samples) < min_population:
        return []
    vals = np.array(list(samples.values()), dtype=np.float64)
    med = np.median(vals)
    mad = np.median(np.abs(vals - med)) + 1e-9
    out: List[Tuple[int, float]] = []
    for key, v in samples.items():
        z = 0.6745 * (float(v) - med) / mad
        if z > zscore:
            out.append((key, float(z)))
    return out


@dataclass
class FaultPolicy:
    heartbeat_timeout_s: float = 60.0
    straggler_zscore: float = 3.0  # step-latency outlier threshold
    straggler_min_steps: int = 8  # warm-up before straggler detection
    max_evictions_per_hour: int = 8


@dataclass
class VirtualHost:
    host_id: int
    alive: bool = True
    straggle_factor: float = 1.0  # >1 = slow host
    last_heartbeat: float = 0.0
    step_times: List[float] = field(default_factory=list)


class ClusterMonitor:
    """Tracks heartbeats + step latencies; decides evictions."""

    def __init__(self, n_hosts: int, policy: Optional[FaultPolicy] = None):
        # default must be constructed per-monitor: a dataclass instance in the
        # signature is evaluated once and shared, so one monitor mutating its
        # policy (e.g. relaxing the heartbeat timeout) would retune every
        # other monitor in the process
        self.policy = policy if policy is not None else FaultPolicy()
        self.hosts: Dict[int, VirtualHost] = {
            i: VirtualHost(host_id=i) for i in range(n_hosts)
        }
        self.evictions: List[Tuple[float, int, str]] = []

    # -- signals ---------------------------------------------------------------
    def heartbeat(self, host_id: int, now: float) -> None:
        self.hosts[host_id].last_heartbeat = now

    def report_step(self, host_id: int, seconds: float) -> None:
        self.hosts[host_id].step_times.append(seconds)

    def inject_failure(self, host_id: int) -> None:
        self.hosts[host_id].alive = False

    def inject_straggler(self, host_id: int, factor: float) -> None:
        self.hosts[host_id].straggle_factor = factor

    # -- detection ---------------------------------------------------------------
    def detect(self, now: float) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        # heartbeat timeouts: check EVERY tracked host — a dead host is
        # precisely one that stopped heartbeating
        for h in self.hosts.values():
            if now - h.last_heartbeat > self.policy.heartbeat_timeout_s:
                out.append((h.host_id, "heartbeat-timeout"))
        live = [h for h in self.hosts.values() if h.alive]
        # stragglers: median/MAD outlier test across hosts' recent step times
        min_steps = min(self.policy.straggler_min_steps, 3)
        recent = {
            h.host_id: np.mean(h.step_times[-min_steps:])
            for h in live
            if len(h.step_times) >= min_steps
        }
        for hid, z in straggler_outliers(recent, self.policy.straggler_zscore):
            out.append((hid, f"straggler(z={z:.1f})"))
        return out

    def evict(self, host_id: int, reason: str, now: float) -> None:
        del self.hosts[host_id]
        self.evictions.append((now, host_id, reason))

    def n_alive(self) -> int:
        return len(self.hosts)


@dataclass
class RecoveryEvent:
    step: int
    reason: str
    old_hosts: int
    new_hosts: int
    resumed_from: Optional[int]


def run_with_faults(
    train_epoch: Callable[[int, int], float],  # (start_step, n_hosts) -> end_step
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], Optional[int]],
    monitor: ClusterMonitor,
    schedule: Dict[int, Tuple[str, int]],  # step -> ("fail"|"straggle", host_id)
    total_steps: int,
    steps_per_round: int = 10,
    base_step_time: float = 0.1,
) -> Tuple[int, List[RecoveryEvent]]:
    """Drive a training loop against the virtual cluster.

    Each round simulates ``steps_per_round`` SPMD steps: every live host
    reports heartbeat + step latency (stragglers report inflated times); the
    monitor then decides evictions. An eviction triggers the real recovery
    path: save/restore via the atomic checkpointer and a smaller host count.
    """
    events: List[RecoveryEvent] = []
    step = restore_fn() or 0
    now = 0.0
    while step < total_steps:
        # inject scheduled faults
        for s, (kind, hid) in list(schedule.items()):
            if s <= step and hid in monitor.hosts:
                if kind == "fail":
                    monitor.inject_failure(hid)
                else:
                    monitor.inject_straggler(hid, 8.0)
                del schedule[s]
        # one round of synchronous steps; time advances past the heartbeat
        # window so hosts that stopped heartbeating (alive=False) stand out
        now += monitor.policy.heartbeat_timeout_s + 1
        for h in monitor.hosts.values():
            t = base_step_time * h.straggle_factor
            if h.alive:
                monitor.heartbeat(h.host_id, now)
                monitor.report_step(h.host_id, t)
        detected = monitor.detect(now)
        if detected:
            old = monitor.n_alive()
            save_fn(step)
            for hid, reason in detected:
                if hid in monitor.hosts:
                    monitor.evict(hid, reason, now)
            resumed = restore_fn()
            events.append(
                RecoveryEvent(
                    step=step,
                    reason=";".join(r for _, r in detected),
                    old_hosts=old,
                    new_hosts=monitor.n_alive(),
                    resumed_from=resumed,
                )
            )
            step = resumed or step
        step = train_epoch(step, monitor.n_alive())
        if step % (steps_per_round * 5) == 0:
            save_fn(step)
    save_fn(step)
    return step, events
