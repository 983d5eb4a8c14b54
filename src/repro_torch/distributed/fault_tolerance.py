"""Fault tolerance for long multi-host runs: heartbeats, straggler
detection, checkpoint/restart, elastic re-meshing, and int8 gradient
compression.

The components are transport-agnostic and unit tested with injected clocks
and failures; the sharded serving loop (``distributed/serving.py``) beats
its coordinator through ``HeartbeatMonitor`` on its own round clock:

    monitor = HeartbeatMonitor(...)        # detects dead hosts
    detector = StragglerDetector(...)      # flags slow steps -> re-shard hint
    runner = ResilientRunner(...)          # retries steps, checkpoints,
                                           # re-meshes on device-count change

``compress_int8`` / ``decompress_int8`` quantize a tensor per slice for a
cross-host all-reduce; the all-reduce itself (``compressed_psum``) waits for
the port's ``torch.distributed`` layer (ROADMAP item 14).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch


# ---------------------------------------------------------------- heartbeat
class HeartbeatMonitor:
    """Declares a host dead after ``timeout`` without a beat."""

    # clock is an injectable DEFAULT (every test passes a fake clock); the
    # monitor's decisions are a function of the injected clock, not of a
    # raw read at the decision site.
    def __init__(self, hosts: List[str], timeout: float = 60.0,
                 clock=time.monotonic):  # corelint: disable=wall-clock-decision
        self.timeout = timeout
        self.clock = clock
        self.last: Dict[str, float] = {h: clock() for h in hosts}

    def beat(self, host: str):
        self.last[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]

    def all_alive(self) -> bool:
        return not self.dead_hosts()


# ---------------------------------------------------------------- straggler
@dataclass
class StragglerDetector:
    """EWMA step-time tracker; a step > ``threshold`` x EWMA is a straggler.

    Mitigation is re-sharding around the slow host (or swapping in a hot
    spare); the detector emits the decision, the runner acts."""

    alpha: float = 0.1
    threshold: float = 2.5
    warmup: int = 5
    _ewma: float = 0.0
    _n: int = 0
    events: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = dt if self._ewma == 0 else (self._ewma + dt) / 2
            return False
        is_straggler = dt > self.threshold * self._ewma
        if is_straggler:
            self.events.append(step)
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return is_straggler

    @property
    def ewma(self) -> float:
        return self._ewma


# ------------------------------------------------------------ elastic rerun
@dataclass
class RunnerReport:
    steps_done: int
    restarts: int
    remeshes: int
    straggler_events: int
    final_step_time_ewma: float


class ResilientRunner:
    """Drives a train loop with checkpoint/restart + elastic re-meshing.

    Parameters
    ----------
    step_fn(state, step) -> state     may raise (device loss, preemption)
    save_fn(step, state) / restore_fn(like) -> (step, state)
    remesh_fn(state, n_devices) -> state   re-shards state onto a new mesh
    device_count_fn() -> int          polled every step (elasticity signal)
    """

    def __init__(
        self,
        step_fn: Callable,
        save_fn: Callable,
        restore_fn: Callable,
        *,
        remesh_fn: Optional[Callable] = None,
        device_count_fn: Callable[[], int] = lambda: 1,
        checkpoint_every: int = 50,
        max_restarts: int = 10,
        straggler: Optional[StragglerDetector] = None,
        # injectable default, same contract as HeartbeatMonitor.clock
        clock=time.perf_counter,  # corelint: disable=wall-clock-decision
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.remesh_fn = remesh_fn
        self.device_count_fn = device_count_fn
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerDetector()
        self.clock = clock

    def run(self, state, n_steps: int, start_step: int = 0) -> tuple:
        restarts = remeshes = 0
        step = start_step
        devices = self.device_count_fn()
        while step < n_steps:
            try:
                now = self.device_count_fn()
                if now != devices and self.remesh_fn is not None:
                    state = self.remesh_fn(state, now)
                    devices = now
                    remeshes += 1
                t0 = self.clock()
                state = self.step_fn(state, step)
                self.straggler.observe(step, self.clock() - t0)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(step, state)
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                step, state = self.restore_fn()
        self.save_fn(step, state)
        report = RunnerReport(
            steps_done=step - start_step,
            restarts=restarts,
            remeshes=remeshes,
            straggler_events=len(self.straggler.events),
            final_step_time_ewma=self.straggler.ewma,
        )
        return state, report


# ------------------------------------------------------- grad compression
def compress_int8(x: torch.Tensor, *, axis: int = -1):
    """Symmetric per-slice int8 quantization for a cross-host gradient
    all-reduce (bandwidth /4 vs fp32).  Returns (q, scale); rounding is
    half to even, as ``jnp.round`` rounds."""
    x = torch.as_tensor(x)
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
