"""Multi-host sharded serving with quorum-voted plan swaps (DESIGN.md §6),
on the card: every host's engine scores through ``cascade_score`` with a
scorer it deserialized itself from COREWIRE bytes.

The input stream is sharded across K simulated hosts.  Each host runs its
OWN ``CascadeServer`` — local CUSUM detectors, importance-audit sampler,
and weighted reservoir — but local drift triggers do not swap plans:
they become ``DriftVote``s to a ``QuorumSwapCoordinator``.  On quorum the
coordinator merges every host's reservoir export (IPW weights preserved),
runs the warm-started re-optimization ONCE, and broadcasts the result as
the versioned scorer wire artifact through a two-phase (prepare/commit)
epoch swap: hosts stage + ack first, and only install once every peer has
acknowledged — no host ever serves a plan version its peers haven't seen.
In-flight records still finish under the plan version that scored them
(the engine's versioned ``_PlanState`` machinery), so record conservation
holds across global swaps exactly as it does across local ones.

Three transports share all protocol logic:

* ``transport="inline"`` — hosts are plain objects driven round-robin by
  the caller's thread; deterministic, the benchmark/test default.
* ``transport="thread"`` — each host runs in its own worker thread with a
  command queue; the coordinator talks to it only via messages.  Same
  code path as inline (``_ThreadHost`` proxies ``ShardHost``), but the
  prepare/commit barrier crosses real thread boundaries.
* ``transport="process"`` — one host per OS subprocess
  (``distributed/procworker.py``): the parent speaks a newline-delimited
  JSON control protocol over pipes, with COREWIRE blobs (artifacts,
  re-sync frames) riding base64-embedded.  The worker runs the same
  ``ShardHost`` the other transports drive — one protocol core.

Fault tolerance (DESIGN.md §6 failure model): the coordinator replicates
its state machine to a ``StandbyCoordinator`` via epoch-stamped deltas;
heartbeat loss promotes the standby, which completes or cleanly aborts
any in-flight two-phase swap.  The prepare barrier runs under an ack
deadline: silent hosts become a NACK or get FENCED (serve-behind on
their pinned epoch, excluded from quorum math, COREWIRE re-sync on
rejoin).  Hosts additionally stream their IPW kappa² contingency counts
so the coordinator pools correlation evidence fleet-wide.

A real deployment would replace the transport with RPC; the protocol core
(``distributed/consensus.py``) is transport-agnostic by construction.

Every host takes ``device`` (``ShardedCascadeServer`` defaults to CUDA and
raises without a card): its engine, the scorers it deserializes and the
coordinator's re-optimizations all run there.  There is no switch around
the scorer.  Thread hosts share the card's current stream; ``cascade_score``
serializes its launches per stream (``kernels/proxy_score.py``).
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.query import PhysicalPlan
from repro_torch.distributed.consensus import (
    DriftVote,
    QuorumSwapCoordinator,
    StandbyCoordinator,
    StateDelta,
    SwapAck,
    SwapCommit,
    SwapPrepare,
    SwapRecord,
)
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.serving.engine import CascadeServer, ServeStats
from repro_torch.serving.stats import AdaptivePolicy, DriftEvent
from repro_torch.util import advisory_wall_ms, resolve_device


@dataclass
class ShardedServeStats:
    """Aggregate view over K hosts plus the consensus layer."""

    n_hosts: int
    per_host: List[ServeStats]
    submitted_per_host: List[int]
    votes_cast: int = 0
    swaps_committed: int = 0
    swaps_aborted: int = 0
    final_epoch: int = 0
    swap_log: List[SwapRecord] = field(default_factory=list)
    wall_ms: float = 0.0
    # ----- fault tolerance -----
    failovers: int = 0
    failover_resolution: str = ""  # "completed" | "aborted" | "idle"
    standby_rearms: int = 0  # fresh standbys registered after a failover
    fences: int = 0  # hosts fenced out of a barrier (stragglers)
    resyncs: int = 0  # COREWIRE catch-up installs on rejoin
    pooled_swaps: int = 0  # swaps initiated by pooled kappa² evidence
    plan_cache_writebacks: int = 0  # committed plans recorded cross-query
    # ----- request front end (slo_ms set): per-host FrontEndStats -----
    frontend_stats: List = field(default_factory=list)

    @property
    def fleet_goodput_ratio(self) -> float:
        """Fleet-level goodput / throughput: requests that met their SLO
        over requests completed, summed across every host's front end."""
        done = sum(f.requests_done for f in self.frontend_stats)
        met = sum(f.requests_met_slo for f in self.frontend_stats)
        return met / done if done else 0.0

    @property
    def submitted(self) -> int:
        return sum(self.submitted_per_host)

    @property
    def emitted(self) -> int:
        return sum(s.emitted for s in self.per_host)

    @property
    def rejected(self) -> int:
        return sum(s.rejected for s in self.per_host)

    @property
    def host_cost_ms(self) -> List[float]:
        return [s.model_cost_ms for s in self.per_host]

    @property
    def critical_path_cost_ms(self) -> float:
        """Hosts run in parallel: the cost-model makespan is the slowest
        host's total, not the sum."""
        return max(self.host_cost_ms) if self.per_host else 0.0

    @property
    def aggregate_rows_per_cost_s(self) -> float:
        cp = self.critical_path_cost_ms
        return self.submitted / (cp / 1e3) if cp > 0 else 0.0

    @property
    def consensus_ms_total(self) -> float:
        return sum(r.consensus_ms for r in self.swap_log)


class ShardHost:
    """One simulated serving host: a private ``CascadeServer`` whose drift
    triggers are exported as votes, plus the two-phase staging slot."""

    def __init__(self, host_id: int, plan: PhysicalPlan, *, tile: int,
                 policy: AdaptivePolicy, seed: int,
                 slo_ms: Optional[float] = None, device="cuda"):
        self.host_id = host_id
        self.device = resolve_device(device)
        self.engine = CascadeServer(
            plan, tile=tile, adaptive=True, policy=policy, seed=seed,
            device=self.device)
        self.query = plan.query
        self.epoch = 0
        self._voted_epoch = -1
        # (epoch, plan, scorer, attempt) staged by phase 1, or None
        self._staged: Optional[Tuple[int, PhysicalPlan, object, int]] = None
        self.submitted = 0
        self.resyncs = 0
        # idx -> engine plan version current when the record was submitted
        # (None until a test enables tracking; kept off the hot path)
        self.track_versions = False
        self.submit_version: Dict[int, int] = {}
        # request front end (DESIGN.md §7): with an SLO every chunk
        # becomes a deadline-carrying request through the batching loop.
        # Backpressure is SHED-ONLY here: plan versions are pinned to
        # quorum epochs, so a host-local degrade install would break the
        # fleet's epoch ordering (coordinator-priced degrades are the
        # filed follow-up) — but deadline shedding and per-request
        # goodput accounting work unchanged.
        self.frontend = None
        if slo_ms is not None:
            from repro_torch.serving.frontend import ServingFrontEnd, SLOPolicy

            self.slo_ms = float(slo_ms)
            self.frontend = ServingFrontEnd(
                self.engine, policy=SLOPolicy(degrade=False))
            # version tracking must stamp at ACTUAL engine submission —
            # the front end's batching loop can hold a chunk's tail rows
            # across an epoch install, and those legitimately run (and
            # emit) under the newer pinned version
            self.frontend.add_submit_hook(self._note_submit_versions)

    def _note_submit_versions(self, indices) -> None:
        if self.track_versions:
            v = self.engine.plan_version
            for i in indices:
                self.submit_version[int(i)] = v

    # ------------------------------------------------------------- serving
    def submit_chunk(self, indices: np.ndarray, rows: np.ndarray) -> None:
        if self.track_versions and self.frontend is None:
            v = self.engine.plan_version
            for i in indices:
                self.submit_version[int(i)] = v
        if self.frontend is not None:
            fe = self.frontend
            fe.submit_request(indices, rows, deadline_ms=self.slo_ms,
                              arrival_ms=fe.now_ms)
            fe.step()
        else:
            self.engine.submit(indices, rows)
            self.engine.pump()
        self.submitted += len(rows)

    def drain(self) -> ServeStats:
        if self.frontend is not None:
            while self.frontend.step():
                pass
            self.frontend.drain()
        else:
            self.engine.pump(drain=True)
        st = self.engine.stats
        shed = (self.frontend.stats.records_shed
                if self.frontend is not None else 0)
        st.rejected = self.submitted - st.emitted - shed
        return st

    # -------------------------------------------------------------- voting
    def poll_vote(self) -> Optional[DriftVote]:
        """Consume a pending local drift trigger into a quorum vote.
        At most one vote per served epoch; repeat triggers within the
        epoch stay parked on the engine (the eventual global install
        clears them)."""
        if self._voted_epoch == self.epoch:
            return None
        drift = self.engine.take_drift()
        if drift is None:
            return None
        signal, observed, expected = drift
        _mode, escalated = self.engine.escalation_hint()
        self._voted_epoch = self.epoch
        return DriftVote(
            host=self.host_id, epoch=self.epoch,
            event=DriftEvent(
                at_record=self.submitted, signal=signal,
                observed=float(observed), expected=float(expected),
                escalated=escalated, plan_version=self.epoch,
            ),
            reservoir=self.engine.reservoir_export(),
            kappa=self.engine.kappa_export(),
        )

    def reservoir_export(self):
        return self.engine.reservoir_export()

    def kappa_export(self):
        """Cumulative IPW contingency counts for fleet-level pooling."""
        return self.engine.kappa_export()

    # --------------------------------------------------------- two-phase
    def prepare(self, msg: SwapPrepare,
                timeout: Optional[float] = None) -> SwapAck:
        """Phase 1: deserialize + stage the artifact; serve nothing new.
        ``timeout`` is accepted for transport-API uniformity — an inline
        host cannot be silent (the deadline is enforced by the threaded /
        process transports, whose calls really can hang)."""
        from repro_torch.kernels.ops import deserialize_scorer

        try:
            if msg.epoch != self.epoch + 1:
                raise ValueError(
                    f"host {self.host_id} at epoch {self.epoch} cannot "
                    f"stage epoch {msg.epoch}")
            plan, scorer = deserialize_scorer(msg.artifact, self.query,
                                              device=self.device)
            self._staged = (msg.epoch, plan, scorer, msg.attempt)
            return SwapAck(host=self.host_id, epoch=msg.epoch, ok=True,
                           attempt=msg.attempt)
        except Exception as e:  # NACK aborts the epoch coordinator-side
            self._staged = None
            return SwapAck(host=self.host_id, epoch=msg.epoch, ok=False,
                           error=str(e), attempt=msg.attempt)

    def commit(self, msg: SwapCommit) -> None:
        """Phase 2: every peer acked — install the staged plan.  In-flight
        queue entries finish under their scoring version."""
        if self._staged is None or self._staged[0] != msg.epoch \
                or self._staged[3] != msg.attempt:
            # the attempt check matters under message reordering: the
            # staged copy may be a STALE same-epoch artifact (a late
            # prepare from an aborted round overwrote the current one) —
            # installing it would diverge from what the fleet acked
            raise RuntimeError(
                f"host {self.host_id}: commit for epoch {msg.epoch} "
                f"(attempt {msg.attempt}) without a matching staged plan")
        _, plan, scorer, _ = self._staged
        self.engine.install_plan(plan, scorer=scorer, version=msg.epoch)
        self.epoch = msg.epoch
        self._staged = None

    def abort(self) -> None:
        """Aborted epoch: drop the staged copy AND re-arm voting — the
        epoch number did not advance, so without the reset every host
        that voted would be locked out (`_voted_epoch == epoch`) and a
        transient NACK would permanently disable quorum swaps."""
        self._staged = None
        self._voted_epoch = -1

    def resync(self, frame: bytes) -> int:
        """Catch-up install for a fenced host rejoining the fleet: a
        COREWIRE v1.1 re-sync frame carries the committed artifact of the
        fleet's CURRENT epoch.  Unlike ``prepare``, there is no two-phase
        dance — every active peer already acked this artifact — and the
        epoch may jump by more than one (the host serve-behinds through
        however many swaps it missed).  Returns the installed epoch."""
        from repro_torch.kernels.ops import (
            FRAME_RESYNC,
            deserialize_frame,
            deserialize_scorer,
        )

        kind, epoch, payload, _meta = deserialize_frame(frame)
        if kind != FRAME_RESYNC:
            raise ValueError(f"host {self.host_id}: expected a resync "
                             f"frame, got {kind!r}")
        if epoch <= self.epoch:
            return self.epoch  # stale resync: already caught up
        plan, scorer = deserialize_scorer(payload, self.query, device=self.device)
        self.engine.install_plan(plan, scorer=scorer, version=epoch)
        self.epoch = epoch
        self._staged = None
        self._voted_epoch = -1
        self.resyncs += 1
        return self.epoch


class HostTimeout(Exception):
    """A host RPC missed its deadline (thread/process transports): the
    caller decides between NACK-on-deadline and straggler fencing."""


class _ThreadHost:
    """Thread-isolated ``ShardHost``: the host's engine lives entirely on
    its worker thread; every interaction is a (request, reply) message
    pair over queues.  API-identical to ``ShardHost``."""

    def __init__(self, host: ShardHost):
        self._host = host
        self.host_id = host.host_id
        self._req: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, name=f"shard-host-{host.host_id}", daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            fn, args, reply = self._req.get()
            if fn is None:
                reply.put(None)
                return
            try:
                reply.put((True, fn(*args)))
            except Exception as e:  # surfaced on the caller thread
                reply.put((False, e))

    def _call(self, fn, *args, timeout: Optional[float] = None):
        reply: "queue.Queue" = queue.Queue()
        self._req.put((fn, args, reply))
        try:
            ok, out = reply.get(timeout=timeout)
        except queue.Empty:
            raise HostTimeout(
                f"host {self.host_id} silent past {timeout}s deadline")
        if not ok:
            raise out
        return out

    @property
    def epoch(self) -> int:
        return self._host.epoch

    @property
    def submitted(self) -> int:
        return self._host.submitted

    @property
    def engine(self) -> CascadeServer:
        return self._host.engine

    @property
    def track_versions(self) -> bool:
        return self._host.track_versions

    @track_versions.setter
    def track_versions(self, v: bool) -> None:
        self._host.track_versions = v

    @property
    def submit_version(self) -> Dict[int, int]:
        return self._host.submit_version

    @property
    def frontend(self):
        return self._host.frontend

    def submit_chunk(self, indices, rows):
        return self._call(self._host.submit_chunk, indices, rows)

    def drain(self):
        return self._call(self._host.drain)

    @property
    def resyncs(self) -> int:
        return self._host.resyncs

    def poll_vote(self):
        return self._call(self._host.poll_vote)

    def reservoir_export(self):
        return self._call(self._host.reservoir_export)

    def kappa_export(self):
        return self._call(self._host.kappa_export)

    def prepare(self, msg, timeout: Optional[float] = None):
        return self._call(self._host.prepare, msg, timeout=timeout)

    def commit(self, msg):
        return self._call(self._host.commit, msg)

    def abort(self):
        return self._call(self._host.abort)

    def resync(self, frame):
        return self._call(self._host.resync, frame)

    def stop(self):
        reply: "queue.Queue" = queue.Queue()
        self._req.put((None, (), reply))
        reply.get()
        self._thread.join(timeout=10)


class ShardedCascadeServer:
    """K-host sharded serving loop.

    ``plan`` should come from ``optimize(..., keep_state=True)`` so the
    coordinator's re-optimizations warm-start; hosts receive only the
    serialized artifact (builder state never fans out).  ``n_hosts=1``
    degrades to single-host serving THROUGH the consensus path (quorum of
    one), which is what the sharded benchmark uses as its baseline.

    Fault-tolerance knobs:

    * ``standby`` — maintain a ``StandbyCoordinator`` mirror (replicated
      state deltas ride a COREWIRE v1.1 frame per transition).  On
      primary heartbeat loss the standby takes over mid-epoch.
    * ``kill_coordinator_at`` — failure injection: ``"prepare"`` kills
      the primary after half the prepare broadcast (partial staging —
      takeover must ABORT), ``"commit"`` after the barrier closed but
      before the commit broadcast, ``"mid-commit"`` after one host
      installed (takeover must COMPLETE / re-sync), or an int record
      count (idle death at a chunk boundary).
    * ``straggler_host`` / ``straggler_policy`` — host made silent for
      the first prepare barrier; ``"fence"`` commits without it under
      serve-behind version fencing (re-sync on rejoin), ``"nack"``
      converts the deadline miss into an abort.
    * ``ack_deadline_s`` — the prepare barrier's per-host ack deadline
      (enforced for real by the thread/process transports).

    ``device`` is where every host serves and the coordinator
    re-optimizes (CUDA by default; raises without a card).  Process
    workers get it in their spec, and the parent loads the kernel library
    before it spawns them, so that they only load it; ``init_timeout_s``
    bounds each worker's start (its ``init`` reply).
    """

    def __init__(self, plan: PhysicalPlan, n_hosts: int = 4, *,
                 tile: int = 1024, policy: Optional[AdaptivePolicy] = None,
                 quorum_frac: float = 0.5, seed: int = 0,
                 transport: str = "inline",
                 max_tile: int = 8192,
                 standby: bool = True,
                 kill_coordinator_at=None,
                 straggler_host: Optional[int] = None,
                 straggler_policy: str = "fence",
                 ack_deadline_s: float = 30.0,
                 heartbeat_rounds: float = 1.5,
                 worker_spec: Optional[dict] = None,
                 slo_ms: Optional[float] = None,
                 plan_cache=None, device="cuda",
                 init_timeout_s: float = 600.0):
        self.device = resolve_device(device)
        if transport not in ("inline", "thread", "process"):
            raise ValueError(f"unknown transport {transport!r}")
        if straggler_policy not in ("fence", "nack"):
            raise ValueError(f"unknown straggler policy {straggler_policy!r}")
        # one kill point, or a sequence of them: each consumed in order,
        # so a SECOND primary death after the first failover (served by
        # the re-armed standby) is injectable too
        if kill_coordinator_at is None:
            kill_points: Tuple = ()
        elif isinstance(kill_coordinator_at, (list, tuple)):
            kill_points = tuple(kill_coordinator_at)
        else:
            kill_points = (kill_coordinator_at,)
        for kp in kill_points:
            if kp not in ("prepare", "commit", "mid-commit") \
                    and not isinstance(kp, int):
                # a typo here would silently disable the failure injection —
                # a fault-tolerance test would then pass exercising nothing
                raise ValueError(
                    f"unknown kill point {kp!r}: expected "
                    f"'prepare' | 'commit' | 'mid-commit' | record count")
        self.n_hosts = int(n_hosts)
        self.policy = policy or AdaptivePolicy()
        self.plan0 = plan
        # cross-query plan cache (core.plan_cache.PlanCache): the
        # coordinator records the initial plan and every quorum-COMMITTED
        # re-optimization — aborted prepares never pollute the cache
        self.plan_cache = plan_cache
        self._last_reopt_plan: Optional[PhysicalPlan] = None
        self.query = plan.query
        self.max_tile = max_tile
        self.ack_deadline_s = float(ack_deadline_s)
        self.straggler_policy = straggler_policy
        # the injected straggler is partitioned from the coordinator from
        # the start (it still serves its shard); its link heals right
        # after the first barrier it goes missing from — see _finish_swap
        self._straggler_pending = straggler_host
        self._kill_queue: deque = deque(kill_points)
        self._silent: Set[int] = (
            set() if straggler_host is None else {int(straggler_host)})
        self._primary_alive = True
        self._round = 0
        self._swap_log_prefix: List[SwapRecord] = []
        coord_kw = dict(
            reopt_fn=self._reopt, quorum_frac=quorum_frac,
            choose_mode=lambda p, fresh: self.policy.choose_escalation(p, fresh)[0],
            max_tile=max_tile, kappa_tol=self.policy.kappa_tol,
            kappa_pool_baseline=self.policy.kappa_pool_baseline,
        )
        self._coord_kw = coord_kw  # standby re-construction after failover
        self.standby = (StandbyCoordinator(plan, self.n_hosts, **coord_kw)
                        if standby else None)
        self.coordinator = QuorumSwapCoordinator(
            plan, self.n_hosts,
            replicate=self._replicate if standby else None, **coord_kw)
        # heartbeat clock = serving rounds (deterministic in simulation);
        # a real deployment would beat on wall time
        self._hb = HeartbeatMonitor(["coordinator"],
                                    timeout=float(heartbeat_rounds),
                                    clock=lambda: float(self._round))
        self.transport = transport
        self._closed = False
        if transport == "process":
            from repro_torch.distributed.procworker import start_process_hosts
            from repro_torch.kernels.ops import serialize_scorer

            if worker_spec is None:
                raise ValueError(
                    "transport='process' needs worker_spec: the worker "
                    "rebuilds the synthetic workload from its seeds (UDF "
                    "closures cannot travel over the pipe)")
            if self.device.type == "cuda":
                # build (or find) and load the kernel library here, once:
                # the workers then only load it
                from repro_torch.kernels import proxy_score

                proxy_score._lib()
            artifact = serialize_scorer(plan, max_tile=max_tile)
            self.hosts = start_process_hosts(
                self.n_hosts, spec=dict(worker_spec, device=str(self.device)),
                artifact=artifact, tile=tile, policy=self.policy, seed=seed,
                slo_ms=slo_ms, init_timeout_s=init_timeout_s)
        else:
            hosts = [
                ShardHost(k, plan, tile=tile, policy=self.policy,
                          seed=seed + 1000 * k, slo_ms=slo_ms,
                          device=self.device)
                for k in range(self.n_hosts)
            ]
            self.hosts = (
                [_ThreadHost(h) for h in hosts] if transport == "thread"
                else hosts)
        self.stats = ShardedServeStats(
            n_hosts=self.n_hosts,
            per_host=[h.engine.stats for h in self.hosts],
            submitted_per_host=[0] * self.n_hosts,
        )
        self._record_to_cache(plan)

    # ------------------------------------------------------ re-optimization
    def _reopt(self, plan: PhysicalPlan, merged, mode: str) -> PhysicalPlan:
        from repro_torch.core.api import REBUILD_DEFAULTS, rebuild_plan

        new_plan = rebuild_plan(
            plan, merged.x,
            REBUILD_DEFAULTS.replace(reopt=mode, step=self.policy.step),
            known_sigma=merged.known_sigma, device=self.device)
        # stashed, not recorded: the cache write-back waits for the quorum
        # barrier to COMMIT this plan fleet-wide (_finish_swap)
        self._last_reopt_plan = new_plan
        return new_plan

    def _record_to_cache(self, plan: Optional[PhysicalPlan]) -> None:
        if self.plan_cache is None or plan is None:
            return
        if self.plan_cache.record_plan(plan, step=self.policy.step) is not None:
            self.stats.plan_cache_writebacks += 1

    # ------------------------------------------------------- replication
    def _replicate(self, delta: StateDelta) -> None:
        """Ship one coordinator transition to the standby as a COREWIRE
        v1.1 delta frame — the same envelope a cross-machine deployment
        would piggyback on its vote/prepare traffic (serialize +
        deserialize both run, so the frame path is exercised on every
        transition of every sharded run)."""
        from repro_torch.kernels.ops import FRAME_DELTA, deserialize_frame, serialize_frame

        frame = serialize_frame(
            FRAME_DELTA, delta.epoch, delta.artifact or b"",
            meta={"kind": delta.kind, "host": delta.host,
                  "has_artifact": delta.artifact is not None})
        kind, epoch, payload, meta = deserialize_frame(frame)
        assert kind == FRAME_DELTA
        self.standby.apply(StateDelta(
            kind=meta["kind"], epoch=epoch, host=meta["host"],
            artifact=payload if meta["has_artifact"] else None))

    # ------------------------------------------------------ failure control
    def set_silent(self, host_id: int, silent: bool = True) -> None:
        """Simulate a network partition: a silent host receives no
        coordinator RPCs (prepare/commit/poll) but keeps serving its
        local shard — exactly a straggler behind a dead link."""
        if silent:
            self._silent.add(host_id)
        else:
            self._silent.discard(host_id)

    def _kill_primary(self) -> None:
        """Failure injection: the primary stops beating and processing;
        its swap log survives (it is OUR log for reporting — a real
        deployment loses it, which is why the standby mirrors state)."""
        self._swap_log_prefix.extend(self.coordinator.swap_log)
        self._primary_alive = False

    def _consume_kill(self, point: str) -> bool:
        if self._primary_alive and self._kill_queue \
                and self._kill_queue[0] == point:
            self._kill_queue.popleft()
            self._kill_primary()
            return True
        return False

    def _failover(self) -> None:
        coord, resolution = self.standby.take_over(
            self.hosts, unreachable=set(self._silent))
        self.coordinator = coord
        self._primary_alive = True
        self._hb.beat("coordinator")
        self.stats.failovers += 1
        self.stats.failover_resolution = resolution
        # re-arm replication: a promoted coordinator must not run
        # unreplicated forever.  Register a fresh standby (in a real
        # fleet: re-elected from the active host set), replay the
        # promoted coordinator's state snapshot through the same COREWIRE
        # delta channel live deltas use, then attach it — a SECOND
        # primary loss after this failover resolves exactly like the
        # first (completes or cleanly aborts any in-flight epoch).
        self.standby = StandbyCoordinator(self.plan0, self.n_hosts,
                                          **self._coord_kw)
        for delta in coord.snapshot_deltas():
            self._replicate(delta)
        coord.replicate = self._replicate
        self.stats.standby_rearms += 1

    # ------------------------------------------------------------ protocol
    def _reachable(self, h) -> bool:
        return h.host_id not in self._silent

    def _handle_votes(self) -> None:
        fenced = self.coordinator.fenced
        for h in self.hosts:
            if not self._reachable(h) or h.host_id in fenced:
                continue
            vote = h.poll_vote()
            if vote is None:
                continue
            self.stats.votes_cast += 1
            if self.coordinator.offer_vote(vote):
                self._run_swap()

    def _sync_stats(self) -> None:
        """Periodic fleet stats sync: pool every reachable host's kappa²
        contingency counts coordinator-side; pooled drift beyond
        tolerance opens a coordinator-initiated (unvoted) swap.  Opt-in
        via ``policy.kappa_pool_baseline > 0``."""
        if self.policy.kappa_pool_baseline <= 0:
            return
        coord = self.coordinator
        for h in self.hosts:
            if not self._reachable(h) or h.host_id in coord.fenced:
                continue
            if coord.offer_stats(h.host_id, h.epoch, h.kappa_export()):
                reservoirs = [x.reservoir_export() for x in self.hosts
                              if self._reachable(x)
                              and x.host_id not in coord.fenced]
                self._finish_swap(coord.propose_pooled(reservoirs))
                return

    def _handle_rejoins(self) -> None:
        """Fenced hosts whose link healed catch up: a COREWIRE re-sync
        frame installs the fleet's committed epoch directly (every active
        peer acked that artifact when it committed), then the host
        re-enters quorum math."""
        from repro_torch.kernels.ops import FRAME_RESYNC, serialize_frame

        coord = self.coordinator
        if not coord.fenced or coord.pending is not None:
            return
        for h in self.hosts:
            if h.host_id not in coord.fenced or not self._reachable(h):
                continue
            if h.epoch < coord.epoch:
                if coord.last_artifact is None:
                    continue  # nothing committed to sync from (shouldn't happen)
                frame = serialize_frame(FRAME_RESYNC, coord.epoch,
                                        coord.last_artifact,
                                        meta={"host": h.host_id})
                h.resync(frame)
                self.stats.resyncs += 1
            coord.mark_rejoined(h.host_id)

    def _run_swap(self) -> None:
        """Quorum reached: merge + re-optimize + two-phase broadcast."""
        voters = set(self.coordinator.voters)
        extras = [h.reservoir_export() for h in self.hosts
                  if h.host_id not in voters and self._reachable(h)
                  and h.host_id not in self.coordinator.fenced]
        self._finish_swap(self.coordinator.propose(extra_reservoirs=extras))

    def _finish_swap(self, prepare: SwapPrepare) -> None:
        """Drive one two-phase barrier: prepare broadcast under the ack
        deadline, straggler resolution, commit broadcast — with the
        failure-injection kill points threaded through."""
        coord = self.coordinator
        initiated_by = coord._pending_record.initiated_by
        submitted_at_quorum = sum(h.submitted for h in self.hosts)
        barrier = [h for h in self.hosts if h.host_id not in coord.fenced]
        t0 = advisory_wall_ms()
        commit = None
        missing: List[int] = []
        delivered = 0
        for h in barrier:
            if delivered >= (len(barrier) + 1) // 2 \
                    and self._consume_kill("prepare"):
                return  # primary died mid-prepare: some hosts staged, some not
            if not self._reachable(h):
                missing.append(h.host_id)
                continue
            try:
                # the deadline is only real where a call can hang; inline
                # hosts are same-thread (and tests monkeypatch prepare)
                ack = (h.prepare(prepare) if self.transport == "inline"
                       else h.prepare(prepare, timeout=self.ack_deadline_s))
            except HostTimeout:
                missing.append(h.host_id)
                continue
            delivered += 1
            commit = coord.offer_ack(ack)
            if not ack.ok:
                break
        if commit is None and coord.pending is not None and missing:
            # deadline expired with silent hosts: fence or NACK them
            commit = coord.resolve_prepare_deadline(missing,
                                                    self.straggler_policy)
            self.stats.fences += sum(1 for hid in missing
                                     if hid in coord.fenced)
        coord.note_prepare_ms(advisory_wall_ms() - t0)
        if commit is None:
            # aborted (NACK / nack-policy straggler): drop staged copies
            for h in barrier:
                if self._reachable(h):
                    h.abort()
            self.stats.swaps_aborted += 1
            self._heal_straggler(missing)
            return
        if self._consume_kill("commit"):
            return  # barrier closed, commit broadcast lost with the primary
        t0 = advisory_wall_ms()
        installed = 0
        for h in barrier:
            if h.host_id in coord.fenced or not self._reachable(h):
                continue
            h.commit(commit)
            installed += 1
            if installed == 1 and self._consume_kill("mid-commit"):
                return  # one host installed; the rest must catch up via standby
        coord.note_commit_ms(advisory_wall_ms() - t0)
        # the barrier is synchronous in every transport: any submissions
        # while it was open would show up here
        coord.swap_log[-1].lag_records = (
            sum(h.submitted for h in self.hosts) - submitted_at_quorum)
        self.stats.swaps_committed += 1
        self._record_to_cache(self._last_reopt_plan)
        self._last_reopt_plan = None
        if initiated_by == "pooled:kappa2":
            self.stats.pooled_swaps += 1
        self._heal_straggler(missing)

    # -------------------------------------------------------- serving loop
    def _drive(self, streams: List[np.ndarray], idx_map: List[np.ndarray],
               chunk: int) -> ShardedServeStats:
        """Round-robin the hosts one chunk at a time, handling votes,
        stats pooling, straggler rejoins (and any resulting swap) at
        every chunk boundary; heartbeat loss promotes the standby."""
        t_start = advisory_wall_ms()
        pos = [0] * self.n_hosts
        while any(pos[k] < len(streams[k]) for k in range(self.n_hosts)):
            self._round += 1
            if self._primary_alive:
                self._hb.beat("coordinator")
            for k, h in enumerate(self.hosts):
                lo = pos[k]
                if lo >= len(streams[k]):
                    continue
                hi = min(lo + chunk, len(streams[k]))
                h.submit_chunk(idx_map[k][lo:hi], streams[k][lo:hi])
                pos[k] = hi
            if self._primary_alive and self._kill_queue \
                    and isinstance(self._kill_queue[0], int) \
                    and sum(h.submitted for h in self.hosts) >= self._kill_queue[0]:
                self._kill_queue.popleft()
                self._kill_primary()
            if self._primary_alive:
                self._handle_votes()
                self._sync_stats()
                self._handle_rejoins()
            elif self.standby is not None and self._hb.dead_hosts():
                self._failover()
        if not self._primary_alive and self.standby is not None:
            self._failover()  # stream ended inside the detection window
        # catch up any still-fenced reachable host before the drain: a
        # barrier (or failover) resolving on the final round otherwise
        # leaves it serving behind with no round left to re-sync it
        self._heal_straggler(list(self._silent))
        self._handle_rejoins()
        for k, h in enumerate(self.hosts):
            h.drain()
            self.stats.submitted_per_host[k] = h.submitted
            if getattr(h, "frontend", None) is not None:
                self.stats.frontend_stats.append(h.frontend.stats)
        self.stats.final_epoch = self.coordinator.epoch
        self.stats.swap_log = (list(self._swap_log_prefix)
                               + list(self.coordinator.swap_log))
        # recount from the authoritative log: a swap can commit inside the
        # coordinator while the primary died before broadcasting (the
        # standby finishes the install) — the incremental counters only
        # see barriers the DRIVER completed
        self.stats.swaps_committed = sum(
            1 for r in self.stats.swap_log if r.committed)
        self.stats.swaps_aborted = sum(
            1 for r in self.stats.swap_log if not r.committed)
        self.stats.wall_ms = advisory_wall_ms() - t_start
        self.close()
        return self.stats

    def close(self) -> None:
        """Stop the thread and process transports' hosts (once; inline
        hosts hold nothing to stop).  A run ends with it, and a run that
        raises calls it before the error propagates, so no worker thread
        or process outlives its server."""
        if self.transport in ("thread", "process") and not self._closed:
            self._closed = True
            for h in self.hosts:
                h.stop()

    def _heal_straggler(self, missing: List[int]) -> None:
        """The injected straggler misses exactly one barrier; once that
        barrier resolved (committed without it, or aborted), its link
        heals and the next round's rejoin path re-syncs it."""
        if self._straggler_pending is not None \
                and self._straggler_pending in missing:
            self._silent.discard(self._straggler_pending)
            self._straggler_pending = None

    def run_streams(self, streams: Sequence[np.ndarray], *,
                    chunk: int = 2048,
                    index_bases: Optional[Sequence[int]] = None
                    ) -> ShardedServeStats:
        """Serve one pre-sharded stream per host (lengths may differ).
        ``index_bases`` offsets each shard's global record indices so they
        stay disjoint across hosts (defaults to cumulative offsets)."""
        if len(streams) != self.n_hosts:
            raise ValueError(f"{len(streams)} streams for {self.n_hosts} hosts")
        if index_bases is None:
            index_bases, acc = [], 0
            for x in streams:
                index_bases.append(acc)
                acc += len(x)
        idx_map = [np.arange(len(x), dtype=np.int64) + base
                   for x, base in zip(streams, index_bases)]
        return self._drive_or_close([np.asarray(x) for x in streams], idx_map,
                                    chunk)

    def run_stream(self, x: np.ndarray, *, chunk: int = 2048
                   ) -> ShardedServeStats:
        """Shard one stream round-robin by contiguous chunk: chunk i goes
        to host i mod K, preserving each shard's arrival order."""
        shards: List[List[np.ndarray]] = [[] for _ in range(self.n_hosts)]
        bases: List[List[np.ndarray]] = [[] for _ in range(self.n_hosts)]
        for ci, s in enumerate(range(0, len(x), chunk)):
            k = ci % self.n_hosts
            shards[k].append(x[s:s + chunk])
            bases[k].append(np.arange(s, min(s + chunk, len(x)), dtype=np.int64))
        streams = [np.concatenate(s) if s else np.empty((0, x.shape[1]), x.dtype)
                   for s in shards]
        idx_map = [np.concatenate(b) if b else np.empty(0, np.int64)
                   for b in bases]
        return self._drive_or_close(streams, idx_map, chunk)

    def _drive_or_close(self, streams, idx_map, chunk) -> ShardedServeStats:
        try:
            return self._drive(streams, idx_map, chunk)
        except BaseException:
            self.close()
            raise

    @property
    def emitted(self) -> List[List[int]]:
        return [list(h.engine.emitted) for h in self.hosts]
