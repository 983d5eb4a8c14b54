"""Quorum-voted plan-swap consensus for multi-host sharded serving
(DESIGN.md §6): the JAX package's state machine, message for message, on
this package's streaming statistics and COREWIRE serializer.

Per-host drift detection is statistically noisy: one shard's CUSUM firing
may be shard skew, not population drift.  A **global** plan swap therefore
requires a quorum of hosts to have voted drift within the same plan epoch.
This module is the transport-agnostic protocol core — explicit message
dataclasses plus a coordinator state machine with no I/O, threads, or
engine imports — so the inline serving loop, the thread transport, and
the unit tests all exercise the identical logic.

Protocol (one swap):

1. **VOTE** — a host whose local detector fired sends ``DriftVote`` (its
   ``DriftEvent`` payload + its weighted reservoir export).  One vote per
   host per epoch; votes carrying a stale epoch are discarded.
2. **QUORUM** — when ``quorum(K)`` distinct hosts have voted, the
   coordinator merges every known reservoir export (IPW weights
   preserved), decides escalation from the merged Horvitz-Thompson
   selectivities, runs the warm-started re-optimization ONCE, and
   serializes the resulting ``(plan, scorer)`` into the versioned wire
   artifact.
3. **PREPARE** — the artifact is broadcast with the next epoch number.
   Each host deserializes and stages it (does NOT serve it) and replies
   ``SwapAck``.
4. **COMMIT** — only after **all** hosts acked does the coordinator send
   ``SwapCommit``; hosts then atomically install the staged plan.  A
   single NACK aborts the epoch (staged plans are dropped, votes cleared).
   No host ever *serves* a plan version a peer has not acknowledged —
   the two-phase barrier is what the conservation property test leans on.

Fault tolerance (DESIGN.md §6, failure model):

* **Standby coordinator** — every state transition emits an epoch-stamped
  ``StateDelta`` through the ``replicate`` callback (the transport
  piggybacks it on the vote/prepare traffic it already carries).  A
  ``StandbyCoordinator`` mirrors the protocol state from those deltas and
  ``take_over()`` resolves an in-flight two-phase swap after primary
  loss: it COMPLETES the commit when any host already installed the new
  epoch or every active host had acked, and cleanly ABORTS otherwise.
  Optimizer warm-start state (builder / B&B tree) is deliberately NOT
  replicated — after failover, re-optimizations rebase from the seed
  plan's builder.
* **Straggler fencing** — the transport collects prepare-acks under a
  deadline; ``resolve_prepare_deadline`` converts the silent hosts into
  a NACK (policy ``"nack"``) or FENCES them (policy ``"fence"``): the
  fleet commits without them, quorum/ack arithmetic shrinks to the
  active hosts, and the fenced host keeps serving its pinned old epoch
  until a COREWIRE re-sync frame catches it up (``mark_rejoined``).
* **Cross-host kappa² pooling** — hosts stream their weighted IPW
  contingency counts (``DriftVote.kappa`` and the periodic
  ``offer_stats`` sync); the coordinator sums them into fleet-level
  ``StreamingKappa2`` tables.  The pooled table reaches statistical
  maturity ~K× sooner than any single shard's, so a correlation drift
  split evenly across shards — invisible to every local detector —
  still escalates to a B&B re-search (``propose_pooled``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.correlation import StreamingKappa2
from repro_torch.util import advisory_wall_ms
from repro_torch.serving.stats import (
    DriftEvent,
    ReservoirSample,
    ipw_selectivity,
    merge_reservoir_samples,
)

# host kappa export:
#   (pred_i, pred_j) -> ((label_a, label_b) -> weight, n_weighted, n_rows)
KappaExport = Dict[Tuple[int, int],
                   Tuple[Dict[Tuple[int, int], float], float, int]]


def kappa_export_to_json(kappa: Optional[KappaExport]) -> Optional[dict]:
    """Wire-friendly form of a host kappa export (tuple keys -> strings);
    the process transport's newline-delimited control protocol is JSON."""
    if kappa is None:
        return None
    return {
        f"{i},{j}": {
            "counts": [[int(a), int(b), float(c)]
                       for (a, b), c in counts.items()],
            "n": float(n), "rows": int(rows),
        }
        for (i, j), (counts, n, rows) in kappa.items()
    }


def kappa_export_from_json(obj: Optional[dict]) -> Optional[KappaExport]:
    if obj is None:
        return None
    out: KappaExport = {}
    for key, entry in obj.items():
        i, j = (int(v) for v in key.split(","))
        out[(i, j)] = (
            {(int(a), int(b)): float(c) for a, b, c in entry["counts"]},
            float(entry["n"]), int(entry["rows"]),
        )
    return out


# ------------------------------------------------------------- messages
@dataclass
class DriftVote:
    """Host-local drift trigger escalated to the coordinator."""

    host: int
    epoch: int  # plan epoch the host was serving when its detector fired
    event: DriftEvent
    reservoir: ReservoirSample
    # the host's weighted IPW contingency counts (engine.kappa_export()):
    # pooled coordinator-side so fleet-level correlation evidence exists
    # even when every per-shard kappa estimate is immature or sub-threshold
    kappa: Optional[KappaExport] = None
    # which registered query this vote concerns (multi-tenant fleets route
    # per-qid to independent epoch spaces; default 0 = single-query wire)
    qid: int = 0


@dataclass
class SwapPrepare:
    """Phase 1 broadcast: stage (don't serve) the new plan artifact."""

    epoch: int  # the NEW epoch being proposed
    artifact: bytes  # kernels.ops.serialize_scorer wire blob
    # Per-coordinator proposal nonce.  An abort keeps the epoch NUMBER
    # (the re-proposal targets the same epoch with a fresh artifact), so
    # (host, epoch) alone cannot distinguish an ack for round 1 from an
    # ack for round 2 — a stale round-1 ack still in flight after a
    # fence + abort + rejoin would count toward round 2's barrier and
    # let the rejoined host install the round-1 artifact the rest of the
    # fleet never committed (found by analysis/protocol_check.py).
    # Default 0 keeps the pre-nonce wire shape decodable.
    attempt: int = 0
    qid: int = 0  # target query (per-query epoch spaces, DESIGN.md §10)


@dataclass
class SwapAck:
    host: int
    epoch: int
    ok: bool
    error: str = ""
    attempt: int = 0  # echo of SwapPrepare.attempt (see there)
    qid: int = 0      # echo of SwapPrepare.qid


@dataclass
class SwapCommit:
    """Phase 2 broadcast: every host acked — install atomically."""

    epoch: int
    # echo of the winning SwapPrepare.attempt: a host must only install
    # a staged plan from the SAME proposal round — under message
    # reordering its staged copy can be a stale same-epoch artifact (a
    # late round-1 prepare overwrote round 2's), and an epoch-only match
    # would install a plan the fleet never committed
    attempt: int = 0
    qid: int = 0  # target query (per-query epoch spaces)


@dataclass
class StateDelta:
    """One replicated protocol transition (primary -> standby).

    Deltas are epoch-stamped and piggybacked on the message traffic the
    transport already carries; applying them in order reconstructs
    everything a standby needs to resolve an in-flight swap: who voted,
    the pending prepare (with its artifact), which hosts acked, and the
    commit/abort/fence outcomes."""

    kind: str  # "vote" | "prepare" | "ack" | "commit" | "abort" | "fence" | "rejoin"
    epoch: int
    host: Optional[int] = None
    artifact: Optional[bytes] = None
    attempt: int = 0  # prepare deltas carry the proposal nonce
    qid: int = 0      # originating query (multi-tenant standby mirrors)


@dataclass
class SwapRecord:
    """Coordinator-side log entry for one attempted swap."""

    epoch: int
    voters: List[int]
    signals: List[str]
    mode: str  # escalation decision ("alloc" | "bnb")
    committed: bool
    aborted_by: Optional[int] = None
    merged_rows: int = 0
    # hosts excluded from this epoch's barrier (straggler fencing): they
    # keep serving the previous epoch until a re-sync catches them up
    fenced: List[int] = field(default_factory=list)
    # what opened the swap: "quorum" (voted), "pooled:kappa2" (fleet-level
    # correlation evidence, no vote quorum), "failover" (standby resolved
    # an in-flight epoch after primary loss)
    initiated_by: str = "quorum"
    # records submitted anywhere between quorum and commit: >0 would mean
    # a host kept serving while the two-phase barrier was still open
    # (filled by the transport; the state machine cannot see submissions)
    lag_records: int = 0
    # wall-clock spent in each protocol step (re-optimization separate:
    # it is real optimizer work, not consensus overhead)
    reopt_ms: float = 0.0
    serialize_ms: float = 0.0
    prepare_ms: float = 0.0
    commit_ms: float = 0.0

    @property
    def consensus_ms(self) -> float:
        return self.serialize_ms + self.prepare_ms + self.commit_ms


def quorum(n_hosts: int, frac: float = 0.5) -> int:
    """Votes needed for a global swap: strict majority by default
    (``floor(frac * K) + 1``), never more than K, never fewer than 1."""
    return max(1, min(n_hosts, int(n_hosts * frac) + 1))


class QuorumSwapCoordinator:
    """Collects ``DriftVote``s and drives the two-phase swap.

    The coordinator owns the AUTHORITATIVE plan (with its live builder /
    B&B tree in ``plan.meta`` — hosts only ever hold deserialized
    artifacts, so re-optimization state never fans out).  ``reopt_fn``
    is injected: ``(plan, merged_sample, mode) -> new_plan`` — the
    sharded server binds it to ``core.api.rebuild_plan``; unit tests
    bind a stub.
    """

    def __init__(self, plan, n_hosts: int, *,
                 reopt_fn: Callable[[object, ReservoirSample, str], object],
                 quorum_frac: float = 0.5,
                 choose_mode: Optional[Callable[[object, Dict[int, float]], str]] = None,
                 max_tile: int = 8192,
                 kappa_tol: float = 0.08,
                 kappa_pool_baseline: float = 120.0,
                 replicate: Optional[Callable[[StateDelta], None]] = None):
        self.plan = plan
        self.n_hosts = int(n_hosts)
        self.quorum_frac = float(quorum_frac)
        self.reopt_fn = reopt_fn
        self.choose_mode = choose_mode
        self.max_tile = max_tile
        self.kappa_tol = float(kappa_tol)
        self.kappa_pool_baseline = float(kappa_pool_baseline)
        self.replicate = replicate
        self.epoch = 0  # current committed epoch
        self._votes: Dict[int, DriftVote] = {}  # host -> vote (current epoch)
        self.swap_log: List[SwapRecord] = []
        self.pending: Optional[SwapPrepare] = None
        self._pending_record: Optional[SwapRecord] = None
        self._new_plan = None
        self._acks: Dict[int, SwapAck] = {}
        # monotonic proposal nonce (see SwapPrepare.attempt); a promoted
        # standby seeds it from the mirrored prepare deltas
        self.attempt = 0
        # straggler fencing: hosts excluded from barriers + quorum math
        self.fenced: Set[int] = set()
        # committed artifact of the current epoch (re-sync source)
        self.last_artifact: Optional[bytes] = None
        # cross-host kappa² pooling (per current epoch)
        self._kappa_by_host: Dict[int, KappaExport] = {}
        self._kappa_baseline: Optional[Dict[Tuple[int, int], float]] = None
        self._pooled_fired = False

    def _emit(self, delta: StateDelta) -> None:
        if self.replicate is not None:
            self.replicate(delta)

    # ------------------------------------------------------------ voting
    @property
    def active_hosts(self) -> int:
        """Hosts participating in quorum/barrier math (not fenced)."""
        return self.n_hosts - len(self.fenced)

    @property
    def quorum_size(self) -> int:
        return quorum(self.active_hosts, self.quorum_frac)

    @property
    def votes_pending(self) -> int:
        return len(self._votes)

    @property
    def voters(self) -> List[int]:
        return sorted(self._votes)

    def offer_vote(self, vote: DriftVote) -> bool:
        """Register one host's drift vote.  Returns True when this vote
        completes a quorum (caller should then run ``propose``).  Votes
        for a superseded epoch, duplicate votes from the same host, votes
        from fenced hosts, and votes arriving while a swap is already in
        flight are discarded."""
        if vote.kappa is not None:
            self.offer_stats(vote.host, vote.epoch, vote.kappa)
        if vote.epoch != self.epoch or self.pending is not None:
            return False
        if vote.host in self._votes or vote.host in self.fenced:
            return False
        self._votes[vote.host] = vote
        self._emit(StateDelta(kind="vote", epoch=self.epoch, host=vote.host))
        return len(self._votes) >= self.quorum_size

    # ----------------------------------------------- cross-host kappa² pool
    def offer_stats(self, host: int, epoch: int,
                    kappa: Optional[KappaExport]) -> bool:
        """Fold one host's cumulative IPW contingency counts into the
        fleet pool (latest export wins — host tables are cumulative per
        epoch and reset on install, so no double counting).  Returns True
        when the POOLED kappa² has drifted beyond ``kappa_tol`` from the
        pooled baseline — the caller should then run ``propose_pooled``.

        The pooled table crosses the ``kappa_pool_baseline`` label count
        ~K× sooner than any single host's local guard arms, which is
        exactly why an evenly-split correlation drift is visible here
        and nowhere else.  ``kappa_pool_baseline <= 0`` disables pooled
        detection entirely (the default policy: pooling lets the
        coordinator open swaps without any vote quorum, so fleets opt
        in)."""
        if self.kappa_pool_baseline <= 0:
            return False
        if kappa is None or epoch != self.epoch or host in self.fenced:
            return False
        self._kappa_by_host[host] = kappa
        if self._kappa_baseline is not None \
                and (self._pooled_fired or self.pending is not None):
            # nothing can fire this round: skip the O(K · pairs) re-merge
            # (the per-host exports are stored; pooling resumes next call)
            return False
        pooled, n_min = self._pooled_kappa()
        if self._kappa_baseline is None:
            if pooled and n_min >= self.kappa_pool_baseline:
                self._kappa_baseline = pooled
            return False
        if n_min < 2.0 * self.kappa_pool_baseline:
            # evidence accumulated since the freeze must at least match
            # the baseline mass: small-sample kappa² estimates right
            # after an install are noisy enough to flap across the tol
            return False
        return self._pooled_shift(pooled) > self.kappa_tol

    def _pooled_kappa(self) -> Tuple[Dict[Tuple[int, int], float], float]:
        """Fleet-level kappa² per predicate pair (summed contingency
        tables) plus the smallest per-pair pooled LABEL count (actual
        audited rows — the IPW-weighted mass ``n`` overstates the
        statistical information by ~1/audit_rate)."""
        pairs = sorted({p for k in self._kappa_by_host.values() for p in k})
        pooled: Dict[Tuple[int, int], float] = {}
        n_min = float("inf")
        for pair in pairs:
            sk = StreamingKappa2()
            for export in self._kappa_by_host.values():
                entry = export.get(pair)
                if entry is not None:
                    sk.merge_counts(*entry)
            pooled[pair] = sk.value()
            n_min = min(n_min, sk.n_rows)
        return pooled, (0.0 if n_min == float("inf") else float(n_min))

    def _pooled_shift(self, pooled: Optional[Dict[Tuple[int, int], float]] = None
                      ) -> float:
        """Largest |pooled kappa² − pooled baseline| over pairs; 0 until
        the pooled baseline has frozen."""
        if self._kappa_baseline is None:
            return 0.0
        if pooled is None:
            pooled, _ = self._pooled_kappa()
        return max((abs(pooled.get(k, 0.0) - v)
                    for k, v in self._kappa_baseline.items()), default=0.0)

    def mark_fenced(self, host: int) -> None:
        """Exclude a silent host from quorum/barrier arithmetic; it keeps
        serving its pinned epoch (serve-behind) until ``mark_rejoined``."""
        if host not in self.fenced:
            self.fenced.add(host)
            self._votes.pop(host, None)
            self._kappa_by_host.pop(host, None)
            # an already-collected ack from this host no longer speaks
            # for it: the fence removed it from the barrier, and keeping
            # the ack would let it satisfy a FUTURE _maybe_commit if the
            # host is unfenced without re-preparing
            self._acks.pop(host, None)
            self._emit(StateDelta(kind="fence", epoch=self.epoch, host=host))

    def mark_rejoined(self, host: int) -> None:
        """Re-admit a fenced host after its COREWIRE re-sync installed the
        current epoch."""
        if host in self.fenced:
            self.fenced.discard(host)
            self._emit(StateDelta(kind="rejoin", epoch=self.epoch, host=host))

    # ---------------------------------------------------------- proposing
    def propose(self, extra_reservoirs: Optional[List[ReservoirSample]] = None
                ) -> SwapPrepare:
        """Quorum reached: merge reservoirs, re-optimize once, serialize.

        ``extra_reservoirs``: exports pulled from hosts that did NOT vote
        — their rows are just as fresh, and the merged sample should span
        every shard, not only the drifted ones."""
        if len(self._votes) < self.quorum_size:
            raise RuntimeError(
                f"propose() before quorum: {len(self._votes)} votes < "
                f"{self.quorum_size}")
        merged = merge_reservoir_samples(
            [v.reservoir for v in self._votes.values()]
            + list(extra_reservoirs or []))
        return self._propose(
            merged, self._decide_mode(merged), voters=sorted(self._votes),
            signals=[v.event.signal for v in self._votes.values()],
            initiated_by="quorum")

    def propose_pooled(self, reservoirs: List[ReservoirSample]) -> SwapPrepare:
        """Coordinator-initiated swap on pooled fleet evidence: the pooled
        kappa² drifted beyond tolerance while no vote quorum exists (each
        shard's local view is too weak to fire).  A correlation-structure
        shift invalidates the marginal-only regret estimate, so the mode
        is always the B&B re-search."""
        self._pooled_fired = True
        merged = merge_reservoir_samples(list(reservoirs))
        return self._propose(merged, "bnb", voters=[],
                             signals=["pooled:kappa2"],
                             initiated_by="pooled:kappa2")

    def _propose(self, merged: ReservoirSample, mode: str, *,
                 voters: List[int], signals: List[str],
                 initiated_by: str) -> SwapPrepare:
        from repro_torch.kernels.ops import serialize_scorer

        if self.pending is not None:
            raise RuntimeError("a swap is already in flight")
        t0 = advisory_wall_ms()
        new_plan = self.reopt_fn(self.plan, merged, mode)
        reopt_ms = advisory_wall_ms() - t0
        t0 = advisory_wall_ms()
        artifact = serialize_scorer(new_plan, max_tile=self.max_tile)
        ser_ms = advisory_wall_ms() - t0
        new_epoch = self.epoch + 1
        self.attempt += 1
        self.pending = SwapPrepare(epoch=new_epoch, artifact=artifact,
                                   attempt=self.attempt)
        self._pending_record = SwapRecord(
            epoch=new_epoch, voters=voters, signals=signals,
            mode=mode, committed=False, merged_rows=merged.n_rows,
            fenced=sorted(self.fenced), initiated_by=initiated_by,
            reopt_ms=reopt_ms, serialize_ms=ser_ms,
        )
        self._new_plan = new_plan
        self._acks = {}
        self._emit(StateDelta(kind="prepare", epoch=new_epoch,
                              artifact=self.pending.artifact,
                              attempt=self.attempt))
        return self.pending

    def _decide_mode(self, merged: ReservoirSample) -> str:
        """Escalation from the MERGED evidence: the per-host kappa²/regret
        decisions ride the votes, but the coordinator re-derives the mode
        from pooled Horvitz-Thompson selectivities so one noisy shard
        cannot force the expensive B&B path alone.  A majority of
        escalated votes still forces "bnb" (correlation-structure shifts
        are only visible host-side)."""
        if self.choose_mode is not None:
            fresh = {}
            for p in merged.known_sigma:
                sel = ipw_selectivity(merged, p, min_labels=8)
                if sel is not None:
                    fresh[p] = sel
            mode = self.choose_mode(self.plan, fresh)
        else:
            mode = "alloc"
        escalated = sum(1 for v in self._votes.values() if v.event.escalated)
        if escalated * 2 > len(self._votes):
            mode = "bnb"
        elif self._pooled_shift() > self.kappa_tol:
            # pooled fleet evidence outranks the marginal-only regret
            # estimate even when no single vote carried an escalation hint
            mode = "bnb"
        return mode

    # ------------------------------------------------------- ack / commit
    def offer_ack(self, ack: SwapAck) -> Optional[SwapCommit]:
        """Phase-1 responses.  Returns the ``SwapCommit`` once every
        ACTIVE (non-fenced) host has acked; a NACK aborts the epoch
        immediately (returns None and clears the in-flight state —
        callers observe via ``pending``).

        Three classes of ack are inert (dropped without touching the
        barrier): acks for a non-pending epoch, acks from a FENCED host
        (it was excluded from the barrier when its deadline expired — a
        late ack must not re-enter quorum arithmetic, and its NACK must
        not abort an epoch it is no longer part of), and acks whose
        ``attempt`` nonce does not match the pending prepare (a stale
        response to an earlier aborted round of the same epoch number —
        see SwapPrepare.attempt)."""
        if self.pending is None or ack.epoch != self.pending.epoch:
            return None
        if ack.host in self.fenced:
            return None
        if ack.attempt != self.pending.attempt:
            return None
        if not ack.ok:
            self._abort(aborted_by=ack.host)
            return None
        self._acks[ack.host] = ack
        self._emit(StateDelta(kind="ack", epoch=ack.epoch, host=ack.host))
        return self._maybe_commit()

    def resolve_prepare_deadline(self, missing: List[int],
                                 policy: str = "fence"
                                 ) -> Optional[SwapCommit]:
        """The transport's ack deadline expired with ``missing`` hosts
        silent.  ``policy="nack"`` treats the first straggler as a NACK
        (epoch aborts fleet-wide); ``policy="fence"`` excludes the
        stragglers from the barrier — they keep serving their pinned old
        epoch and the remaining hosts commit without them (serve-behind
        version fencing; the fenced hosts catch up via re-sync)."""
        if self.pending is None or not missing:
            return None
        if policy == "nack":
            self._abort(aborted_by=missing[0])
            return None
        if policy != "fence":
            raise ValueError(f"unknown straggler policy {policy!r}")
        for host in missing:
            self.mark_fenced(host)
        if self._pending_record is not None:
            self._pending_record.fenced = sorted(
                set(self._pending_record.fenced) | set(missing))
        if self.active_hosts == 0:
            # every host went silent: nothing left to commit on — abort
            # rather than leave the epoch pending forever
            self._abort(aborted_by=missing[0])
            return None
        return self._maybe_commit()

    def _maybe_commit(self) -> Optional[SwapCommit]:
        active = set(range(self.n_hosts)) - self.fenced
        if not active or not active.issubset(self._acks):
            return None
        commit = SwapCommit(epoch=self.pending.epoch,
                            attempt=self.pending.attempt)
        self.epoch = self.pending.epoch
        self.plan = self._new_plan
        self.last_artifact = self.pending.artifact
        rec = self._pending_record
        rec.committed = True
        self.swap_log.append(rec)
        self._emit(StateDelta(kind="commit", epoch=commit.epoch,
                              artifact=self.last_artifact))
        self._clear_round()
        self._reset_epoch_stats()
        return commit

    def _abort(self, aborted_by: Optional[int]) -> None:
        rec = self._pending_record
        rec.aborted_by = aborted_by
        self.swap_log.append(rec)
        self._emit(StateDelta(kind="abort", epoch=self.pending.epoch,
                              host=aborted_by))
        self._clear_round()
        # fences deliberately SURVIVE the abort: a fenced host may be
        # several epochs behind, and only the re-sync/rejoin path may
        # re-admit it — clearing here would strand it (unfenced but
        # behind, its votes discarded on epoch mismatch forever)
        self._pooled_fired = False

    def note_prepare_ms(self, ms: float) -> None:
        """Transport-side hook: wall time spent distributing the prepare
        + collecting acks (the state machine itself cannot see I/O)."""
        if self._pending_record is not None:
            self._pending_record.prepare_ms += ms
        elif self.swap_log:
            self.swap_log[-1].prepare_ms += ms

    def note_commit_ms(self, ms: float) -> None:
        """Transport-side hook: wall time spent distributing the commit
        and installing the staged plan on every host — the slow half of
        phase 2, invisible to the state machine."""
        if self.swap_log:
            self.swap_log[-1].commit_ms += ms

    def _clear_round(self) -> None:
        self.pending = None
        self._pending_record = None
        self._new_plan = None
        self._acks = {}
        self._votes = {}

    def _reset_epoch_stats(self) -> None:
        """A committed install resets every host's streaming tables, so
        the pooled mirror restarts with the new epoch too."""
        self._kappa_by_host = {}
        self._kappa_baseline = None
        self._pooled_fired = False

    # ----------------------------------------------------- standby re-arm
    def snapshot_deltas(self) -> List[StateDelta]:
        """Serialize the CURRENT protocol state as an ordered delta replay
        — applying these to a fresh ``StandbyCoordinator`` reconstructs
        exactly the mirror an always-attached standby would hold.  Used to
        re-arm replication after a failover (the promoted coordinator
        would otherwise run unreplicated forever): register a new standby,
        replay this snapshot through the normal replication channel, then
        point ``replicate`` at it for live deltas."""
        deltas: List[StateDelta] = []
        if self.epoch > 0:
            deltas.append(StateDelta(kind="commit", epoch=self.epoch,
                                     artifact=self.last_artifact))
        for host in sorted(self.fenced):
            deltas.append(StateDelta(kind="fence", epoch=self.epoch,
                                     host=host))
        for host in sorted(self._votes):
            deltas.append(StateDelta(kind="vote", epoch=self.epoch,
                                     host=host))
        if self.pending is not None:
            deltas.append(StateDelta(kind="prepare", epoch=self.pending.epoch,
                                     artifact=self.pending.artifact,
                                     attempt=self.pending.attempt))
            for host in sorted(self._acks):
                deltas.append(StateDelta(kind="ack",
                                         epoch=self.pending.epoch, host=host))
        return deltas

    # ------------------------------------------------------------- stats
    @property
    def swaps_committed(self) -> int:
        return sum(1 for r in self.swap_log if r.committed)


class StandbyCoordinator:
    """Replicated mirror of a ``QuorumSwapCoordinator``'s protocol state.

    The primary emits ``StateDelta``s (piggybacked on the vote/prepare
    traffic); ``apply`` folds them into a mirror of the epoch, the voted
    hosts, the in-flight prepare (with its artifact), the collected acks,
    and the fence set.  On primary heartbeat loss, ``take_over`` probes
    the hosts and resolves any in-flight two-phase swap:

    * **complete** — some host already installed the proposed epoch
      (primary died mid-commit-broadcast; aborting would strand it), or
      every active host had acked (the barrier was closed; only the
      commit broadcast was lost): the standby re-broadcasts the commit.
      A host that cannot commit (never staged) is fenced for re-sync
      rather than blocking the takeover.
    * **abort** — anything less: staged copies are dropped fleet-wide and
      voting re-arms.  No host ever serves an epoch its peers have not
      acknowledged, through the failover included.

    Optimizer warm-start state is deliberately not replicated: the new
    coordinator re-optimizes from the seed plan's builder (protocol
    safety over search warmth)."""

    def __init__(self, base_plan, n_hosts: int, *,
                 reopt_fn: Callable[[object, ReservoirSample, str], object],
                 quorum_frac: float = 0.5,
                 choose_mode: Optional[Callable] = None,
                 max_tile: int = 8192,
                 kappa_tol: float = 0.08,
                 kappa_pool_baseline: float = 120.0):
        self.base_plan = base_plan
        self.n_hosts = int(n_hosts)
        self._kw = dict(reopt_fn=reopt_fn, quorum_frac=quorum_frac,
                        choose_mode=choose_mode, max_tile=max_tile,
                        kappa_tol=kappa_tol,
                        kappa_pool_baseline=kappa_pool_baseline)
        self.epoch = 0
        self.voted: Set[int] = set()
        self.fenced: Set[int] = set()
        self.pending: Optional[Tuple[int, bytes]] = None  # (epoch, artifact)
        self.pending_attempt = 0  # SwapPrepare.attempt of the mirrored prepare
        self.acks: Set[int] = set()
        self.last_artifact: Optional[bytes] = None
        self.deltas_applied = 0
        # highest proposal nonce seen in prepare deltas: the promoted
        # coordinator resumes ABOVE it so stale acks for the dead
        # primary's rounds can never match a post-failover prepare
        self.attempts_seen = 0

    def apply(self, delta: StateDelta) -> None:
        self.deltas_applied += 1
        if delta.kind == "vote":
            self.voted.add(delta.host)
        elif delta.kind == "prepare":
            self.pending = (delta.epoch, delta.artifact)
            self.pending_attempt = delta.attempt
            self.acks = set()
            self.attempts_seen = max(self.attempts_seen, delta.attempt)
        elif delta.kind == "ack":
            self.acks.add(delta.host)
        elif delta.kind == "commit":
            self.epoch = delta.epoch
            self.last_artifact = delta.artifact
            self.pending = None
            self.acks = set()
            self.voted = set()
        elif delta.kind == "abort":
            self.pending = None
            self.acks = set()
            self.voted = set()
        elif delta.kind == "fence":
            self.fenced.add(delta.host)
            self.voted.discard(delta.host)
        elif delta.kind == "rejoin":
            self.fenced.discard(delta.host)
        else:
            raise ValueError(f"unknown delta kind {delta.kind!r}")

    def take_over(self, hosts, *, unreachable: Optional[Set[int]] = None
                  ) -> Tuple[QuorumSwapCoordinator, str]:
        """Build a live coordinator from the mirrored state, resolving any
        in-flight swap against the probed host fleet.  Returns
        ``(coordinator, resolution)`` with resolution one of
        ``"completed"``, ``"aborted"``, ``"idle"``.  ``unreachable``
        hosts are skipped (still partitioned); they stay fenced."""
        unreachable = unreachable or set()
        coord = QuorumSwapCoordinator(
            self.base_plan, self.n_hosts, replicate=None, **self._kw)
        coord.epoch = self.epoch
        coord.attempt = self.attempts_seen
        coord.last_artifact = self.last_artifact
        coord.fenced = set(self.fenced) | (unreachable & set(
            h.host_id for h in hosts))
        resolution = "idle"
        reachable = [h for h in hosts if h.host_id not in unreachable]
        if self.pending is not None:
            epoch, artifact = self.pending
            active = [h for h in reachable if h.host_id not in self.fenced]
            installed = [h for h in active if h.epoch >= epoch]
            all_acked = {h.host_id for h in active}.issubset(self.acks)
            if installed or all_acked:
                for h in active:
                    if h.epoch >= epoch:
                        continue
                    try:
                        h.commit(SwapCommit(epoch=epoch,
                                            attempt=self.pending_attempt))
                    except Exception:
                        # never staged (prepare was lost with the primary):
                        # fence for re-sync instead of blocking takeover
                        coord.mark_fenced(h.host_id)
                coord.epoch = epoch
                coord.last_artifact = artifact
                coord.swap_log.append(SwapRecord(
                    epoch=epoch, voters=sorted(self.voted),
                    signals=["failover"], mode="takeover", committed=True,
                    fenced=sorted(coord.fenced), initiated_by="failover"))
                resolution = "completed"
            else:
                for h in reachable:
                    h.abort()
                coord.swap_log.append(SwapRecord(
                    epoch=epoch, voters=sorted(self.voted),
                    signals=["failover"], mode="takeover", committed=False,
                    aborted_by=-1, initiated_by="failover"))
                resolution = "aborted"
        else:
            # re-arm voting: the primary's collected votes died with it
            for h in reachable:
                h.abort()
        # hosts still behind the resolved epoch (the primary committed and
        # died before finishing the broadcast, or they were already
        # fenced): fence them so the serving loop's re-sync path installs the
        # committed artifact — no host ever serves an epoch its peers
        # have not acknowledged, failover included
        behind = [h for h in reachable
                  if h.epoch < coord.epoch and h.host_id not in coord.fenced]
        for h in behind:
            coord.mark_fenced(h.host_id)
        if resolution == "idle" and behind:
            resolution = "resync"
        return coord, resolution


class MultiQueryCoordinator:
    """Routes swap-protocol traffic to per-query coordinators.

    A multi-tenant fleet serves several registered queries through the
    same hosts, but their plans drift (and swap) independently.  A
    single ``QuorumSwapCoordinator`` would couple the tenants: it drops
    votes while a prepare is in flight, so one tenant's slow two-phase
    barrier would silently discard another tenant's drift evidence and
    stall its swap.  This wrapper instead holds one full coordinator —
    its own epoch space, vote set, kappa² pool, and pending barrier —
    per ``qid`` and dispatches every inbound message by its ``qid``
    field.  Outbound prepares/commits are stamped with the qid so the
    transport can deliver them to the right per-query plan slot on each
    host.

    The isolation invariant (tested in tests/test_multiquery.py): any
    interleaving of two tenants' vote → propose → ack → commit rounds
    commits both, and neither tenant's epoch ever observes the other's
    messages.
    """

    def __init__(self, plans: Dict[int, object], n_hosts: int, **kw):
        """``plans`` maps qid -> authoritative plan; ``kw`` is forwarded
        verbatim to every per-query ``QuorumSwapCoordinator`` (inject a
        per-qid ``reopt_fn`` by closing over the qid if tenants need
        different re-optimization policies)."""
        self.n_hosts = int(n_hosts)
        self._kw = dict(kw)
        self.coords: Dict[int, QuorumSwapCoordinator] = {
            int(qid): QuorumSwapCoordinator(plan, n_hosts, **kw)
            for qid, plan in plans.items()
        }

    def coord(self, qid: int) -> QuorumSwapCoordinator:
        return self.coords[int(qid)]

    def add_query(self, qid: int, plan) -> QuorumSwapCoordinator:
        """Register a tenant after construction (session-style API)."""
        qid = int(qid)
        if qid in self.coords:
            raise ValueError(f"qid {qid} already registered")
        self.coords[qid] = QuorumSwapCoordinator(
            plan, self.n_hosts, **self._kw)
        return self.coords[qid]

    @property
    def qids(self) -> List[int]:
        return sorted(self.coords)

    def epoch(self, qid: int) -> int:
        return self.coords[int(qid)].epoch

    # ------------------------------------------------------------- routing
    def offer_vote(self, vote: DriftVote) -> bool:
        """Route one host's vote to its query's coordinator.  A pending
        prepare on one qid never discards a vote for another qid."""
        return self.coords[vote.qid].offer_vote(vote)

    def propose(self, qid: int,
                extra_reservoirs: Optional[List[ReservoirSample]] = None
                ) -> SwapPrepare:
        prep = self.coords[int(qid)].propose(extra_reservoirs)
        prep.qid = int(qid)
        return prep

    def propose_pooled(self, qid: int,
                       reservoirs: List[ReservoirSample]) -> SwapPrepare:
        prep = self.coords[int(qid)].propose_pooled(reservoirs)
        prep.qid = int(qid)
        return prep

    def offer_ack(self, ack: SwapAck) -> Optional[SwapCommit]:
        commit = self.coords[ack.qid].offer_ack(ack)
        if commit is not None:
            commit.qid = ack.qid
        return commit

    def resolve_prepare_deadline(self, qid: int, missing: List[int],
                                 policy: str = "fence"
                                 ) -> Optional[SwapCommit]:
        commit = self.coords[int(qid)].resolve_prepare_deadline(
            missing, policy)
        if commit is not None:
            commit.qid = int(qid)
        return commit

    # fencing is a HOST property, not a query property: a silent host is
    # silent for every tenant it serves, so the fence fans out
    def mark_fenced(self, host: int) -> None:
        for c in self.coords.values():
            c.mark_fenced(host)

    def mark_rejoined(self, host: int) -> None:
        for c in self.coords.values():
            c.mark_rejoined(host)

    def pending_qids(self) -> List[int]:
        """Queries with a swap currently in flight (diagnostics)."""
        return sorted(q for q, c in self.coords.items()
                      if c.pending is not None)
