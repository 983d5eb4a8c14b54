"""The port's quorum-swap consensus against the JAX package's, message for
message: the same votes, acks, fences, deadlines and deltas go through
both packages' ``QuorumSwapCoordinator`` / ``StandbyCoordinator`` /
``MultiQueryCoordinator`` with a stub re-optimizer that returns the same
plan, and every ``StateDelta``, ``SwapPrepare`` (its artifact bytes
included), ``SwapCommit``, ``SwapRecord`` (but its wall-clock ms) and
return value must be equal.  The cases are the JAX package's coordinator
and standby tests (tests/test_ft_serving.py, tests/test_sharded_serving.py,
tests/test_multiquery.py), each asserting its own expectations on both
packages.  The plan is the JAX package's, carried across with
``interop.physical_plan``; the artifacts both coordinators serialize from
it are the same bytes.  Kappa exports and ``FRAME_DELTA`` frames written by either package
are read by the other."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import OptimizeOptions as JOptions, build_plan as j_build_plan
from repro.core.correlation import StreamingKappa2 as JKappa
from repro.data import synthetic as jsyn
from repro.distributed import consensus as jcons
from repro.kernels import ops as jops
from repro.serving import stats as jstats

from repro_torch import interop
from repro_torch.core.correlation import StreamingKappa2 as TKappa
from repro_torch.core.query import MLUDF, Predicate, Query
from repro_torch.distributed import consensus as tcons
from repro_torch.kernels import ops as tops
from repro_torch.serving import stats as tstats
from _one_thread import one_thread  # noqa: F401


class Pkg:
    """One package's consensus surface and its copy of the plan."""

    def __init__(self, name, cons, stats, ops, plan):
        self.name, self.cons, self.stats, self.ops, self.plan = name, cons, stats, ops, plan


@pytest.fixture(scope="module")
def packages():
    ds = jsyn.make_dataset(n=2000, n_features=64, n_columns=3, correlation=0.9,
                           feature_noise=0.9, label_noise=0.2, seed=41)
    udfs = jsyn.make_udfs(ds, hidden=8, depth=1, train_rows=400, seed=41,
                          declared_cost_ms=10.0)
    jq = jsyn.make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    jplan = j_build_plan(jq, ds.x[:600], JOptions(mode="core-a", step=0.05, kind="mixed"))
    # the port binds the plan to its own query of the same shape (the
    # coordinators never call a UDF)
    tq = Query([Predicate(udf=MLUDF(name=p.udf.name, fn=None, cost=p.udf.cost,
                                    n_classes=p.udf.n_classes), values=p.values)
                for p in jq.predicates], accuracy_target=jq.accuracy_target)
    tplan = interop.physical_plan(jplan, tq, "cpu")
    # both packages tune the scorer's block_m to the same value on the CPU,
    # so the two coordinators write the same artifact
    assert jops.serialize_scorer(jplan, max_tile=8192) == tops.serialize_scorer(tplan)
    return (Pkg("jax", jcons, jstats, jops, jplan), Pkg("torch", tcons, tstats, tops, tplan))


def norm(o):
    """Comparable form: dataclasses by field (wall-clock ms dropped, the
    class name kept), arrays by dtype, shape and bytes."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        d = {f.name: norm(getattr(o, f.name)) for f in dataclasses.fields(o)
             if not f.name.endswith("_ms")}
        d["__type__"] = type(o).__name__
        return d
    if isinstance(o, np.ndarray):
        return ("ndarray", o.dtype.str, o.shape, o.tobytes())
    if isinstance(o, dict):
        return sorted(((repr(k), norm(v)) for k, v in o.items()))
    if isinstance(o, (list, tuple)):
        return [norm(x) for x in o]
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    if isinstance(o, (np.integer, np.floating, np.bool_)):
        return o.item()
    return o


class Run:
    """Drives one package through a case and records every message."""

    def __init__(self, pkg: Pkg):
        self.pkg, self.log = pkg, []

    def rec(self, tag, obj):
        self.log.append((tag, norm(obj)))
        return obj

    def coord(self, n_hosts, *, modes=None, merged=None, **kw):
        """A coordinator whose stub re-optimizer records (rows, mode) and
        returns the plan, replicating every delta into the log."""
        def reopt(plan, sample, mode):
            self.rec("reopt", (sample.n_rows, mode, sample.indices))
            if merged is not None:
                merged.append(sample.n_rows)
            if modes is not None:
                modes.append(mode)
            return self.pkg.plan

        return self.pkg.cons.QuorumSwapCoordinator(
            self.pkg.plan, n_hosts, reopt_fn=reopt,
            replicate=lambda d: self.rec("delta", d), **kw)

    def standby(self, n_hosts=3):
        return self.pkg.cons.StandbyCoordinator(self.pkg.plan, n_hosts,
                                                reopt_fn=lambda p, m, mode: p)

    def vote(self, host, epoch=0, escalated=False, n_rows=4, qid=0, kappa=None):
        rng = np.random.RandomState(host)
        st = self.pkg.stats
        return self.pkg.cons.DriftVote(
            host=host, epoch=epoch,
            event=st.DriftEvent(at_record=100, signal="stage0:keep", observed=0.1,
                                expected=0.5, escalated=escalated),
            reservoir=st.ReservoirSample(
                indices=np.arange(n_rows) + 1000 * host,
                x=rng.randn(n_rows, 3).astype(np.float32),
                known_sigma={0: (np.ones(n_rows, bool), rng.random_sample(n_rows) < 0.5)},
                weights=np.ones(n_rows)),
            kappa=kappa, qid=qid)

    def ack(self, host, epoch, attempt, ok=True, error="", qid=0):
        return self.pkg.cons.SwapAck(host=host, epoch=epoch, ok=ok, error=error,
                                     attempt=attempt, qid=qid)

    def delta(self, kind, epoch, host=None, artifact=None, attempt=0):
        return self.pkg.cons.StateDelta(kind=kind, epoch=epoch, host=host, artifact=artifact,
                                        attempt=attempt)


class StubHost:
    def __init__(self, host_id, epoch=0, staged=None):
        self.host_id = host_id
        self.epoch = epoch
        self._staged = staged  # epoch the host staged, or None
        self.committed = []
        self.aborted = 0

    def commit(self, msg):
        if self._staged != msg.epoch:
            raise RuntimeError("no staged plan")
        self.epoch = msg.epoch
        self._staged = None
        self.committed.append(msg.epoch)

    def abort(self):
        self._staged = None
        self.aborted += 1

    def state(self):
        return (self.host_id, self.epoch, self._staged, list(self.committed), self.aborted)


def standby_state(sb):
    return dict(epoch=sb.epoch, voted=sorted(sb.voted), fenced=sorted(sb.fenced),
                pending=sb.pending, pending_attempt=sb.pending_attempt, acks=sorted(sb.acks),
                last_artifact=sb.last_artifact, deltas_applied=sb.deltas_applied,
                attempts_seen=sb.attempts_seen)


def coord_state(c):
    return dict(epoch=c.epoch, attempt=c.attempt, fenced=sorted(c.fenced),
                voters=c.voters, pending=norm(c.pending), last_artifact=c.last_artifact,
                swap_log=norm(c.swap_log), quorum_size=c.quorum_size)


# ------------------------------------------------------------------- cases
def case_quorum_sizes(r):
    q = r.pkg.cons.quorum
    sizes = [q(1), q(2), q(3), q(4), q(5), q(4, frac=0.75), q(0), q(7, frac=0.0)]
    assert sizes[:6] == [1, 2, 2, 3, 3, 4]
    r.rec("sizes", sizes)


def case_vote_accounting(r):
    coord = r.coord(4)
    assert not r.rec("vote", coord.offer_vote(r.vote(0)))
    assert not r.rec("vote", coord.offer_vote(r.vote(0)))  # duplicate host
    assert coord.votes_pending == 1
    assert not r.rec("vote", coord.offer_vote(r.vote(1, epoch=3)))  # stale/future epoch
    assert not r.rec("vote", coord.offer_vote(r.vote(1)))
    assert r.rec("vote", coord.offer_vote(r.vote(2)))  # 3rd distinct host = quorum of 3
    r.rec("prepare", coord.propose())
    with pytest.raises(RuntimeError):  # propose() twice
        coord.propose()
    r.rec("state", coord_state(coord))


def case_two_phase_commit_and_abort(r):
    merged = []
    coord = r.coord(3, merged=merged)
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    prep = r.rec("prepare", coord.propose(extra_reservoirs=[r.vote(9).reservoir]))
    assert prep.epoch == 1 and merged == [12]  # 2 votes + 1 extra, 4 rows each
    a = coord.pending.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, a))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(1, 1, a))) is None
    commit = r.rec("commit", coord.offer_ack(r.ack(2, 1, a)))
    assert commit is not None and commit.epoch == 1
    assert coord.epoch == 1 and coord.swaps_committed == 1 and coord.votes_pending == 0
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h, epoch=1)))
    r.rec("prepare", coord.propose())
    a = coord.pending.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 2, a))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(1, 2, a, ok=False, error="boom"))) is None
    assert coord.pending is None and coord.epoch == 1
    assert [x.committed for x in coord.swap_log] == [True, False]
    assert coord.swap_log[-1].aborted_by == 1
    r.rec("state", coord_state(coord))


def case_majority_escalated_votes_force_bnb(r):
    modes = []

    def choose_mode(plan, fresh):
        r.rec("fresh", fresh)  # the merged Horvitz-Thompson selectivities
        return "alloc"

    coord = r.coord(3, modes=modes, choose_mode=choose_mode)
    r.rec("vote", coord.offer_vote(r.vote(0, escalated=True)))
    r.rec("vote", coord.offer_vote(r.vote(1, escalated=True)))
    r.rec("prepare", coord.propose())
    assert modes == ["bnb"]  # 2/2 escalated overrides the alloc decision


def case_duplicate_votes_do_not_double_merge(r):
    merged = []
    coord = r.coord(3, merged=merged)
    assert not r.rec("vote", coord.offer_vote(r.vote(0)))
    for _ in range(5):  # persistent duplicate sender
        assert not r.rec("vote", coord.offer_vote(r.vote(0)))
    assert coord.votes_pending == 1
    assert r.rec("vote", coord.offer_vote(r.vote(1)))  # quorum(3) == 2
    r.rec("prepare", coord.propose())
    assert merged == [8]


def case_prepare_ack_after_abort_is_inert(r):
    coord = r.coord(3)
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    r.rec("prepare", coord.propose())
    att1 = coord.pending.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, att1))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(1, 1, att1, ok=False, error="boom"))) is None
    assert coord.pending is None
    assert r.rec("commit", coord.offer_ack(r.ack(2, 1, att1))) is None  # after the abort
    assert coord.pending is None and coord.epoch == 0
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    prep2 = r.rec("prepare", coord.propose())
    assert prep2.epoch == 1 and prep2.attempt == att1 + 1
    a2 = prep2.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, a2))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(1, 1, a2))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(2, 1, a2))) is not None
    assert coord.epoch == 1
    r.rec("state", coord_state(coord))


def case_fenced_host_ack_after_fence_is_inert(r):
    coord = r.coord(3)
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    r.rec("prepare", coord.propose())
    att = coord.pending.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, att))) is None
    coord.mark_fenced(2)
    assert r.rec("commit", coord.offer_ack(r.ack(2, 1, att))) is None
    assert coord.pending is not None
    commit = r.rec("commit", coord.offer_ack(r.ack(1, 1, att)))
    assert commit is not None and commit.epoch == 1 and coord.epoch == 1
    coord.mark_rejoined(2)
    r.rec("state", coord_state(coord))


def case_stale_attempt_ack_during_retry_round_is_inert(r):
    coord = r.coord(3)
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    r.rec("prepare", coord.propose())
    att1 = coord.pending.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, att1))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(1, 1, att1, ok=False, error="slow"))) is None
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    prep2 = r.rec("prepare", coord.propose())
    att2 = prep2.attempt
    assert prep2.epoch == 1 and att2 == att1 + 1
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, att2))) is None
    assert r.rec("commit", coord.offer_ack(r.ack(2, 1, att1))) is None  # stale round-1 ack
    assert coord.pending is not None
    assert r.rec("commit", coord.offer_ack(r.ack(1, 1, att2))) is None
    commit = r.rec("commit", coord.offer_ack(r.ack(2, 1, att2)))
    assert commit is not None and commit.attempt == att2 and coord.epoch == 1


def case_quorum_k2_is_unanimity(r):
    coord = r.coord(2)
    assert coord.quorum_size == 2
    assert not r.rec("vote", coord.offer_vote(r.vote(0)))
    with pytest.raises(RuntimeError):
        coord.propose()
    assert r.rec("vote", coord.offer_vote(r.vote(1)))
    r.rec("prepare", coord.propose())
    a = coord.pending.attempt
    assert r.rec("commit", coord.offer_ack(r.ack(0, 1, a))) is None
    commit = r.rec("commit", coord.offer_ack(r.ack(1, 1, a)))
    assert commit is not None and coord.epoch == 1
    coord.mark_fenced(1)
    assert coord.quorum_size == 1
    r.rec("state", coord_state(coord))


def _deadline(r, policy):
    coord = r.coord(4)
    for h in range(3):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    r.rec("prepare", coord.propose())
    a = coord.pending.attempt
    r.rec("commit", coord.offer_ack(r.ack(0, 1, a)))
    r.rec("commit", coord.offer_ack(r.ack(1, 1, a)))
    out = r.rec("commit", coord.resolve_prepare_deadline([2, 3], policy))
    if policy == "fence":
        # the barrier shrinks to the hosts that acked: it commits without 2, 3
        assert out is not None and coord.fenced == {2, 3} and coord.epoch == 1
        assert coord.swap_log[-1].fenced == [2, 3] and coord.quorum_size == 2
        assert r.rec("commit", coord.resolve_prepare_deadline([1], policy)) is None
        coord.mark_rejoined(2)
        coord.mark_rejoined(3)
    else:
        assert out is None and coord.pending is None and coord.swap_log[-1].aborted_by == 2
    r.rec("state", coord_state(coord))
    other = r.coord(2)
    for h in range(2):
        r.rec("vote", other.offer_vote(r.vote(h)))
    r.rec("prepare", other.propose())
    with pytest.raises(ValueError):
        other.resolve_prepare_deadline([1], "bogus")


def case_deadline_fence(r):
    _deadline(r, "fence")


def case_deadline_nack(r):
    _deadline(r, "nack")


def case_all_silent_aborts(r):
    coord = r.coord(2)
    for h in range(2):
        r.rec("vote", coord.offer_vote(r.vote(h)))
    r.rec("prepare", coord.propose())
    assert r.rec("commit", coord.resolve_prepare_deadline([0, 1], "fence")) is None
    assert coord.pending is None and coord.swap_log[-1].aborted_by == 0
    r.rec("state", coord_state(coord))


def _kappa_export(K, seed, gain):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 3, 200)
    b = np.where(rng.random_sample(200) < gain, a, rng.randint(0, 3, 200))
    k = K()
    k.update(a, b, weights=1.0 / rng.uniform(0.2, 1.0, 200))
    return {(0, 1): k.export(), (0, 2): k.export()}


def case_pooled_kappa(r):
    """Per-host kappa exports pooled until the pooled kappa² shifts past
    tolerance, then a coordinator-initiated (unvoted) B&B swap."""
    K = r.pkg.cons.StreamingKappa2
    coord = r.coord(3, kappa_pool_baseline=150.0)
    for h in range(3):
        r.rec("pooled", coord.offer_stats(h, 0, _kappa_export(K, h, 0.9)))
    fired = [r.rec("pooled", coord.offer_stats(h, 0, _kappa_export(K, 10 + h, 0.1)))
             for h in range(3)]
    assert any(fired)
    prep = r.rec("prepare", coord.propose_pooled([r.vote(h).reservoir for h in range(3)]))
    assert coord.swap_log == [] and coord._pending_record.initiated_by == "pooled:kappa2"
    for h in range(3):
        r.rec("commit", coord.offer_ack(r.ack(h, 1, prep.attempt)))
    assert coord.epoch == 1 and coord.swap_log[-1].mode == "bnb"
    r.rec("vote", coord.offer_vote(r.vote(0, epoch=1, kappa=_kappa_export(K, 0, 0.5))))
    r.rec("state", coord_state(coord))


def case_standby_mirrors_deltas(r):
    sb = r.standby()
    for d in (r.delta("vote", 0, host=0), r.delta("vote", 0, host=2)):
        sb.apply(d)
    assert sb.voted == {0, 2}
    sb.apply(r.delta("prepare", 1, artifact=b"abc", attempt=3))
    assert sb.pending == (1, b"abc")
    sb.apply(r.delta("ack", 1, host=0))
    r.rec("standby", standby_state(sb))
    sb.apply(r.delta("commit", 1, artifact=b"abc"))
    assert sb.epoch == 1 and sb.pending is None and sb.voted == set()
    sb.apply(r.delta("fence", 1, host=2))
    assert sb.fenced == {2}
    sb.apply(r.delta("rejoin", 1, host=2))
    assert sb.fenced == set()
    with pytest.raises(ValueError):
        sb.apply(r.delta("bogus", 1))
    r.rec("standby", standby_state(sb))


def case_takeover_completes_closed_barrier(r):
    sb = r.standby()
    sb.apply(r.delta("prepare", 1, artifact=b"abc"))
    for h in range(3):
        sb.apply(r.delta("ack", 1, host=h))
    hosts = [StubHost(h, epoch=0, staged=1) for h in range(3)]
    coord, resolution = sb.take_over(hosts)
    assert resolution == "completed" and coord.epoch == 1 and coord.last_artifact == b"abc"
    assert all(h.epoch == 1 for h in hosts)
    assert coord.swap_log[-1].committed and coord.swap_log[-1].initiated_by == "failover"
    r.rec("takeover", (resolution, coord_state(coord), [h.state() for h in hosts]))


def case_takeover_aborts_open_barrier(r):
    sb = r.standby()
    sb.apply(r.delta("vote", 0, host=0))
    sb.apply(r.delta("prepare", 1, artifact=b"abc"))
    sb.apply(r.delta("ack", 1, host=0))
    hosts = [StubHost(0, staged=1), StubHost(1, staged=1), StubHost(2)]
    coord, resolution = sb.take_over(hosts)
    assert resolution == "aborted" and coord.epoch == 0
    assert all(h.aborted == 1 and h._staged is None for h in hosts)
    assert not coord.swap_log[-1].committed
    r.rec("takeover", (resolution, coord_state(coord), [h.state() for h in hosts]))


def case_takeover_resyncs_after_lost_commit_broadcast(r):
    sb = r.standby()
    sb.apply(r.delta("prepare", 1, artifact=b"abc"))
    for h in range(3):
        sb.apply(r.delta("ack", 1, host=h))
    sb.apply(r.delta("commit", 1, artifact=b"abc"))
    hosts = [StubHost(0, epoch=1), StubHost(1, epoch=0), StubHost(2, epoch=0)]
    coord, resolution = sb.take_over(hosts)
    assert resolution == "resync" and coord.epoch == 1 and coord.fenced == {1, 2}
    assert hosts[0].epoch == 1
    r.rec("takeover", (resolution, coord_state(coord), [h.state() for h in hosts]))


def case_takeover_with_unreachable_and_unstaged_hosts(r):
    """A closed barrier whose one reachable host never staged (fenced for
    re-sync) and whose partitioned host stays fenced."""
    sb = r.standby(4)
    sb.apply(r.delta("vote", 0, host=1))
    sb.apply(r.delta("prepare", 1, artifact=b"xyz", attempt=5))
    for h in range(4):
        sb.apply(r.delta("ack", 1, host=h))
    hosts = [StubHost(0, staged=1), StubHost(1, staged=None), StubHost(2, staged=1),
             StubHost(3, staged=1)]
    coord, resolution = sb.take_over(hosts, unreachable={3})
    assert resolution == "completed" and coord.attempt == 5
    assert coord.fenced == {1, 3}
    r.rec("takeover", (resolution, coord_state(coord), [h.state() for h in hosts]))


def case_snapshot_rearms_open_barrier(r):
    coord = r.coord(3)
    r.rec("vote", coord.offer_vote(r.vote(0)))
    r.rec("vote", coord.offer_vote(r.vote(1)))
    r.rec("prepare", coord.propose())
    r.rec("commit", coord.offer_ack(r.ack(0, 1, coord.pending.attempt)))
    sb = r.standby()
    for delta in r.rec("snapshot", coord.snapshot_deltas()):
        sb.apply(delta)
    assert sb.voted == {0, 1} and sb.pending == (1, coord.pending.artifact)
    assert sb.acks == {0} and sb.epoch == 0 and sb.last_artifact is None
    r.rec("standby", standby_state(sb))


def case_snapshot_rearms_committed_state(r):
    coord = r.coord(3)
    coord.mark_fenced(2)
    r.rec("vote", coord.offer_vote(r.vote(0)))
    r.rec("vote", coord.offer_vote(r.vote(1)))
    r.rec("prepare", coord.propose())
    a = coord.pending.attempt
    r.rec("commit", coord.offer_ack(r.ack(0, 1, a)))
    commit = r.rec("commit", coord.offer_ack(r.ack(1, 1, a)))
    assert commit is not None and coord.epoch == 1
    sb = r.standby()
    for delta in r.rec("snapshot", coord.snapshot_deltas()):
        sb.apply(delta)
    assert sb.epoch == 1 and sb.last_artifact == coord.last_artifact
    assert sb.fenced == {2} and sb.pending is None
    r.rec("standby", standby_state(sb))


def case_multiquery_isolates_tenants(r):
    mc = r.pkg.cons.MultiQueryCoordinator(
        {0: r.pkg.plan, 1: r.pkg.plan}, n_hosts=3,
        reopt_fn=lambda plan, merged, mode: plan,
        replicate=lambda d: r.rec("delta", d))
    assert mc.qids == [0, 1]
    assert [r.rec("vote", mc.offer_vote(r.vote(h, qid=0))) for h in range(2)] == [False, True]
    prep0 = r.rec("prepare", mc.propose(0))
    assert prep0.qid == 0 and prep0.epoch == 1 and 0 in mc.pending_qids()
    assert not r.rec("vote", mc.offer_vote(r.vote(2, qid=0)))
    assert [r.rec("vote", mc.offer_vote(r.vote(h, qid=1))) for h in range(2)] == [False, True]
    prep1 = r.rec("prepare", mc.propose(1))
    assert prep1.qid == 1 and prep1.epoch == 1
    commit1 = None
    for h in range(3):
        c = r.rec("commit", mc.offer_ack(r.ack(h, prep1.epoch, mc.coord(1).pending.attempt,
                                               qid=1)))
        commit1 = c or commit1
    assert commit1 is not None and commit1.qid == 1
    assert mc.epoch(1) == 1 and mc.epoch(0) == 0
    assert 0 in mc.pending_qids() and 1 not in mc.pending_qids()
    commit0 = None
    for h in range(3):
        c = r.rec("commit", mc.offer_ack(r.ack(h, prep0.epoch, mc.coord(0).pending.attempt,
                                               qid=0)))
        commit0 = c or commit0
    assert commit0 is not None and commit0.qid == 0
    assert mc.epoch(0) == 1 and mc.epoch(1) == 1


def case_multiquery_routes_by_qid(r):
    mc = r.pkg.cons.MultiQueryCoordinator({0: r.pkg.plan, 1: r.pkg.plan}, n_hosts=3,
                                          reopt_fn=lambda plan, merged, mode: plan)
    assert not r.rec("vote", mc.offer_vote(r.vote(0, qid=1)))
    assert mc.coord(1).votes_pending == 1 and mc.coord(0).votes_pending == 0
    mc.mark_fenced(2)
    assert 2 in mc.coord(0).fenced and 2 in mc.coord(1).fenced
    mc.mark_rejoined(2)
    assert 2 not in mc.coord(0).fenced and 2 not in mc.coord(1).fenced
    with pytest.raises(ValueError):
        mc.add_query(1, r.pkg.plan)
    mc.add_query(2, r.pkg.plan)
    for h in range(2):
        r.rec("vote", mc.offer_vote(r.vote(h, qid=2)))
    prep = r.rec("prepare", mc.propose(2, extra_reservoirs=[r.vote(2).reservoir]))
    assert prep.qid == 2
    assert r.rec("commit", mc.resolve_prepare_deadline(2, [0, 1, 2], "nack")) is None
    assert mc.pending_qids() == [] and mc.coord(2).swap_log[-1].aborted_by == 0
    r.rec("prepare", mc.propose_pooled(0, [r.vote(0).reservoir]))
    r.rec("state", [coord_state(mc.coord(q)) for q in mc.qids])


CASES = [case_quorum_sizes, case_vote_accounting, case_two_phase_commit_and_abort,
         case_majority_escalated_votes_force_bnb, case_duplicate_votes_do_not_double_merge,
         case_prepare_ack_after_abort_is_inert, case_fenced_host_ack_after_fence_is_inert,
         case_stale_attempt_ack_during_retry_round_is_inert, case_quorum_k2_is_unanimity,
         case_deadline_fence, case_deadline_nack, case_all_silent_aborts, case_pooled_kappa,
         case_standby_mirrors_deltas, case_takeover_completes_closed_barrier,
         case_takeover_aborts_open_barrier, case_takeover_resyncs_after_lost_commit_broadcast,
         case_takeover_with_unreachable_and_unstaged_hosts, case_snapshot_rearms_open_barrier,
         case_snapshot_rearms_committed_state, case_multiquery_isolates_tenants,
         case_multiquery_routes_by_qid]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_message_for_message(packages, case):
    logs = []
    for pkg in packages:
        run = Run(pkg)
        case(run)
        logs.append(run.log)
    jlog, tlog = logs
    assert len(tlog) == len(jlog) > 0
    for i, (j, t) in enumerate(zip(jlog, tlog)):
        assert t == j, f"message {i} ({j[0]}) differs"


# ------------------------------------------------------- kappa and frames
def test_kappa_export_json_crosses_packages():
    """Each package reads the other's kappa JSON, and the pooled tables
    give the same kappa²."""
    rng = np.random.RandomState(5)
    a, b, w = rng.randint(0, 3, 50), rng.randint(0, 3, 50), 1.0 / rng.uniform(0.1, 1, 50)
    jk, tk = JKappa(), TKappa()
    jk.update(a, b, weights=w)
    tk.update(a, b, weights=w)
    jexp, texp = {(0, 1): jk.export()}, {(0, 1): tk.export()}
    assert jcons.kappa_export_to_json(jexp) == tcons.kappa_export_to_json(texp)
    back_t = tcons.kappa_export_from_json(jcons.kappa_export_to_json(jexp))
    back_j = jcons.kappa_export_from_json(tcons.kappa_export_to_json(texp))
    assert back_t == back_j == jexp
    pooled_j, pooled_t = JKappa(), TKappa()
    pooled_j.merge_counts(*back_j[(0, 1)])
    pooled_t.merge_counts(*back_t[(0, 1)])
    assert pooled_t.value() == pooled_j.value()
    assert tcons.kappa_export_from_json(None) is None


def _frame(ops, delta):
    """A delta as the sharded server replicates it: one FRAME_DELTA."""
    return ops.serialize_frame(ops.FRAME_DELTA, delta.epoch, delta.artifact or b"",
                               meta={"kind": delta.kind, "host": delta.host,
                                     "has_artifact": delta.artifact is not None})


def _apply_frame(pkg, standby, frame):
    kind, epoch, payload, meta = pkg.ops.deserialize_frame(frame)
    assert kind == pkg.ops.FRAME_DELTA
    standby.apply(pkg.cons.StateDelta(kind=meta["kind"], epoch=epoch, host=meta["host"],
                                      artifact=payload if meta["has_artifact"] else None))


@pytest.mark.parametrize("writer", [0, 1], ids=["jax_writes", "torch_writes"])
def test_delta_frames_restore_the_other_packages_standby(packages, writer):
    """A coordinator's deltas through one commit, one aborted round, a
    fence and an open barrier, written as FRAME_DELTA frames by one
    package, restore the other package's standby to the state its own
    frames give its own standby, exactly; the frames are the same bytes."""
    deltas = {p.name: [] for p in packages}
    for pkg in packages:
        run = Run(pkg)
        coord = run.coord(4)
        coord.replicate = deltas[pkg.name].append
        for h in range(3):
            coord.offer_vote(run.vote(h))
        coord.propose()
        a = coord.pending.attempt
        for h in range(4):
            coord.offer_ack(run.ack(h, 1, a))
        for h in range(3):
            coord.offer_vote(run.vote(h, epoch=1))
        coord.propose()
        coord.offer_ack(run.ack(0, 2, coord.pending.attempt, ok=False, error="boom"))
        coord.mark_fenced(3)
        for h in range(2):
            coord.offer_vote(run.vote(h, epoch=1))
        coord.propose()
        coord.offer_ack(run.ack(1, 2, coord.pending.attempt))
    src, dst = packages[writer], packages[1 - writer]
    frames = [_frame(src.ops, d) for d in deltas[src.name]]
    assert frames == [_frame(dst.ops, d) for d in deltas[dst.name]]
    own, other = Run(dst).standby(4), Run(dst).standby(4)
    for f in frames:
        _apply_frame(dst, other, f)
    for d in deltas[dst.name]:
        _apply_frame(dst, own, _frame(dst.ops, d))
    mirror = Run(src).standby(4)
    for f in frames:
        _apply_frame(src, mirror, f)
    assert standby_state(other) == standby_state(own) == standby_state(mirror)
    assert other.pending is not None and other.fenced == {3} and other.epoch == 1
