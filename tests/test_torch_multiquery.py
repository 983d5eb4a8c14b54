"""The port's multi-query half and session surface against the JAX
package: ``CascadeScorer.score_margins`` and ``from_plans`` on the same
plans (carried across with ``interop.physical_plan``), ``MultiQueryEngine``
emissions against isolated ``CascadeServer`` twins across a mid-stream
swap of one tenant, the weighted-fair scheduler's cases, ``CoreSession``
dispatch (one host, the fleet, several queries; the JAX package's refusal
of a multi-query fleet) and its plan cache, and the serve CLI's flag round
trip, its fleet flags reaching ``ShardedCascadeServer`` and its
``--plan-cache`` runs.

On the CPU the scorer's plain route keeps a stacked column's masks
bit-identical to the isolated scorer's at these widths, so the session's
emissions are held equal to its twins', as the JAX package holds its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OptimizeOptions as JOptions, build_plan as j_build_plan
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn
from repro.kernels.ops import CascadeScorer as JScorer

from repro_torch import interop
from repro_torch.core import CoreSession, OptimizeOptions, PlanCache, ServeConfig, orig_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed.serving import ShardedCascadeServer
from repro_torch.kernels.ops import CascadeScorer
from repro_torch.launch import serve as cli
from repro_torch.serving.engine import CascadeServer
from repro_torch.serving.frontend import ServingFrontEnd
from repro_torch.serving.multiquery import FairScheduler, MultiQueryEngine, eq31_benefit

DATA = dict(n=4000, correlation=0.9, seed=17)
OPTS = dict(mode="core-a", step=0.05, seed=17)
MARGIN_TOL = 1e-5


@pytest.fixture(scope="module")
def workload():
    """Two queries sharing column 1's UDF (JAX UDF weights carried across),
    the JAX package's plans for them and a second plan for the first, each
    also as the port's plan."""
    ds = jsyn.make_dataset(**DATA)
    idx = np.random.RandomState(17).choice(ds.n, 800, replace=False)
    udfs, layers = [], []
    for j in range(ds.truth.shape[1]):
        params, predict, _ = jsyn._train_udf_model(ds.x[idx], ds.truth[idx, j], ds.n_classes[j],
                                                   16, 1, 17 + j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=10.0, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
    tds = tsyn.make_dataset(**DATA)
    tudfs = tsyn.make_udfs(tds, hidden=16, depth=1, train_rows=800, seed=17,
                           declared_cost_ms=10.0, weights=layers, device="cpu")
    out = dict(ds=ds, tds=tds, tudfs=tudfs, jplans=[], tplans=[])
    for cols, seed, opts in (([0, 1], 18, OPTS), ([1, 2], 19, OPTS),
                             ([0, 1], 18, dict(OPTS, step=0.1))):
        jq = jsyn.make_query(ds, udfs, columns=cols, seed=seed)
        tq = tsyn.make_query(tds, tudfs, columns=cols, seed=seed)
        jplan = j_build_plan(jq, ds.x[:800], JOptions(**opts))
        out["jplans"].append(jplan)
        out["tplans"].append(interop.physical_plan(jplan, tq, "cpu"))
    # the alternative plan serves the first query's own query object
    alt = out["tplans"][2]
    alt.query = out["tplans"][0].query
    return out


# ------------------------------------------------------------- the scorer
@pytest.mark.parametrize("rows,max_tile", [(700, 1024), (2500, 1024)])
def test_score_margins_matches_reference(workload, rows, max_tile):
    """Masks equal to the JAX package's except ties, margins within
    1e-5*max(1,|thr|), over one tile and over several (the last ragged)."""
    x = workload["ds"].x[800:800 + rows]
    jm, jd = JScorer.from_plan(workload["jplans"][1], max_tile=max_tile).score_margins(x)
    port = CascadeScorer.from_plan(workload["tplans"][1], max_tile=max_tile, device="cpu")
    tm, td = port.score_margins(x)
    assert tm.shape == jm.shape and td.shape == (rows,) and td.dtype == np.float32
    scores = port.score_compact(x, need_scores=True)[0]
    tol = MARGIN_TOL * np.maximum(1.0, np.abs(port.thr_host))
    tie = np.abs(scores - port.thr_host) <= tol
    assert not ((tm != np.asarray(jm)) & ~tie).any()
    np.testing.assert_allclose(td, np.asarray(jd), rtol=0, atol=float(tol.max()))
    want = np.abs(scores - port.thr_host).min(axis=1)
    np.testing.assert_array_equal(td, want)
    np.testing.assert_array_equal(tm, port.score_masks(x))


def test_from_plans_column_maps_and_dedupe(workload):
    """Column maps equal to the JAX package's; the first plan registered
    twice shares every column; stacked masks equal the isolated scorers'."""
    jplans, tplans = workload["jplans"], workload["tplans"]
    pick = [0, 1, 0]
    jsc, jmaps = JScorer.from_plans([jplans[i] for i in pick])
    tsc, tmaps = CascadeScorer.from_plans([tplans[i] for i in pick], device="cpu")
    assert tmaps == jmaps and tsc.n_proxies == jsc.n_proxies
    assert tmaps[2] == tmaps[0]
    assert tsc.n_proxies == sum(s.proxy is not None for i in (0, 1) for s in tplans[i].stages)
    assert tsc.dtype == "float32" and tsc.stage_cols == list(range(tsc.n_proxies))
    x = workload["ds"].x[800:2800]
    full = tsc.score_masks(x)
    for plan, cols in zip(tplans, tmaps):
        iso = CascadeScorer.from_plan(plan, device="cpu").score_masks(x)
        np.testing.assert_array_equal(full[:, [c for c in cols if c is not None]], iso)
    # the common quant dtype, or float32 when the plans disagree
    q8 = [interop.physical_plan(jplans[i], tplans[i].query, "cpu") for i in (0, 1)]
    for p in q8:
        p.meta["quant_dtype"] = "int8"
    assert CascadeScorer.from_plans(q8, device="cpu")[0].dtype == "int8"
    assert CascadeScorer.from_plans([q8[0], tplans[1]], device="cpu")[0].dtype == "float32"
    none, maps = CascadeScorer.from_plans([orig_plan(tplans[0].query)], device="cpu")
    assert none is None and maps == [[None, None]]


# ------------------------------------------------------------- the session engine
@pytest.fixture(scope="module")
def session_run(workload):
    """A two-query session driven in lockstep with two isolated twins, the
    first query's plan swapped (in both) at a mid-stream chunk boundary."""
    p1, p2, alt = workload["tplans"]
    session = CoreSession(options=OptimizeOptions(**OPTS), device="cpu")
    handles = [session.register_query(p.query) for p in (p1, p2)]
    for h, p in zip(handles, (p1, p2)):
        h.plan = p
    eng = session.serve()
    assert isinstance(eng, MultiQueryEngine)
    iso = [CascadeServer(p, tile=1024, device="cpu") for p in (p1, p2)]
    x = workload["tds"].x[800:3800]
    chunk, swap_at = 512, 1536
    for s0 in range(0, len(x), chunk):
        if s0 == swap_at:
            eng.install_plan(0, alt)
            iso[0].install_plan(alt)
        idx = np.arange(s0, min(s0 + chunk, len(x)))
        eng.submit(idx, x[idx])
        eng.pump()
        for srv in iso:
            srv.submit(idx, x[idx])
            srv.pump()
    eng.drain()
    for srv in iso:
        srv.pump(drain=True)
    return dict(eng=eng, iso=iso, n=len(x), handles=handles, plans=(p1, p2))


def test_session_emissions_equal_isolated_twins(session_run):
    eng, iso = session_run["eng"], session_run["iso"]
    for qid in (0, 1):
        assert sorted(eng.servers[qid].emitted) == sorted(iso[qid].emitted)
        assert iso[qid].in_flight() == 0
    assert eng.servers[0].stats.plan_swaps == 1 and eng.servers[1].stats.plan_swaps == 0
    assert eng.stats.restacks == 1


def test_session_conservation_and_udf_dedupe(session_run):
    eng, n = session_run["eng"], session_run["n"]
    assert eng.conserved() == (True, "ok")
    st = eng.session_stats()
    assert st["finalized_per_query"] == [n, n]
    ded = st["dedupe"]
    assert ded["hits"] > 0 and ded["saved_cost_ms"] > 0 and 0 < ded["hit_rate"] < 1
    for h, plan in zip(session_run["handles"], session_run["plans"]):
        qs = h.stats()
        assert qs["in_flight"] == 0 and qs["emitted"] == len(eng.servers[h.qid].emitted)
        assert qs["weight"] == pytest.approx(eq31_benefit(plan))  # set when served


# ------------------------------------------------------------- the scheduler
def test_wfq_service_tracks_weights():
    w = {0: 1.0, 1: 4.0}
    sched = FairScheduler(w)
    quantum = 10.0
    for _ in range(200):
        sched.charge(sched.pick([0, 1]), quantum)
    v = {0: 0.0, 1: 0.0}
    bound = quantum / min(w.values())
    for qid, cost in sched.service_log:
        v[qid] += cost / w[qid]
        assert abs(v[0] - v[1]) <= bound + 1e-9
    assert sched.served_cost[1] / sched.served_cost[0] == pytest.approx(4.0, rel=0.15)


def test_wfq_no_banked_credit_on_reentry():
    sched = FairScheduler({0: 1.0, 1: 1.0})
    for _ in range(50):
        assert sched.pick([0]) == 0
        sched.charge(0, 10.0)
    grants = []
    for _ in range(10):
        q = sched.pick([0, 1])
        sched.charge(q, 10.0)
        grants.append(q)
    assert grants.count(1) <= 6
    assert 0 in grants[:2]


def test_wfq_pick_prefers_min_vtime_then_weight():
    sched = FairScheduler({0: 1.0, 1: 2.0, 2: 2.0})
    assert sched.pick([0, 1, 2]) == 1
    sched.charge(1, 4.0)
    assert sched.pick([0, 1, 2]) == 2
    sched.charge(2, 4.0)
    assert sched.pick([0, 1, 2]) == 0


# ------------------------------------------------------------- CoreSession
def test_serve_dispatch_and_refusals(workload, tmp_path):
    tds, q1, q2 = workload["tds"], workload["tplans"][0].query, workload["tplans"][1].query
    x = tds.x[:800]
    opts = OptimizeOptions(**OPTS)
    s1 = CoreSession(options=opts, device="cpu")
    h = s1.register_query(q1, x)
    assert isinstance(s1.serve(), CascadeServer) and h.plan is not None
    with pytest.raises(RuntimeError, match="already built"):
        s1.serve()
    with pytest.raises(RuntimeError, match="precede serve"):
        s1.register_query(q1, x)
    s1.run_stream(tds.x[800:2000], chunk=512)
    st = h.stats()
    assert st["emitted"] + st["rejected"] == 1200
    with pytest.raises(KeyError):
        s1.query_stats(1)

    s2 = CoreSession(options=opts, device="cpu")
    s2.register_query(q1, x)
    assert isinstance(s2.serve(slo=200.0), ServingFrontEnd)

    s3 = CoreSession(options=opts, device="cpu")
    s3.register_query(q1, x)
    s3.register_query(q2, x)
    # the JAX package's refusal: a multi-query session does not shard
    with pytest.raises(ValueError, match="multi-query sharded serving is not wired yet"):
        s3.serve(hosts=2)
    # with hosts == 1 the fleet's knobs are left unread: one host serves
    for fleet_only in (dict(transport="thread"), dict(drift_skew=0.4),
                       dict(kill_coordinator_at="prepare"), dict(straggler_host=1)):
        one = CoreSession(options=opts, device="cpu")
        one.register_query(q1, x)
        assert isinstance(one.serve(config=ServeConfig(**fleet_only)), CascadeServer)
    # only the serve CLI reads plan_cache_path: a session serves and writes nothing
    path = tmp_path / "plans.bin"
    assert isinstance(s3.serve(config=ServeConfig(plan_cache_path=str(path))),
                      MultiQueryEngine)
    assert not path.exists()

    # a session, a query and a server each take a plan cache and serve
    cache = PlanCache()
    s5 = CoreSession(options=opts, plan_cache=cache, device="cpu")
    h5 = s5.register_query(q1, x)
    assert h5.plan_cache is cache and isinstance(s5.serve(), CascadeServer)
    assert h5.optimize_info["path"] == "cold" and s5.server.stats.plan_cache_writebacks == 1
    s5.run_stream(tds.x[800:2000], chunk=512)
    assert h5.stats()["emitted"] + h5.stats()["rejected"] == 1200
    own = PlanCache()
    s6 = CoreSession(options=opts, device="cpu")
    h6 = s6.register_query(q1, x, plan_cache=own)
    s6.register_query(q2, x)
    eng = s6.serve()
    assert h6.plan_cache is own and isinstance(eng, MultiQueryEngine)
    assert [srv.stats.plan_cache_writebacks for srv in eng.servers] == [0, 0]
    assert h6.optimize_info["path"] == "cold" and len(own) == 1
    srv = CascadeServer(workload["tplans"][0], plan_cache=cache, device="cpu")
    assert srv.stats.plan_cache_writebacks == 1
    srv.run_stream(tds.x[800:2000], chunk=512)
    assert srv.stats.emitted + srv.stats.rejected == 1200
    fleet = CoreSession(options=opts, device="cpu").register_query(q1, x).session.serve(hosts=3)
    assert isinstance(fleet, ShardedCascadeServer) and len(fleet.hosts) == 3
    assert fleet.device.type == "cpu" and "builder" in fleet.plan0.meta  # keep_state
    s4 = CoreSession(options=opts, device="cpu")
    s4.register_query(q1, x, quant_dtype="fp32")
    s4.register_query(q1, x, quant_dtype="int8")
    assert [h.options.quant_dtype for h in s4.handles] == [None, "int8"]


# ------------------------------------------------------------- the serve CLI
#: one non-default value per flag, as the JAX package's CLI test has it
NON_DEFAULT_ARGV = [
    "--n", "5000", "--correlation", "0.7", "--accuracy", "0.85",
    "--mode", "core-a", "--proxy-kind", "mlp", "--quant-dtype", "int8",
    "--preds", "3", "--tile", "512", "--udf-cost-ms", "12.5",
    "--seed", "9", "--adaptive", "--drift", "--hosts", "2",
    "--drift-skew", "0.4", "--transport", "thread",
    "--kill-coordinator-at", "prepare", "--straggler-host", "1",
    "--slo-ms", "250", "--arrival-rate", "80", "--request-rows", "64",
    "--no-backpressure", "--plan-cache", "/tmp/pc.bin",
    "--queries", "/tmp/q.json", "--device", "cpu",
]


def test_flag_map_covers_every_cli_flag():
    dests = {a.dest for a in cli.build_arg_parser()._actions} - {"help"}
    assert dests == set(cli.FLAG_MAP)


def test_every_cli_flag_round_trips_into_config():
    parser = cli.build_arg_parser()
    args, defaults = parser.parse_args(NON_DEFAULT_ARGV), parser.parse_args([])
    cfg = cli.config_from_args(args)
    sections = {"workload": cfg.workload, "optimize": cfg.optimize, "serve": cfg.serve}
    for dest, (sec, fld) in cli.FLAG_MAP.items():
        want = getattr(args, dest)
        assert want != getattr(defaults, dest), f"--{dest} left at its default"
        if dest in cli._INVERTED:
            want = not want
        assert getattr(sections[sec], fld) == want, (dest, sec, fld)


def test_cli_normalization_rules():
    parser = cli.build_arg_parser()
    cfg = cli.config_from_args(parser.parse_args([]))
    assert cfg.optimize.quant_dtype is None and cfg.serve.backpressure is True
    assert cfg.workload.device == "cuda"
    cfg = cli.config_from_args(parser.parse_args(["--mode", "core-h", "--seed", "5"]))
    assert cfg.optimize.mode == "core-h"
    assert (cfg.workload.seed, cfg.optimize.seed, cfg.serve.seed) == (5, 5, 5)
    cfg = cli.config_from_args(parser.parse_args(["--mode", "pp"]))
    assert cfg.workload.mode == "pp" and cfg.optimize.mode != "pp"


class _Reached(Exception):
    pass


@pytest.fixture
def one_thread():
    """The CLI trains its UDFs and proxies with many small products: one
    torch thread is fastest, and stays fast when other test processes share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv,field,want", [
    (["--hosts", "2"], None, None),
    (["--transport", "thread"], "transport", "thread"),
    (["--drift-skew", "0.4"], "drift_scales", "drift scales [0.6, 1.4]"),
    (["--kill-coordinator-at", "prepare"], "kill_coordinator_at", "prepare"),
    (["--straggler-host", "1"], "straggler_host", 1)])
@pytest.mark.usefixtures("one_thread")
def test_cli_fleet_flags_reach_the_fleet(argv, field, want, monkeypatch, capsys):
    """``--hosts 2`` serves across two hosts on the CPU; each fleet flag's
    value reaches ``ShardedCascadeServer`` (``--drift-skew`` the shards'
    drift scales), caught where the fleet is built."""
    from repro_torch.distributed import serving

    base = ["--device", "cpu", "--n", "3000", "--preds", "2", "--udf-cost-ms", "10"]
    if field is None:
        cli.main(base + argv)
        out = capsys.readouterr().out
        served = int(out.split("\nserved ")[1].split()[0])
        emitted = int(out.split("emitted ")[1].split()[0])
        rejected = int(out.split("(+")[1].split()[0])
        assert "on 2 hosts" in out and served == emitted + rejected == 2000  # held out
        assert "consensus: " in out and "served accuracy" in out
        return
    seen = {}

    class Fleet:
        def __init__(self, plan, n_hosts, **kw):
            seen.update(kw, n_hosts=n_hosts)

        def run_streams(self, xs, **kw):
            raise _Reached

    monkeypatch.setattr(serving, "ShardedCascadeServer", Fleet)
    with pytest.raises(_Reached):
        cli.main(base + ["--hosts", "2", "--drift"] + argv)
    assert seen["n_hosts"] == 2 and seen["device"].type == "cpu"
    if field == "drift_scales":
        assert want in capsys.readouterr().out
    else:
        assert seen[field] == want


def test_cli_plan_cache_cold_then_hit(tmp_path, capsys):
    """``--plan-cache`` run twice: the first run builds COLD and saves two
    entries, the optimizer's and the engine's write-back (fingerprinted at
    the engine's re-optimization step), as the JAX package's CLI does; the
    second replays the cached artifact (HIT) and writes nothing; with
    ``--adaptive`` the same query takes the warm path (the drift loop needs
    a live builder) and saves its write-backs.  The saved file loads in the
    JAX package byte for byte."""
    from repro.core import PlanCache as JPlanCache

    path = tmp_path / "p.bin"
    argv = ["--device", "cpu", "--n", "6000", "--preds", "2", "--mode", "core",
            "--plan-cache", str(path)]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "plan cache: COLD" in out and "plan cache saved: 2 entries" in out
    cli.main(argv)
    out = capsys.readouterr().out
    assert "plan cache: HIT" in out and "(1 exact / 0 warm hits, 0 writes)" in out
    assert "proxy families: packed1 packed1" in out
    assert JPlanCache.from_bytes(path.read_bytes()).to_bytes() == path.read_bytes()
    cli.main(argv + ["--adaptive"])
    out = capsys.readouterr().out
    assert "plan cache: WARM" in out and "(0 exact / 1 warm hits, " in out
    swaps = int(out.split("adaptive: ")[1].split()[0])
    writes = int(out.split("warm hits, ")[1].split()[0])
    assert writes == 2 + swaps  # the warm build, the engine's install, each swap


def test_cli_serves_on_the_cpu(capsys):
    cli.main(["--device", "cpu", "--n", "3000", "--preds", "2", "--mode", "core-a",
              "--tile", "257", "--udf-cost-ms", "10"])
    out = capsys.readouterr().out
    served = int(out.split("\nserved ")[1].split()[0])
    emitted = int(out.split("emitted ")[1].split()[0])
    rejected = int(out.split("(+")[1].split()[0])
    assert served == emitted + rejected == 2000
    assert "served accuracy" in out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--n", "2000"])
