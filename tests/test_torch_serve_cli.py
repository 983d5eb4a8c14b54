"""The serve CLI's ``--adaptive --drift`` flow at ``--n 12000 --preds 3
--mode core --tile 257``, with the CLI's own default ``AdaptivePolicy``,
on both packages.  The JAX package's UDFs are trained as its
``make_udfs`` trains them and carried across with ``interop.udf_layers``;
the JAX plan (built with ``keep_state`` as the CLI builds it) is carried
across with ``interop.physical_plan``.  The port must then swap as often
as the reference, first on the same signal at the same record, and serve
the same accuracy within 0.02.

With nothing carried across, the port's CLI trains its own UDFs from the
JAX package's initial weights (the reference's threefry draws) and builds
its own plan.  Its trained weights differ from the reference's by roundoff
that training amplifies, yet it asks the reference's query, value set for
value set, and swaps as often as the reference does.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_plan as j_build_plan
from repro.core import execute_plan as j_execute, orig_plan as j_orig
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.serving.engine import CascadeServer as JServer

from repro_torch import interop
from repro_torch.core import execute_plan, orig_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import CascadeServer
from _one_thread import one_thread  # noqa: F401


ARGV = ["--n", "12000", "--preds", "3", "--mode", "core", "--tile", "257",
        "--adaptive", "--drift"]


def _drifting_stream(syn, ds, wl):
    """The CLI's drifting stream (both packages' ``main`` build it so)."""
    k = max(1000, int(0.05 * wl.n))
    return syn.make_drifting_stream(
        ds, max(wl.n // 4, 2000), wl.n - k,
        shift_targets={c: (2.8 if c != 1 else -2.6) for c in range(wl.preds)},
        corr_gain=2.5, seed=wl.seed)


@pytest.fixture(scope="module")
def cli_runs():
    jcfg = jserve.config_from_args(jserve.build_arg_parser().parse_args(ARGV))
    tcfg = tserve.config_from_args(tserve.build_arg_parser().parse_args(ARGV + ["--device", "cpu"]))
    wl, sv = jcfg.workload, jcfg.serve
    assert (tcfg.workload.n, tcfg.workload.preds, tcfg.serve.tile, tcfg.serve.adaptive) == (
        wl.n, wl.preds, sv.tile, sv.adaptive)
    k = max(1000, int(0.05 * wl.n))
    ds = jsyn.make_dataset(n=wl.n, correlation=wl.correlation, seed=wl.seed)
    # the JAX package's make_udfs(hidden=64, depth=2, train_rows=3000), with
    # the trained params kept so that they can be carried across
    idx = np.random.RandomState(wl.seed).choice(ds.n, min(3000, ds.n), replace=False)
    udfs, layers = [], []
    for j in range(ds.truth.shape[1]):
        params, predict, _ = jsyn._train_udf_model(
            ds.x[idx], ds.truth[idx, j], ds.n_classes[j], 64, 2, wl.seed + j)
        udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=wl.udf_cost_ms, n_classes=ds.n_classes[j],
                          fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
        layers.append(interop.udf_layers(params))
    jq = jsyn.make_query(ds, udfs, columns=list(range(wl.preds)), target_selectivity=0.5,
                         accuracy_target=wl.accuracy, seed=wl.seed + 1)
    jplan = j_build_plan(jq, ds.x[:k], jcfg.optimize.replace(keep_state=True))

    tds = tsyn.make_dataset(n=wl.n, correlation=wl.correlation, seed=wl.seed)
    tudfs = tsyn.make_udfs(tds, hidden=64, depth=2, train_rows=3000, seed=wl.seed,
                           declared_cost_ms=wl.udf_cost_ms, weights=layers, device="cpu")
    tq = tsyn.make_query(tds, tudfs, columns=list(range(wl.preds)), target_selectivity=0.5,
                         accuracy_target=wl.accuracy, seed=wl.seed + 1)
    assert [p.values for p in tq.predicates] == [p.values for p in jq.predicates]
    tplan = interop.physical_plan(jplan, tq, "cpu")

    js, ts = _drifting_stream(jsyn, ds, wl), _drifting_stream(tsyn, tds, tcfg.workload)
    assert np.array_equal(js.x, ts.x)
    ref = JServer(jplan, tile=sv.tile, adaptive=True, seed=sv.seed)
    ref_stats = ref.run_stream(js.x)
    srv = CascadeServer(tplan, tile=tcfg.serve.tile, adaptive=True, seed=tcfg.serve.seed,
                        device="cpu")
    stats = srv.run_stream(ts.x)
    orig = set(j_execute(j_orig(jq), js.x).passed.tolist())
    torig = set(execute_plan(orig_plan(tq), ts.x, device="cpu").passed.tolist())
    return dict(n=ts.n, boundary=ts.boundary, jq=jq, ref=ref, ref_stats=ref_stats, srv=srv,
                stats=stats,
                acc=sum(i in torig for i in srv.emitted) / len(torig),
                ref_acc=sum(i in orig for i in ref.emitted) / len(orig))


def test_cli_adaptive_drift_flow_swaps_like_reference(cli_runs):
    r = cli_runs
    stats, ref_stats = r["stats"], r["ref_stats"]
    for server, st in ((r["srv"], stats), (r["ref"], ref_stats)):
        assert st.emitted + st.rejected == r["n"]
        assert server.in_flight() == 0
    assert stats.plan_swaps == ref_stats.plan_swaps >= 1
    first, ref_first = stats.drift_events[0], ref_stats.drift_events[0]
    assert (first.signal, first.at_record, first.order_before) == (
        ref_first.signal, ref_first.at_record, ref_first.order_before)
    assert first.at_record > r["boundary"]
    assert abs(r["acc"] - r["ref_acc"]) <= 0.02


def test_cli_own_udfs_ask_the_reference_query_and_swap_like_it(cli_runs, capsys):
    """The port's CLI as a user runs it (``--device cpu``): its own UDFs and
    its own plan, nothing carried across."""
    tserve.main(ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    query = re.search(r"^query: (.*) A=", out, re.M).group(1)
    assert query == " AND ".join(cli_runs["jq"].names())
    swaps = int(re.search(r"^adaptive: (\d+) plan swap", out, re.M).group(1))
    assert swaps == cli_runs["ref_stats"].plan_swaps >= 1
    served, emitted, rejected = map(int, re.search(
        r"^served (\d+) records .*; emitted (\d+) \(\+(\d+) rejected\)", out, re.M).groups())
    assert emitted + rejected == served == cli_runs["n"]
