"""The port's three remaining examples against the JAX package's own
(``examples/*.py``, loaded by path and run with the same cuts as the
port's), on the same numpy-seeded inputs, with the JAX package's weights
carried across (trained weights differ by roundoff, so the flows after
training are held on the reference's weights):

* ``video_cascade``: the JAX UDFs' trained layers carried across as
  ``tests/test_torch_serve_cli.py`` carries them.  For each of core-a,
  core-h and core: the same order and allocation, Eq. 3.1 costs within
  1e-3 relative and thresholds within 1e-3 relative
  (``test_torch_slice._assert_plans_agree``), but for the proxies named in
  MARGIN_FLIPS, held to HINGE_TOL (5%, as ``test_torch_slice`` holds the
  baselines'): a hinge-loss proxy's training can flip a margin across 1 at
  another step under another summation order; core-a's first two proxies
  do so on one torch thread (thresholds 3.1e-3 and 6.3e-3 apart); the
  accuracy against ORIG within 1e-3 (a row or two at a float32 tie), the
  same B&B nodes visited.
* ``resilient_training`` at the reduced deepseek-67b and mamba2-2.7b
  configs (bf16), the JAX initial state carried across by ``interop``: the
  losses of every step before the preemption within 5e-2 (the JAX
  example's run is a straight run up to there), the state after those
  steps within ``_adam_close``'s bound, and one restart that ends equal
  bit for bit to a run without the preemption (the port checkpoints the
  data cursor; the JAX example's iterator runs on, so its replayed steps
  see later batches and only the dense and SSM families are held to it).
  Without carried weights too: the port's own ``PRNGKey(0)`` init (the
  reference's, ``util/prng.py``) gives the reference's losses before the
  preemption within 5e-2 for those two and for seamless-m4t-medium, whose
  batches both packages draw from ``make_batch(..., PRNGKey(step))``; and
  step 0 of ``launch.train`` in f32 reports the JAX launcher's loss within
  1e-5 at reduced deepseek-67b and paligemma-3b.
* the backbone UDFs (``make_backbone_udf``, ``interop.backbone_udf_params``)
  at both reduced configs: logits at the JAX initial weights within 5e-2
  (the MoE's expert choices pinned to the reference's, each own choice that
  differs a near tie, as ``tests/test_torch_moe.py`` does); the loss and
  the parameters after one AdamW step within 5e-2 and ``_adam_close``;
  training only the leaves the loss reaches equal bit for bit to training
  every leaf; ``fn`` padding as the reference pads, and labels equal but
  at near ties.
* ``transformer_udf_serving`` with the JAX-trained weights and measured
  costs carried across, every call of the port's UDFs held to the
  reference's logits on the same padded rows (``_HeldToReference``: MoE
  routes pinned, logits within 5e-2, a label that differs only at a near
  tie, 2 x 5e-2, and then the reference's taken, so that both optimizers
  see the same labels): the same order and allocation, the Eq. 3.1
  estimate within 1e-3 and thresholds within 1e-3, but for the first
  stage's proxy (MARGIN_FLIPS: 2.2e-2 apart on one thread); the records
  ``CascadeServer`` emits equal except where a proxy score lies between
  the two packages' thresholds; ORIG's and CORE's costs within 1e-3
  relative.

Near ties are counted and printed.  Every JAX run is shared through module
fixtures.
"""
import importlib.util
import inspect
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_accuracy as j_plan_accuracy
from repro.core.query import MLUDF
from repro.data import synthetic as jsyn
from repro.models import moe as JM
from repro.training import optim as joptim

from repro_torch import interop, resilient_training, transformer_udf_serving, video_cascade
from repro_torch.configs import reduced_config
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from test_torch_slice import _assert_plans_agree
from _one_thread import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LOGIT_TOL = 5e-2  # bf16 logits (the model families' bound)
LABEL_TIE = 2 * LOGIT_TOL  # a label can differ only where the top two are this close
ROUTER_TIE_TOL = chip_smoke.ROUTER_TIE_TOL  # relative gap of two router probabilities that tie
FOLD_TOL = 1e-4
HINGE_TOL = 0.05  # a proxy threshold after a hinge-margin flip (module doc)
# The stages whose hinge-loss proxies flip a margin on one torch thread, by
# plan: each trains on the same rows in both packages (their feature means
# and scales agree to 4e-7), yet their weights end 1.7e-3 (core-a's stage
# 0), 8.2e-3 (its stage 1) and 6.2e-4 (the UDF plan's stage 0) apart, where
# the other proxies' agree to 6e-7.  Only their thresholds are held to
# HINGE_TOL; every other one to 1e-3.
MARGIN_FLIPS = {"core-a": (0, 1), "core-h": (), "core": (), "udf": (0,)}
ACC_TOL = 1e-3
UDF_N, UDF_STEPS = 3000, 3  # the example: 12,000 records, 100 steps a UDF
VIDEO_N = 6000  # the example: 10,000 records
RESILIENT_STEPS = 8  # the example: 30 steps; the preemption before step 4
CONVERT = {"dense": interop.transformer_params, "ssm": interop.ssm_params}


def quiet(*_a, **_kw):
    pass


def _example(name: str):
    """The JAX package's ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)


def _adam_close(got, want, lr, steps):
    """bf16 or f32 parameters after ``steps`` AdamW steps from equal ones:
    within 2 lr a step (an element whose gradient is near eps may take either
    sign's update) plus half a bf16 step of each side's value."""
    got, want = _np(got), _np(want)
    ulp = 2.0 ** -8 * (np.abs(got) + np.abs(want))
    bad = np.abs(got - want) > 2 * lr * steps + ulp + 1e-6
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def _assert_plans_agree_but_flips(got, want, flips):
    """``_assert_plans_agree`` with thresholds within 1e-3 relative, but for
    the stages in ``flips`` (MARGIN_FLIPS), held to HINGE_TOL."""
    _assert_plans_agree(got, want, thr_rel=HINGE_TOL)
    off = [(i, a.threshold, b.threshold) for i, (a, b) in enumerate(zip(got.stages, want.stages))
           if a.threshold != pytest.approx(b.threshold, rel=1e-3, abs=1e-3)]
    assert all(i in flips for i, _, _ in off), f"thresholds beyond 1e-3: {off}"
    if off:
        print(f"thresholds at a margin flip (stage, port, reference): {off}")


# ------------------------------------------------------------ video cascade
@pytest.fixture(scope="module")
def video():
    """The JAX example's ``main`` at VIDEO_N records, its UDFs trained as
    the JAX package's ``make_udfs`` trains them, keeping their layers; and
    the port's ``video_cascade.run`` with those layers."""
    mod = _example("video_cascade")
    layers, plans, results = [], {}, []

    def make_udfs(ds, *, hidden, depth, train_rows, seed, declared_cost_ms, cost_scale):
        idx = np.random.RandomState(seed).choice(ds.n, min(train_rows, ds.n), replace=False)
        udfs = []
        for j in range(ds.truth.shape[1]):
            scale = cost_scale.get(j, 1.0)
            params, predict, _ = jsyn._train_udf_model(
                ds.x[idx], ds.truth[idx, j], ds.n_classes[j], int(hidden * scale), depth, seed + j)
            udfs.append(MLUDF(name=f"{ds.name}.udf{j}", cost=declared_cost_ms * scale,
                              n_classes=ds.n_classes[j],
                              fn=lambda xx, _p=predict: np.asarray(_p(jnp.asarray(xx, jnp.float32)))))
            layers.append(interop.udf_layers(params))
        return udfs

    real_optimize, real_execute = mod.optimize, mod.execute_plan

    def optimize(q, x, *, mode, step):
        plans[mode] = real_optimize(q, x, mode=mode, step=step)
        return plans[mode]

    def execute(plan, x):
        results.append(real_execute(plan, x))
        return results[-1]

    mod.make_udfs, mod.optimize, mod.execute_plan = make_udfs, optimize, execute
    mod.make_dataset = lambda **kw: jsyn.make_dataset(**{**kw, "n": VIDEO_N})
    with pytest.warns(DeprecationWarning):
        mod.main()
    orig, res = results[0], dict(zip(video_cascade.MODES, results[1:]))
    port = video_cascade.run(VIDEO_N, "cpu", udf_weights=layers, log=quiet)
    return dict(plans=plans, orig=orig, res=res, port=port)


@pytest.mark.parametrize("mode", video_cascade.MODES)
def test_video_cascade_matches_reference(video, mode):
    ref_plan, got = video["plans"][mode], video["port"]["modes"][mode]
    _assert_plans_agree_but_flips(got["plan"], ref_plan, MARGIN_FLIPS[mode])
    assert got["plan"].est_total_cost == pytest.approx(ref_plan.est_total_cost, rel=ACC_TOL)
    want_acc = j_plan_accuracy(video["res"][mode], video["orig"])
    assert got["accuracy"] == pytest.approx(want_acc, abs=ACC_TOL)
    n = video["port"]["records"]
    assert got["exec_ms_per_record"] == pytest.approx(video["res"][mode].cost_per_record(n),
                                                      rel=ACC_TOL)
    assert video["port"]["orig"].cost_per_record(n) == pytest.approx(
        video["orig"].cost_per_record(n), rel=1e-6)
    ref_trace = ref_plan.meta.get("trace")
    assert (got["trace"] is None) == (ref_trace is None)
    if ref_trace is not None:
        for key in ("nodes_visited", "nodes_total"):
            assert got["trace"][key] == ref_trace[key]


# ------------------------------------------------------- resilient training
def _run_resilient_reference(arch, ckdir) -> dict:
    """The JAX example's ``main`` at RESILIENT_STEPS steps: {"init": its
    initial state, "states": every step's (step, state), "losses"}."""
    mod = _example("resilient_training")
    seen = {"states": []}
    real_init, real_runner = mod.init_train_state, mod.ResilientRunner

    def init_train_state(cfg, key):
        seen["init"] = real_init(cfg, key)
        return seen["init"]

    class Runner(real_runner):
        def __init__(self, step_fn, *a, **kw):
            seen["losses"] = inspect.getclosurevars(step_fn).nonlocals["losses"]

            def recorded(state, step):
                state = step_fn(state, step)
                seen["states"].append((step, state))
                return state

            super().__init__(recorded, *a, **kw)

    mod.init_train_state, mod.ResilientRunner = init_train_state, Runner
    mod.tempfile = types.SimpleNamespace(mkdtemp=lambda prefix: str(ckdir))
    with mock.patch.object(sys, "argv", ["resilient_training.py", "--arch", arch,
                                         "--steps", str(RESILIENT_STEPS)]):
        mod.main()
    return seen


@pytest.fixture(scope="module", params=["deepseek-67b", "mamba2-2.7b"])
def resilient(request, tmp_path_factory):
    """The JAX example's run (``_run_resilient_reference``); then the port's
    run from its initial state: straight, preempted (checkpoints every 3
    steps, so the restart restores step 3), and straight to the
    preemption's step; and the port's own run to there, from its own
    ``PRNGKey(0)`` init."""
    arch = request.param
    seen = _run_resilient_reference(arch, tmp_path_factory.mktemp("jax_ckpt"))
    cfg = reduced_config(arch)

    def carried():
        jp, jo = seen["init"]
        params = L.trainable(CONVERT[cfg.family](jp, cfg, "cpu"))
        return params, interop.adamw_state(jo, params, "cpu")

    kw = dict(device="cpu", log=quiet)
    straight = resilient_training.run(arch, RESILIENT_STEPS, preempt=False, init=carried(), **kw)
    preempted = resilient_training.run(arch, RESILIENT_STEPS, ckpt_every=3, init=carried(), **kw)
    half = resilient_training.run(arch, RESILIENT_STEPS // 2, preempt=False, init=carried(),
                                  **kw)
    own = resilient_training.run(arch, RESILIENT_STEPS // 2, preempt=False, **kw)
    return dict(arch=arch, cfg=cfg, seen=seen, straight=straight, preempted=preempted, half=half,
                own=own)


def _own_losses_match(seen, own):
    fail_at = RESILIENT_STEPS // 2
    ref = seen["losses"][:fail_at]
    got = [loss for _, loss in own["losses"]]
    assert len(got) == fail_at
    assert got == pytest.approx(ref, abs=LOGIT_TOL, rel=LOGIT_TOL)


def test_resilient_own_init_matches_reference_before_the_preemption(resilient):
    """Without carried weights: the port's ``PRNGKey(0)`` init is the JAX
    example's (``util/prng.py``), so its losses before the preemption are
    the reference's within LOGIT_TOL."""
    _own_losses_match(resilient["seen"], resilient["own"])


@pytest.mark.parametrize("arch", ["seamless-m4t-medium"])
def test_resilient_keyed_batches_match_reference(arch, tmp_path):
    """An encoder-decoder draws its whole batch from ``make_batch(cfg, 8, 32,
    PRNGKey(step))`` in both packages: from its own init, the port's
    losses before the preemption are the JAX example's within LOGIT_TOL."""
    seen = _run_resilient_reference(arch, tmp_path / "jax_ckpt")
    own = resilient_training.run(arch, RESILIENT_STEPS // 2, preempt=False, device="cpu",
                                 log=quiet)
    _own_losses_match(seen, own)


@pytest.mark.parametrize("arch", ["deepseek-67b", "paligemma-3b"])
def test_launcher_step_zero_loss_matches_reference(arch, tmp_path):
    """Step 0 of ``launch.train`` at a reduced config in f32 reports the JAX
    launcher's step-0 loss within 1e-5: the same ``PRNGKey(0)`` weights and
    the same batch (the stream's first sequences; a VLM's
    ``make_batch(cfg, 8, 64, PRNGKey(0))``)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    losses = []
    real_step = jtrain.make_train_step

    def make_train_step(cfg, **kw):
        step = jax.jit(real_step(cfg, **kw))

        def recorded(p, o, b):
            out = step(p, o, b)
            losses.append(float(out[2]["loss"]))
            return out
        return recorded

    real_config = jtrain.reduced_config
    f32 = lambda name: real_config(name).replace(dtype="float32")  # noqa: E731
    with mock.patch.object(jtrain, "make_train_step", make_train_step), \
            mock.patch.object(jtrain, "reduced_config", f32), \
            mock.patch.object(jtrain, "jax", types.SimpleNamespace(
                jit=lambda f: f, random=jax.random, devices=jax.devices)), \
            mock.patch.object(sys, "argv", ["train.py", "--arch", arch, "--steps", "1",
                                            "--ckpt-every", "100",
                                            "--ckpt-dir", str(tmp_path / "jax")]):
        jtrain.main()
    cfg = reduced_config(arch).replace(dtype="float32")
    got = ttrain.run(cfg, steps=1, batch=8, seq=64, device="cpu", ckpt_every=0, log=quiet)
    assert len(losses) == 1
    assert got["losses"][0] == pytest.approx(losses[0], abs=1e-5, rel=1e-5)


def test_resilient_losses_match_reference_before_the_preemption(resilient):
    fail_at = RESILIENT_STEPS // 2
    ref = resilient["seen"]["losses"][:fail_at]  # a straight run up to the preemption
    got = [loss for _, loss in resilient["straight"]["losses"][:fail_at]]
    assert got == pytest.approx(ref, abs=LOGIT_TOL, rel=LOGIT_TOL)
    step, (jp, jo) = resilient["seen"]["states"][fail_at - 1]
    assert step == fail_at - 1
    model = CONVERT[resilient["cfg"].family](jp, resilient["cfg"], "cpu")
    ref_named = dict(model.named_parameters())
    for name, p in resilient["half"]["params"].named_parameters():
        _adam_close(p, ref_named[name], resilient_training.LR, fail_at)


def test_resilient_restart_equals_a_straight_run(resilient):
    a, b = resilient["preempted"], resilient["straight"]
    assert a["report"].restarts == 1 and a["restored_from"] == [3]
    assert a["report"].steps_done == RESILIENT_STEPS
    for (na, pa), (nb, pb) in zip(a["params"].named_parameters(), b["params"].named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    for n in b["opt"].mu:
        assert torch.equal(a["opt"].mu[n], b["opt"].mu[n]) and torch.equal(a["opt"].nu[n],
                                                                           b["opt"].nu[n])
    assert a["opt"].step == b["opt"].step == RESILIENT_STEPS
    # steps 3 and after replay the straight run's batches
    assert dict(a["losses"]) == dict(b["losses"])
    assert [s for s, _ in a["losses"]] == [0, 1, 2, 3, 3, 4, 5, 6, 7]


# ------------------------------------------------ transformer UDF serving
_ROUTE_LOGS = []  # the innermost _record_reference_routes call's list last


def _record_reference_routes(run):
    """``run()`` (a JAX package call) with every ``moe_apply`` recording its
    top-k experts (N, k), in call order.  A jitted function traced here
    keeps its recording callback, which reports to the current call."""
    routes = []
    real = JM.moe_apply

    def spy(p, cfg, x):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"],
                               axis=-1)
        jax.debug.callback(lambda e: _ROUTE_LOGS[-1].append(np.asarray(e)),
                           jax.lax.top_k(probs, cfg.moe.top_k)[1], ordered=True)
        return real(p, cfg, x)

    JM.moe_apply = spy
    _ROUTE_LOGS.append(routes)
    try:
        out = run()
        jax.effects_barrier()
    finally:
        JM.moe_apply = real
        _ROUTE_LOGS.pop()
    return out, routes


class _Pinned:
    """The port's ``moe.route`` returning the reference's experts, call by
    call (``chip_smoke.pinned_route``), each own choice that differs held to
    a near tie."""

    def __init__(self, routes):
        self.routes, self.calls, self.flips, self.max_gap = routes, 0, 0, 0.0

    def wanted(self):
        for r in self.routes:
            self.calls += 1
            yield torch.from_numpy(np.array(r)).to(torch.int64)

    def __enter__(self):
        self.patch = mock.patch.object(TM, "route", chip_smoke.pinned_route(
            TM.route, self.wanted(), self, ROUTER_TIE_TOL))
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()
        assert exc[0] is not None or self.calls == len(self.routes)


class _HeldToReference:
    """``transformer_udf_serving.udf_logits`` held to the reference's
    logits function on every call, on the same (padded) rows and the
    reference's trained tree: the MoE's expert choices pinned to the
    reference's (each own choice that differs a near tie), the logits within
    LOGIT_TOL, and each row whose two argmaxes differ (its reference top two
    within LABEL_TIE) given the reference's logits, so that both packages'
    optimizers and servers see the same labels.  Counts calls, router flips
    and pinned labels."""

    def __init__(self, ref):
        self.ref, self.calls, self.flips, self.pinned = ref, 0, 0, 0
        self.real = transformer_udf_serving.udf_logits
        self.patch = mock.patch.object(transformer_udf_serving, "udf_logits", self)

    def __enter__(self):
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()

    def __call__(self, params, cfg, xt):
        i = [f"{a}-smoke" for a in UDF_IDS].index(cfg.name)
        trained = self.ref["steps"][i][-1]
        want, routes = _record_reference_routes(lambda: np.asarray(
            self.ref["jit_logit_fns"][i](trained, jnp.asarray(xt.numpy()))))
        with _Pinned(routes) as pin:
            got = self.real(params, cfg, xt)
        self.calls += 1
        self.flips += pin.flips
        np.testing.assert_allclose(_np(got), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        differ = got.argmax(1).numpy() != want.argmax(1)
        if differ.any():
            top = np.sort(want[differ], axis=1)
            assert (top[:, -1] - top[:, -2] < LABEL_TIE).all(), "a label differs off a tie"
            got = got.clone()
            got[torch.from_numpy(differ)] = torch.from_numpy(want[differ])
            self.pinned += int(differ.sum())
        return got


@pytest.fixture(scope="module")
def udf_reference():
    """The JAX example's ``main`` at UDF_N records and UDF_STEPS steps a
    UDF, recording each UDF's initial tree (``adamw_init``'s argument),
    its tree after every step (``adamw_update``'s result, through a debug
    callback), its logits function, the plan, the server and ORIG's and
    CORE's results; then the port's ``run`` with the trained trees and
    measured costs carried across, held to the reference's UDFs
    (``_HeldToReference``)."""
    mod = _example("transformer_udf_serving")
    inits, steps, udfs, plans, results, servers = [], [], [], [], [], []

    def adamw_init(p):
        inits.append(p)
        steps.append([])
        return joptim.adamw_init(p)

    def adamw_update(p, g, o, **kw):
        p, o = joptim.adamw_update(p, g, o, **kw)
        jax.debug.callback(lambda q, _log=steps[-1]: _log.append(q), p, ordered=True)
        return p, o

    real_make, real_optimize, real_execute = (mod.make_backbone_udf, mod.optimize,
                                              mod.execute_plan)

    def make_backbone_udf(arch, ds, column, *, steps, seed):
        udfs.append(real_make(arch, ds, column, steps=UDF_STEPS, seed=seed))
        return udfs[-1]

    class Server(mod.CascadeServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    def optimize(q, x, **kw):
        plans.append(real_optimize(q, x, **kw))
        return plans[-1]

    def execute(plan, x):
        results.append(real_execute(plan, x))
        return results[-1]

    mod.optim = types.SimpleNamespace(adamw_init=adamw_init, adamw_update=adamw_update)
    mod.make_backbone_udf, mod.optimize, mod.execute_plan = make_backbone_udf, optimize, execute
    mod.CascadeServer = Server
    mod.make_dataset = lambda **kw: jsyn.make_dataset(**{**kw, "n": UDF_N})
    with pytest.warns(DeprecationWarning):
        mod.main()
    jax.effects_barrier()
    logit_fns = []
    for u in udfs:
        infer = inspect.getclosurevars(u.fn).nonlocals["infer"]
        logit_fns.append(inspect.getclosurevars(infer.__wrapped__).nonlocals["logits_fn"])
    # jitted for the held calls (traced under _record_reference_routes only)
    ref = dict(inits=inits, steps=steps, udfs=udfs, logit_fns=logit_fns,
               jit_logit_fns=[jax.jit(f) for f in logit_fns], plan=plans[0],
               server=servers[0], orig=results[0], res=results[1])
    params = [interop.backbone_udf_params(s[-1], transformer_udf_serving.udf_config(arch), "cpu")
              for s, arch in zip(steps, UDF_IDS)]
    with _HeldToReference(ref) as held:
        port = transformer_udf_serving.run(UDF_N, steps=0, device="cpu", udf_params=params,
                                           udf_costs=[u.cost for u in udfs], log=quiet)
    print(f"the port's UDFs: {held.calls} calls held to the reference's, {held.flips} own "
          f"router choices and {held.pinned} labels at near ties")
    return ref, port


UDF_IDS = [arch for arch, _, _ in transformer_udf_serving.UDFS]


def _train_rows(i):
    """The UDF's training rows and labels (the example's first 2,000)."""
    column = transformer_udf_serving.UDFS[i][1]
    ds = jsyn.make_dataset(name="stream", n=UDF_N, correlation=0.92, n_classes=3,
                           feature_noise=1.0, seed=4)
    rows = transformer_udf_serving.TRAIN_ROWS
    return (torch.from_numpy(np.asarray(ds.x[:rows], np.float32)),
            torch.from_numpy(np.asarray(ds.truth[:rows, column], np.int64)))


@pytest.mark.parametrize("i", range(len(UDF_IDS)), ids=UDF_IDS)
def test_backbone_udf_logits_at_the_initial_weights(udf_reference, i):
    ref, port = udf_reference
    cfg = transformer_udf_serving.udf_config(UDF_IDS[i])
    params = interop.backbone_udf_params(ref["inits"][i], cfg, "cpu")
    x = np.asarray(port["ds"].x[:300], np.float32)
    want, routes = _record_reference_routes(
        lambda: np.asarray(ref["logit_fns"][i](ref["inits"][i], jnp.asarray(x))))
    assert (len(routes) > 0) == (cfg.family == "moe")
    with _Pinned(routes) as pin, torch.no_grad():
        got = transformer_udf_serving.udf_logits(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    print(f"{UDF_IDS[i]}: logits max |diff| {float(np.abs(_np(got) - want).max()):.3g}, "
          f"{pin.flips} own router choices at near ties")


@pytest.mark.parametrize("i", range(len(UDF_IDS)), ids=UDF_IDS)
def test_backbone_udf_one_adamw_step(udf_reference, i):
    ref, _ = udf_reference
    cfg = transformer_udf_serving.udf_config(UDF_IDS[i])
    params = interop.backbone_udf_params(ref["inits"][i], cfg, "cpu")
    x, y = _train_rows(i)
    losses = transformer_udf_serving.train_udf(params, cfg, x, y, steps=1)
    assert losses[0] == pytest.approx(_jax_loss(ref["logit_fns"][i], ref["inits"][i], x, y),
                                      abs=LOGIT_TOL, rel=LOGIT_TOL)
    after = ref["steps"][i][0]
    with torch.no_grad():
        got_loss = float(transformer_udf_serving.udf_loss(params, cfg, x, y))
    assert got_loss == pytest.approx(_jax_loss(ref["logit_fns"][i], after, x, y),
                                     abs=LOGIT_TOL, rel=LOGIT_TOL)
    want = transformer_udf_serving.udf_leaves(interop.backbone_udf_params(after, cfg, "cpu"))
    for name, p in transformer_udf_serving.udf_leaves(params).items():
        _adam_close(p, want[name], transformer_udf_serving.LR, 1)


def _jax_loss(logits_fn, p, x, y):
    lg = logits_fn(p, jnp.asarray(x.numpy()))
    yj = jnp.asarray(y.numpy())
    return float(jnp.mean(jax.nn.logsumexp(lg, 1) - jnp.take_along_axis(lg, yj[:, None], 1)[:, 0]))


@pytest.mark.parametrize("i", range(len(UDF_IDS)), ids=UDF_IDS)
def test_training_only_the_reached_leaves_equals_training_them_all(udf_reference, i):
    """The embedding and LM head get no gradient; AdamW without weight
    decay leaves them as they are, so updating every leaf with zero
    gradients there (the reference's tree-wide update) gives the same bits."""
    from repro_torch.training import optim

    ref, _ = udf_reference
    cfg = transformer_udf_serving.udf_config(UDF_IDS[i])
    x, y = _train_rows(i)
    reached = interop.backbone_udf_params(ref["inits"][i], cfg, "cpu")
    transformer_udf_serving.train_udf(reached, cfg, x, y, steps=2)
    every = interop.backbone_udf_params(ref["inits"][i], cfg, "cpu")
    named = transformer_udf_serving.udf_leaves(every)
    for p in named.values():
        p.requires_grad_(True)
    opt = optim.adamw_init(named)
    for _ in range(2):
        loss = transformer_udf_serving.udf_loss(every, cfg, x, y)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
        opt = optim.adamw_update(named, dict(zip(named, grads)), opt,
                                 lr=transformer_udf_serving.LR)
    got = transformer_udf_serving.udf_leaves(reached)
    for name, p in named.items():
        assert torch.equal(got[name], p.detach()), name
    start = transformer_udf_serving.udf_leaves(
        interop.backbone_udf_params(ref["inits"][i], cfg, "cpu"))
    unreached = [n for n in named if n.startswith("backbone.embed")]
    assert unreached and all(torch.equal(got[n], start[n]) for n in unreached)


@pytest.mark.parametrize("i", range(len(UDF_IDS)), ids=UDF_IDS)
def test_backbone_udf_pads_and_labels_as_the_reference(udf_reference, i):
    """``fn`` on 300 records runs one padded batch of 512 (the records, then
    zeros), which ``_HeldToReference`` holds to the reference's logits on
    the same padded rows; its labels equal the reference ``fn``'s but at
    near ties."""
    ref, port = udf_reference
    udf = port["udfs"][i]
    x = np.asarray(port["ds"].x[2000:2300], np.float32)
    seen = []
    with _HeldToReference(ref) as held:
        real = held.real

        def spy(params, cfg, xt):
            seen.append(xt.clone())
            return real(params, cfg, xt)

        held.real = spy
        got = udf(x)
    assert len(seen) == 1 and seen[0].shape == (512, x.shape[1])
    assert torch.equal(seen[0][:300], torch.from_numpy(x)) and not seen[0][300:].any()
    assert np.array_equal(got, np.asarray(ref["udfs"][i](x)))
    print(f"{UDF_IDS[i]}: {held.pinned} labels and {held.flips} router choices at near ties")


def test_transformer_udf_serving_matches_reference(udf_reference):
    ref, port = udf_reference
    _assert_plans_agree_but_flips(port["plan"], ref["plan"], MARGIN_FLIPS["udf"])
    assert port["plan"].est_total_cost == pytest.approx(ref["plan"].est_total_cost, rel=ACC_TOL)
    rest = port["rest"]
    # a record's emission may differ only where a proxy score lies between
    # the two packages' thresholds (the UDFs are held to the reference's)
    may_differ = np.zeros(len(rest), bool)
    for got_st, ref_st in zip(port["plan"].stages, ref["plan"].stages):
        if ref_st.proxy is None:
            continue
        s = np.asarray(ref_st.proxy.score(rest))
        lo, hi = sorted((got_st.threshold, ref_st.threshold))
        pad = FOLD_TOL * max(1.0, abs(ref_st.threshold))
        may_differ |= (s >= lo - pad) & (s <= hi + pad)
    emitted, ref_emitted = set(port["server"].emitted), set(ref["server"].emitted)
    diff = np.array(sorted(emitted ^ ref_emitted), np.int64)
    assert not (~may_differ[diff]).any(), f"records {diff[~may_differ[diff]]} differ"
    print(f"served: {len(emitted)} emitted, {len(diff)} differ from the reference's at "
          f"threshold ties")
    stats = port["stats"]
    assert stats.emitted + stats.rejected == len(rest)
    assert port["orig"].model_cost_ms == pytest.approx(ref["orig"].model_cost_ms, rel=ACC_TOL)
    assert port["res"].model_cost_ms == pytest.approx(ref["res"].model_cost_ms, rel=ACC_TOL)
