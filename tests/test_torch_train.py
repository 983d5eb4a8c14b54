"""The port's training path on the CPU against the JAX package's: the
optimizers (``repro.training.optim``), one train step
(``repro.training.train_loop.make_train_step``) for deepseek-67b,
qwen3-moe, deepseek-v2-lite and paligemma at their reduced configs in f32
with accum 1 and 2 (the JAX parameters and optimizer state carried across
by ``interop``), the data pipeline's batches and cursors, checkpoints each
package restores from the other, and the train CLI with ``--resume`` and a
simulated preemption.  On the CPU attention takes ``layers.mha``'s einsum
route in both packages.

Tolerances: the loss within 1e-5; moments within 1e-5 of each tensor's
largest value.  AdamW's first update is g / (|g| + eps) a parameter (eps
1e-8): where the reference gradient is below ADAM_COND * eps its direction
turns on the gradient's last bits (a cancellation both packages round
differently), so updated parameters are held to 1e-5 of their largest value
where |g| >= ADAM_COND * eps, and within 2 * lr (Adam's step bound)
elsewhere.  The optimizers alone, given the same gradients, are held to
1e-6 (f32) and one bf16 step (bf16 parameters).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import reduced_config as jax_reduced_config
from repro.data.pipeline import Cursor as JaxCursor
from repro.data.pipeline import ShardedStream as JaxStream
from repro.training import optim as joptim
from repro.training.train_loop import init_train_state as jax_init_train_state
from repro.training.train_loop import make_train_step as jax_make_train_step

from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Cursor, ShardedStream
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import leaves
from repro_torch.training import optim
from repro_torch.training.train_loop import init_train_state, make_train_step
from _one_thread import one_thread  # noqa: F401

ARCHS = ("deepseek-67b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "paligemma-3b")
CONVERT = {"dense": interop.transformer_params, "moe": interop.moe_params,
           "vlm": interop.vlm_params}
LR = 1e-3
ADAM_EPS, ADAM_COND = 1e-8, 100


@pytest.fixture(scope="module", autouse=True)
def quick_compiles():
    """XLA's cheaper compile pipeline for this module's one-off programs
    (restored afterwards): compiling, not running, is their cost here."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------- optimizers
SHAPES = {"a": (6,), "b": (4, 5), "c": (3, 4, 5)}


def _leaves(seed, dtype):
    rng = np.random.RandomState(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _as_jax(d, dtype):
    return {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in d.items()}


def _as_torch(d, dtype):
    return {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in d.items()}


OPTIMIZERS = {  # name -> (jax init, jax update, port init, port update, kwargs, moment fields)
    "adamw": (joptim.adamw_init, joptim.adamw_update, optim.adamw_init, optim.adamw_update,
              dict(lr=1e-2, weight_decay=0.1), ("mu", "nu")),
    "adafactor": (joptim.adafactor_init, joptim.adafactor_update, optim.adafactor_init,
                  optim.adafactor_update, dict(lr=1e-2), ("vr", "vc")),
    "sgd": (joptim.sgd_init, joptim.sgd_update, optim.sgd_init, optim.sgd_update,
            dict(lr=1e-2, weight_decay=0.1), ("momentum",)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name, dtype):
    jinit, jupd, tinit, tupd, kw, fields = OPTIMIZERS[name]
    p0 = _leaves(0, dtype)
    jp, tp = _as_jax(p0, dtype), _as_torch(p0, dtype)
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _leaves(step + 1, dtype)
        jp, js = jupd(jp, _as_jax(g, dtype), js, **kw)
        ts = tupd(tp, _as_torch(g, dtype), ts, **kw)
    assert ts.step == int(js.step) == 3
    for k in SHAPES:
        got, want = _np(tp[k]), np.asarray(jp[k].astype(jnp.float32))
        assert tp[k].dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:  # one bf16 step: the f32 update rounds to the parameter's type
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        for f in fields:
            np.testing.assert_allclose(_np(getattr(ts, f)[k]), np.asarray(getattr(js, f)[k]),
                                       rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- train step
def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (2, 17))
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    if cfg.family == "vlm":
        pat = rng.standard_normal((2, cfg.encoder.num_prefix, cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pat), torch.from_numpy(pat)
    return jb, tb


def _jax_init(cfg, seed):
    """``init_train_state`` of the JAX package, compiled as one program (its
    op-by-op dispatch takes several times longer on the CPU)."""
    return jax.jit(functools.partial(jax_init_train_state, cfg))(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _jax_start(arch):
    """The JAX package's initial f32 params and AdamW state (the same for
    every accum count; drawn once an arch)."""
    return _jax_init(jax_reduced_config(arch).replace(dtype="float32"), 0)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, accum):
    jcfg = jax_reduced_config(arch).replace(dtype="float32", accum_steps=accum)
    cfg = reduced_config(arch).replace(dtype="float32", accum_steps=accum)
    params, opt = _jax_start(arch)
    jb, tb = _batch(cfg)
    p1, o1, m = jax.jit(jax_make_train_step(jcfg, lr=LR))(params, opt, jb)

    convert = CONVERT[cfg.family]
    model = L.trainable(convert(params, cfg, device="cpu"))
    state = interop.adamw_state(opt, model, device="cpu")
    _, state, tm = make_train_step(cfg, lr=LR)(model, state, tb)

    assert abs(float(tm["loss"]) - float(m["loss"])) <= 1e-5
    ref = dict(convert(p1, cfg, device="cpu").named_parameters())
    ref_state = interop.adamw_state(o1, model, device="cpu")
    assert state.step == ref_state.step == 1
    for n, p in model.named_parameters():
        for f in ("mu", "nu"):
            assert _rel(getattr(state, f)[n], getattr(ref_state, f)[n]) <= 1e-5, (n, f)
        good = (ref_state.mu[n] / 0.1).abs() >= ADAM_COND * ADAM_EPS
        diff = (p.detach() - ref[n]).abs()
        if bool(good.any()):
            assert float(diff[good].max() / ref[n].abs().max()) <= 1e-5, n
        if bool((~good).any()):
            assert float(diff[~good].max()) <= 2 * LR, n


def test_families_without_a_loss_raise():
    """Every family of ``configs/archs.py`` has a loss now (slice O); only a
    family the port does not know raises, before anything is allocated."""
    for arch in ("mamba2-2.7b", "recurrentgemma-2b", "seamless-m4t-medium"):
        make_train_step(reduced_config(arch))
    with pytest.raises(NotImplementedError, match="no family"):
        make_train_step(reduced_config("deepseek-67b").replace(family="speech"))
    with pytest.raises(NotImplementedError, match="no family"):
        init_train_state(reduced_config("deepseek-67b").replace(family="speech"), device="cpu")


def test_adafactor_step_runs_on_the_jax_leaves():
    """Adafactor's state lives on the JAX package's leaves (layer stacks
    whole), so ``interop.adafactor_state`` carries it across as it is and
    one step moves every parameter."""
    jcfg = jax_reduced_config("deepseek-67b").replace(dtype="float32", optimizer="adafactor")
    cfg = reduced_config("deepseek-67b").replace(dtype="float32", optimizer="adafactor")
    params, opt = _jax_init(jcfg, 0)
    model = L.trainable(interop.transformer_params(params, cfg, device="cpu"))
    state = interop.adafactor_state(opt, model, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.vr.items()} == {
        tuple(path): np.asarray(leaf).shape
        for path, leaf in leaves.flat(jax.tree.map(np.asarray, opt.vr)).items()}
    jb, tb = _batch(cfg)
    p1, o1, _ = jax.jit(jax_make_train_step(jcfg, lr=LR))(params, opt, jb)
    _, state, _ = make_train_step(cfg, lr=LR)(model, state, tb)
    ref = dict(interop.transformer_params(p1, cfg, device="cpu").named_parameters())
    ref_state = interop.adafactor_state(o1, model, device="cpu")
    for k in state.vr:
        assert _rel(state.vr[k], ref_state.vr[k]) <= 1e-5 and _rel(state.vc[k], ref_state.vc[k]) <= 1e-5
    for n, p in model.named_parameters():
        assert _rel(p, ref[n]) <= 1e-4, n


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 3)])
def test_stream_yields_the_jax_batches_and_cursors(host_id, num_hosts):
    data = np.arange(200 * 3).reshape(200, 3)
    kw = dict(host_id=host_id, num_hosts=num_hosts, batch=16, seed=7)
    start = dict(epoch=1, position=32)
    mine = ShardedStream(data, cursor=Cursor.from_dict(start), **kw)
    ref = JaxStream(data, cursor=JaxCursor.from_dict(start), **kw)
    for _, a, b in zip(range(12), iter(mine), iter(ref)):
        np.testing.assert_array_equal(a, b)
        assert mine.cursor.as_dict() == ref.cursor.as_dict()
    assert interop.cursor(ref.cursor) == mine.cursor


# ---------------------------------------------------------------- checkpoints
def _cross_state():
    """The same (params, AdamW state, cursor) in both packages: reduced
    deepseek-67b in bf16, so leaves of three types travel."""
    jcfg = jax_reduced_config("deepseek-67b")
    cfg = reduced_config("deepseek-67b")
    params, opt = _jax_init(jcfg, 3)
    opt = opt._replace(step=jnp.asarray(5, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    model = L.trainable(interop.transformer_params(params, cfg, device="cpu"))
    state = interop.adamw_state(opt, model, device="cpu")
    cursor = {"epoch": 2, "position": 48}
    return (params, opt, cursor), train_cli.state_tree(model, state, cursor), (model, state)


def test_checkpoints_cross_between_the_packages(tmp_path):
    jax_tree, tree, (model, state) = _cross_state()
    assert len(flatten(tree)) == len(jax.tree_util.tree_leaves(jax_tree))
    JaxCheckpointer(tmp_path / "jax", async_save=False).save(5, jax_tree)
    Checkpointer(tmp_path / "port", async_save=False).save(5, tree)
    for a, b in (("jax", "port"), ("port", "jax")):
        ma = json.loads((tmp_path / a / "step_00000005" / "meta.json").read_text())
        mb = json.loads((tmp_path / b / "step_00000005" / "meta.json").read_text())
        assert (ma["n_leaves"], ma["sha256"], ma["shapes"], ma["dtypes"]) == (
            mb["n_leaves"], mb["sha256"], mb["shapes"], mb["dtypes"])
    # the port restores the JAX package's checkpoint leaf for leaf
    like = train_cli.state_tree(model, state, {"epoch": 0, "position": 0}, device="meta")
    got = Checkpointer(tmp_path / "jax").restore(like)
    for a, b in zip(flatten(got), flatten(tree)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    fresh = L.trainable(interop.transformer_params(jax_tree[0], reduced_config("deepseek-67b"),
                                                   device="cpu"))
    opt2, cursor = train_cli.load_state_tree(got, fresh, optim.adamw_init(
        dict(fresh.named_parameters())))
    assert opt2.step == 5 and cursor == {"epoch": 2, "position": 48}
    assert all(torch.equal(opt2.mu[n], state.mu[n]) for n in state.mu)
    # the JAX package restores the port's checkpoint leaf for leaf
    back = JaxCheckpointer(tmp_path / "port").restore(jax_tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_tree)):
        if hasattr(b, "dtype"):  # the cursor's Python ints come back as JAX makes them
            assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_integrity_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"w": torch.arange(6, dtype=torch.bfloat16), "n": 3}
    for step in (1, 2, 3):
        ck.save(step, tree)
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert not list(tmp_path.glob(".tmp_ckpt_*"))
    got = ck.restore({"w": torch.zeros(6, dtype=torch.bfloat16), "n": 0})
    assert torch.equal(got["w"], tree["w"]) and got["n"] == 3
    meta_path = tmp_path / "step_00000003" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["sha256"] = "0" * 64
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(IOError, match="integrity"):
        ck.restore(tree, 3)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"w": tree["w"]}, 2)


# ---------------------------------------------------------------- the CLI
def test_train_cli_resumes_and_restarts(tmp_path, capsys):
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "2"]
    first = train_cli.main(args + ["--steps", "3"])
    assert sorted(first["losses"]) == [0, 1, 2]
    resumed = train_cli.main(args + ["--steps", "5", "--resume"])
    assert resumed["start"] == 3 and sorted(resumed["losses"]) == [3, 4]
    assert "resumed from step 3" in capsys.readouterr().out
    straight = train_cli.main(args[:2] + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "5"])
    assert all(torch.equal(a, b) for a, b in zip(straight["params"].parameters(),
                                                 resumed["params"].parameters()))
    # a preemption before step 3: the runner restores step 2 and the cursor
    failed = train_cli.main(args[:2] + ["--ckpt-dir", str(tmp_path / "c"), "--steps", "5",
                                        "--ckpt-every", "2", "--fail-at", "3"])
    assert failed["report"].restarts == 1 and "restarted from step 2" in capsys.readouterr().out
    assert failed["losses"] == straight["losses"]
    assert all(torch.equal(a, b) for a, b in zip(straight["params"].parameters(),
                                                 failed["params"].parameters()))
