"""Training of the families slice O brings to the card, on the CPU against
the JAX package: the SSM loss and its gradients
(``jax.value_and_grad(repro.models.ssm.loss)``) at the JAX init and with
Mamba-2's published ``A_log`` / ``dt_bias`` ranges; one train step
(``repro.training.train_loop.make_train_step``) of reduced mamba2-2.7b,
seamless-m4t-medium and recurrentgemma-2b in f32 with the JAX parameters
and AdamW state carried across by ``interop``; the train CLI at reduced
mamba2 with a simulated preemption; and checkpoints of each of the three
families that each package restores from the other (the SSM's layer stack,
the encoder-decoder's two stacks, the hybrid's tuple of blocks).  On the
CPU ``ssd_chunk`` runs its plain forward and, under ``loss``, the plain
backward formulas through the autograd Function.

Tolerances (those of ``tests/test_torch_train.py``): the loss within 1e-5;
gradients and moments within 1e-5 of each tensor's largest value (the
SSM's within 1e-4: its gradients pass through the chunk recurrence's f32
exps, summed in other orders); updated parameters within 1e-5 of their
largest value where AdamW's update is well conditioned (|g| >= ADAM_COND *
eps) and within 2 * lr elsewhere.
"""
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import reduced_config as jax_reduced_config
from repro.models import ssm as jssm
from repro.training.train_loop import init_train_state as jax_init_train_state
from repro.training.train_loop import make_train_step as jax_make_train_step

from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
from repro_torch.configs import reduced_config
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.leaves import leaf_of
from repro_torch.training.train_loop import make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _one_thread import one_thread  # noqa: F401

ARCHS = ("mamba2-2.7b", "seamless-m4t-medium", "recurrentgemma-2b")
CONVERT = {"ssm": interop.ssm_params, "encdec": interop.encdec_params,
           "hybrid": interop.rglru_params}
LR = 1e-3
ADAM_EPS, ADAM_COND = 1e-8, 100


@pytest.fixture(scope="module", autouse=True)
def quick_compiles():
    """XLA's cheaper compile pipeline for this module's one-off programs
    (restored afterwards)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ref_leaf(tree, name):
    path, layer = leaf_of(name)
    for key in path:
        tree = tree[key]
    return np.asarray(tree)[layer] if layer is not None else np.asarray(tree)


def _batch(cfg, seed=0, S=32):
    """Tokens, labels and (encdec) frames as numpy, in both packages."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (2, S + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    if cfg.family == "encdec":
        fr = rng.standard_normal((2, S // cfg.encoder.frame_ratio, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return jb, tb


@pytest.mark.parametrize("dynamics", ["jax_init", "published"])
def test_ssm_loss_and_gradients_match_jax(dynamics):
    jcfg = jax_reduced_config("mamba2-2.7b").replace(dtype="float32", remat=False)
    cfg = reduced_config("mamba2-2.7b").replace(dtype="float32", remat=True)
    jparams = jssm.init(jax.random.PRNGKey(1), jcfg)
    if dynamics == "published":
        A_log, dt_bias = chip_smoke.published_dynamics(cfg.num_layers, cfg.ssm_heads, seed=2)
        jparams["layers"]["A_log"] = jnp.asarray(A_log)
        jparams["layers"]["dt_bias"] = jnp.asarray(dt_bias)
    jb, tb = _batch(cfg, seed=3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jssm.loss(p, jcfg, b), has_aux=True))(jparams, jb)
    model = L.trainable(interop.ssm_params(jparams, cfg, device="cpu"))
    loss, _ = ssm.loss(model, cfg, tb)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    for name, g in zip(names, grads):
        assert _rel(g, _ref_leaf(jgrads, name)) <= 1e-4, name
    with torch.no_grad():  # serving is unchanged by the loss's remat and Function
        assert torch.equal(ssm.forward(model, cfg, tb), ssm._logits(model, cfg, tb))


def _jax_init(cfg, seed):
    return jax.jit(functools.partial(jax_init_train_state, cfg))(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg = jax_reduced_config(arch).replace(dtype="float32")
    cfg = reduced_config(arch).replace(dtype="float32")
    params, opt = _jax_init(jcfg, 0)
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
            assert _rel(getattr(state, f)[n], _np(getattr(ref_state, f)[n])) <= 1e-5, (n, f)
        good = (ref_state.mu[n] / 0.1).abs() >= ADAM_COND * ADAM_EPS
        diff = (p.detach() - ref[n]).abs()
        if bool(good.any()):
            assert float(diff[good].max() / ref[n].abs().max()) <= 1e-5, n
        if bool((~good).any()):
            assert float(diff[~good].max()) <= 2 * LR, n


def test_ssm_train_cli_restart_equals_a_straight_run(tmp_path, capsys):
    args = ["--arch", "mamba2-2.7b", "--device", "cpu", "--layers", "2", "--batch", "2",
            "--seq", "32", "--steps", "4"]
    straight = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "0"])
    assert sorted(straight["losses"]) == [0, 1, 2, 3]
    failed = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "2",
                                    "--fail-at", "3"])
    assert failed["report"].restarts == 1 and "restarted from step 2" in capsys.readouterr().out
    assert failed["losses"] == straight["losses"]
    assert all(torch.equal(a, b) for a, b in zip(straight["params"].parameters(),
                                                 failed["params"].parameters()))
    for n in straight["opt"].mu:
        assert torch.equal(straight["opt"].mu[n], failed["opt"].mu[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_between_the_packages(tmp_path, arch):
    """The same (params, AdamW state, cursor) in bf16 saved by each package:
    the same leaves, shapes, types and digest, and each restores the
    other's leaf for leaf."""
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    params, opt = _jax_init(jcfg, 3)
    opt = opt._replace(step=jnp.asarray(5, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    model = L.trainable(CONVERT[cfg.family](params, cfg, device="cpu"))
    state = interop.adamw_state(opt, model, device="cpu")
    cursor = {"epoch": 2, "position": 48}
    jax_tree, tree = (params, opt, cursor), train_cli.state_tree(model, state, cursor)
    assert len(flatten(tree)) == len(jax.tree_util.tree_leaves(jax_tree))
    JaxCheckpointer(tmp_path / "jax", async_save=False).save(5, jax_tree)
    Checkpointer(tmp_path / "port", async_save=False).save(5, tree)
    ma = json.loads((tmp_path / "jax" / "step_00000005" / "meta.json").read_text())
    mb = json.loads((tmp_path / "port" / "step_00000005" / "meta.json").read_text())
    assert (ma["n_leaves"], ma["sha256"], ma["shapes"], ma["dtypes"]) == (
        mb["n_leaves"], mb["sha256"], mb["shapes"], mb["dtypes"])
    like = train_cli.state_tree(model, state, {"epoch": 0, "position": 0}, device="meta")
    got = Checkpointer(tmp_path / "jax").restore(like)
    for a, b in zip(flatten(got), flatten(tree)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    back = JaxCheckpointer(tmp_path / "port").restore(jax_tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
