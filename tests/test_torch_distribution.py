"""The port's distribution layer on 4 gloo ranks against the JAX package.

One job of 4 ranks (``torch.multiprocessing`` spawn, a ``file://``
rendezvous under the test's temporary directory, so that no TCP port is
shared across test processes) runs every check once (``_torch_dist_worker``)
and each test reads its part:

* the reduced llama3-405b train step (accum 2, batch 8 x 32, f32, AdamW) on
  a (2, 2) ("data", "model") mesh through ``make_sharded_train_step``: its
  loss and updated parameters within 1e-5 of the port's single-process step
  on the same weights, which are the JAX package's carried across by
  ``interop``; the single-process step against the JAX package's
  single-device step within ``test_torch_train.py``'s limits;
* ``flash_attention`` on DTensor operands (``local_map``; on the CPU the
  plain version) against the plain version on the whole tensors, forward
  and gradients, for each way the KV heads meet the model axis;
* ``compressed_psum`` over "model" of a (1, 4) mesh against JAX's under
  ``jax.vmap(..., axis_name="model")`` on the same stacked inputs: the sum
  within 1e-6, the residual exact;
* ``moe_apply_ep`` on the (1, 4) mesh against JAX's ``moe_apply_ep`` on 4
  forced host devices (one JAX subprocess), output and aux within 1e-5;
* the elastic restore: saved from (2, 2), restored onto (4, 1) with that
  mesh's shardings, values intact and placements as ``sharding.py`` gives.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _one_thread import one_thread  # noqa: F401

from repro.configs import reduced_config as jax_reduced_config
from repro.distributed.fault_tolerance import compressed_psum as jax_compressed_psum
from repro.training.train_loop import init_train_state as jax_init_train_state
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import leaves
from repro_torch.models import moe
from repro_torch.training.train_loop import leaf_params, make_train_step

import _torch_dist_worker as worker

ROOT = Path(__file__).resolve().parents[1]
LR = worker.LR
ADAM_EPS, ADAM_COND = 1e-8, 100
FLASH = {"kv_sharded": (4, 2), "one_kv_head_a_rank": (4, 1), "kv_head_a_q_head": (6, 3),
         "heads_replicated": (3, 1)}  # (H, K) on a model axis of 2

JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, numpy as np
    from repro.configs import reduced_config
    from repro.distributed import ctx
    from repro.models import moe
    cfg = reduced_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    p = moe.init_experts(jax.random.PRNGKey(0), cfg)
    x = np.random.RandomState(3).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    with ctx.use_mesh(mesh, ep=True):
        out, aux = jax.jit(lambda p, x: moe.moe_apply_ep(p, cfg, x))(p, x)
    np.savez(sys.argv[1], x=x, out=np.asarray(out), aux=np.asarray(aux),
             **{k: np.asarray(p[k]) for k in ("router", "wg", "wi", "wo")})
""")


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _cfgs():
    j = jax_reduced_config("llama3-405b").replace(dtype="float32", accum_steps=2)
    t = reduced_config("llama3-405b").replace(dtype="float32", accum_steps=2)
    return j, t


def _batch(cfg):
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 33))
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    jcfg, cfg = _cfgs()
    params, opt = jax.jit(functools.partial(jax_init_train_state, jcfg))(jax.random.PRNGKey(0))
    toks, labels = _batch(cfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    p1, o1, m = jax.jit(jax_make_train_step(jcfg, lr=LR))(params, opt, jb)

    model = L.trainable(interop.transformer_params(params, cfg, device="cpu"))
    start = leaf_params(model)
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    state = interop.adamw_state(opt, model, device="cpu")
    _, state, tm = make_train_step(cfg, lr=LR)(model, state, tb)

    ep = work / "jax_ep.npz"
    r = subprocess.run([sys.executable, "-c", JAX_EP, str(ep)], capture_output=True, text=True,
                       cwd=ROOT, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    ep = dict(np.load(ep))

    rng = np.random.RandomState(5)
    flash = {}
    for name, (H, K) in FLASH.items():
        flash[name] = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                            for s in ((4, 16, H, 16), (4, 16, K, 16), (4, 16, K, 16),
                                      (4, 16, H, 16)))
    psum = rng.standard_normal((4, 6, 32)).astype(np.float32)
    torch.save({"leaves": start, "batch": tb, "flash": flash, "psum": torch.from_numpy(psum),
                "moe": {k: torch.from_numpy(v) for k, v in ep.items()}}, work / "inputs.pt")
    mp.spawn(worker.run, args=(4, str(work / "rendezvous"), str(work)), nprocs=4, join=True)
    res = torch.load(work / "results.pt", weights_only=False)
    return {"res": res, "jax": (p1, o1, m), "port": (model, state, tm), "cfg": cfg, "ep": ep,
            "psum": psum, "flash": flash, "start": start}


def _adam_close(got, want, mu):
    """``test_torch_train.py``'s rule for an updated parameter: within 1e-5
    of its largest value where the gradient is at least ADAM_COND * eps
    (the first AdamW step is g / (|g| + eps)), within 2 * lr elsewhere."""
    good = (mu / 0.1).abs() >= ADAM_COND * ADAM_EPS
    diff = (got - want).abs()
    ok = True
    if bool(good.any()):
        ok &= float(diff[good].max() / want.abs().max()) <= 1e-5
    if bool((~good).any()):
        ok &= float(diff[~good].max()) <= 2 * LR
    return ok


def test_sharded_train_step_matches_single_process(job):
    res, (model, state, tm) = job["res"]["train"], job["port"]
    assert abs(res["loss"] - float(tm["loss"])) <= 1e-5
    single = leaf_params(model)
    mu = leaves.stacked(state.mu)
    assert set(res["params"]) == set(single)
    for k, want in single.items():
        assert _rel(res["mu"][k], mu[k]) <= 1e-5, k  # the gradients (AdamW's first moment)
        assert _adam_close(res["params"][k], want, mu[k]), k
        assert float((res["params"][k] - job["start"][k]).abs().max()) > 0, k  # it moved
    # the matmul weights are laid out by the train rule
    assert res["placements"][("layers", "attn", "wq")] == ["S(1)", "S(2)"]


def test_single_process_step_matches_jax(job):
    (p1, o1, m), (model, state, tm), cfg = job["jax"], job["port"], job["cfg"]
    assert abs(float(tm["loss"]) - float(m["loss"])) <= 1e-5
    ref = dict(interop.transformer_params(p1, cfg, device="cpu").named_parameters())
    ref_state = interop.adamw_state(o1, model, device="cpu")
    for n, p in model.named_parameters():
        assert _adam_close(p.detach(), ref[n], ref_state.mu[n]), n


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_on_dtensors(job, case):
    q, k, v, dout = (t.clone().requires_grad_(i < 3) for i, t in enumerate(job["flash"][case]))
    want = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(want, (q, k, v), dout)
    got = job["res"]["flash"][case]
    assert _rel(got["out"], want) <= 1e-6
    for g, w in zip(got["grads"], grads):
        assert _rel(g, w) <= 1e-5
    heads = "S(2)" if FLASH[case][0] % 2 == 0 else "R"
    assert got["placements"] == ["S(0)", heads]


def test_compressed_psum_matches_jax(job):
    summed, residual = jax.vmap(lambda x: jax_compressed_psum(x, "model"),
                                axis_name="model")(jnp.asarray(job["psum"]))
    got = job["res"]["psum"]
    np.testing.assert_allclose(_np(got["summed"]), np.asarray(summed)[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(got["residual"]), np.asarray(residual))


def test_moe_apply_ep_matches_jax(job):
    ep, got = job["ep"], job["res"]["moe"]
    np.testing.assert_allclose(_np(got["out"]), ep["out"], rtol=0, atol=1e-5)
    assert abs(got["aux"] - float(ep["aux"])) <= 1e-5


def test_moe_apply_ep_without_a_mesh_is_moe_apply(job):
    ep = job["ep"]
    cfg = reduced_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    p = moe.Experts(cfg, device="cpu")
    with torch.no_grad():
        for name in ("router", "wg", "wi", "wo"):
            getattr(p, name).copy_(torch.from_numpy(ep[name]))
        x = torch.from_numpy(ep["x"])
        a, b = moe.moe_apply_ep(p, cfg, x), moe.moe_apply(p, cfg, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_elastic_restore_onto_another_mesh(job):
    got = job["res"]["elastic"]
    assert got["equal"] and got["placements_ok"]
    assert got["sharded"] > 0
