"""Every model family's initial weights, the registry's batches and the
transformer-UDF example's initial trees, drawn from one key by the port
(``util/prng.py``: threefry2x32 in numpy on the CPU), against the JAX
package's ``jax.random`` draws from the same key.

All are held bit for bit (``torch.equal`` of the values, int dtype as
given): the port follows the reference's split tree and evaluates its
truncated normal, randint and bf16 normal with XLA's CPU arithmetic, so no
tolerance is needed.  Leaves are compared in the JAX package's layout
(``models/leaves.py``: layer stacks on a leading dim).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import registry as jreg

from repro_torch import transformer_udf_serving as tus
from repro_torch.configs import reduced_config
from repro_torch.configs.archs import ALL
from repro_torch.models import layers as TL
from repro_torch.models import leaves
from repro_torch.models.registry import get_family, make_batch, params_spec
from repro_torch.util import prng
from _one_thread import one_thread  # noqa: F401

ARCHS = sorted(ALL)


def _jax_leaves(tree, prefix=()):
    """{path: array} of a JAX params tree: dict keys sorted, a tuple's
    entries by index (the hybrid's blocks), as ``leaves.stacked`` keys
    them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_jax_leaves(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_jax_leaves(sub, prefix + (i,)))
        return out
    return {prefix: np.asarray(tree)}


def _equal(got: torch.Tensor, want: np.ndarray) -> bool:
    if want.dtype == jnp.bfloat16:
        want, got = want.astype(np.float32), got.float()
    want = torch.from_numpy(np.array(want))
    return got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_leaf_for_leaf(arch, seed):
    cfg = reduced_config(arch)
    jcfg = jax_reduced_config(arch)
    model = get_family(cfg).init(seed, cfg, device="cpu")
    got = leaves.stacked({n: p.detach() for n, p in model.named_parameters()})
    want = _jax_leaves(jreg.get_family(jcfg).init(jax.random.PRNGKey(seed), jcfg))
    assert sorted(got) == sorted(want)
    bad = [path for path in want if not _equal(got[path], want[path])]
    assert not bad, f"{arch} seed {seed}: {bad}"


def test_init_takes_an_int_or_a_key():
    """An int is read as ``PRNGKey(int)``; a (2,) uint32 key is used as it
    is; "meta" draws nothing."""
    cfg = reduced_config("deepseek-67b")
    fam = get_family(cfg)
    a = fam.init(5, cfg, device="cpu")
    b = fam.init(prng.key(5), cfg, device="cpu")
    c = fam.init(np.array([1, 2], np.uint32), cfg, device="cpu")
    assert torch.equal(a.layers[1].mlp.wo, b.layers[1].mlp.wo)
    assert not torch.equal(a.layers[1].mlp.wo, c.layers[1].mlp.wo)
    with pytest.raises(ValueError):
        fam.init(np.zeros(3, np.uint32), cfg, device="cpu")
    with prng.recording() as drawn:
        spec = params_spec(cfg)
    assert not drawn and spec["layers"]["attn"]["wq"].device.type == "meta"
    assert TL.seeded(0, torch.device("meta")) is None


def test_init_draws_each_weight_once():
    """One draw (one kernel launch on the card) a drawn weight, straight
    into the parameter: norms and biases are filled, not drawn."""
    cfg = reduced_config("qwen3-moe-30b-a3b")
    with prng.recording() as drawn:
        model = get_family(cfg).init(0, cfg, device="cpu")
    params = dict(model.named_parameters())
    ptrs = {p.data_ptr() for p in params.values()}
    assert all(t.data_ptr() in ptrs for t, _ in drawn)
    assert len(drawn) == len({t.data_ptr() for t, _ in drawn})
    assert len(drawn) == sum(1 for n in params if not n.endswith(("ln1", "ln2", "final_norm",
                                                                   "q_norm", "k_norm")))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_jax(arch):
    cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
    for key, (B, S) in ((0, (2, 40)), (3, (3, 17))):
        got = make_batch(cfg, B, S, key=key, device="cpu")
        want = jreg.make_batch(jcfg, B, S, jax.random.PRNGKey(key))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name]
            if name in ("tokens", "labels"):
                assert g.dtype == torch.int64
                g = g.to(torch.int32)
            assert _equal(g, np.asarray(w)), (arch, key, name)
    default = make_batch(cfg, 2, 24, device="cpu")
    assert torch.equal(default["tokens"], make_batch(cfg, 2, 24, key=prng.key(0),
                                                     device="cpu")["tokens"])


def _example():
    path = Path(__file__).resolve().parents[1] / "examples" / "transformer_udf_serving.py"
    spec = importlib.util.spec_from_file_location("_jax_transformer_udf_serving", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,column,seed", tus.UDFS)
def test_udf_initial_trees_match_the_example(arch, column, seed):
    """``init_udf_params`` against the JAX example's tree, rebuilt here as
    ``make_backbone_udf`` builds it (examples/transformer_udf_serving.py,
    the ``params`` dict): backbone from k1, proj and head normals times
    0.05 from k2 and k3."""
    mod = _example()
    jcfg = mod.reduced_config(arch).replace(remat=False)
    n_features, n_classes = 24, 5 + column
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = {
        "backbone": _jax_leaves(mod.get_family(jcfg).init(k1, jcfg)),
        "proj": jax.random.normal(k2, (n_features, mod.SEQ * jcfg.d_model)) * 0.05,
        "head": jax.random.normal(k3, (jcfg.d_model, n_classes)) * 0.05,
    }
    cfg = tus.udf_config(arch)
    got = tus.init_udf_params(cfg, n_features, n_classes, seed, device="cpu")
    assert _equal(got["proj"], np.asarray(want["proj"]))
    assert _equal(got["head"], np.asarray(want["head"]))
    named = leaves.stacked({n: p.detach() for n, p in got["backbone"].named_parameters()})
    assert sorted(named) == sorted(want["backbone"])
    assert all(_equal(named[p], w) for p, w in want["backbone"].items())
