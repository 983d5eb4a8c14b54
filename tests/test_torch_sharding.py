"""The port's sharding rules against the JAX package's, with no processes:
every leaf's spec from ``repro_torch.distributed.sharding`` equals the
``PartitionSpec`` that ``repro.distributed.sharding`` gives on a JAX
``AbstractMesh`` of the same shape, for every architecture, mode and mesh;
the same for optimizer states, batches and decode caches; and the port's
``registry.params_spec`` / ``input_specs`` (meta tensors) have the JAX
package's shapes and dtypes."""
import functools

import jax
import numpy as np
import pytest
import torch
from _one_thread import one_thread  # noqa: F401
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import SHAPES as J_SHAPES, get_config as j_get_config
from repro.configs.registry import ARCHS
from repro.distributed import sharding as jsh
from repro.models import registry as jreg
from repro.training.train_loop import init_opt_state as j_init_opt_state
from repro_torch.configs import SHAPES, get_config, supports_shape
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import AbstractMesh as TMesh
from repro_torch.models import leaves, registry as treg
from repro_torch.training import optim

ARCH_NAMES = sorted(ARCHS)
MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((4, 2), ("data", "model")), ((1, 1), ("data", "model")))
MODES = ("train", "serve_tp", "serve_2d")


def _meshes():
    for shape, names in MESHES:
        yield AbstractMesh(shape, names), TMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _specs(arch):
    """(JAX abstract params, port meta params) of the published config."""
    return jreg.params_spec(j_get_config(arch)), treg.params_spec(get_config(arch))


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {jsh._names_of(path): leaf for path, leaf in flat}


def _port_leaves(tree) -> dict:
    out = {}
    tsh.tree_map_with_names(lambda names, leaf: out.setdefault(names, leaf), tree)
    return out


def _spec_mismatches(j_sh, t_sh) -> list:
    j, t = _jax_leaves(j_sh), _port_leaves(t_sh)
    assert set(j) == set(t), sorted(set(j) ^ set(t))[:8]
    return [(n, tuple(j[n].spec), t[n].spec) for n in j if tuple(j[n].spec) != t[n].spec]


def _dtype(x) -> str:
    return str(x).removeprefix("torch.") if isinstance(x, torch.dtype) else np.dtype(x).name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_spec_shapes_and_dtypes_equal_jax(arch):
    j, t = _specs(arch)
    jl, tl = _jax_leaves(j), _port_leaves(t)
    assert set(jl) == set(tl), sorted(set(jl) ^ set(tl))[:8]
    for n in jl:
        assert tuple(jl[n].shape) == tuple(tl[n].shape), n
        assert _dtype(jl[n].dtype) == _dtype(tl[n].dtype), n
        assert tl[n].device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shardings_equal_jax(arch):
    j, t = _specs(arch)
    for jm, tm in _meshes():
        for mode in MODES:
            bad = _spec_mismatches(jsh.params_shardings(j, jm, mode),
                                   tsh.params_shardings(t, tm, mode))
            assert not bad, (tm, mode, bad[:5])


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_opt_shardings_equal_jax(arch, optimizer):
    jcfg = j_get_config(arch).replace(optimizer=optimizer)
    j, t = _specs(arch)
    j_opt = jax.eval_shape(lambda: j_init_opt_state(jcfg, j))
    flat = leaves.flat(t)
    t_opt = optim.adafactor_init(flat) if optimizer == "adafactor" else optim.adamw_init(flat)
    for jm, tm in _meshes():
        bad = _spec_mismatches(jsh.opt_shardings(j_opt, jm), tsh.opt_shardings(t_opt, tm))
        assert not bad, (tm, bad[:5])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_and_batch_and_cache_shardings_equal_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    n_shapes = 0
    for name, shape in SHAPES.items():
        if not supports_shape(tcfg, shape):
            continue
        n_shapes += 1
        j = jreg.input_specs(jcfg, J_SHAPES[name])
        t = treg.input_specs(tcfg, shape)
        jl, tl = _jax_leaves(j), _port_leaves(t)
        if shape.kind == "decode":
            # the cache's position: a JAX int32 scalar, the port's a python int
            assert tl.pop(("cache", "pos")) == 0 and jl.pop(("cache", "pos")).shape == ()
        assert set(jl) == set(tl), (name, sorted(set(jl) ^ set(tl)))
        for n in jl:
            assert tuple(jl[n].shape) == tuple(tl[n].shape), (name, n)
            assert _dtype(jl[n].dtype) == _dtype(tl[n].dtype), (name, n)
        for jm, tm in _meshes():
            if shape.kind == "decode":
                bad = _spec_mismatches(jsh.cache_sharding(j["cache"], jm),
                                       tsh.cache_sharding(t["cache"], tm))
                bad += _spec_mismatches(jsh.batch_sharding({"tokens": j["tokens"]}, jm),
                                        tsh.batch_sharding({"tokens": t["tokens"]}, tm))
            else:
                bad = _spec_mismatches(jsh.batch_sharding(j, jm), tsh.batch_sharding(t, tm))
            assert not bad, (name, tm, bad[:5])
    assert n_shapes >= 3


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_mode_for_equals_jax(arch):
    for jm, tm in _meshes():
        assert jsh.serve_mode_for(j_get_config(arch), jm) == tsh.serve_mode_for(
            get_config(arch), tm), tm


CASES = (  # tests/test_distribution.py's five rule asserts, on its (2, 4) mesh
    (("layers", "attn", "wq"), (4, 64, 32), "train", P(None, "data", "model")),
    (("layers", "attn", "wo"), (4, 32, 64), "train", P(None, "model", "data")),
    (("layers", "attn", "wq"), (4, 63, 31), "train", P(None, None, None)),
    (("embed",), (256, 64), "serve_tp", P("model", None)),
    (("experts", "wg"), (4, 8, 64, 32), "serve_tp", P(None, "model", None, None)),
)


@pytest.mark.parametrize("names,shape,mode,want", CASES)
def test_hand_written_rules(names, shape, mode, want):
    jm, tm = AbstractMesh((2, 4), ("data", "model")), TMesh((2, 4), ("data", "model"))
    assert jsh.param_spec(names, shape, jm, mode) == want
    assert tsh.param_spec(names, shape, tm, mode) == tuple(want)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m3 = TMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements((None, ("pod", "data"), "model"), m3) == [Shard(1), Shard(1), Shard(2)]
    assert tsh.placements((), m3) == [Replicate()] * 3
    m2 = TMesh((16, 16), ("data", "model"))
    assert tsh.placements(("model", None), m2) == [Replicate(), Shard(0)]
