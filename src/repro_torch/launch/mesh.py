"""Device meshes (the JAX package's ``launch/mesh.py``).

Every builder is a function, so importing this module touches no process
group: the dry run (``launch/dryrun.py``) sets up its fake world of 256 or
512 ranks first, tests their gloo world, the card a group of one.  Each
builds a ``DeviceMesh`` over the default process group's whole world and
raises when the world's size is not the mesh's: nothing shrinks a mesh to
fit.  ``device_type`` is the caller's: "cuda" on the card, "cpu" under gloo
or the fake group.

``AbstractMesh`` is a mesh's shape and axis names alone (JAX's
``jax.sharding.AbstractMesh``): the sharding rules (``distributed/
sharding.py``) read nothing else, so they run on it without processes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh(NamedTuple):
    """A mesh's ``shape`` and ``mesh_dim_names``, the two attributes of a
    ``DeviceMesh`` the sharding rules read."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _device_mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {math.prod(shape)} ranks; "
                           "none is initialized")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``."""
    shape, names = PRODUCTION[multi_pod]
    return _device_mesh(shape, names, device_type)


def make_dev_mesh(n_data: int = 2, n_model: int = 4, device_type: str = "cuda"):
    """A small ("data", "model") mesh for tests and the card."""
    return _device_mesh((n_data, n_model), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
