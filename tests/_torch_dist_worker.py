"""One rank of ``test_torch_distribution.py``'s 4-rank gloo job: the port's
train step, ``flash_attention``, ``compressed_psum``, ``moe_apply_ep`` and
the elastic restore under device meshes.  It reads ``inputs.pt`` from the
work directory and rank 0 writes ``results.pt``; it imports torch and the
port alone."""
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

LR = 1e-3


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _train(inp, mesh) -> dict:
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (batch_sharding, distribute, opt_shardings,
                                                  params_shardings)
    from repro_torch.training.train_loop import init_leaf_opt_state, make_sharded_train_step

    cfg = reduced_config("llama3-405b").replace(dtype="float32", accum_steps=2)
    plain = {k: v.clone() for k, v in inp["leaves"].items()}  # the step updates them in place
    params = distribute(plain, params_shardings(plain, mesh, "train"), requires_grad=True)
    opt_plain = init_leaf_opt_state(cfg, plain)
    opt = distribute(opt_plain, opt_shardings(opt_plain, mesh))
    batch = distribute(inp["batch"], batch_sharding(inp["batch"], mesh))
    with ctx.use_mesh(mesh):
        params, opt, m = make_sharded_train_step(cfg, lr=LR)(params, opt, batch)
    return {"loss": float(_full(m["loss"])),
            "params": {k: _full(v).detach() for k, v in params.items()},
            "mu": {k: _full(v) for k, v in opt.mu.items()},
            "placements": {k: [str(p) for p in v.placements] for k, v in params.items()}}


def _flash(inp, mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements
    from repro_torch.kernels.flash_attention import flash_attention

    out = {}
    for name, (q, k, v, dout) in inp["flash"].items():
        spec = placements(("data", None, None, None), mesh)  # batch over data; heads by the wrapper
        dq, dk, dv = (distribute_tensor(t, mesh, spec).requires_grad_(True) for t in (q, k, v))
        o = flash_attention(dq, dk, dv, causal=True)
        g = torch.autograd.grad(o, (dq, dk, dv), distribute_tensor(dout, mesh, o.placements))
        out[name] = {"out": _full(o).detach(), "grads": [_full(x) for x in g],
                     "placements": [str(p) for p in o.placements]}
    return out


def _psum_and_moe(inp, mesh) -> dict:
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import ctx
    from repro_torch.distributed.fault_tolerance import compressed_psum
    from repro_torch.models import moe

    rank = mesh.get_local_rank("model")
    summed, residual = compressed_psum(inp["psum"][rank], "model", mesh)
    residuals = [torch.empty_like(residual) for _ in range(mesh.size())]
    dist.all_gather(residuals, residual)
    cfg = reduced_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    p = moe.Experts(cfg, device="cpu")
    with torch.no_grad():
        for name in ("router", "wg", "wi", "wo"):
            getattr(p, name).copy_(inp["moe"][name])
    with ctx.use_mesh(mesh, ep=True), torch.no_grad():
        o, aux = moe.moe_apply_ep(p, cfg, inp["moe"]["x"])
    return {"psum": {"summed": summed, "residual": torch.stack(residuals)},
            "moe": {"out": _full(o), "aux": float(_full(aux))}}


def _elastic(inp, work: Path, mesh) -> dict:
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.launch.mesh import make_dev_mesh

    tree = inp["leaves"]
    ck = Checkpointer(work / "ckpt", async_save=False)
    if dist.get_rank() == 0:
        ck.save(1, tree)
    dist.barrier()
    mesh2 = make_dev_mesh(4, 1, device_type="cpu")
    shardings = params_shardings(tree, mesh2, "train")
    restored = Checkpointer(work / "ckpt", async_save=False).restore(tree, 1, shardings=shardings)
    full = {k: _full(restored[k]) for k in tree}  # every rank joins every gather
    return {"equal": all(torch.equal(full[k], tree[k]) for k in tree),
            "placements_ok": all(list(restored[k].placements) == shardings[k].placements
                                 and restored[k].device_mesh.shape == (4, 1) for k in tree),
            "sharded": sum(any(p.is_shard() for p in restored[k].placements)
                           for k in tree)}


def run(rank: int, world: int, init_file: str, work: str) -> None:
    from repro_torch.launch.mesh import make_dev_mesh

    torch.set_num_threads(1)
    work = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        inp = torch.load(work / "inputs.pt", weights_only=False)
        mesh22 = make_dev_mesh(2, 2, device_type="cpu")
        mesh14 = make_dev_mesh(1, 4, device_type="cpu")
        out = {"train": _train(inp, mesh22), "flash": _flash(inp, mesh22),
               **_psum_and_moe(inp, mesh14), "elastic": _elastic(inp, work, mesh22)}
        if rank == 0:
            torch.save(out, work / "results.pt")
    except Exception:
        (work / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
