"""Training launcher on the card: any architecture of ``configs/archs.py``
(dense, MoE / MLA, SSM, hybrid, encoder-decoder, VLM), reduced or at full
width, with the JAX package's resilience substrate (checkpoint and restart
through ``ResilientRunner``, straggler detection).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-67b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-67b --full \\
        --layers 2 --batch 4 --seq 4096 --steps 4 --ckpt-every 0
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 [--resume]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b --device cpu \\
        --layers 2 --steps 3 --ckpt-every 0

The JAX package's flags (``repro/launch/train.py``), plus ``--device``
(CUDA by default: raises without a card; ``cpu`` runs every kernel's plain
version), ``--layers`` (cut the depth, an encoder-decoder's encoder too, so that a
full-width config fits one card), ``--ckpt-every 0`` (no checkpoints) and ``--fail-at STEP`` (a
simulated preemption before that step, once: the runner restores the last
checkpoint, rewinds the data cursor and goes on).  The default ``--arch``
is deepseek-67b (the JAX launcher's default is mamba2-2.7b).

The weights are the JAX launcher's, ``init_train_state(cfg, PRNGKey(0))``
(``util/prng.py``: threefry2x32, on the card by the ``threefry`` kernel).
The batch is the JAX launcher's too: for the dense, MoE, SSM and hybrid
families ``--batch`` sequences of ``--seq`` tokens from a stream of 8,192
random sequences drawn by ``np.random.RandomState(0)`` (``data/pipeline.py``);
an encoder-decoder's or a VLM's whole batch (tokens, labels, frames or
patches) is ``registry.make_batch(cfg, batch, seq, PRNGKey(step))``.  Each
is cut into ``cfg.accum_steps`` micro-batches.
The checkpointed state is (params, optimizer state, cursor) in the JAX
package's layout (``models/leaves.py``), so each package reads the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import Cursor, ShardedStream
from repro_torch.distributed.fault_tolerance import ResilientRunner, StragglerDetector
from repro_torch.models import leaves
from repro_torch.models import registry
from repro_torch.models.registry import _token_len
from repro_torch.training import optim
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.util import prng, resolve_device

DATA_ROWS = 8192


class Preemption(RuntimeError):
    """The simulated failure ``--fail-at`` injects."""


def state_tree(params, opt, cursor: dict, device="cpu"):
    """(params, optimizer state, cursor) in the JAX package's layout, every
    tensor on ``device`` (the host for a save, "meta" for a restore's
    template)."""
    named = {n: p.detach() for n, p in params.named_parameters()}

    def tree(flat_named):
        return leaves.nest(leaves.stacked({n: t.to(device) for n, t in flat_named.items()}))

    step = torch.tensor(opt.step, dtype=torch.int32)
    if isinstance(opt, optim.AdafactorState):
        o = optim.AdafactorState(
            step=step, vr=leaves.nest({k: v.to(device) for k, v in opt.vr.items()}),
            vc=leaves.nest({k: v.to(device) for k, v in opt.vc.items()}))
    else:
        o = optim.AdamWState(step=step, mu=tree(opt.mu), nu=tree(opt.nu))
    return tree(named), o, dict(cursor)


@torch.no_grad()
def load_state_tree(tree, params, opt):
    """Copy a restored ``state_tree`` into ``params`` and ``opt`` in place;
    returns (optimizer state, cursor dict)."""
    p_tree, o_tree, cursor = tree
    leaves.unstack_into(leaves.flat(p_tree), dict(params.named_parameters()))
    step = int(o_tree.step)
    if isinstance(opt, optim.AdafactorState):
        for mine, theirs in ((opt.vr, o_tree.vr), (opt.vc, o_tree.vc)):
            for k, v in leaves.flat(theirs).items():
                mine[k].copy_(v)
        opt = opt._replace(step=step)
    else:
        leaves.unstack_into(leaves.flat(o_tree.mu), opt.mu)
        leaves.unstack_into(leaves.flat(o_tree.nu), opt.nu)
        opt = opt._replace(step=step)
    return opt, {k: int(v) for k, v in cursor.items()}


def make_data(cfg, seq: int, rows: int = DATA_ROWS, seed: int = 0) -> np.ndarray:
    """(rows, S + 1) int32 token sequences, S = ``seq`` less a VLM's patch
    prefix, from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, size=(rows, _token_len(cfg, seq) + 1)).astype(np.int32)


def make_batch(cfg, seqs: np.ndarray, step: int, device) -> dict:
    """Step ``step``'s batch from the stream's ``seqs`` (B, S + 1): tokens and
    next-token labels; for an encoder-decoder or a VLM instead
    ``registry.make_batch(cfg, B, seq, PRNGKey(step))``, the JAX launchers'
    batch, at the sequence length ``seq`` whose text is S tokens."""
    if cfg.family in ("encdec", "vlm"):
        seq = seqs.shape[1] - 1 + (cfg.encoder.num_prefix if cfg.family == "vlm" else 0)
        return registry.make_batch(cfg, seqs.shape[0], seq, prng.key(step), device)
    tokens = torch.from_numpy(seqs.astype(np.int64))
    return {"tokens": tokens[:, :-1].to(device), "labels": tokens[:, 1:].to(device)}


def with_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers; an encoder-decoder's encoder stack
    to the same count."""
    if cfg.encoder is not None and cfg.encoder.num_layers:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, num_layers=layers))
    return cfg.replace(num_layers=layers)


def run(cfg, *, steps: int, batch: int, seq: int, lr: float = 1e-3, device="cuda",
        ckpt_dir="checkpoints", ckpt_every: int = 20, resume: bool = False,
        fail_at: Optional[int] = None, data: Optional[np.ndarray] = None,
        log: Callable[[str], None] = print) -> dict:
    """Train ``cfg`` for ``steps`` global steps through ``ResilientRunner``.
    ``data`` replaces the seeded stream's sequences.  Returns {"params",
    "opt", "report", "losses" ({step: loss}), "step_s" (host seconds of each
    step, the loss read included), "start", "seconds"}."""
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, lr=lr)
    params, opt = init_train_state(cfg, 0, dev)
    log(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
        f"params~{sum(p.numel() for p in params.parameters()) / 1e6:.1f}M "
        f"opt={cfg.optimizer} accum={cfg.accum_steps} remat={cfg.remat} device={dev}")
    stream = ShardedStream(make_data(cfg, seq) if data is None else data, batch=batch, seed=0)
    ck = Checkpointer(Path(ckpt_dir) / cfg.name, keep=3) if ckpt_every else None
    live = {"opt": opt, "it": None, "failed": False}
    losses, step_s = {}, []
    start = 0

    def restore():
        ck.wait()  # a save still being written is the latest
        step = ck.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ck.dir} to restart from")
        like = state_tree(params, live["opt"], stream.cursor.as_dict(), device="meta")
        live["opt"], cursor = load_state_tree(ck.restore(like, step), params, live["opt"])
        stream.cursor = Cursor.from_dict(cursor)
        live["it"] = iter(stream)
        return step

    if resume and ck is not None and ck.latest_step() is not None:
        start = restore()
        log(f"resumed from step {start}")
    live["it"] = live["it"] or iter(stream)

    def run_step(state, step):
        if fail_at is not None and step == fail_at and not live["failed"]:
            live["failed"] = True
            raise Preemption(f"simulated preemption before step {step}")
        t0 = time.perf_counter()
        b = make_batch(cfg, next(live["it"]), step, dev)
        _, live["opt"], m = step_fn(params, live["opt"], b)
        losses[step] = float(m["loss"])
        step_s.append(time.perf_counter() - t0)
        if step % 10 == 0:
            log(f"  step {step}: loss {losses[step]:.4f}")
        return (params, live["opt"], stream.cursor.as_dict())

    def save(step, state):
        if ck is not None:
            ck.save(step, state_tree(*state))

    def restore_fn():
        if ck is None:  # no checkpoints: the failed step's own error stands
            raise
        step = restore()
        log(f"restarted from step {step}")
        return step, (params, live["opt"], stream.cursor.as_dict())

    runner = ResilientRunner(run_step, save, restore_fn, checkpoint_every=ckpt_every or steps + 1,
                             straggler=StragglerDetector())
    t0 = time.perf_counter()
    _, report = runner.run((params, live["opt"], stream.cursor.as_dict()), steps,
                           start_step=start)
    if ck is not None:
        ck.wait()
    seconds = time.perf_counter() - t0
    log(f"done: {report.steps_done} steps in {seconds:.1f}s ({report.restarts} restarts, "
        f"{report.straggler_events} stragglers)")
    return {"params": params, "opt": live["opt"], "report": report, "losses": losses,
            "step_s": step_s, "start": start, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a ported architecture on the card.")
    ap.add_argument("--arch", default="deepseek-67b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true", help="the published config's widths")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=20, help="0: no checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a preemption before this step, once")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if args.layers is not None:
        cfg = with_depth(cfg, args.layers)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               device=args.device, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               resume=args.resume, fail_at=args.fail_at)


if __name__ == "__main__":
    main()
