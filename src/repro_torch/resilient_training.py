"""Fault-tolerant training of a reduced architecture with the whole training
substrate: the sharded data stream, AdamW, asynchronous checkpoints, a
simulated preemption with restart, and straggler detection.

    PYTHONPATH=src python -m repro_torch.resilient_training [--arch mamba2-2.7b] [--device cpu]

The flow of the JAX package's ``examples/resilient_training.py``: the
reduced config of ``--arch`` (every family) initialised from
``PRNGKey(0)`` (the JAX example's weights, ``util/prng.py``),
``make_train_step(cfg, lr=1e-3)``, a ``ShardedStream`` of batch 8 over a
``RandomState(0)`` token matrix of shape (4096, 33) (an encoder-decoder's
or a VLM's batch drawn whole by ``registry.make_batch(cfg, 8, 32 or 40,
PRNGKey(step))``, as the JAX example draws it), a ``Checkpointer(keep=2)``
saving asynchronously at step 0 and every 10 steps, a preemption before
step ``steps // 2`` answered by ``ResilientRunner`` from the latest
checkpoint, and a ``StragglerDetector(threshold=3.0)``.

One difference from the JAX example, deliberate: the checkpoint holds the
data cursor with the parameters and the optimizer state
(``launch.train.state_tree``), and a restart rewinds the stream to it, so a
restarted run replays the same batches and ends equal bit for bit to a run
without the preemption (the JAX example's iterator runs on, so its replayed
steps see later batches).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Cursor, ShardedStream
from repro_torch.distributed.fault_tolerance import ResilientRunner, StragglerDetector
from repro_torch.launch.train import load_state_tree, make_batch, state_tree
from repro_torch.training.train_loop import init_train_state, make_train_step
from repro_torch.util import resolve_device

ROWS, SEQ, BATCH = 4096, 32, 8
CKPT_EVERY = 10
LR = 1e-3


class Preemption(RuntimeError):
    """The simulated failure before step ``steps // 2``."""


def tokens_for(cfg) -> np.ndarray:
    """The stream's (ROWS, SEQ + 1) int32 token matrix."""
    rng = np.random.RandomState(0)
    return rng.randint(0, cfg.vocab_size, size=(ROWS, SEQ + 1)).astype(np.int32)


def run(arch: str = "deepseek-67b", steps: int = 30, *, device="cuda", preempt: bool = True,
        ckpt_every: int = CKPT_EVERY, init=None, log=print) -> dict:
    """Train ``reduced_config(arch)`` for ``steps`` steps through
    ``ResilientRunner``, preempted once before step ``steps // 2`` when
    ``preempt``.  ``init``: (params, optimizer state) to start from instead
    of ``init_train_state(cfg, PRNGKey(0))`` (how a JAX package's state is
    carried across).  Checkpoints go under a temporary directory.  Returns {"cfg", "params", "opt", "losses" (a
    (step, loss) pair for every step run, replays included), "report",
    "restored_from", "seconds"}."""
    dev = resolve_device(device)
    cfg = reduced_config(arch)
    train_step = make_train_step(cfg, lr=LR)
    params, opt = init if init is not None else init_train_state(cfg, 0, dev)
    stream = ShardedStream(tokens_for(cfg), batch=BATCH, seed=0)
    live = {"opt": opt, "it": iter(stream), "armed": preempt}
    losses, restored = [], []

    with tempfile.TemporaryDirectory(prefix="ckpt_") as tmp:
        ck = Checkpointer(Path(tmp), keep=2)

        def step_fn(state, step):
            if step == steps // 2 and live["armed"]:
                live["armed"] = False
                raise Preemption(f"simulated preemption before step {step}")
            batch = make_batch(cfg, next(live["it"]), step, dev)
            _, live["opt"], m = train_step(params, live["opt"], batch)
            losses.append((step, float(m["loss"])))
            return params, live["opt"], stream.cursor.as_dict()

        def save_fn(step, state):
            ck.save(step, state_tree(*state), blocking=False)
            log(f"  checkpoint @ step {step}")

        def restore_fn():
            ck.wait()  # a save still being written is the latest
            step = ck.latest_step()
            like = state_tree(params, live["opt"], stream.cursor.as_dict(), device="meta")
            live["opt"], cursor = load_state_tree(ck.restore(like, step), params, live["opt"])
            stream.cursor = Cursor.from_dict(cursor)
            live["it"] = iter(stream)
            restored.append(step)
            log(f"  RESTORED from step {step}")
            return step, (params, live["opt"], stream.cursor.as_dict())

        t0 = time.perf_counter()
        save_fn(0, (params, opt, stream.cursor.as_dict()))
        runner = ResilientRunner(step_fn, save_fn, restore_fn, checkpoint_every=ckpt_every,
                                 straggler=StragglerDetector(threshold=3.0))
        _, report = runner.run((params, opt, stream.cursor.as_dict()), steps)
        ck.wait()
        seconds = time.perf_counter() - t0
    log(f"\narch={arch}: {report.steps_done} steps, {report.restarts} restart(s), "
        f"{report.straggler_events} straggler event(s)")
    log(f"loss: {losses[0][1]:.3f} -> {losses[-1][1]:.3f} "
        f"(ewma step time {report.final_step_time_ewma * 1e3:.0f} ms)")
    return dict(cfg=cfg, params=params, opt=live["opt"], losses=losses, report=report,
                restored_from=restored, straggler_steps=list(runner.straggler.events),
                seconds=seconds)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-67b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, args.steps, device=args.device)


if __name__ == "__main__":
    main()
