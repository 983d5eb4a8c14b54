"""The port's ``distributed/fault_tolerance.py`` against the JAX package's:
the heartbeat monitor and the straggler detector on the same injected
clocks and step times, the resilient runner through the same failures and
device-count changes (the same reports and checkpoints), and
``compress_int8`` / ``decompress_int8`` on the same numpy-seeded arrays,
bit for bit (both round half to even in f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as jft

from repro_torch.distributed import fault_tolerance as tft

PACKAGES = {"jax": jft, "torch": tft}


def _heartbeat_trace(ft):
    t = [0.0]
    mon = ft.HeartbeatMonitor(["h0", "h1"], timeout=10, clock=lambda: t[0])
    out = []
    t[0] = 5.0
    mon.beat("h0")
    t[0] = 12.0
    out.append(mon.dead_hosts())
    mon.beat("h1")
    out.append(mon.all_alive())
    t[0] = 25.5
    out.append(mon.dead_hosts())
    return out


def test_heartbeat_monitor_matches_reference():
    got = {name: _heartbeat_trace(ft) for name, ft in PACKAGES.items()}
    assert got["torch"] == got["jax"] == [["h1"], True, ["h0", "h1"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_matches_reference(seed):
    rng = np.random.RandomState(seed)
    dts = rng.uniform(0.8, 1.2, 40)
    dts[rng.choice(np.arange(8, 40), 4, replace=False)] *= 5.0  # planted stragglers
    out = {}
    for name, ft in PACKAGES.items():
        d = ft.StragglerDetector(threshold=2.0, warmup=3)
        flags = [d.observe(i, float(dt)) for i, dt in enumerate(dts)]
        out[name] = (flags, list(d.events), d.ewma)
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) == 4


def _resilient_run(ft):
    saved = {}
    fail_at = {7, 13}
    devices = [4]
    remeshed = []

    def step_fn(state, step):
        if step == 9:
            devices[0] = 2
        if step in fail_at:
            fail_at.remove(step)
            raise RuntimeError("simulated device loss")
        return state + 1

    def save_fn(step, state):
        saved["ckpt"] = (step, state)

    def remesh_fn(state, n):
        remeshed.append(n)
        return state

    save_fn(0, 0)
    ticks = iter(np.arange(0.0, 1000.0, 0.5))
    runner = ft.ResilientRunner(
        step_fn, save_fn, lambda: saved["ckpt"], remesh_fn=remesh_fn,
        device_count_fn=lambda: devices[0], checkpoint_every=5, max_restarts=3,
        clock=lambda: float(next(ticks)))
    state, report = runner.run(0, 20)
    return state, report.__dict__, remeshed, saved["ckpt"]


def test_resilient_runner_matches_reference():
    """The JAX package's restart + re-mesh case (one more failure): the
    same final state, report, re-meshes and last checkpoint."""
    got = {name: _resilient_run(ft) for name, ft in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    state, report, remeshed, ckpt = got["torch"]
    assert state == 20 and ckpt == (20, 20) and remeshed == [2]
    assert report["restarts"] == 2 and report["remeshes"] == 1


@pytest.mark.parametrize("shape,axis,seed", [((1, 8), -1, 0), ((17, 8), -1, 1),
                                             ((64, 8), -1, 2), ((5, 33), 0, 3),
                                             ((3, 4, 16), 1, 4)])
def test_compress_int8_matches_reference(shape, axis, seed):
    """Codes and scales bit for bit, the round trip within amax / 127
    (the JAX package's bound), on arrays with exact .5 ties planted."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.uniform(0.1, 10)).astype(np.float32)
    x.flat[0] = 0.0
    jq, js = jft.compress_int8(jnp.asarray(x), axis=axis)
    tq, ts = tft.compress_int8(torch.from_numpy(x), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rec = tft.decompress_int8(tq, ts).numpy()
    np.testing.assert_array_equal(rec, np.asarray(jft.decompress_int8(jq, js)))
    amax = np.abs(x).max(axis=axis, keepdims=True)
    assert np.all(np.abs(rec - x) <= amax / 127.0 + 1e-6)


def test_compress_int8_rounds_ties_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, scale = tft.compress_int8(x)
    jq, _ = jft.compress_int8(jnp.asarray(x.numpy()))
    assert float(scale) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]] == np.asarray(jq).tolist()
