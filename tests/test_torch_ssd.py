"""The port's SSD (``repro_torch.kernels.ssd_scan`` and ``kernels/ops.py::ssd``)
against the JAX package's on the CPU: the same numpy-seeded inputs go
through both.

Tolerances: ``ssd_chunk`` at atol = rtol = 1e-4 (y_diag, states) and 1e-5
(chunk_decay), and ``ops.ssd`` at 2e-4: the JAX package's own kernel tests
(``tests/test_kernels.py:81-83``, ``:106-107``), both sides in f32 summed in
other orders.  On the CPU ``ssd_chunk`` runs its plain version; the CUDA
kernel is held to that on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import ssd as jax_ops_ssd
from repro.kernels.ssd_scan import ssd_chunk as jax_ssd_chunk
from repro.models.ssm import ssd_chunked as jax_ssd_chunked

from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
from _one_thread import one_thread  # noqa: F401


CHUNK_TOL, DECAY_TOL, OPS_TOL = 1e-4, 1e-5, 2e-4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _chunk_inputs(nc, q, h, g, p, n, seed, dA_scale=0.1):
    """x, dA = -|N| * dA_scale, B, C (groups g) as numpy, as the JAX test
    draws them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(nc, q, h, p).astype(np.float32)
    dA = (-np.abs(rng.randn(nc, q, h)) * dA_scale).astype(np.float32)
    B = rng.randn(nc, q, g, n).astype(np.float32)
    C = rng.randn(nc, q, g, n).astype(np.float32)
    return x, dA, B, C


# the JAX test's shapes (tests/test_kernels.py:75) and G = 2 < H
CHUNK_CASES = [  # (nc, Q, H, G, P, N, dA scale)
    (2, 16, 4, 4, 8, 16, 0.1), (4, 64, 2, 2, 16, 32, 0.1), (3, 32, 6, 2, 8, 16, 0.1),
]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_ssd_chunk_matches_jax(case):
    nc, q, h, g, p, n, scale = case
    x, dA, B, C = _chunk_inputs(nc, q, h, g, p, n, seed=nc * q + h, dA_scale=scale)
    Bh, Ch = np.repeat(B, h // g, axis=2), np.repeat(C, h // g, axis=2)
    got = ssd_chunk(*(torch.from_numpy(a) for a in (x, dA, B, C)))
    kern = jax_ssd_chunk(*(jnp.asarray(a) for a in (x, dA, Bh, Ch)), interpret=True)
    oracle = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in (x, dA, Bh, Ch)))
    port_oracle = ref.ssd_chunk_ref(*(torch.from_numpy(a) for a in (x, dA, Bh, Ch)))
    for want in (kern, oracle, port_oracle):
        _close(got[0], want[0], CHUNK_TOL)
        _close(got[1], want[1], CHUNK_TOL)
        _close(got[2], want[2], DECAY_TOL)
    assert all(t.dtype == torch.float32 for t in got)


# Q = 256 (mamba2-2.7b's chunk), with a log-decay about as deep as the JAX
# init gives (-0.8 a step) and a shallow one, up to the serving widths
@pytest.mark.parametrize("case", [(16, 32, 0.8), (64, 128, 0.8), (64, 128, 0.01)])
def test_ssd_chunk_at_q256(case):
    """Held as ``chip_smoke.py`` holds the kernel: the largest difference
    over the tensor's largest value within 1e-4.  Element by element 1e-4
    is too tight at Q = 256 (the JAX test stops at 64): y_diag sums up to
    256 terms of size up to |C.B| ~ sqrt(N), so f32 summation-order noise
    reaches 1.5e-4 to 3e-4 in the few elements where they cancel."""
    P, N, scale = case
    x, dA, B, C = _chunk_inputs(2, 256, 2, 1, P, N, seed=11, dA_scale=scale)
    got = ssd_chunk(*(torch.from_numpy(a) for a in (x, dA, B, C)))
    want = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in (x, dA, np.repeat(B, 2, axis=2),
                                                         np.repeat(C, 2, axis=2))))
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= CHUNK_TOL * np.abs(b).max()
    _close(got[2], want[2], DECAY_TOL)


def test_ssd_chunk_bf16_widens_like_jax():
    x, dA, B, C = _chunk_inputs(2, 64, 4, 1, 16, 32, seed=5)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C)]
    got = ssd_chunk(tb[0], torch.from_numpy(dA), tb[1], tb[2])
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, B, C)]
    want = jax_ssd_chunk(jb[0], jnp.asarray(dA), jnp.repeat(jb[1], 4, axis=2),
                         jnp.repeat(jb[2], 4, axis=2), interpret=True)
    for a, b in zip(got, want):
        _close(a, b, CHUNK_TOL)


def test_ssd_chunk_takes_strided_slices():
    """B and C as slices of one wider projection pass without a copy and
    give what contiguous copies give."""
    x, dA, B, C = _chunk_inputs(2, 32, 4, 2, 8, 16, seed=9)
    wide = torch.from_numpy(np.concatenate([B.reshape(2, 32, 32), C.reshape(2, 32, 32)], -1))
    Bs = wide[..., :32].reshape(2, 32, 2, 16)
    Cs = wide[..., 32:].reshape(2, 32, 2, 16)
    assert not Bs.is_contiguous()
    got = ssd_chunk(torch.from_numpy(x), torch.from_numpy(dA), Bs, Cs)
    want = ssd_chunk(torch.from_numpy(x), torch.from_numpy(dA), torch.from_numpy(B),
                     torch.from_numpy(C))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_chunk_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(ssd_scan, "ssd_chunk_plain",
                        lambda *a: calls.append(1) or ssd_chunk_plain(*a))
    before = ssd_chunk.launches
    ssd_chunk(*(torch.from_numpy(a) for a in _chunk_inputs(1, 16, 2, 1, 8, 16, seed=0)))
    assert calls == [1] and ssd_chunk.launches == before


def _bad(kind):
    x, dA, B, C = (torch.from_numpy(a) for a in _chunk_inputs(2, 32, 4, 2, 8, 16, seed=1))
    return {
        "q_not_multiple_of_16": lambda: (x[:, :24], dA[:, :24], B[:, :24], C[:, :24]),
        "q_above_256": lambda: tuple(torch.cat([t] * 9, dim=1) for t in (x, dA, B, C)),
        "p_above_64": lambda: (torch.zeros(2, 32, 4, 65), dA, B, C),
        "n_above_128": lambda: (x, dA, torch.zeros(2, 32, 2, 129), torch.zeros(2, 32, 2, 129)),
        "groups_do_not_divide_heads": lambda: (x, dA, torch.zeros(2, 32, 3, 16),
                                               torch.zeros(2, 32, 3, 16)),
        "mixed_types": lambda: (x.to(torch.bfloat16), dA, B, C),
        "float64": lambda: (x.double(), dA, B.double(), C.double()),
        "dA_not_float32": lambda: (x, dA.double(), B, C),
        "x_heads_not_packed": lambda: (x.transpose(2, 3).contiguous().transpose(2, 3), dA, B, C),
    }[kind]()


@pytest.mark.parametrize("kind", ["q_not_multiple_of_16", "q_above_256", "p_above_64",
                                  "n_above_128", "groups_do_not_divide_heads", "mixed_types",
                                  "float64", "dA_not_float32", "x_heads_not_packed"])
def test_ssd_chunk_refuses(kind):
    with pytest.raises(ValueError):
        ssd_chunk(*_bad(kind))


def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)  # softplus
    A_log = (rng.randn(h) * 0.5).astype(np.float32)
    B = rng.randn(b, s, g, n).astype(np.float32)
    C = rng.randn(b, s, g, n).astype(np.float32)
    D = rng.randn(h).astype(np.float32)
    return x, dt, A_log, B, C, D


# the shapes of tests/test_kernels.py:90, then G = 2 and a deeper recurrence
@pytest.mark.parametrize("shape", [(2, 128, 4, 8, 1, 16, 32), (1, 96, 6, 8, 2, 16, 16),
                                   (2, 256, 2, 16, 1, 32, 64)])
def test_ops_ssd_matches_jax(shape):
    b, s, h, p, g, n, chunk = shape
    args = _ssd_inputs(b, s, h, p, g, n, seed=sum(shape))
    y, final = ops.ssd(*(torch.from_numpy(a) for a in args), chunk)
    for fn in (jax_ops_ssd, jax_ssd_chunked):
        wy, wf = fn(*(jnp.asarray(a) for a in args), chunk)
        _close(y, wy, OPS_TOL)
        _close(final, wf, OPS_TOL)
    assert y.dtype == torch.float32 and final.shape == (b, h, p, n)


def test_ops_ssd_refuses_a_ragged_sequence():
    args = _ssd_inputs(1, 40, 2, 8, 1, 16, seed=0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(*(torch.from_numpy(a) for a in args), 16)


def test_ops_ssd_chunk_length_does_not_change_the_result():
    """The SSD decomposition is exact for any chunk length (the check
    ``chip_smoke.py`` relies on when its reference ``forward`` takes a
    shorter chunk)."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(2, 128, 4, 8, 1, 16, seed=4)]
    y64, f64 = ops.ssd(*args, 64)
    y16, f16 = ops.ssd(*args, 16)
    torch.testing.assert_close(y16, y64, rtol=OPS_TOL, atol=OPS_TOL)
    torch.testing.assert_close(f16, f64, rtol=OPS_TOL, atol=OPS_TOL)
