"""The rounding argument behind the tensor-core ``ssd_chunk`` backward,
emulated in plain torch on the CPU: an emulation, not the kernel, which runs
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``
``ssd_bwd_kernels``).

The route takes bf16 x, B and C, exact as one bf16 piece each; every f32
operand of a product enters as bf16 hi + lo (``hopper::split_bf16``, |v - hi
- lo| <= 2^-17 |v|), and each product is the sum of its pieces' products,
each exact in f32, small terms first:

    v      = B dst^T                  B.dst_lo + B.dst_hi
    dM^T   = x dy^T                   x.dy_lo + x.dy_hi
    dx     = w v + M^T dy             M_lo.dy_hi + M_hi.dy_lo + M_hi.dy_hi
    state  = sum_h (w x) dst          (wx)_lo.dst_hi + (wx)_hi.dst_lo + (wx)_hi.dst_hi
    dB     = (sum dS)^T C + state     dS_lo.C + dS_hi.C
    dC     = (sum dS) B               f32 (the CUDA-core kernel)

with M = S * L (S = C B^T in f32), L and w from the kernel's warp-scan
cumsum, G = dM * M summed by rows and columns in f32, and dS = dM * L summed
over the group's heads in head order.  Sums here are torch's f32 sums in its
own order (the kernel's tensor cores truncate theirs; only the card shows
that).  Held against ``ssd_chunk_backward_plain`` and ``jax.vjp`` of the JAX
package's ``repro.kernels.ref.ssd_chunk_ref`` under the card limits
(``chip_smoke.SSD_BWD_TOL``: one bf16 step, 2^-7, of each gradient's largest
value for dx, dB and dC; ``SSD_BWD_DDA_TOL``, 1e-4, for ddA).
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import ssd_chunk_backward_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_ssd_tc import _route_case, _warp_scan_cumsum  # noqa: E402
from _one_thread import one_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
NAMES = chip_smoke.SSD_BWD_NAMES


@pytest.fixture(scope="module", autouse=True)
def quick_compiles():
    """XLA's cheaper compile pipeline for this module's one-off programs
    (restored afterwards): compiling, not running, is their cost here."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


def _inputs(nc, q, h, g, p, n, kind, seed):
    """Numpy-seeded bf16 x, B, C, f32 dA ("jax_test" -|N(0,1)| 0.1, the JAX
    test's; "published" -A dt over Mamba-2's published ranges; "jax_init"
    -softplus(N(0,1)), the JAX package's init) and the f32 output
    gradients dy, dstates, ddecay."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x, B, C = (rng.randn(*s).astype(f) for s in ((nc, q, h, p), (nc, q, g, n), (nc, q, g, n)))
    z = rng.randn(nc, q, h).astype(f)
    if kind == "jax_test":
        dA = -np.abs(z) * 0.1
    elif kind == "jax_init":
        dA = -np.logaddexp(0.0, z)
    else:
        A_log, dt_bias = (a[0] for a in chip_smoke.published_dynamics(1, h, seed))
        dA = -np.exp(A_log) * np.logaddexp(0.0, z + dt_bias)
    grads = (rng.randn(nc, q, h, p), rng.randn(nc, h, p, n), rng.randn(nc, h))
    x, B, C = (torch.from_numpy(a).to(BF16) for a in (x, B, C))
    return (x, torch.from_numpy(dA.astype(f)), B, C,
            *(torch.from_numpy(a.astype(f)) for a in grads))


def _split(t):
    """bf16 hi and lo of an f32 tensor, widened back to f32."""
    hi = t.to(BF16).float()
    return hi, (t - hi).to(BF16).float()


def _tc_backward_emulation(x, dA, B, C, dy, dst, ddec, drop=None):
    """The tensor-core route's arithmetic (module docstring); ``drop``
    leaves one piece or term out: "dM:dy_lo", "v:dst_lo", "dx:M_lo",
    "dx:dy_lo", "state:wx_lo", "state:dst_lo" or "dB:dS_lo".  Returns (dx,
    ddA, dB, dC) as the kernel does."""
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    keep = lambda name: drop != name  # noqa: E731
    xf = x.float().reshape(nc, Q, G, rep, P)
    Bf, Cf = B.float(), C.float()
    cum = _warp_scan_cumsum(dA.transpose(1, 2)).reshape(nc, G, rep, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), torch.zeros(()))
    w = torch.exp(cum[..., -1:] - cum)  # (nc, G, rep, Q)
    w_tok = w.permute(0, 3, 1, 2)[..., None]  # (nc, Q, G, rep, 1)
    S = torch.einsum("cqgn,csgn->cgqs", Cf, Bf)
    M = S[:, :, None] * L  # (nc, G, rep, Q(i), Q(j))
    dyh, dyl = _split(dy.reshape(nc, Q, G, rep, P))
    dsth, dstl = _split(dst.reshape(nc, G, rep, P, N))
    v = torch.einsum("csgn,cgrpn->csgrp", Bf, dstl) if keep("v:dst_lo") else 0
    v = v + torch.einsum("csgn,cgrpn->csgrp", Bf, dsth)
    dM = torch.einsum("cqgrp,csgrp->cgrqs", dyl, xf) if keep("dM:dy_lo") else 0
    dM = dM + torch.einsum("cqgrp,csgrp->cgrqs", dyh, xf)
    Mh, Ml = _split(M)
    dx = w_tok * v
    if keep("dx:M_lo"):
        dx = dx + torch.einsum("cgrqs,cqgrp->csgrp", Ml, dyh)
    if keep("dx:dy_lo"):
        dx = dx + torch.einsum("cgrqs,cqgrp->csgrp", Mh, dyl)
    dx = dx + torch.einsum("cgrqs,cqgrp->csgrp", Mh, dyh)
    Gm = torch.where(torch.tril(torch.ones((Q, Q), dtype=torch.bool), -1), dM * M,
                     torch.zeros(()))
    u = w * (xf * v).sum(dim=-1).permute(0, 2, 3, 1)
    dcum = Gm.sum(dim=-1) - Gm.sum(dim=-2) - u
    last = u.sum(dim=-1) + ddec.reshape(nc, G, rep) * torch.exp(cum[..., -1])
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], dim=-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    dS = torch.zeros((nc, G, Q, Q))
    for r in range(rep):  # head order
        dS = dS + dM[:, :, r] * L[:, :, r]
    xwh, xwl = _split(xf * w_tok)
    state = torch.zeros((nc, Q, G, N))
    for r in range(rep):
        for a, b, name in ((xwl, dsth, "state:wx_lo"), (xwh, dstl, "state:dst_lo"),
                           (xwh, dsth, None)):
            if name is None or keep(name):
                state = state + torch.einsum("csgp,cgpn->csgn", a[:, :, :, r], b[:, :, r])
    dSh, dSl = _split(dS)
    dB = torch.einsum("cgqs,cqgn->csgn", dSl, Cf) if keep("dB:dS_lo") else 0
    dB = dB + torch.einsum("cgqs,cqgn->csgn", dSh, Cf) + state
    dC = torch.einsum("cgqs,csgn->cqgn", dS, Bf)
    ddA = ddA.reshape(nc, H, Q).transpose(1, 2).contiguous()
    return dx.reshape(nc, Q, H, P).to(BF16), ddA, dB.to(BF16), dC.to(BF16)


def _jax_vjp(x, dA, B, C, dy, dst, ddec):
    """``jax.vjp`` of the JAX package's chunk reference on the f32 values
    of the same inputs; its B and C are broadcast to the heads, so a
    group's gradient is the sum over its heads."""
    nc, q, h, _ = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    arrays = [t.float().numpy() for t in (x, dA, B, C)]
    arrays[2:] = [np.repeat(a, rep, 2) for a in arrays[2:]]
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *(jnp.asarray(a) for a in arrays))
    jdx, jdA, jdB, jdC = vjp(tuple(jnp.asarray(t.numpy()) for t in (dy, dst, ddec)))
    group = functools.partial(np.sum, axis=3)
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in (
        jdx, jdA, group(np.asarray(jdB).reshape(nc, q, g, rep, n)),
        group(np.asarray(jdC).reshape(nc, q, g, rep, n))))


CASES = [  # (nc, Q, H, G, P, N, dA kind)
    (2, 64, 4, 1, 64, 64, "jax_test"), (2, 128, 4, 2, 32, 128, "published"),
    (1, 256, 4, 1, 64, 128, "published"), (2, 80, 6, 3, 16, 16, "jax_test"),
    (1, 256, 2, 1, 16, 32, "jax_init"),
]


@pytest.mark.parametrize("case", CASES, ids=[f"Q{c[1]}-P{c[4]}-N{c[5]}-{c[6]}" for c in CASES])
def test_tensor_core_rounding_within_the_card_limits(case):
    """The emulation within the card check's limits of the plain formulas
    (the on-card reference); ddA, where the pieces matter, well inside its
    1e-4.  At Q 64 and 80 also within them of ``jax.vjp`` of the JAX
    package's reference (two compiles, the module's cost; at Q 256 with
    these log-decays the reference's ddA is NaN: it takes exp of every (i,
    j) difference, which overflows above the diagonal, and its gradient
    meets inf * 0 there)."""
    args = _inputs(*case, seed=sum(case[:6]))
    got = _tc_backward_emulation(*args)
    errs = chip_smoke.check_ssd_bwd_output(f"{case} vs plain", got,
                                           ssd_chunk_backward_plain(*args), "bfloat16")
    assert errs["ddA"] <= chip_smoke.SSD_BWD_DDA_TOL / 5, errs
    if case[1] <= 80:
        jerrs = chip_smoke.ssd_bwd_errors(got, _jax_vjp(*args))
        assert chip_smoke.ssd_bwd_within(jerrs, "bfloat16"), jerrs


SEEN = ["dM:dy_lo", "v:dst_lo"]


@pytest.mark.parametrize("drop", SEEN)
def test_one_piece_fewer_misses_the_limit(drop):
    """dy's and dst's lo pieces reach ddA (through G = dM M and u = w x.v),
    whose f32 limit sees either dropped: they read 3.1e-3 and 2.9e-4 of
    ddA's largest value here, against 1e-4 (with every term: 2.7e-6).  The
    other single pieces and terms move only the bf16 outputs, by less than
    their limit of one bf16 step (2^-7 = 7.8e-3 of the largest value), so
    no single one of them can be seen: dropping dx's M_lo or dy_lo term
    reads 7.3e-3 and 3.6e-3 of dx (1.8e-3 with every term), the state
    term's (w x)_lo or dst_lo, or dB's dS_lo, 4.3e-3 of dB (2.1e-3 with
    every term).  The route keeps them: at 2^-17 of a term apiece they move
    each output by far less than one rounding of it."""
    args = _inputs(1, 256, 4, 1, 64, 128, "published", seed=3)
    want = ssd_chunk_backward_plain(*args)
    errs = chip_smoke.ssd_bwd_errors(_tc_backward_emulation(*args, drop=drop), want)
    assert errs["ddA"] > chip_smoke.SSD_BWD_DDA_TOL, errs
    assert not chip_smoke.ssd_bwd_within(errs, "bfloat16")


@pytest.mark.parametrize("kind,want", [
    ("bf16", "tensor_cores"), ("sliced", "tensor_cores"), ("float32", "cuda_cores"),
    ("p_8", "cuda_cores"), ("n_48", "cuda_cores"), ("x_misaligned", "cuda_cores"),
    ("sliced_odd_stride", "cuda_cores"), ("f32_p_8", "cuda_cores")])
def test_backward_route_is_decided_by_dtype_shape_and_layout(kind, want):
    """The backward's rule, on dtype, shape and layout alone (the same on any
    device): the forward's tensor-core shapes and alignment in bf16 take
    the tensor cores; f32 inputs and every other shape the CUDA cores."""
    x, B, C = _route_case(kind)
    assert ssd_scan.backward_route(x, B, C) == want


def test_cpu_backward_counts_no_launch():
    """On the CPU the backward is the plain formulas: no launch on either
    route."""
    ssd_scan.reset_launches()
    args = _inputs(1, 64, 2, 1, 16, 16, "jax_test", seed=0)
    got = ssd_scan.ssd_chunk_backward(*args)
    want = ssd_chunk_backward_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssd_scan.ssd_chunk_backward.launches == 0
    assert ssd_scan.ssd_chunk_backward.route_launches == dict.fromkeys(ssd_scan.ROUTES, 0)
