"""The rounding argument behind the tensor-core ``ssd_chunk`` backward,
emulated in plain torch on the CPU: an emulation, not the kernel, which runs
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``
``ssd_bwd_kernels``).

bf16 x, B and C are exact as one bf16 piece each; f32 x, B and C enter as
bf16 hi + lo (as the f32 forward's ``tc::ssd_chunk_split`` takes them), and
so does every f32 operand of a product (``hopper::split_bf16``, |v - hi -
lo| <= 2^-17 |v|).  Each product is the sum of its pieces' products but
lo.lo, each exact in f32, small terms first (lo.hi, hi.lo, hi.hi; with one
exact bf16 operand the two terms of the other's pieces):

    S^T    = B C^T                    (f32: B and C in pieces)
    v      = B dst^T                  B's pieces . dst's
    dM^T   = x dy^T                   x's pieces . dy's
    dx     = w v + M^T dy             M's pieces . dy's
    u      = w x . v                  x as hi + lo in f32
    state  = sum_h (w x) dst          (w x)'s pieces . dst's
    dB     = (sum dS)^T C + state     dS's pieces . C's
    dC     = (sum dS) B               f32 (the CUDA-core kernel)

with M = S * L, L and w from the kernel's warp-scan cumsum, G = dM * M
summed by rows and columns in f32, and dS = dM * L summed over the group's
heads in head order.  Sums here are torch's f32 sums in its own order (the
kernel's tensor cores truncate theirs; only the card shows that).  Held
against ``ssd_chunk_backward_plain`` and ``jax.vjp`` of the JAX package's
``repro.kernels.ref.ssd_chunk_ref`` under the card limits
(``chip_smoke.SSD_BWD_TOL``: in bf16 one bf16 step, 2^-7, of each
gradient's largest value for dx, dB and dC, in f32 1e-4;
``SSD_BWD_DDA_TOL``, 1e-4, for ddA).
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


def _inputs(nc, q, h, g, p, n, kind, seed, dtype=BF16):
    """Numpy-seeded x, B, C in ``dtype``, f32 dA ("jax_test" -|N(0,1)| 0.1,
    the JAX test's; "published" -A dt over Mamba-2's published ranges;
    "jax_init" -softplus(N(0,1)), the JAX package's init) and the f32
    output gradients dy, dstates, ddecay."""
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
    x, B, C = (torch.from_numpy(a).to(dtype) for a in (x, B, C))
    return (x, torch.from_numpy(dA.astype(f)), B, C,
            *(torch.from_numpy(a.astype(f)) for a in grads))


def _split(t):
    """bf16 hi and lo of an f32 tensor, widened back to f32."""
    hi = t.to(BF16).float()
    return hi, (t - hi).to(BF16).float()


def _product(spec, a, b, drop, name, a_name, b_name):
    """einsum ``spec`` of two operands given as their pieces (one exact
    bf16 piece, or f32 hi and lo), as the kernels run it: every pair of
    pieces but lo.lo, small terms first (lo.hi, hi.lo, hi.hi), each exact
    in f32.  ``drop`` "name:a_name_lo" leaves the terms of a's lo piece
    out (likewise b's)."""
    out = 0
    for i, j in ((1, 0), (0, 1), (0, 0)):
        if i >= len(a) or j >= len(b):
            continue
        if (i and drop == f"{name}:{a_name}_lo") or (j and drop == f"{name}:{b_name}_lo"):
            continue
        out = out + torch.einsum(spec, a[i], b[j])
    return out


def _tc_backward_emulation(x, dA, B, C, dy, dst, ddec, drop=None, one_pass=False):
    """The tensor-core route's arithmetic (module docstring), in bf16 or
    f32 (x, B and C then in hi and lo pieces too); ``one_pass``: the
    one-pass kernel's, which differs in two places (dC as the products of
    sum dS's and B's pieces, u from x itself); ``drop`` leaves one
    piece of one product out ("dM:dy_lo", "v:dst_lo", "dx:M_lo",
    "dx:dy_lo", "state:wx_lo", "state:dst_lo", "dB:dS_lo"; in f32 also
    "S:B_lo", "S:C_lo", "v:B_lo", "dM:x_lo", "dS:x_lo", "dB:C_lo") or an
    f32 input's lo piece everywhere ("x:lo", "B:lo", "C:lo").  Returns (dx,
    ddA, dB, dC) as the kernel does."""
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    f32_in = x.dtype == F32

    def pieces(t, name):
        if not f32_in:
            return [t.float()]
        hi, lo = _split(t.float())
        return [hi] if drop == f"{name}:lo" else [hi, lo]

    xp = [t.reshape(nc, Q, G, rep, P) for t in pieces(x, "x")]
    xf = sum(xp)  # x as the kernels see it (hi + lo in f32)
    Bp, Cp = pieces(B, "B"), pieces(C, "C")
    Bf = B.float()
    cum = _warp_scan_cumsum(dA.transpose(1, 2)).reshape(nc, G, rep, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), torch.zeros(()))
    w = torch.exp(cum[..., -1:] - cum)  # (nc, G, rep, Q)
    w_tok = w.permute(0, 3, 1, 2)[..., None]  # (nc, Q, G, rep, 1)
    # S^T = B C^T (A = B's band rows, then C)
    S = _product("csgn,cqgn->cgqs", Bp, Cp, drop, "S", "B", "C")
    M = S[:, :, None] * L  # (nc, G, rep, Q(i), Q(j))
    dyp = list(_split(dy.reshape(nc, Q, G, rep, P)))
    dstp = list(_split(dst.reshape(nc, G, rep, P, N)))
    v = _product("csgn,cgrpn->csgrp", Bp, dstp, drop, "v", "B", "dst")
    dM = _product("csgrp,cqgrp->cgrqs", xp, dyp, drop, "dM", "x", "dy")
    dx = w_tok * v + _product("cgrqs,cqgrp->csgrp", list(_split(M)), dyp, drop, "dx", "M", "dy")
    Gm = torch.where(torch.tril(torch.ones((Q, Q), dtype=torch.bool), -1), dM * M,
                     torch.zeros(()))
    xu = x.float().reshape(nc, Q, G, rep, P) if one_pass else xf
    u = w * (xu * v).sum(dim=-1).permute(0, 2, 3, 1)
    dcum = Gm.sum(dim=-1) - Gm.sum(dim=-2) - u
    last = u.sum(dim=-1) + ddec.reshape(nc, G, rep) * torch.exp(cum[..., -1])
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], dim=-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    # the group's sum of dS over its heads in head order (bwd_group's own
    # dM^T, from x's and dy's pieces again)
    dMg = _product("csgrp,cqgrp->cgrqs", xp, dyp, drop, "dS", "x", "dy")
    dS = torch.zeros((nc, G, Q, Q))
    for r in range(rep):
        dS = dS + dMg[:, :, r] * L[:, :, r]
    xw = list(_split(xf * w_tok))
    state = torch.zeros((nc, Q, G, N))
    for r in range(rep):
        state = state + _product("csgp,cgpn->csgn", [t[:, :, :, r] for t in xw],
                                 [t[:, :, r] for t in dstp], drop, "state", "wx", "dst")
    dB = _product("cgqs,cqgn->csgn", list(_split(dS)), Cp, drop, "dB", "dS", "C") + state
    if one_pass:
        dC = _product("cgqs,csgn->cqgn", list(_split(dS)), Bp, drop, "dC", "dS", "B")
    else:
        dC = torch.einsum("cgqs,csgn->cqgn", dS, Bf)
    ddA = ddA.reshape(nc, H, Q).transpose(1, 2).contiguous()
    return dx.reshape(nc, Q, H, P).to(x.dtype), ddA, dB.to(B.dtype), dC.to(C.dtype)


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


F32_CASES = CASES[:4]


@pytest.mark.parametrize("case", F32_CASES,
                         ids=[f"Q{c[1]}-P{c[4]}-N{c[5]}-{c[6]}" for c in F32_CASES])
def test_f32_split_rounding_within_the_f32_limits(case):
    """f32 x, B and C in hi and lo pieces, every product three products of
    pieces: within the f32 limits (1e-4 of each gradient's largest value,
    ddA 1e-4) of the plain formulas, with room (at most 2.2e-5 at these
    cases and the module's Q 256 "jax_init" one), and at Q <= 80 of
    ``jax.vjp`` of the JAX package's reference."""
    args = _inputs(*case, seed=sum(case[:6]), dtype=F32)
    got = _tc_backward_emulation(*args)
    assert all(t.dtype == F32 for t in got)
    errs = chip_smoke.check_ssd_bwd_output(f"{case} f32 vs plain", got,
                                           ssd_chunk_backward_plain(*args), "float32")
    assert max(errs.values()) <= chip_smoke.SSD_BWD_TOL["float32"] / 4, errs
    if case[1] <= 80:
        jerrs = chip_smoke.ssd_bwd_errors(got, _jax_vjp(*args))
        assert chip_smoke.ssd_bwd_within(jerrs, "float32"), jerrs


F32_KEPT = ["x:lo", "B:lo", "C:lo", "S:B_lo", "S:C_lo", "v:B_lo", "v:dst_lo", "dM:x_lo",
            "dM:dy_lo", "dS:x_lo", "dS:dy_lo", "dx:M_lo", "dx:dy_lo", "state:wx_lo",
            "state:dst_lo", "dB:dS_lo", "dB:C_lo"]


@pytest.mark.parametrize("drop", F32_KEPT)
def test_f32_one_piece_fewer_misses_the_limit(drop):
    """In f32 every piece the route keeps is seen: an input's lo piece left
    out everywhere (x, B, C) or one lo term of any product moves some
    gradient past its 1e-4 limit (by 1.9e-4 to 3.1e-3 of its largest value
    here; with every term the largest is 9.6e-6)."""
    args = _inputs(1, 256, 4, 1, 64, 128, "published", seed=3, dtype=F32)
    errs = chip_smoke.ssd_bwd_errors(_tc_backward_emulation(*args, drop=drop),
                                     ssd_chunk_backward_plain(*args))
    assert not chip_smoke.ssd_bwd_within(errs, "float32"), errs


ONE_PASS_CASES = [  # (nc, Q, H, G, P, N, dA kind, dtype): the one-pass route's shapes
    (16, 16, 16, 1, 8, 16, "published", "bfloat16"), (16, 16, 16, 1, 8, 16, "published", "float32"),
    (3, 32, 6, 3, 24, 40, "jax_test", "bfloat16"), (2, 32, 4, 2, 8, 48, "jax_init", "float32"),
]


@pytest.mark.parametrize("case", ONE_PASS_CASES, ids=[
    f"Q{c[1]}-P{c[4]}-N{c[5]}-{c[6]}-{c[7]}" for c in ONE_PASS_CASES])
def test_one_pass_rounding_within_the_card_limits(case):
    """The one-pass kernel's arithmetic (the wgmma route's pieces, dC as a
    product of pieces too, u from x itself) at the shapes it takes (chunks
    of at most 32 tokens off the wgmma head and state dims; the reduced
    mamba2's P 8 first): within the card limits of the plain formulas, and
    of ``jax.vjp`` of the JAX package's reference, in both types."""
    assert ssd_scan.route(*_route_operands(case)) == "one_pass"
    args = _inputs(*case[:7], seed=sum(case[:6]), dtype=getattr(torch, case[7]))
    got = _tc_backward_emulation(*args, one_pass=True)
    chip_smoke.check_ssd_bwd_output(f"{case} vs plain", got, ssd_chunk_backward_plain(*args),
                                    case[7])
    jerrs = chip_smoke.ssd_bwd_errors(got, _jax_vjp(*args))
    assert chip_smoke.ssd_bwd_within(jerrs, case[7]), jerrs


def _route_operands(case):
    """Zero x, B and C of ``case``'s shape and type: what ``route``
    reads."""
    nc, Q, H, G, P, N = case[:6]
    dt = getattr(torch, case[7])
    return (torch.zeros((nc, Q, H, P), dtype=dt), torch.zeros((nc, Q, G, N), dtype=dt),
            torch.zeros((nc, Q, G, N), dtype=dt))


PAD_CASES = {  # the wgmma kernels' padding: (nc, Q, H, G, P, N, dA kind), B and C's layout
    "p_8": ((2, 64, 4, 2, 8, 16, "published"), "packed"),
    "p_24_n_40": ((2, 48, 4, 2, 24, 40, "jax_test"), "packed"),
    "odd_stride_slice": ((2, 64, 4, 2, 16, 32, "jax_init"), "odd_stride"),
}


@pytest.mark.parametrize("kind", list(PAD_CASES))
def test_padding_onto_the_wgmma_shapes_is_exact(kind):
    """``pad_to_tensor_cores`` (f32): zero columns of x, dy, B, C and
    dstates add exact zeros, so the plain backward of the padded operands,
    cut back by ``unpad_grads``, is the plain backward of the unpadded ones
    (within 1e-6 of each gradient's largest value: exact here), whose
    operands the wgmma kernels then take (the forward's tensor-core rule);
    both match ``jax.vjp`` of the JAX package's reference."""
    case, layout = PAD_CASES[kind]
    nc, Q, H, G, P, N = case[:6]
    x, dA, B, C, dy, dst, ddec = _inputs(*case, seed=sum(case[:6]), dtype=F32)
    if layout == "odd_stride":  # B and C slices of one projection, token stride 2 G N + 1
        wide = torch.zeros((nc, Q, 2 * G * N + 1))
        wide[..., :G * N], wide[..., G * N:2 * G * N] = B.flatten(2), C.flatten(2)
        B = wide[..., :G * N].unflatten(2, (G, N))
        C = wide[..., G * N:2 * G * N].unflatten(2, (G, N))
    assert not ssd_scan.at_tensor_core_shapes(x, B, C)  # the wgmma kernels do not take them
    padded = ssd_scan.pad_to_tensor_cores(x, B, C, dy, dst)
    px, pB, pC = padded[:3]
    assert ssd_scan.route(px, pB, pC) == "tensor_cores"
    assert ssd_scan.at_tensor_core_shapes(px, pB, pC)
    assert px.shape[3] in ssd_scan.TC_P and pB.shape[3] in ssd_scan.TC_N
    got = ssd_scan.unpad_grads(ssd_chunk_backward_plain(px, dA, pB, pC, *padded[3:], ddec), P, N)
    want = ssd_chunk_backward_plain(x, dA, B, C, dy, dst, ddec)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), name
    jerrs = chip_smoke.ssd_bwd_errors(got, _jax_vjp(x, dA, B.contiguous(), C.contiguous(), dy,
                                                    dst, ddec))
    assert chip_smoke.ssd_bwd_within(jerrs, "float32"), jerrs


@pytest.mark.parametrize("kind,want", [
    ("bf16", "tensor_cores"), ("sliced", "tensor_cores"), ("float32", "tensor_cores"),
    ("p_8", "tensor_cores"), ("n_48", "tensor_cores"), ("x_misaligned", "tensor_cores"),
    ("sliced_odd_stride", "tensor_cores"), ("f32_p_8", "tensor_cores"),
    ("f32_x_misaligned", "tensor_cores"), ("f32_sliced_odd_stride", "tensor_cores")])
def test_backward_route_is_decided_by_dtype_shape_and_layout(kind, want):
    """The backward's rule (the forward's, the same on any device): at
    chunks of 64 tokens every dtype, shape and layout takes the wgmma
    kernels, in bf16 and f32 alike.  What they do not take as it is (P 8,
    N 48, misaligned data, odd token strides) goes through
    ``pad_to_tensor_cores`` first, whose operands they take; operands they
    take already pass unchanged."""
    x, B, C = _route_case(kind)
    assert ssd_scan.route(x, B, C) == want
    nc, Q, H, P = x.shape
    dy, dst = torch.zeros((nc, Q, H, P)), torch.zeros((nc, H, P, B.shape[3]))
    px, pB, pC, pdy, pdst = ssd_scan.pad_to_tensor_cores(x, B, C, dy, dst)
    assert ssd_scan.route(px, pB, pC) == "tensor_cores"
    assert pdy.shape[3] == px.shape[3] and pdst.shape[2:] == (px.shape[3], pB.shape[3])
    kept = [p is t for p, t in ((px, x), (pB, B), (pC, C))]
    assert ssd_scan.at_tensor_core_shapes(px, pB, pC)
    assert all(kept) == ssd_scan.at_tensor_core_shapes(x, B, C)


@pytest.mark.parametrize("path,dtype,n", [("tensor_cores", BF16, 4), ("tensor_cores", F32, 5),
                                          ("one_pass", F32, 1), ("one_pass", BF16, 1)])
def test_backward_kernels_name_each_route(path, dtype, n):
    """The kernels each route launches, in order (the names the card's
    profile and resource report are read by): f32 on the wgmma route adds
    ``tc::bwd_v`` after ``tc::bwd_scores``; the one-pass route is one
    kernel in both types."""
    names = ssd_scan.backward_kernels(path, dtype)
    assert len(names) == n
    assert ("tc::bwd_v" in names) == (path == "tensor_cores" and dtype == F32)
    if path == "tensor_cores":
        assert names[-1] == "bwd_dc" and all(k.startswith("tc::") for k in names[:-1])
    else:
        assert names == ("op::bwd_chunk",)


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
