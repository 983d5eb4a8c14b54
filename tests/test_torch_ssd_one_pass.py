"""The forward's one-pass route (``op::fwd_chunk`` in ``csrc/ssd_chunk.cu``)
and its padded wgmma route, on the CPU: the kernel's arithmetic emulated in
plain torch (an emulation, not the kernel, which runs only on the card:
``tests/test_torch_gpu.py``, ``chip_smoke.py`` ``ssd_kernels``), the route
rule both directions share, and the padding's exactness.

The one-pass kernel, per chunk and head (a warp a head): cum by an
inclusive shuffle scan over the lanes (a lane a token, offsets 1, 2, 4, 8,
16: emulated here bit for bit); S = C B^T once a chunk and group; L
selected to 0 above the diagonal, then exponentiated; M = S * L, w =
exp(cum[-1] - cum); y_diag = M x and states = (w x)^T B, with M and w x
(f32) as bf16 hi + lo pieces, and with f32 inputs x, B and C too; each
product is its pieces' products but lo.lo (lo.hi, hi.lo, hi.hi), every
sum f32.  Held to the JAX package's ``ssd_chunk`` (interpret mode, groups
broadcast to heads) on the same numpy-seeded inputs under
``chip_smoke.SSD_TOL`` (1e-4 of the largest value) and the chunk_decay
limit (``DECAY_TOL``, 1e-5, plus the cumsum's f32 bound); one piece fewer
(M's lo term in bf16, any one lo piece in f32) misses ``SSD_TOL``.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk as jax_ssd_chunk

from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import ssd_chunk_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_ssd_bwd_tc import _product, _split  # noqa: E402
from test_torch_ssd_tc import _route_case  # noqa: E402
from _one_thread import one_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16


def _inputs(nc, q, h, g, p, n, kind, dtype, seed, sliced=False):
    """Numpy-seeded x, B, C in ``dtype`` and f32 dA ("jax_test" -|N(0,1)|
    0.1; "published" -A dt over Mamba-2's published ranges); ``sliced``: B
    and C slices of one (nc, q, h p + 2 g n) projection, as ``ops.ssd``
    passes them."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(nc, q, h, p).astype(f)
    wide = rng.randn(nc, q, h * p + 2 * g * n).astype(f)
    z = rng.randn(nc, q, h).astype(f)
    if kind == "jax_test":
        dA = -np.abs(z) * 0.1
    else:
        A_log, dt_bias = (a[0] for a in chip_smoke.published_dynamics(1, h, seed))
        dA = -np.exp(A_log) * np.logaddexp(0.0, z + dt_bias)
    wide_t = torch.from_numpy(wide).to(dtype)
    B = wide_t[..., h * p:h * p + g * n].unflatten(2, (g, n))
    C = wide_t[..., h * p + g * n:].unflatten(2, (g, n))
    if not sliced:
        B, C = B.contiguous(), C.contiguous()
    return torch.from_numpy(x).to(dtype), torch.from_numpy(dA.astype(f)), B, C


def _lane_scan_cumsum(dA):
    """cumsum over the last axis (length <= 32) in the one-pass kernel's
    order: lane l holds step l, and for o = 1, 2, 4, 8, 16 every lane l >= o
    adds lane l - o's value (bit for bit the kernel's f32 adds)."""
    v = dA.clone()
    for o in (1, 2, 4, 8, 16):
        shifted = torch.zeros_like(v)
        shifted[..., o:] = v[..., :-o]
        v = v + shifted
    return v


def _one_pass_emulation(x, dA, B, C, drop=None):
    """``op::fwd_chunk``'s arithmetic in plain torch (module docstring);
    ``drop`` leaves one lo piece of one product out ("y:M_lo",
    "states:wx_lo"; in f32 also "S:C_lo", "S:B_lo", "y:x_lo",
    "states:B_lo")."""
    nc, Q, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G

    def pieces(t):
        return list(_split(t.float())) if x.dtype == F32 else [t.float()]

    cum = _lane_scan_cumsum(dA.transpose(1, 2)).reshape(nc, G, rep, Q)
    S = _product("cqgn,csgn->cgqs", pieces(C), pieces(B), drop, "S", "C", "B")
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), torch.zeros(()))
    M = S[:, :, None] * L  # (nc, G, rep, Q(i), Q(j))
    xp = [t.reshape(nc, Q, G, rep, P) for t in pieces(x)]
    y = _product("cgrij,cjgrp->cigrp", list(_split(M)), xp, drop, "y", "M", "x")
    w = torch.exp(cum[..., -1:] - cum)  # (nc, G, rep, Q)
    wx = x.float().reshape(nc, Q, G, rep, P) * w.permute(0, 3, 1, 2)[..., None]
    states = _product("cjgrp,cjgn->cgrpn", list(_split(wx)), pieces(B), drop, "states", "wx",
                      "B")
    return (y.reshape(nc, Q, H, P), states.reshape(nc, H, P, N),
            torch.exp(cum[..., -1]).reshape(nc, H))


def _jax_reference(x, dA, B, C):
    """The JAX package's ``ssd_chunk`` (interpret mode) on the same values,
    B and C broadcast from groups to heads."""
    rep = x.shape[2] // B.shape[2]
    jt = jnp.bfloat16 if x.dtype == BF16 else jnp.float32
    jx, jB, jC = (jnp.asarray(t.float().numpy(), jt) for t in (x, B, C))
    want = jax_ssd_chunk(jx, jnp.asarray(dA.numpy()), jnp.repeat(jB, rep, axis=2),
                         jnp.repeat(jC, rep, axis=2), interpret=True)
    return [torch.from_numpy(np.array(w, np.float32)) for w in want]


ONE_PASS_CASES = [  # (nc, Q, H, G, P, N, dA kind, dtype, sliced)
    (16, 16, 16, 1, 8, 16, "published", "bfloat16", False),  # the reduced mamba2's
    (16, 16, 16, 1, 8, 16, "published", "float32", False),
    (3, 32, 6, 3, 24, 40, "jax_test", "bfloat16", True),
    (3, 32, 6, 3, 24, 40, "jax_test", "float32", True),
]


@pytest.mark.parametrize("case", ONE_PASS_CASES, ids=[
    f"Q{c[1]}-P{c[4]}-N{c[5]}-{c[7]}" for c in ONE_PASS_CASES])
def test_one_pass_rounding_within_the_card_limits(case):
    """The one-pass kernel's arithmetic at the shapes it takes (the
    reduced mamba2's first): within SSD_TOL (y_diag, states) and the
    chunk_decay limit of the JAX package's ``ssd_chunk``, and of
    ``ssd_chunk_plain``, in both types."""
    nc, Q, H, G, P, N, kind, dtype, sliced = case
    x, dA, B, C = _inputs(nc, Q, H, G, P, N, kind, getattr(torch, dtype), seed=sum(case[:6]),
                          sliced=sliced)
    assert ssd_scan.route(x, B, C) == "one_pass"
    got = _one_pass_emulation(x, dA, B, C)
    chip_smoke.check_ssd_output(f"{case} vs JAX", got, _jax_reference(x, dA, B, C), dA)
    chip_smoke.check_ssd_output(f"{case} vs plain", got, ssd_chunk_plain(x, dA, B, C), dA)


DROPS = [("bfloat16", "y:M_lo"), ("bfloat16", "states:wx_lo"), ("float32", "S:C_lo"),
         ("float32", "S:B_lo"), ("float32", "y:M_lo"), ("float32", "y:x_lo"),
         ("float32", "states:wx_lo"), ("float32", "states:B_lo")]


@pytest.mark.parametrize("dtype,drop", DROPS, ids=[f"{d}-{p}" for d, p in DROPS])
def test_one_piece_fewer_misses_the_tolerance(dtype, drop):
    """At the reduced mamba2's shape, one lo piece of one product left out
    (M's or w x's in bf16; in f32 any of the six) moves y_diag or states
    past SSD_TOL of the JAX package's ``ssd_chunk``: the card check would
    see a kernel that lost it."""
    x, dA, B, C = _inputs(16, 16, 16, 1, 8, 16, "published", getattr(torch, dtype), seed=3)
    errs = chip_smoke.ssd_errors(_one_pass_emulation(x, dA, B, C, drop=drop),
                                 _jax_reference(x, dA, B, C), dA)
    out = "states" if drop.startswith("states") else "y_diag"
    assert errs[f"{out}_rel"] > chip_smoke.SSD_TOL, errs


PAD_CASES = [  # the JAX package's test shapes off the wgmma head and state dims, Q > 32
    (5, 80, 6, 3, 8, 16, "jax_test", "float32"), (2, 48, 4, 2, 24, 40, "jax_test", "float32"),
    (5, 80, 6, 3, 8, 16, "jax_test", "bfloat16"), (2, 48, 4, 2, 24, 40, "jax_test", "bfloat16"),
]


@pytest.mark.parametrize("case", PAD_CASES, ids=[f"Q{c[1]}-P{c[4]}-N{c[5]}-{c[7]}"
                                                 for c in PAD_CASES])
def test_padded_forward_is_exact(case):
    """``pad_operands``: zero columns of x, B and C add exact zeros, so
    ``ssd_chunk_plain`` on the padded operands, cut back by
    ``unpad_outputs``, equals the unpadded call (bit for bit here), whose
    operands the wgmma kernels then take as they are; both within 1e-5 of
    the largest value (chunk_decay element by element) of the JAX
    package's ``ssd_chunk``."""
    nc, Q, H, G, P, N, kind, dtype = case
    x, dA, B, C = _inputs(nc, Q, H, G, P, N, kind, getattr(torch, dtype), seed=sum(case[:6]))
    assert ssd_scan.route(x, B, C) == "tensor_cores"
    assert not ssd_scan.at_tensor_core_shapes(x, B, C)
    px, pB, pC = ssd_scan.pad_operands(x, B, C)
    assert ssd_scan.at_tensor_core_shapes(px, pB, pC)
    assert px.dtype == x.dtype and px.shape[3] in ssd_scan.TC_P and pB.shape[3] in ssd_scan.TC_N
    y, states, decay = ssd_chunk_plain(px, dA, pB, pC)
    got = (*ssd_scan.unpad_outputs(y, states, P, N), decay)
    want = ssd_chunk_plain(x, dA, B, C)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)
    ref = _jax_reference(x, dA, B, C)
    for a, b in zip(got[:2], ref[:2]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert float(((got[2] - ref[2]).abs() / ref[2].abs()).max()) <= 1e-5


@pytest.mark.parametrize("kind", ["bf16", "sliced", "float32", "p_8", "n_48", "x_misaligned",
                                  "sliced_odd_stride", "f32_p_8", "f32_x_misaligned",
                                  "f32_sliced_odd_stride"])
@pytest.mark.parametrize("q", [16, 32])
def test_short_chunks_off_the_wgmma_shapes_take_one_pass(kind, q):
    """At chunks of 16 and 32 tokens the rule sends what the wgmma kernels
    take as they are there, and everything else to the one-pass kernel,
    forward and backward alike; past ONE_PASS_MAX_REP heads a group the
    padded wgmma route takes it instead."""
    x, B, C = (t[:, :q] for t in _route_case(kind))
    want = "tensor_cores" if ssd_scan.at_tensor_core_shapes(x, B, C) else "one_pass"
    assert ssd_scan.at_tensor_core_shapes(x, B, C) == (kind in ("bf16", "sliced", "float32"))
    assert ssd_scan.route(x, B, C) == want
    wide = x[:, :, :1].expand(-1, -1, (ssd_scan.ONE_PASS_MAX_REP + 1) * B.shape[2], -1)
    if want == "one_pass":
        assert ssd_scan.route(wide, B, C) == "tensor_cores"


def test_cpu_forward_counts_no_launch():
    """On the CPU the forward is ``ssd_chunk_plain`` on every route's
    operands: no launch is counted, on either route."""
    ssd_scan.reset_launches()
    for sliced in (False, True):
        x, dA, B, C = _inputs(2, 16, 4, 2, 8, 16, "jax_test", BF16, seed=1, sliced=sliced)
        got = ssd_scan.ssd_chunk(x, dA, B, C)
        assert all(torch.equal(a, b) for a, b in zip(got, ssd_chunk_plain(x, dA, B, C)))
    assert ssd_scan.ssd_chunk.launches == 0
    assert ssd_scan.ssd_chunk.route_launches == dict.fromkeys(ssd_scan.ROUTES, 0)
    assert ssd_scan.ROUTES == ("tensor_cores", "one_pass")


def test_chunk_decay_has_an_allocation_of_its_own():
    """The forward's outputs as ``_outputs`` lays them out (on any device):
    y_diag and states contiguous views of one allocation, at the pointers
    the launch is given; chunk_decay in one of its own, since ``ops.ssd``'s
    recurrence saves it for the backward and a view would keep y_diag and
    states alive until then."""
    nc, Q, H, P, N = 3, 16, 4, 8, 16
    (y, st, dec), ptrs = ssd_scan._outputs(nc, Q, H, P, N, torch.device("cpu"))
    assert [tuple(t.shape) for t in (y, st, dec)] == [(nc, Q, H, P), (nc, H, P, N), (nc, H)]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (y, st, dec))
    assert y.untyped_storage().data_ptr() == st.untyped_storage().data_ptr()
    assert dec.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
    assert dec.untyped_storage().nbytes() == 4 * nc * H
    assert ptrs == (y.data_ptr(), st.data_ptr(), dec.data_ptr())
