"""The rounding argument behind the tensor-core ``ssd_chunk``, emulated tile
by tile in plain torch on the CPU: an emulation, not the kernel, which runs
only on the card (``tests/test_torch_gpu.py``).

bf16 inputs: the kernel's products see exact bf16 x, B and C; S = C B^T
sums their (exact) products in f32; M = S * L and xw = x * exp(cum[-1] -
cum) are f32 and enter their products split into bf16 hi + lo (|M - hi -
lo| <= 2^-17 |M|, derived in ``csrc/hopper.cuh``).  f32 inputs (the split
route): x, B and C are split the same way, and each of the three products
runs as hi.hi + lo.hi + hi.lo; xw is (xh + xl) * w, split again.  Every sum
is f32; the cumsum runs in the kernel's warp-scan order.  L's exp is the
CPU's here; the kernel's ``__expf`` is within a few ulp of it wherever L is
not negligible.  Held against ``ssd_chunk_plain`` and the JAX package's
``ssd_chunk`` (interpret mode) under ``chip_smoke.SSD_TOL`` (1e-4 of the
largest value) and the ``chunk_decay`` limit, on numpy-seeded inputs at
small shapes and at Q = 256 with Mamba-2's published log-decay range.  The
same emulation with one piece fewer misses ``SSD_TOL``: M and xw rounded to
bf16 alone (bf16), or any one lo term of the three f32 products dropped, so
the limit sees a lost term.
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
from _one_thread import one_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
TILE = 64  # rows of the kernel's (i, j) tiles


def _inputs(nc, q, h, g, p, n, seed, kind, dtype=BF16):
    """Numpy-seeded x, B, C (in ``dtype``) and f32 dA: "jax_test"
    -|N(0,1)| 0.1, "published" -A dt over Mamba-2's published A and dt
    ranges (``chip_smoke.published_dynamics``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(nc, q, h, p).astype(np.float32)
    B = rng.randn(nc, q, g, n).astype(np.float32)
    C = rng.randn(nc, q, g, n).astype(np.float32)
    z = rng.randn(nc, q, h).astype(np.float32)
    if kind == "jax_test":
        dA = -np.abs(z) * 0.1
    else:
        A_log, dt_bias = (a[0] for a in chip_smoke.published_dynamics(1, h, seed))
        dA = -np.exp(A_log) * np.logaddexp(0.0, z + dt_bias)
    x, B, C = (torch.from_numpy(a).to(dtype) for a in (x, B, C))
    return x, torch.from_numpy(dA.astype(np.float32)), B, C


def _warp_scan_cumsum(dA):
    """cumsum over the last axis (length <= 256) in the kernel's order:
    each of 32 lanes sums 8 consecutive steps in sequence, the lane totals
    go through an inclusive shuffle scan (offsets 1, 2, 4, 8, 16), and each
    step adds the next lower lane's inclusive total."""
    q = dA.shape[-1]
    v = torch.nn.functional.pad(dA, (0, 256 - q)).unflatten(-1, (32, 8))
    part = torch.zeros_like(v)
    run = torch.zeros(v.shape[:-1], dtype=F32)
    for e in range(8):
        run = run + v[..., e]
        part[..., e] = run
    incl = run.clone()
    for off in (1, 2, 4, 8, 16):
        shifted = torch.zeros_like(incl)
        shifted[..., off:] = incl[..., :-off]
        incl = incl + shifted
    base = torch.zeros_like(incl)
    base[..., 1:] = incl[..., :-1]
    return (base[..., None] + part).flatten(-2)[..., :q]


def _split(t, terms):
    """bf16 hi (+ lo) of f32 ``t``, widened back to f32, one per term."""
    hi = t.to(BF16).to(F32)
    return [hi] if terms == 1 else [hi, (t - hi).to(BF16).to(F32)]


SPLIT_TERMS = tuple(f"{prod}:{term}" for prod in ("S", "y", "states")
                    for term in ("lo.hi", "hi.lo"))


def _split_product(a, b, drop=None):
    """a @ b over bf16 pieces, hi.hi + lo.hi + hi.lo, less the term ``drop``
    names ("lo.hi" or "hi.lo")."""
    (ah, al), (bh, bl) = _split(a, 2), _split(b, 2)
    out = ah @ bh
    if drop != "lo.hi":
        out = out + al @ bh
    if drop != "hi.lo":
        out = out + ah @ bl
    return out


def _tensor_core_emulation(x, dA, B, C, terms=2, drop=None):
    """The tensor-core kernel's rounding in plain torch, tile by tile.  bf16
    inputs: M and xw in ``terms`` pieces.  f32 inputs (the split route):
    every product as three over pieces; ``drop`` ("S:lo.hi", ...,
    ``SPLIT_TERMS``) leaves one lo term out."""
    nc, Q, H, P = x.shape
    G = B.shape[2]
    split = x.dtype == F32
    nt = -(-Q // TILE)
    y = torch.zeros((nc, Q, H, P), dtype=F32)
    states = torch.empty((nc, H, P, B.shape[3]), dtype=F32)
    cum = _warp_scan_cumsum(dA.transpose(1, 2))  # (nc, H, Q)
    rows = torch.arange(Q)

    def product(name, a, b):
        if split:
            return _split_product(a, b, drop and drop.removeprefix(f"{name}:")
                                  if drop and drop.startswith(name + ":") else None)
        if name == "S":
            return a @ b  # exact bf16 products, f32 sums
        return sum(part @ b for part in _split(a, terms))

    for c in range(nc):
        for h in range(H):
            g = h // (H // G)
            xb, bb, cb = x[c, :, h].to(F32), B[c, :, g].to(F32), C[c, :, g].to(F32)
            cu = cum[c, h]
            for i in range(nt):
                ri = rows[i * TILE:(i + 1) * TILE]
                acc = torch.zeros((len(ri), P), dtype=F32)
                for j in range(i + 1):
                    rj = rows[j * TILE:(j + 1) * TILE]
                    s = product("S", cb[ri], bb[rj].T)
                    keep = rj[None, :] <= ri[:, None]
                    seg = torch.where(keep, cu[ri][:, None] - cu[rj][None, :],
                                      torch.zeros((), dtype=F32))
                    m = torch.where(keep, s * torch.exp(seg), torch.zeros((), dtype=F32))
                    acc = acc + product("y", m, xb[rj])
                y[c, ri, h] = acc
            xs = sum(_split(xb, 2)) if split else xb  # the kernel's x: its pieces' sum
            xw = xs * torch.exp(cu[-1] - cu)[:, None]
            states[c, h] = product("states", xw.T, bb)
    return y, states, torch.exp(cum[..., -1])


CASES = [  # (nc, Q, H, G, P, N, dA)
    (2, 64, 4, 2, 16, 32, "jax_test"),
    (2, 80, 3, 3, 16, 16, "jax_test"),  # ragged Q, one head a group
    (1, 256, 4, 1, 64, 128, "published"),  # the serving chunk and widths
]


def _jax_reference(x, dA, B, C):
    rep = x.shape[2] // B.shape[2]
    jt = jnp.bfloat16 if x.dtype == BF16 else jnp.float32
    jb = [jnp.asarray(t.float().numpy(), jt) for t in (x, B, C)]
    want = jax_ssd_chunk(jb[0], jnp.asarray(dA.numpy()), jnp.repeat(jb[1], rep, axis=2),
                         jnp.repeat(jb[2], rep, axis=2), interpret=True)
    return [torch.from_numpy(np.array(w, np.float32)) for w in want]


@pytest.mark.parametrize("case", CASES, ids=[f"Q{c[1]}-P{c[4]}-N{c[5]}" for c in CASES])
def test_tensor_core_rounding_within_the_card_limits(case):
    nc, q, h, g, p, n, kind = case
    x, dA, B, C = _inputs(nc, q, h, g, p, n, seed=sum(case[:6]), kind=kind)
    got = _tensor_core_emulation(x, dA, B, C)
    chip_smoke.check_ssd_output("emulation vs plain", got, ssd_chunk_plain(x, dA, B, C), dA)
    errs = chip_smoke.check_ssd_output("emulation vs JAX", got, _jax_reference(x, dA, B, C), dA)
    assert 0 < errs["y_diag_rel"] <= 2e-5 and 0 < errs["states_rel"] <= 2e-5


def test_one_term_split_misses_the_tolerance():
    """M and xw rounded to bf16 alone (no lo term) at the serving chunk:
    both outputs miss SSD_TOL, so the card check would reject a kernel that
    lost either lo term."""
    x, dA, B, C = _inputs(1, 256, 4, 1, 64, 128, seed=3, kind="published")
    errs = chip_smoke.ssd_errors(_tensor_core_emulation(x, dA, B, C, terms=1),
                                 ssd_chunk_plain(x, dA, B, C), dA)
    assert errs["y_diag_rel"] > chip_smoke.SSD_TOL and errs["states_rel"] > chip_smoke.SSD_TOL
    assert errs["chunk_decay_ok"]


SPLIT_CASES = [  # the JAX package's f32 test shape the route takes, G < H, ragged Q, Q = 256
    (4, 64, 2, 2, 16, 32, "jax_test"), (2, 80, 6, 3, 16, 16, "jax_test"),
    (1, 256, 4, 1, 64, 128, "published")]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[f"Q{c[1]}-P{c[4]}-N{c[5]}"
                                                   for c in SPLIT_CASES])
def test_split_rounding_within_the_card_limits(case):
    """f32 inputs on the split route (three products over bf16 pieces, an
    emulation): held to ``ssd_chunk_plain`` and to the JAX package's f32
    ``ssd_chunk`` at SSD_TOL and the decay limit."""
    nc, q, h, g, p, n, kind = case
    x, dA, B, C = _inputs(nc, q, h, g, p, n, seed=sum(case[:6]), kind=kind, dtype=F32)
    got = _tensor_core_emulation(x, dA, B, C)
    errs = chip_smoke.check_ssd_output("split emulation vs plain", got,
                                       ssd_chunk_plain(x, dA, B, C), dA)
    assert 0 < errs["y_diag_rel"] <= 2e-5 and 0 < errs["states_rel"] <= 2e-5
    chip_smoke.check_ssd_output("split emulation vs JAX", got, _jax_reference(x, dA, B, C), dA)


@pytest.mark.parametrize("drop", SPLIT_TERMS)
def test_one_piece_fewer_misses_the_tolerance(drop):
    """At the serving chunk in f32, dropping any one of the six lo terms
    (two in each of S, y and states) moves y_diag or states past SSD_TOL."""
    x, dA, B, C = _inputs(1, 256, 4, 1, 64, 128, seed=3, kind="published", dtype=F32)
    errs = chip_smoke.ssd_errors(_tensor_core_emulation(x, dA, B, C, drop=drop),
                                 ssd_chunk_plain(x, dA, B, C), dA)
    out = "states" if drop.startswith("states") else "y_diag"
    assert errs[f"{out}_rel"] > chip_smoke.SSD_TOL, errs


def _route_case(kind):
    x, dA, B, C = (torch.zeros(s) for s in ((2, 64, 4, 16), (2, 64, 4), (2, 64, 2, 32),
                                            (2, 64, 2, 32)))
    bf = [t.to(BF16) for t in (x, B, C)]
    wide = torch.zeros((2, 64, 64 + 2 * 64 + 4), dtype=BF16)  # token stride 196: not 8 | 196
    wide32 = torch.zeros((2, 64, 64 + 2 * 64 + 2))  # f32 token stride 194: not 4 | 194
    return {
        "bf16": bf,
        "float32": [x, B, C],
        "p_8": [torch.zeros((2, 64, 4, 8), dtype=BF16), bf[1], bf[2]],
        "f32_p_8": [torch.zeros((2, 64, 4, 8)), B, C],
        "n_48": [bf[0], torch.zeros((2, 64, 2, 48), dtype=BF16),
                 torch.zeros((2, 64, 2, 48), dtype=BF16)],
        "x_misaligned": [torch.zeros(bf[0].numel() + 1, dtype=BF16)[1:].view(bf[0].shape),
                         bf[1], bf[2]],
        "f32_x_misaligned": [torch.zeros(x.numel() + 1)[1:].view(x.shape), B, C],
        "sliced": [bf[0], *(torch.zeros((2, 64, 64 + 2 * 64), dtype=BF16)[..., o:o + 64]
                            .unflatten(2, (2, 32)) for o in (64, 128))],
        "sliced_odd_stride": [bf[0], *(wide[..., o:o + 64].unflatten(2, (2, 32))
                                       for o in (64, 128))],
        "f32_sliced_odd_stride": [x, *(wide32[..., o:o + 64].unflatten(2, (2, 32))
                                       for o in (64, 128))],
    }[kind]


@pytest.mark.parametrize("kind,want", [
    ("bf16", "tensor_cores"), ("sliced", "tensor_cores"), ("float32", "tensor_cores"),
    ("p_8", "tensor_cores"), ("n_48", "tensor_cores"), ("x_misaligned", "tensor_cores"),
    ("sliced_odd_stride", "tensor_cores"), ("f32_p_8", "tensor_cores"),
    ("f32_x_misaligned", "tensor_cores"), ("f32_sliced_odd_stride", "tensor_cores")])
def test_route_is_decided_by_dtype_shape_and_layout(kind, want):
    """The rule the wrapper applies before a CUDA launch, forward and
    backward alike, on the operands' dtype, shape and layout alone (the
    same on any device).  At chunks of 64 tokens everything takes the
    wgmma kernels: as it is at P in TC_P, N in TC_N, 16-byte aligned data
    and token strides (``at_tensor_core_shapes``), in bf16 and f32 alike;
    all else on the operands ``pad_operands`` makes (shorter chunks off
    those shapes take the one-pass kernel: tests/test_torch_ssd_one_pass.py)."""
    x, B, C = _route_case(kind)
    assert ssd_scan.route(x, B, C) == want
    direct = kind in ("bf16", "sliced", "float32")
    assert ssd_scan.at_tensor_core_shapes(x, B, C) == direct
    assert ssd_scan.at_tensor_core_shapes(*ssd_scan.pad_operands(x, B, C))
