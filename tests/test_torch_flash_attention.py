"""The port's ``flash_attention`` (its plain route, on the CPU) against the
JAX package's oracle ``repro.kernels.ref.flash_attention_ref``, over
``tests/test_kernels.py``'s shapes plus a GQA group of 7, D = 256 and
ragged lengths; the tensor-core kernel's rounding, emulated tile by tile,
against the plain version: bf16, and f32 as three bf16 pieces (also against
the oracle, and with terms or pieces dropped); the route each dtype and head
dim takes; and the wrapper's refusal of what the kernel cannot take.

Held against the oracle, not the Pallas kernel: the Pallas kernel misses
its own oracle in bf16 (ROADMAP.md Queue 3).  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in f32 (both f32, summed in different
orders), 3e-2 in bf16 (p is rounded to bf16 before the PV product, after
normalising in the oracle and before it in the port).
"""
import math
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _one_thread import one_thread  # noqa: F401

SHAPES = [  # (b, sq, sk, h, kv, d)
    (1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64), (1, 128, 384, 4, 1, 128),  # test_kernels
    (1, 100, 100, 14, 2, 64),  # GQA group 7, ragged
    (2, 64, 64, 2, 1, 256),  # D = 256
    (1, 77, 131, 8, 1, 16),  # ragged, group 8
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(shape, dtype, seed):
    b, sq, sk, h, kv, d = shape
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, sq, h, d), rng.randn(b, sk, kv, d), rng.randn(b, sk, kv, d)]
    arrays = [a.astype(np.float32) for a in arrays]
    torch_qkv = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    jax_qkv = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return torch_qkv, jax_qkv


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(shape, causal, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(shape, dtype, seed=sum(shape))
    out = flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    oref = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal), np.float32)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), oref, rtol=TOL[dtype],
                               atol=TOL[dtype])
    # and within the card check's per-row limit, though the oracle rounds p
    # after normalising it and the port before
    _err, row_err, _close = chip_smoke.flash_errors(
        out, torch.from_numpy(np.array(oref)).to(getattr(torch, dtype)))
    assert row_err <= chip_smoke.FLASH_ROW_TOL[dtype]
    # the port's own copy of the oracle agrees with the JAX package's
    tout = tref.flash_attention_ref(q, k, v, causal=causal).to(torch.float32).numpy()
    np.testing.assert_allclose(tout, oref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_check_catches_a_skipped_kv_tile(dtype):
    """The card check's per-row limit rejects an output whose last 64-key
    tile skipped its P.V product, which the absolute limit lets through
    where rows attend many keys and their values are small."""
    (q, k, v), _ = _qkv((1, 1024, 1024, 4, 1, 128), dtype, seed=3)
    bad_v = v.clone()
    bad_v[:, -64:] = 0
    good = flash_attention_plain(q, k, v, causal=True)
    err, row_err, close = chip_smoke.flash_errors(
        flash_attention_plain(q, k, bad_v, causal=True), good)
    assert row_err > chip_smoke.FLASH_ROW_TOL[dtype]
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_flash_output("skipped tile", flash_attention_plain(q, k, bad_v), good)
    chip_smoke.check_flash_output("same", flash_attention_plain(q, k, v), good)


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    (q, k, v), _ = _qkv((2, 70, 70, 8, 2, 64), "bfloat16", seed=0)
    before = flash_attention.launches
    with mock.patch.object(fa, "flash_attention_plain", wraps=flash_attention_plain) as plain:
        out = flash_attention(q, k, v, causal=False)
        attn = flash_attention(q, k, v, causal=True)
    assert [c.kwargs["causal"] for c in plain.call_args_list] == [False, True]
    assert out.shape == attn.shape == q.shape and out.dtype == attn.dtype == q.dtype
    assert flash_attention.launches == before


def _bad_inputs():
    (q, k, v), _ = _qkv((1, 16, 16, 4, 2, 32), "float32", seed=1)
    yield "head dim", (q[..., :24].contiguous(), k[..., :24].contiguous(),
                       v[..., :24].contiguous())
    yield "H % K", (q[:, :, :3].contiguous(), k, v)
    yield "type", (q.half(), k.half(), v.half())
    yield "mixed types", (q, k.to(torch.bfloat16), v)
    yield "k/v shapes", (q, k, v[:, :8].contiguous())
    yield "rank", (q[0], k[0], v[0])
    yield "contiguity", (q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    # batch x heads past a grid's x dim (2^31 - 1), as a stride-0 view
    yield "grid", (torch.zeros(1, 1, 1, 16).expand(1, 1, 2**31, 16), torch.zeros(1, 1, 1, 16),
                   torch.zeros(1, 1, 1, 16))
    # contiguous, but 4 bytes past a 16-byte boundary: TMA cannot read it
    yield "alignment", (torch.zeros(q.numel() + 1)[1:].view(q.shape), k, v)


@pytest.mark.parametrize("what,qkv", list(_bad_inputs()), ids=[w for w, _ in _bad_inputs()])
def test_wrapper_rejects_what_the_kernel_cannot_take(what, qkv):
    with pytest.raises(ValueError):
        flash_attention(*qkv, causal=True)


def _pieces(t):
    """bf16 hi, mid and lo of f32 ``t`` (``split_bf16_plain``), widened back
    to f32."""
    return [x.float() for x in fa.split_bf16_plain(t)]


# The f32 route's six products of pieces (0 hi, 1 mid, 2 lo) of A and B,
# in the kernel's order (smallest first); mid.lo, lo.mid and lo.lo drop.
TERMS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
PIECE = ("hi", "mid", "lo")


def _split_product(a, b, drop=None):
    """a @ b as the f32 route's six products of bf16 pieces (each exact in
    f32, f32 sums), less the one ``drop`` names ("hi.mid", ...)."""
    pa, pb = _pieces(a), _pieces(b)
    out = torch.zeros((*a.shape[:-1], b.shape[-1]))
    for i, j in TERMS:
        if drop != f"{PIECE[i]}.{PIECE[j]}":
            out = out + pa[i] @ pb[j]
    return out


def _tensor_core_emulation(q, k, v, *, causal, drop=None):
    """The tensor-core kernel's rounding in plain torch, tile by tile: an
    emulation, not the kernel (its sums round to nearest; the tensor cores'
    f32 accumulation truncates, which the kernel bounds by summing each
    tile's P.V apart, and only the card shows).  bf16: scores are f32 products of the
    unscaled bf16 operands (exact in f32, as wgmma's f32 accumulation has
    them); p is rounded to bf16 against the running max.  f32 (the split
    route): every operand, p included, enters as bf16 hi, mid and lo pieces
    and each product as six products of pieces (``drop``, "S:hi.mid" or
    "PV:mid.hi" and so on, leaves one out); each KV tile's P.V summed apart
    and added to the running output, at D = 256 in two column halves of
    128, each its own sum.  Both: scale * log2(e) folded into exp2 on the
    f32 scores; l summed from the f32 p; 128-row query tiles (f32 at
    D = 256: 64, one consumer warpgroup a block), KV tiles of 128 rows
    (bf16: 64 at D = 256; f32: 64 at D = 64, 32 at D = 128 and 256),
    tiles past the causal diagonal skipped."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    split = q.dtype == torch.float32
    bq = 64 if split and D == 256 else 128
    halves = 2 if split and D == 256 else 1
    bk = ((32 if D >= 128 else 64 if D >= 64 else 128) if split
          else (64 if D >= 256 else 128))
    c = torch.tensor(1.0 / math.sqrt(D) * math.log2(math.e), dtype=torch.float32)
    heads = torch.arange(H) // (H // K)
    out = torch.empty_like(q)
    for b in range(B):
        qf = q[b].float().transpose(0, 1)  # (H, Sq, D)
        kf, vf = (t[b].float()[:, heads].transpose(0, 1) for t in (k, v))  # (H, Sk, D)
        for q0 in range(0, Sq, bq):
            rows = qf[:, q0:q0 + bq]
            qpos = torch.arange(q0, q0 + rows.shape[1])[:, None]
            m = torch.full(rows.shape[:2], -math.inf)
            l = torch.zeros(rows.shape[:2])
            acc = torch.zeros(rows.shape)
            for k0 in range(0, Sk, bk):
                if causal and k0 > q0 + bq - 1:
                    break
                kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
                if split:
                    s = _split_product(rows, kt.transpose(1, 2),
                                       drop and drop.removeprefix("S:"))
                else:
                    s = rows @ kt.transpose(1, 2)
                kpos = torch.arange(k0, k0 + s.shape[2])[None, :]
                if causal:
                    s = s.masked_fill(kpos > qpos, fa.NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1) * c)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s * c - m_new[..., None])
                l = corr * l + p.sum(dim=-1)
                if split:
                    pv = torch.cat([_split_product(p, half, drop and drop.removeprefix("PV:"))
                                    for half in vt.chunk(halves, dim=-1)], dim=-1)
                else:
                    pv = p.to(torch.bfloat16).float() @ vt
                acc = corr[..., None] * acc + pv
                m = m_new
            out[b, q0:q0 + bq] = (acc / l.clamp_min(1e-20)[..., None]).transpose(0, 1).to(q.dtype)
    return out


@pytest.mark.parametrize("shape,causal", [((2, 333, 333, 8, 2, 64), True),
                                          ((1, 200, 260, 4, 1, 256), False)])
def test_tensor_core_rounding_within_the_card_limits(shape, causal):
    """The tolerance argument behind the bf16 kernel (an emulation of its
    rounding, not the kernel): held to ``flash_attention_plain`` under the
    card check's limits, ``chip_smoke.FLASH_TOL`` and ``FLASH_ROW_TOL``."""
    (q, k, v), _ = _qkv(shape, "bfloat16", seed=sum(shape))
    got = _tensor_core_emulation(q, k, v, causal=causal)
    err, row_err = chip_smoke.check_flash_output("emulation", got,
                                                 flash_attention_plain(q, k, v, causal=causal))
    assert 0 < row_err <= chip_smoke.FLASH_ROW_TOL["bfloat16"] and err > 0


@pytest.mark.parametrize("shape", SHAPES[:3] + [(1, 150, 150, 2, 1, 256), (1, 96, 200, 4, 2, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_rounding_within_the_card_limits(shape, causal):
    """The f32 tensor-core route's arithmetic (six products of bf16 pieces
    for each of S and P.V, an emulation of its rounding, not the kernel) at
    the JAX package's test shapes and at D = 256 (64-row query tiles,
    32-row KV tiles, P.V in two column halves): held to
    ``flash_attention_plain`` and to the JAX package's oracle under the
    unchanged f32 limits, ``FLASH_TOL`` (2e-5) and ``FLASH_ROW_TOL``
    (1e-4), and within a fifth of the absolute limit of the plain
    version."""
    (q, k, v), (jq, jk, jv) = _qkv(shape, "float32", seed=sum(shape) + causal)
    got = _tensor_core_emulation(q, k, v, causal=causal)
    err, row_err = chip_smoke.check_flash_output(
        "split emulation vs plain", got, flash_attention_plain(q, k, v, causal=causal))
    assert 0 < err <= TOL["float32"] / 5 and row_err <= chip_smoke.FLASH_ROW_TOL["float32"]
    oref = torch.from_numpy(np.array(jref.flash_attention_ref(jq, jk, jv, causal=causal),
                                     np.float32))
    chip_smoke.check_flash_output("split emulation vs JAX", got, oref)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("drop", ["S:hi.mid", "S:mid.hi", "PV:hi.mid", "PV:mid.hi"])
def test_one_piece_fewer_misses_the_limit(drop, D):
    """Dropping a first-order mid term (hi.mid or mid.hi, in S or in P.V)
    moves the output past the f32 limits, so the card check sees it.  The
    limit does not see the smaller ones: dropping one of hi.lo, lo.hi or
    mid.mid leaves errors of 5e-6 to 1.5e-5 here, and the two-piece scheme
    (hi + lo, three products each) 1.4e-5 to 2.2e-5, at the limit's own
    scale; so the route takes three pieces, whose error (about 1.5e-6) sits
    an order of magnitude under it.  The same at D = 256, on its own
    tiling."""
    (q, k, v), _ = _qkv((1, 256, 256, 4, 1, D) if D == 64 else (1, 160, 160, 2, 1, D),
                        "float32", seed=11)
    want = flash_attention_plain(q, k, v, causal=True)
    got = _tensor_core_emulation(q, k, v, causal=True, drop=drop)
    err, row_err, close = chip_smoke.flash_errors(got, want)
    assert not close and row_err > chip_smoke.FLASH_ROW_TOL["float32"], (err, row_err)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_flash_output(drop, got, want)


def test_inputs_without_their_lower_pieces_miss_the_limit():
    """The card's planted fault in plain torch: the route run on q, k and v
    rounded to bf16 (their mid and lo pieces 0) against the plain version on
    the true inputs must miss the f32 limits."""
    (q, k, v), _ = _qkv((1, 256, 256, 4, 1, 64), "float32", seed=11)
    hi = [t.to(torch.bfloat16).float() for t in (q, k, v)]
    got = _tensor_core_emulation(*hi, causal=True)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_flash_output("hi pieces only", got,
                                      flash_attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize("D,dtype,want", [
    (d, "bfloat16", "tensor_cores") for d in fa.HEAD_DIMS] + [
    (d, "float32", "tensor_cores") for d in (16, 32, 64, 128)] + [
    (256, "float32", "tensor_cores")])
def test_route_is_decided_by_dtype_and_head_dim(D, dtype, want):
    """The rule the wrapper applies before a CUDA launch (the same on any
    device): past the packed route's lengths (``packed_plan``;
    tests/test_torch_flash_packed.py), on dtype and head dim alone: every
    call on the tensor cores, f32 at D = 256 too (its own tiling)."""
    (q, k, v), _ = _qkv((1, 80, 80, 4, 2, D), dtype, seed=D)
    assert fa.route(q, k, v) == fa.route_for(D, getattr(torch, dtype)) == want


def test_split_pieces_match_their_stated_bound():
    """``split_bf16`` on a CPU tensor is its plain version: hi = bf16(t),
    mid = bf16(t - hi), lo = bf16(t - hi - mid), with |t - hi - mid| <=
    2^-17 |t| and |t - hi - mid - lo| <= 2^-25 |t| (the bounds the kernel
    headers derive), and no launch."""
    t = torch.from_numpy(np.random.RandomState(5).randn(4, 1000).astype(np.float32) * 1e3)
    before = fa.split_bf16.launches
    hi, mid, lo = fa.split_bf16(t)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert fa.split_bf16.launches == before and torch.equal(hi, t.to(torch.bfloat16))
    two = (t.double() - hi.double() - mid.double()).abs() / t.double().abs()
    three = (t.double() - hi.double() - mid.double() - lo.double()).abs() / t.double().abs()
    assert 0 < float(two.max()) <= 2.0 ** -17 and float(three.max()) <= 2.0 ** -25
