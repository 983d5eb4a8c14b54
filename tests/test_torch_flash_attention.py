"""The port's ``flash_attention`` (its plain route, on the CPU) against the
JAX package's oracle ``repro.kernels.ref.flash_attention_ref``, over
``tests/test_kernels.py``'s shapes plus a GQA group of 7, D = 256 and
ragged lengths; the bf16 kernel's rounding, emulated tile by tile, against
the plain version; and the wrapper's refusal of what the kernel cannot take.

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
    yield "grid", (torch.zeros(1, 1, 65536, 16), torch.zeros(1, 1, 1, 16),
                   torch.zeros(1, 1, 1, 16))
    # contiguous, but 4 bytes past a 16-byte boundary: TMA cannot read it
    yield "alignment", (torch.zeros(q.numel() + 1)[1:].view(q.shape), k, v)


@pytest.mark.parametrize("what,qkv", list(_bad_inputs()), ids=[w for w, _ in _bad_inputs()])
def test_wrapper_rejects_what_the_kernel_cannot_take(what, qkv):
    with pytest.raises(ValueError):
        flash_attention(*qkv, causal=True)


def _tensor_core_emulation(q, k, v, *, causal, bq=128):
    """The bf16 kernel's rounding in plain torch, tile by tile: an emulation,
    not the kernel.  Scores are f32 products of the unscaled bf16 operands
    (exact in f32, as wgmma's f32 accumulation has them); scale * log2(e) is
    folded into exp2 on the f32 scores; p is rounded to bf16 against the
    running max; l is summed from the f32 p; KV tiles of 128 rows (64 at
    D = 256), 128-row query tiles, tiles past the causal diagonal skipped."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    bk = 64 if D >= 256 else 128
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
                s = rows @ kf[:, k0:k0 + bk].transpose(1, 2)
                kpos = torch.arange(k0, k0 + s.shape[2])[None, :]
                if causal:
                    s = s.masked_fill(kpos > qpos, fa.NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1) * c)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s * c - m_new[..., None])
                l = corr * l + p.sum(dim=-1)
                acc = corr[..., None] * acc + p.to(torch.bfloat16).float() @ vf[:, k0:k0 + bk]
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
