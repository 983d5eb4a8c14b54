"""The packed route of the port's ``flash_attention`` (short sequences in
bf16: a transformer UDF's 8 tokens) on the CPU: its plan
(``flash_attention.packed_plan``, which ``csrc/hopper.cuh``'s
``packed::bad_geo`` mirrors), and the kernels' schedule written out in
plain PyTorch (``flash_attention_packed_plain`` and its backward below:
pack a KV group's heads and several records into one tile in the plan's
row order, mask block-diagonally and causally, unpack, lse scattered to
(B, H, Sq); the backward in one pass over the tile's bands) against the
JAX package's oracle ``repro.kernels.ref.flash_attention_ref`` and
``jax.vjp`` of it, on the same numpy-seeded inputs.  The schedule runs in
the inputs' type: in f32 it is the algorithm, in bf16 it also rounds where
the kernels round (p before P.V and dV, dS before dK and dQ).

Held against the oracle, not the Pallas kernel: interpret-mode Pallas flash
fails on this toolchain's jax (ROADMAP.md Queue 3).  Tolerances: the
forward 1e-5 in f32 (atol = rtol: f32 sums in other orders) and 3e-2 in
bf16 (the oracle rounds p after normalising it, the kernel before); each
gradient within 1e-4 (f32) or 2^-6 (bf16: about two bf16 steps) of its
largest value.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as fa
from _one_thread import one_thread  # noqa: F401

BF16 = torch.bfloat16
FWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
SHAPES = [  # (B, Sq, Sk, H, K, D)
    (5, 8, 8, 16, 1, 32),  # one unit a tile (G 16 x 8 positions = 128 rows)
    (7, 8, 8, 4, 2, 16),  # 7 units of 16 rows in a tile, B < U's cap
    (3, 5, 5, 8, 1, 64),  # ragged: 3 units of 40 rows, 15 keys in a 16-column tile
    (2, 64, 64, 16, 1, 16),  # a unit of 1,024 rows over 8 tiles of 8 positions
]
UDF_SHAPES = [  # (shape, U, tiles a unit, forward blocks, N)
    ((2000, 8, 8, 128, 8, 128), 1, 1, 16_000, 16),  # llama3-405b's heads
    ((2000, 8, 8, 32, 4, 128), 2, 1, 4_000, 16),  # qwen3-moe-30b-a3b's
    ((2000, 8, 8, 4, 2, 16), 8, 1, 500, 64),  # the reduced configs' D 16
]


@pytest.fixture(scope="module", autouse=True)
def quick_compiles():
    """XLA's cheaper compile pipeline for this module's one-off programs
    (restored afterwards): compiling, not running, is their cost here."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)


# ----------------------------------------------------------- the schedule
def _plan(q, k):
    B, Sq, H, D = q.shape
    plan = fa.packed_plan(B, Sq, k.shape[1], H, k.shape[2], D, BF16)  # the layout of any type
    assert plan is not None, f"{tuple(q.shape)} does not take the packed route"
    return plan


def _tile(t5, kv: int, p0: int, plan):
    """Rows (u, s, g), g fastest, of the positions [p0, p0 + P) of every
    group's U records at KV head kv, from (groups, U, Sq, K, G, X) t5:
    (groups, PACKED_ROWS, X), positions past Sq and rows past the box zero
    (as TMA leaves them)."""
    groups, U, Sq, _K, G, X = t5.shape
    part = t5[:, :, p0:p0 + plan.P, kv]
    part = torch.cat([part, part.new_zeros((groups, U, plan.P - part.shape[2], G, X))], dim=2)
    rows = part.reshape(groups, plan.rows, X)
    return torch.cat([rows, rows.new_zeros((groups, fa.PACKED_ROWS - plan.rows, X))], dim=1)


def _untile(tile, p0: int, Sq: int, plan, G: int):
    """The inverse of ``_tile`` for the rows that exist: (groups, U, P', G, X)."""
    groups, _rows, X = tile.shape
    part = tile[:, :plan.rows].reshape(groups, plan.U, plan.P, G, X)
    return part[:, :, :min(plan.P, Sq - p0)]


def _keys(t, kv: int, plan):
    """The U units' keys (or values) of KV head kv, (groups, N, D) in f32,
    rows past U * Sk zero."""
    groups = plan.groups
    B, Sk, _K, D = t.shape
    t = torch.cat([t, t.new_zeros((groups * plan.U - B, Sk, t.shape[2], D))])
    rows = t[:, :, kv].reshape(groups, plan.U * Sk, D).to(torch.float32)
    return torch.cat([rows, rows.new_zeros((groups, plan.N - plan.keys, D))], dim=1)


def _pack(t, plan, G: int):
    """(B, Sq, H, X) -> (groups, U, Sq, K, G, X), records past B zero."""
    B, Sq, H, X = t.shape
    t = torch.cat([t, t.new_zeros((plan.groups * plan.U - B, Sq, H, X))])
    return t.reshape(plan.groups, plan.U, Sq, H // G, G, X)


def _mask(plan, G: int, Sk: int, p0: int, Sq: int, B: int, causal: bool):
    """(groups, PACKED_ROWS, N): row r (unit r // (P G), position p0 + (r %
    P G) // G) attends key column c (unit c // Sk, position c % Sk) only in
    its own unit, past no key of the U units, and, if causal, at or before
    its position.  ``valid`` also drops rows past Sq or past B (the
    backward's rows that attend nothing)."""
    r = torch.arange(fa.PACKED_ROWS)
    u, pos = r // (plan.P * G), p0 + (r % (plan.P * G)) // G
    c = torch.arange(plan.N)
    keep = (u[:, None] == c[None] // Sk) & (c[None] < plan.keys) & (r[:, None] < plan.rows)
    if causal:
        keep &= (c[None] % Sk) <= pos[:, None]
    record = torch.arange(plan.groups)[:, None] * plan.U + u[None]
    valid = keep[None] & (pos < Sq)[None, :, None] & (record < B)[:, :, None]
    return keep, valid


def flash_attention_packed_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """The packed forward's schedule: each tile's S = Q.K^T over the U
    units' keys at once, masked, one softmax pass (all keys fit one tile),
    P rounded to v's type for P.V, divided by l; returns (out, lse) with
    lse in the module's (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, plan = H // K, _plan(q, k)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    f32 = torch.float32
    q5 = _pack(q, plan, G)
    out5 = torch.zeros_like(q5)
    lse5 = torch.zeros(q5.shape[:-1], dtype=f32)
    for kv in range(K):
        kt, vt = _keys(k, kv, plan), _keys(v, kv, plan)
        for t in range(plan.tiles):
            p0 = t * plan.P
            keep, _ = _mask(plan, G, Sk, p0, Sq, B, causal)
            s = _tile(q5, kv, p0, plan).to(f32) @ kt.transpose(1, 2)
            s = s.masked_fill(~keep, fa.NEG_INF)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp((s - m) * scale)  # the kernel: exp2 of s c - m c, c = scale log2(e)
            l = p.sum(dim=-1, keepdim=True)
            o = (p.to(v.dtype).to(f32) @ vt) / l.clamp_min(1e-20)
            lse = m * scale + torch.log(l)
            n = min(plan.P, Sq - p0)
            out5[:, :, p0:p0 + n, kv] = _untile(o, p0, Sq, plan, G).to(q.dtype)
            lse5[:, :, p0:p0 + n, kv] = _untile(lse, p0, Sq, plan, G)[..., 0]
    out = out5.reshape(-1, Sq, H, D)[:B]
    return out, lse5.reshape(-1, Sq, H)[:B].permute(0, 2, 1).contiguous()


def flash_attention_packed_backward_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                                          scale: float | None = None):
    """The packed backward's one pass: per tile (in order over a unit's
    bands) Di = rowsum(dO O) from the tile's own rows, P = exp(scale S -
    lse) from the forward's lse, dP = dO.V^T, dS = P (dP - Di), dQ = scale
    dS.K written out, and dV += P^T.dO, dK += dS^T.Q summed over the bands,
    P and dS rounded to q's type as the kernel's operands; dK scaled last."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, plan = H // K, _plan(q, k)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    f32 = torch.float32
    q5, g5, o5 = (_pack(t, plan, G) for t in (q, dout, out))
    l5 = _pack(lse.permute(0, 2, 1)[..., None], plan, G)  # (groups, U, Sq, K, G, 1)
    dq5 = torch.zeros_like(q5)
    dk = torch.zeros((plan.groups * plan.U, Sk, K, D), dtype=k.dtype)
    dv = torch.zeros_like(dk)
    for kv in range(K):
        kt, vt = _keys(k, kv, plan), _keys(v, kv, plan)
        dk_acc = torch.zeros((plan.groups, plan.N, D), dtype=f32)
        dv_acc = torch.zeros_like(dk_acc)
        for t in range(plan.tiles):
            p0 = t * plan.P
            _, valid = _mask(plan, G, Sk, p0, Sq, B, causal)
            qt, gt, ot = (_tile(x, kv, p0, plan).to(f32) for x in (q5, g5, o5))
            lt = _tile(l5, kv, p0, plan)
            p = torch.where(valid, torch.exp(qt @ kt.transpose(1, 2) * scale - lt), 0.0)
            di = (gt * ot).sum(dim=-1, keepdim=True)
            ds = p * (gt @ vt.transpose(1, 2) - di)
            pr, dsr = (x.to(q.dtype).to(f32) for x in (p, ds))
            dv_acc += pr.transpose(1, 2) @ gt
            dk_acc += dsr.transpose(1, 2) @ qt
            n = min(plan.P, Sq - p0)
            dq5[:, :, p0:p0 + n, kv] = _untile((dsr @ kt) * scale, p0, Sq, plan, G).to(q.dtype)
        for acc, dst, mul in ((dk_acc, dk, scale), (dv_acc, dv, 1.0)):
            dst[:, :, kv] = (acc[:, :plan.keys] * mul).reshape(-1, Sk, D).to(k.dtype)
    return dq5.reshape(-1, Sq, H, D)[:B], dk[:B], dv[:B]


# ---------------------------------------------------------------- inputs
def _inputs(shape, dtype, seed):
    B, Sq, Sk, H, K, D = shape
    rng = np.random.RandomState(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), (B, Sq, H, D))]
    return ([torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays],
            [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), np.finfo(np.float32).tiny))


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("shape,U,tiles,blocks,N", UDF_SHAPES)
def test_plan_at_the_udf_shapes(shape, U, tiles, blocks, N):
    """2,000 records of 8 tokens: one, two and eight units a 128-row tile,
    so 256,000 / 64,000 / 8,000 blocks of the old route become 16,000 /
    4,000 / 500; the backward has one block a tile (every unit whole)."""
    B, Sq, Sk, H, K, D = shape
    plan = fa.packed_plan(*shape, BF16)
    assert (plan.U, plan.tiles, plan.blocks, plan.N) == (U, tiles, blocks, N)
    assert plan.rows == (H // K) * Sq * U <= fa.PACKED_ROWS and plan.keys == U * Sk
    assert plan.bwd_blocks == plan.blocks == -(-B // U) * K
    assert fa.route_for(D, BF16, shape[:5]) == fa.backward_route(D, BF16, shape[:5]) == "packed"


def test_plan_unit_spanning_tiles():
    """Sq 64 at G 16: a unit of 1,024 rows spans 8 tiles of 8 positions;
    all 8 share the unit's 64 keys, and the backward walks them in order in
    one block a unit."""
    plan = fa.packed_plan(2, 64, 64, 16, 1, 16, BF16)
    assert (plan.U, plan.P, plan.tiles, plan.rows, plan.keys, plan.N) == (1, 8, 8, 128, 64, 64)
    assert (plan.blocks, plan.bwd_blocks) == (16, 2)
    plan = fa.packed_plan(1, 64, 64, 14, 2, 128, BF16)  # G 7: 18 positions, 126 rows a tile
    assert (plan.P, plan.tiles, plan.rows) == (18, 4, 126)


def test_plan_batch_not_divisible_by_the_tile():
    """13 records at 8 a tile: 2 groups, the second's last 3 records past B
    (zeros to the kernel, never written out); a batch below the cap takes
    U = B."""
    plan = fa.packed_plan(13, 8, 8, 4, 2, 16, BF16)
    assert (plan.U, plan.groups, plan.blocks) == (8, 2, 4)
    assert fa.packed_plan(7, 8, 8, 4, 2, 16, BF16).U == 7


@pytest.mark.parametrize("H,K,U,rows", [(8, 8, 8, 64), (14, 2, 2, 112), (16, 1, 1, 128)])
def test_plan_group_sizes(H, K, U, rows):
    """G 1, 7 and 16 at 8 tokens and D 64: U = 128 // (8 G), capped at 64
    keys (8 units of 8) for G 1."""
    plan = fa.packed_plan(100, 8, 8, H, K, 64, BF16)
    assert (plan.U, plan.rows, plan.tiles) == (U, rows, 1)


def test_plan_one_position():
    """Sq = Sk = 1: a unit is its G rows; 64 records a tile at G 2 and
    D 32, capped by the batch."""
    assert fa.packed_plan(3, 1, 1, 4, 2, 32, BF16).U == 3
    plan = fa.packed_plan(1000, 1, 1, 4, 2, 32, BF16)
    assert (plan.U, plan.rows, plan.keys, plan.N) == (64, 128, 64, 64)


@pytest.mark.parametrize("B", [256, 512, 1024, 2048, 2000])
def test_serving_buckets_take_the_packed_route(B):
    for shape in ((B, 8, 8, 128, 8, 128), (B, 8, 8, 32, 4, 128), (B, 8, 8, 4, 2, 16)):
        assert fa.route_for(shape[5], BF16, (B, *shape[1:5])) == "packed"


@pytest.mark.parametrize("shape,dtype", [
    ((4, 4096, 4096, 64, 8, 128), BF16), ((1, 4096, 4096, 64, 8, 128), BF16),
    ((4, 4096, 4096, 8, 1, 256), BF16), ((2, 256, 256, 4, 2, 16), BF16),
    ((2, 65, 65, 4, 2, 16), BF16), ((2, 8, 65, 4, 2, 16), BF16),
    ((2, 64, 64, 2, 1, 256), BF16),  # 64 keys exceed D 256's 32
    ((2000, 8, 8, 128, 8, 128), torch.float32), ((2000, 8, 8, 4, 2, 16), torch.float32)])
def test_long_sequences_and_f32_never_take_the_packed_route(shape, dtype):
    """S 4,096 (every serving and training path), the restart check's 256
    and anything past 64, and every f32 call keep their routes."""
    assert fa.packed_plan(*shape, dtype) is None
    D = shape[5]
    assert fa.route_for(D, dtype, shape[:5]) == fa.route_for(D, dtype) == "tensor_cores"
    assert fa.backward_route(D, dtype, shape[:5]) == fa.backward_route(D, dtype)


def test_plan_holds_the_kernels_limits():
    """Every plan over a grid of short shapes keeps what ``packed::bad_geo``
    checks: G P U rows fit a tile, U Sk keys fit N (at most D's largest),
    P tiles cover Sq with no tile wholly past it, whole units or U = 1."""
    n = 0
    for B in (1, 3, 200):
        for Sq in (1, 5, 8, 33, 64):
            for Sk in (1, 8, 31, 64):
                for H, K in ((4, 2), (8, 1), (14, 2), (128, 8), (64, 1)):
                    for D in fa.HEAD_DIMS:
                        plan = fa.packed_plan(B, Sq, Sk, H, K, D, BF16)
                        if plan is None:
                            assert Sk > fa.PACKED_MAX_KEYS[D]
                            continue
                        n += 1
                        G = H // K
                        assert plan.rows == G * plan.P * plan.U <= fa.PACKED_ROWS
                        assert plan.keys == plan.U * Sk <= plan.N <= fa.PACKED_MAX_KEYS[D]
                        assert plan.N in fa.PACKED_KEYS
                        assert plan.P * plan.tiles >= Sq > (plan.tiles - 1) * plan.P
                        assert (plan.tiles == 1 and plan.P == Sq) or plan.U == 1
                        assert 1 <= plan.U <= B and plan.groups == -(-B // plan.U)
    assert n > 1000


def test_packed_kernels_by_name():
    """The packed backward is one kernel (no pre-pass, no dQ pass), named as
    the compiler's report names it."""
    kernels = fa.backward_kernels(128, BF16, (2000, 8, 8, 128, 8))
    assert kernels == {"packed": ("pk::packed_bwd<128, 16>", "packed_bwdILi128ELi16E")}
    assert list(fa.backward_kernels(128, BF16)) == ["prep", "dkdv", "dq"]


# --------------------------------------------------- the schedule, held
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_schedule_matches_jax_oracle(shape, causal, dtype):
    """The forward's schedule against ``flash_attention_ref``; its lse
    against the plain version's (the module's convention)."""
    (q, k, v, _), (jq, jk, jv, _) = _inputs(shape, dtype, seed=sum(shape) + causal)
    out, lse = flash_attention_packed_plain(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == q.dtype and lse.shape == (
        shape[0], shape[3], shape[1])
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal), np.float32)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), want, rtol=FWD_TOL[dtype],
                               atol=FWD_TOL[dtype])
    _, plain_lse = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_backward_schedule_matches_jax_vjp(shape, causal, dtype):
    """The one-pass backward's schedule, on the forward schedule's output
    and lse, against ``jax.vjp`` of ``flash_attention_ref``: each gradient
    within GRAD_TOL of its largest value."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(shape, dtype, seed=sum(shape) + 7 * causal)
    out, lse = flash_attention_packed_plain(q, k, v, causal=causal)
    got = flash_attention_packed_backward_plain(q, k, v, out, g, lse, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal),
                     jq, jk, jv)
    want = vjp(jg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == getattr(torch, dtype)
        assert _rel(a.to(torch.float32).numpy(), b) <= GRAD_TOL[dtype], name


def test_a_leak_across_units_is_caught():
    """The checks above see a mask that lets a row attend the next unit's
    keys: the schedule with that fault misses the oracle."""
    shape = (7, 8, 8, 4, 2, 16)
    (q, k, v, _), (jq, jk, jv, _) = _inputs(shape, "float32", seed=3)
    real = _mask

    def leaky(plan, G, Sk, p0, Sq, B, causal):
        keep, valid = real(plan, G, Sk, p0, Sq, B, causal)
        keep = keep | (torch.arange(plan.N)[None] < plan.keys)
        return keep, valid

    globals()["_mask"] = leaky
    try:
        out, _ = flash_attention_packed_plain(q, k, v, causal=True)
    finally:
        globals()["_mask"] = real
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True), np.float32)
    assert np.abs(out.numpy() - want).max() > 0.1


# ----------------------------------------------------------- the CPU route
def test_cpu_packed_shapes_run_the_plain_version_and_launch_nothing():
    """At a UDF shape on the CPU the route is "packed" (the rule holds on
    any device), yet the call runs ``flash_attention_plain`` and its
    backward the plain formulas: no launch on any route."""
    shape = (6, 8, 8, 16, 2, 32)
    (q, k, v, g), _ = _inputs(shape, "bfloat16", seed=11)
    assert fa.route(q, k, v) == "packed"
    fa.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention(*leaves, causal=True, return_lse=True)
    out.backward(g)
    assert torch.equal(out.detach(), fa.flash_attention_plain(q, k, v, causal=True))
    want = fa.flash_attention_backward_plain(q, k, v, out.detach(), g, causal=True)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    assert (fa.flash_attention.launches, fa.flash_attention.backward_launches) == (0, 0)
    assert fa.flash_attention.route_launches == dict.fromkeys(fa.ROUTES, 0)
    assert fa.flash_attention.backward_route_launches == dict.fromkeys(fa.ROUTES, 0)
