"""Card-only checks of the port (marker ``gpu``; they skip without a CUDA
device): the CUDA ``cascade_score``, ``flash_attention`` and ``ssd_chunk``
against their plain versions over ``chip_smoke.py``'s shapes and
tolerances, their launch counters (``flash_attention``'s and ``ssd_chunk``'s
per route, with the route each dtype, shape and layout takes), the f32
tensor-core routes and ``split_bf16`` bit for bit, the optimize-and-execute
path on a short stream, the dense serving path at deepseek-67b's width and
the SSM serving path at mamba2-2.7b's, and the MoE, MLA and VLM paths at
qwen3-moe's, deepseek-v2-lite's and paligemma's, each with two layers and a
short prompt; the tuned scorer and the MoE combine's determinism; the
``flash_attention`` backward kernel against its plain version on both
routes, its counters (per route), two calls bit for bit in each type, every forward
route's lse against the plain one, the autograd Function on the card, and a
train step at deepseek-67b's width (one layer, two micro-batches) with its
launches counted; the ``ssd_chunk`` backward kernel against its plain
formulas, its planted faults, two calls bit for bit, its counter through
``SSDChunk``, a two-layer SSM train path, and the encoder-decoder (flash
launches where ``layers.mha`` routes them) and hybrid (none) paths and
training steps; the ``threefry`` kernel (``jax.random``'s draws) bit for
bit against its plain version for every transform, past 2^32 elements at
sampled indices, and every reduced family's init and batch against the CPU
draw.  On the card: ``python -m pytest -m gpu tests/test_torch_gpu.py``
(``-k f32`` for the f32 routes, ``-k "bwd or train or lse"`` for the
backward and training, ``-k "ssd_bwd or ssm_train or encdec or
side_steps"`` for slice O's, ``-k threefry`` for the draws)."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", chip_smoke.KERNEL_CASES)
def test_kernel_matches_plain_version(cuda, case):
    chip_smoke.check_kernel_case(case, cuda, seed=sum(case[:5]))


def test_launch_counter_and_no_fallback(cuda):
    from repro_torch.kernels.proxy_score import cascade_score

    x, (w1, b1, w2, b2), thr, _ = chip_smoke.make_kernel_case(
        (300, 300, 64, 2, 2, "float32", True, None), cuda, seed=0)
    before = cascade_score.launches
    cascade_score(x, w1, b1, w2, b2, thr, 300)
    assert cascade_score.launches == before + 1
    with pytest.raises(ValueError):  # a CUDA tensor the kernel does not take raises
        cascade_score(x.double(), w1, b1, w2, b2, thr, 300)
    assert cascade_score.launches == before + 1


def test_kernel_refuses_a_cascade_too_wide_for_shared_memory(cuda):
    """x of 4,096 features cannot sit in a block's shared memory: the
    wrapper raises before any launch, with no fallback."""
    from repro_torch.kernels.proxy_score import cascade_score

    x, (w1, b1, w2, b2), thr, _ = chip_smoke.make_kernel_case(
        (64, 64, 4096, 2, 2, "float32", True, None), cuda, seed=0)
    before = cascade_score.launches
    with pytest.raises(ValueError, match="shared memory"):
        cascade_score(x, w1, b1, w2, b2, thr, 64)
    assert cascade_score.launches == before


def test_back_to_back_calls_reset_the_scan(cuda):
    """Calls of other shapes, stages and n_valid queued on one stream with
    no synchronise between them: each call's look-back reads only its own
    status words."""
    from repro_torch.kernels.proxy_score import cascade_score, cascade_score_plain

    cases = [(8192, 8192, 64, 32, 3, "float32", False, (0,)),
             (300, 111, 64, 2, 2, "float32", False, None),
             (65536, 40000, 64, 2, 2, "float32", False, (1,)),
             (8192, 8192, 64, 32, 3, "float32", False, (0, 2)),
             (700, 650, 64, 2, 130, "int8", False, (0, 129))]
    inputs = [chip_smoke.make_kernel_case(c, cuda, seed=i) for i, c in enumerate(cases)]
    torch.cuda.synchronize()
    outs = [cascade_score(x, *w, thr, c[1], out_scale=sc, with_scores=False,
                          compact_cols=c[7])
            for c, (x, w, thr, sc) in zip(cases * 3, inputs * 3)]
    torch.cuda.synchronize()
    for c, (x, w, thr, sc), (_s, mk, pk, ck) in zip(cases * 3, inputs * 3, outs):
        _sp, _mp, pp, cp = cascade_score_plain(x, *w, thr, c[1], out_scale=sc,
                                               compact_cols=c[7])
        assert torch.equal(mk.sum(0, dtype=torch.int32), ck)
        sel = range(c[4]) if c[7] is None else c[7]
        for ci, col in enumerate(sel):
            rows = torch.nonzero(mk[:, col]).flatten().to(torch.int32)
            assert torch.equal(pk[ci, :rows.numel()], rows)
            assert bool((pk[ci, rows.numel():] == -1).all())


def test_concurrent_launches_one_stream(cuda):
    """Four threads launch ``cascade_score`` with compaction into one
    stream, 200 times each, with no synchronise between them (the fleet's
    thread transport can do so): every launch's masks, survivor lists and
    counts equal a serial run's on the same inputs, and the counter counts
    all 800 launches."""
    import threading

    from repro_torch.kernels.proxy_score import cascade_score

    case = (8192, 8000, 64, 32, 3, "float32", False, None)
    inputs = [chip_smoke.make_kernel_case(case, cuda, seed=i) for i in range(4)]
    serial = [cascade_score(x, *w, thr, case[1], out_scale=sc, with_scores=False)
              for x, w, thr, sc in inputs]
    torch.cuda.synchronize()
    before = cascade_score.launches
    outs = [[] for _ in inputs]
    errors = []
    start = threading.Barrier(len(inputs))

    def launch_many(t):
        x, w, thr, sc = inputs[t]
        try:
            start.wait()
            for _ in range(200):
                outs[t].append(cascade_score(x, *w, thr, case[1], out_scale=sc,
                                             with_scores=False))
        except Exception as e:  # surfaced on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=launch_many, args=(t,)) for t in range(len(inputs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert cascade_score.launches == before + 800
    for (_s, mk, pk, ck), runs in zip(serial, outs):
        assert len(runs) == 200
        for _s2, m2, p2, c2 in runs:
            assert torch.equal(c2, ck) and torch.equal(p2, pk) and torch.equal(m2, mk)


def _device_ops(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_compaction_path_is_one_launch(cuda):
    """Scoring, the survivor scan and the compaction: one kernel, and no
    other device op (no allocation fill, no PyTorch kernel)."""
    from repro_torch.kernels.proxy_score import cascade_score

    x, (w1, b1, w2, b2), thr, _ = chip_smoke.make_kernel_case(
        (8192, 8192, 64, 32, 3, "float32", False, (0,)), cuda, seed=0)
    cascade_score(x, w1, b1, w2, b2, thr, 8000, compact_cols=(0,))  # scratch allocated
    names = _device_ops(lambda: cascade_score(x, w1, b1, w2, b2, thr, 8000,
                                              compact_cols=(0,)))
    assert len(names) == 1 and "cascade_score_kernel" in names[0], names


def test_scorer_tile_is_one_pinned_upload_one_launch_one_fetch(cuda):
    import numpy as np

    from repro_torch.kernels.ops import CascadeScorer
    from repro_torch.kernels.proxy_score import cascade_score

    from repro_torch.core.proxy_family import PackedCascade

    rng = np.random.RandomState(0)
    P, H, F = 3, 32, 64  # the main path's mixed3 shape
    pc = PackedCascade(w1=(rng.randn(F, H, P) / 8).astype(np.float32),
                       b1=np.zeros((H, P), np.float32),
                       w2=(rng.randn(H, P) / 6).astype(np.float32),
                       b2=np.zeros(P, np.float32), hidden=(H,) * P, families=("mlp1",) * P)
    scorer = CascadeScorer([None] * P, np.zeros(P, np.float32), packed=pc, device=cuda)
    tile = rng.randn(8000, F).astype(np.float32)
    want = CascadeScorer([None] * P, np.zeros(P, np.float32), packed=pc,
                         device="cpu").score_compact(tile, need_scores=True, compact_cols=(0,))
    scorer.score_compact(tile, compact_cols=(0,))  # buffers and scratch allocated
    before = cascade_score.launches
    out = {}
    names = _device_ops(lambda: out.update(r=scorer.score_compact(tile, compact_cols=(0,))))
    assert cascade_score.launches == before + 1
    assert len(names) == 3, names
    assert "Pinned" in names[0] and "HtoD" in names[0], names
    assert "cascade_score_kernel" in names[1], names
    assert "DtoH" in names[2] and "Pinned" in names[2], names
    _s, masks, packed_rows, counts = out["r"]
    assert masks.shape == (8000, P)
    np.testing.assert_array_equal(counts, masks.sum(0))
    np.testing.assert_array_equal(packed_rows[0], np.flatnonzero(masks[:, 0]))
    tie = np.abs(want[0]) <= chip_smoke.SCORE_TOL  # thresholds are 0
    assert not ((masks != want[1]) & ~tie).any()


def test_main_path_short_stream(cuda):
    tiles = 3
    _plans, _stream, launches, _outcomes = chip_smoke.run_main_path(cuda, tiles * 8192 + 5)
    assert launches == (tiles + 1) * len(chip_smoke.QUERIES)


@pytest.mark.parametrize("case", [c for c in chip_smoke.FLASH_CASES
                                  if c[:6] != chip_smoke.SERVING_SHAPE])
def test_flash_kernel_matches_plain_version(cuda, case):
    chip_smoke.check_flash_case(case, cuda, seed=sum(case[:6]))


def test_flash_launch_counter_and_no_fallback(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = chip_smoke.make_flash_case((1, 70, 70, 8, 2, 64, True, "bfloat16"), cuda, seed=0)
    before = flash_attention.launches
    flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:].view(q.shape)
    shifted.copy_(q)  # contiguous, 2 bytes past a 16-byte boundary: TMA cannot read it
    for bad in ((q.double(), k.double(), v.double()),  # a type the kernel does not take
                (q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous()),
                (shifted, k, v)):
        with pytest.raises(ValueError):
            flash_attention(*bad, causal=True)
    assert flash_attention.launches == before + 1


def test_dense_path_short_prompt(cuda):
    out = chip_smoke.run_dense_path(cuda, layers=2, batch=2, prompt=300, new_tokens=4)
    assert out["launches"] == out["prefill_launches"] == 2


@pytest.mark.parametrize("D,dtype,want", [(128, "bfloat16", "tensor_cores"),
                                          (256, "bfloat16", "tensor_cores"),
                                          (16, "float32", "tensor_cores"),
                                          (64, "float32", "tensor_cores"),
                                          (128, "float32", "tensor_cores"),
                                          (256, "float32", "tensor_cores")])
def test_flash_f32_and_bf16_routes_and_their_launch_counts(cuda, D, dtype, want):
    """Each call launches on the route its dtype and head dim pick, and only
    that route's count moves (``split_bf16`` twice a split call, for K and
    V); every route matches the plain version at the chip limits."""
    from repro_torch.kernels import flash_attention as fa

    case = (2, 200, 200, 8, 2, D, True, dtype)
    q, k, v = chip_smoke.make_flash_case(case, cuda, seed=3)
    assert fa.route(q, k, v) == want
    before, splits = dict(fa.flash_attention.route_launches), fa.split_bf16.launches
    chip_smoke.check_flash_case(case, cuda, seed=3)
    assert {r: n - before[r] for r, n in fa.flash_attention.route_launches.items()} == {
        r: int(r == want) for r in before}
    assert fa.split_bf16.launches - splits == 2 * (dtype == "float32" and want == "tensor_cores")


def test_flash_f32_d256_two_calls_are_equal_bit_for_bit(cuda):
    """The split route at paligemma's shape (one consumer warpgroup, K and V
    rings apart): output and lse the same bits twice."""
    assert all(chip_smoke.flash_repeat(cuda)["bitwise_equal"].values())


def test_split_bf16_matches_its_plain_version_bit_for_bit_f32(cuda):
    from repro_torch.kernels import flash_attention as fa

    out = chip_smoke.check_split_bf16(cuda)
    assert out["pieces_differ"] == 0 and out["max_abs_err"] == 0.0
    with pytest.raises(ValueError):  # the pre-pass takes contiguous f32 only
        fa.split_bf16(torch.zeros(8, 8, device=cuda).t())


def test_flash_f32_planted_faults_are_caught(cuda):
    """At the serving shape in f32 (the split route): a skipped KV tile and
    inputs without their mid and lo pieces are both rejected."""
    out = chip_smoke.planted_fault(cuda, "float32")
    assert out["route"] == "tensor_cores" and out["caught_by_row_tol"]
    assert out["lost_pieces"]["caught"]


@pytest.mark.parametrize("case", [c for c in chip_smoke.SSD_CASES
                                  if c[:6] != chip_smoke.SSD_SERVING])
def test_ssd_kernel_matches_plain_version(cuda, case):
    chip_smoke.check_ssd_case(case, cuda, seed=sum(case[:6]))


def test_ssd_planted_fault_is_caught(cuda):
    assert chip_smoke.ssd_planted_fault(cuda)["caught"]


def test_ssd_f32_planted_faults_are_caught(cuda):
    out = chip_smoke.ssd_planted_fault(cuda, "float32")
    assert out["route"] == "tensor_cores" and out["caught"] and out["lost_pieces"]["caught"]


def test_ssd_launch_counter_and_no_fallback(cuda):
    from repro_torch.kernels.ssd_scan import ssd_chunk

    x, dA, B, C = chip_smoke.ssd_inputs((2, 64, 4, 2, 16, 32, "published", "bfloat16"), cuda,
                                        seed=0)
    before = ssd_chunk.launches
    ssd_chunk(x, dA, B, C)
    assert ssd_chunk.launches == before + 1
    for bad in ((x.double(), dA, B.double(), C.double()),  # a type the kernel does not take
                (x[:, :40], dA[:, :40].contiguous(), B[:, :40], C[:, :40])):  # Q = 40
        with pytest.raises(ValueError):
            ssd_chunk(*bad)
    assert ssd_chunk.launches == before + 1


@pytest.mark.parametrize("case,want", [
    ((2, 64, 4, 2, 16, 32, "published", "bfloat16"), "tensor_cores"),
    ((4, 256, 8, 1, 64, 128, "published", "bfloat16", "sliced"), "tensor_cores"),
    ((2, 64, 4, 2, 8, 32, "published", "bfloat16"), "tensor_cores"),  # P = 8: padded
    ((2, 64, 4, 2, 16, 48, "published", "bfloat16"), "tensor_cores"),  # N = 48: padded
    ((2, 64, 4, 2, 16, 32, "published", "float32"), "tensor_cores"),
    ((3, 208, 4, 1, 64, 128, "published", "float32"), "tensor_cores"),
    ((2, 64, 4, 2, 8, 32, "published", "float32"), "tensor_cores"),  # P = 8: padded
    ((16, 16, 16, 1, 8, 16, "published", "bfloat16"), "one_pass"),  # the reduced mamba2's
    ((16, 16, 16, 1, 8, 16, "published", "float32"), "one_pass"),
])
def test_ssd_routes_and_their_launch_counts(cuda, case, want):
    """Each call launches on the route its dtype, shape and layout pick, and
    only that route's count moves; every route matches the plain
    version."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk

    x, dA, B, C = chip_smoke.ssd_inputs(case, cuda, seed=1)
    assert route(x, B, C) == want
    before = dict(ssd_chunk.route_launches)
    errs = chip_smoke.check_ssd_case(case, cuda, seed=1)
    assert errs["route"] == want
    assert {r: n - before[r] for r, n in ssd_chunk.route_launches.items()} == {
        r: int(r == want) for r in before}


def test_ssd_tensor_core_route_refuses_a_misaligned_layout(cuda):
    """x 2 bytes past a 16-byte boundary cannot be read by TMA: at Q 64 the
    call takes the wgmma kernels on an aligned copy (the padded route,
    decided before the launch), and the wgmma entry itself refuses the
    misaligned x without launching."""
    from repro_torch.kernels import ssd_scan

    x, dA, B, C = chip_smoke.ssd_inputs((2, 64, 4, 2, 16, 32, "published", "bfloat16"), cuda,
                                        seed=2)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert ssd_scan.route(shifted, B, C) == "tensor_cores"
    assert not ssd_scan.at_tensor_core_shapes(shifted, B, C)
    before = dict(ssd_scan.ssd_chunk.route_launches)
    got = ssd_scan.ssd_chunk(shifted, dA, B, C)
    assert chip_smoke.route_taken(ssd_scan.ssd_chunk, before) == "tensor_cores"
    chip_smoke.check_ssd_output("misaligned x", got, ssd_scan.ssd_chunk_plain(shifted, dA, B, C),
                                dA)
    out = [torch.empty(s, dtype=torch.float32, device=cuda)
           for s in ((2, 64, 4, 16), (2, 4, 16, 32), (2, 4))]
    rc = ssd_scan._lib().ssd_chunk_launch(
        shifted.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
        *(t.data_ptr() for t in out), 2, 64, 4, 2, 16, 32, 64, 64, 64,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert rc != 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_one_pass_planted_faults_are_caught(cuda, dtype):
    out = chip_smoke.ssd_one_pass_faults(cuda, dtype)
    assert all(out["caught"].values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_one_pass_calls_are_equal_bit_for_bit(cuda, dtype):
    out = chip_smoke.ssd_repeat(cuda, dtype)
    assert out["route"] == "one_pass" and all(out["bitwise_equal"].values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_outputs_share_one_allocation_under_autograd(cuda, dtype):
    """On the card y_diag and states are views of one allocation and
    chunk_decay has its own; through ``SSDChunk`` (under grad, the one-pass
    route) their gradients reach ``ssd_chunk_backward`` as separate
    tensors' would: the leaves' grads equal a direct backward call bit for
    bit."""
    from repro_torch.kernels import ssd_scan

    x, dA, B, C = chip_smoke.ssd_inputs((*chip_smoke.SSD_REDUCED_SHAPE, "published", dtype),
                                        cuda, seed=3)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dA, B, C)]
    y, st, dec = ssd_scan.ssd_chunk(*leaves)
    assert y.untyped_storage().data_ptr() == st.untyped_storage().data_ptr()
    assert dec.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
    gen = torch.Generator(device=cuda).manual_seed(4)
    grads = [torch.randn(t.shape, generator=gen, device=cuda) for t in (y, st, dec)]
    torch.autograd.backward((y, st, dec), grads)
    want = ssd_scan.ssd_chunk_backward(x, dA, B, C, *grads)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


def test_ssm_path_short_prompt(cuda):
    out = chip_smoke.run_ssm_path(cuda, layers=2, batch=2, prompt=512, new_tokens=16)
    assert out["launches"] == out["prefill_launches"] == 2
    assert out["route_launches"] == {"tensor_cores": 2, "one_pass": 0}
    assert out["f32_route_launches"] == {"tensor_cores": 2, "one_pass": 0}
    assert out["planted_fault"]["caught"]


# ------------------------------------------------------------ serving routes
def _packed_plans(hidden_per_plan, F=64, seed=0):
    """Plans over random folded proxies (``PackedProxy``), one list of
    hidden widths a plan; thresholds 0.  The last plan's first stage is
    the first plan's first stage (the same proxy and threshold), so a stack
    of them shares that column."""
    import numpy as np

    from repro_torch.core.proxy import ProxyModel
    from repro_torch.core.query import PhysicalPlan, PlanStage
    from repro_torch.training.proxy_models import PackedProxy

    rng = np.random.RandomState(seed)
    plans = []
    for hs in hidden_per_plan:
        stages = []
        for i, h in enumerate(hs):
            pp = PackedProxy(w1=(rng.randn(F, h) / 8).astype(np.float32),
                             b1=(0.1 * rng.randn(h)).astype(np.float32),
                             w2=(rng.randn(h) / np.sqrt(h)).astype(np.float32),
                             b2=np.float32(0.05 * rng.randn()), hidden=h)
            proxy = ProxyModel(pred_idx=i, d=(), family="packed1", params=pp, r_curve=None,
                               cost=0.0)
            stages.append(PlanStage(pred_idx=i, proxy=proxy, threshold=0.0))
        plans.append(PhysicalPlan(query=None, stages=stages))
    plans[-1].stages[0] = plans[0].stages[0]
    return plans


def _tie(scores, thr):
    import numpy as np

    return np.abs(scores - thr) <= chip_smoke.SCORE_TOL * np.maximum(1.0, np.abs(thr))


@pytest.mark.parametrize("rows,max_tile", [(1024, 1024), (3000, 1024), (8000, 8192)])
def test_score_margins_matches_plain_route(cuda, rows, max_tile):
    """Masks equal to the plain route's except tie rows; margins
    min_p |s_p - thr_p| within SCORE_TOL * max(1, |thr|)."""
    import numpy as np

    from repro_torch.kernels.ops import CascadeScorer

    plan = _packed_plans([[2, 32, 7]])[0]
    x = np.random.RandomState(1).randn(rows, 64).astype(np.float32)
    got_m, got_d = CascadeScorer.from_plan(plan, max_tile=max_tile, device=cuda).score_margins(x)
    plain = CascadeScorer.from_plan(plan, max_tile=max_tile, device="cpu")
    want_m, want_d = plain.score_margins(x)
    scores = plain.score_compact(x, need_scores=True)[0]
    assert got_m.shape == want_m.shape and got_d.shape == (rows,)
    assert not ((got_m != want_m) & ~_tie(scores, plain.thr_host)).any()
    tol = chip_smoke.SCORE_TOL * max(1.0, float(np.abs(plain.thr_host).max()))
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=tol)


def test_score_margins_tile_is_one_pinned_upload_one_launch_one_fetch(cuda):
    import numpy as np

    from repro_torch.kernels.ops import CascadeScorer
    from repro_torch.kernels.proxy_score import cascade_score

    scorer = CascadeScorer.from_plan(_packed_plans([[2, 2]])[0], max_tile=1024, device=cuda)
    tile = np.random.RandomState(2).randn(1000, 64).astype(np.float32)
    scorer.score_margins(tile)  # buffers allocated
    before = cascade_score.launches
    out = {}
    names = _device_ops(lambda: out.update(r=scorer.score_margins(tile)))
    assert cascade_score.launches == before + 1
    assert len(names) == 3, names
    assert "Pinned" in names[0] and "HtoD" in names[0], names
    assert "cascade_score_kernel" in names[1], names
    assert "DtoH" in names[2] and "Pinned" in names[2], names
    masks, margins = out["r"]
    assert masks.shape == (1000, 2) and margins.shape == (1000,)


def test_stacked_scorer_matches_isolated_scorers(cuda):
    """The stacked (block-diagonal) scorer's column slices against each
    plan's isolated scorer at the multi-query path's widths (hidden 2 and
    32, P 6 stacked after one shared column): rows that differ are counted
    and must all be ties."""
    import numpy as np

    from repro_torch.kernels.ops import CascadeScorer

    plans = _packed_plans([[2, 2], [2, 2, 32], [2, 2]])
    x = np.random.RandomState(3).randn(4096, 64).astype(np.float32)
    stacked, col_maps = CascadeScorer.from_plans(plans, device=cuda)
    assert (stacked.n_features, stacked.n_proxies) == (64, 6)
    assert col_maps[2][0] == col_maps[0][0]
    full = stacked.score_masks(x)
    differ = 0
    for plan, cols in zip(plans, col_maps):
        iso = CascadeScorer.from_plan(plan, device=cuda).score_masks(x)
        plain = CascadeScorer.from_plan(plan, device="cpu")
        scores = plain.score_compact(x, need_scores=True)[0]
        bad = full[:, cols] != iso
        differ += int(bad.any(axis=1).sum())
        assert not (bad & ~_tie(scores, plain.thr_host)).any()
    print(f"stacked vs isolated: {differ} rows differ")


def test_serving_and_multiquery_paths_short(cuda):
    out = chip_smoke.run_serving_path(cuda, 40_000)
    assert out["launches"] == out["tiles"] and out["plan_swaps"] >= 1
    mq = chip_smoke.run_multiquery_path(cuda, out["workload"], 16_384)
    assert mq["launches"] == mq["chunks"] == 4 and mq["stacked_cols_saved"] >= 1


def test_frontend_path_short(cuda):
    """The SLO front end on the card: every tile submitted across its degrade
    and restore swaps is one ``cascade_score`` launch."""
    fe = chip_smoke.run_frontend_path(cuda, chip_smoke.serving_workload(cuda, 40_000), 16_384)
    assert fe["launches"] == fe["tiles"] > 0 and fe["degrades"] >= 1 and fe["conserved"]


def test_artifact_path_short(cuda):
    """Scorers rebuilt from COREWIRE bytes on the card (fp32, int8, fp8):
    identical bytes on re-serializing, the same masks, survivor lists and
    counts as the original scorers bit for bit, one launch a tile."""
    plans, stream, _launches, outcomes = chip_smoke.run_main_path(cuda, 2 * 8192 + 5)
    out = chip_smoke.run_artifact_path(cuda, plans, stream, outcomes)
    assert out["launches"] == out["tiles"] > 0
    assert all(r["rows_differ"] == 0 and r["reserialized_identical"] for r in out["artifacts"])


def test_plan_cache_hit_replays_on_the_card(cuda):
    """An exact hit's scorer, uploaded to the card from the cached artifact,
    scores held-out rows as the cold plan's scorer does, bit for bit."""
    out = chip_smoke.run_plan_cache_path(cuda, chip_smoke.serving_workload(cuda, 131_072),
                                         16_384)
    assert out["paths"][:2] == ["cold", "hit"] and out["replay_rows_differ"] == 0
    assert out["replay_launches"] == out["replay_tiles"] > 0
    assert out["plan_cache_writebacks"] >= 1 + out["plan_swaps"]


def test_classifiers_trained_on_the_card_move_to_a_cpu_builder(cuda):
    """A builder on the CPU adopts classifiers trained on the card as copies
    on the CPU (the donor's stay on the card), and reuses them."""
    import numpy as np

    from repro_torch.core.builder import ProxyBuilder
    from repro_torch.data.synthetic import make_dataset, make_query, make_udfs

    ds = make_dataset(n=3000, n_columns=2, seed=5)
    udfs = make_udfs(ds, hidden=8, depth=1, train_rows=600, seed=5, declared_cost_ms=5.0,
                     device="cpu")
    q = make_query(ds, udfs, columns=[0, 1], seed=6)
    x = ds.x[:1000]
    donor = ProxyBuilder(q, x, device=cuda)
    rows = np.arange(len(x))
    donor.get_proxy(0, ())
    classifiers = donor.export_classifiers()
    cpu = ProxyBuilder(q, x, device="cpu")
    cpu.adopt_classifiers(classifiers)
    for key, (proxy, _phi) in classifiers.items():
        moved = cpu._proxies[key][0]
        assert next(iter(vars(moved.params).values())).device.type == "cpu"
        assert next(iter(vars(proxy.params).values())).device.type == "cuda"
        np.testing.assert_allclose(moved.score(x[rows]), proxy.score(x[rows]), atol=1e-4)
    reused = cpu.stats.n_reused
    cpu.get_proxy(0, ())
    assert cpu.stats.n_reused == reused + 1 and cpu.stats.n_trained == 0


def test_fleet_paths_short(cuda):
    """The fleet on the card at a short size: four inline hosts through
    ``CoreSession.serve(hosts=4)``, the same streams on threads, four
    worker processes on the card and the five fault injections; each
    conserves exactly with one ``cascade_score`` launch a submitted tile
    (each worker's own), and the thread and process runs decide as the
    inline runs do."""
    workload = chip_smoke.serving_workload(cuda, 131_072)
    fleet = chip_smoke.run_fleet_path(cuda, workload, 131_072)
    assert fleet["swaps_committed"] >= 1 and fleet["launches"] == fleet["tiles"]
    thread = chip_smoke.run_fleet_thread(cuda, fleet["fleet"], fleet.pop("run"))
    assert thread["swap_log_equals_inline"] and thread["emitted_equals_inline"]
    proc = chip_smoke.run_fleet_process(cuda, workload, fleet["fleet"], 65_536)
    assert all(w["device"].startswith("cuda") for w in proc["workers"])
    faults = chip_smoke.run_fleet_faults(cuda, workload, fleet["fleet"], 131_072)
    assert all(c["resolution_ok"] for c in faults["cases"].values())


@pytest.mark.parametrize("spec,phase,want", [(chip_smoke.MOE, "moe_path", 2),
                                             (chip_smoke.MLA, "mla_path", 0),
                                             (chip_smoke.VLM, "vlm_path", 2)])
def test_model_paths_short_prompt(cuda, spec, phase, want):
    """qwen3-moe, deepseek-v2-lite and paligemma at their published widths,
    two layers and a short prompt: flash_attention once a GQA layer in the
    prefill, never for MLA, never in decode; the attention, MLA and logits
    checks of ``chip_smoke.run_model_path``."""
    out = chip_smoke.run_model_path(cuda, dict(spec, layers=2, batch=2, prompt=512,
                                               new_tokens=4), phase)
    assert out["launches"] == out["prefill_launches"] == want


def test_moe_decode_is_deterministic_on_the_card(cuda):
    """The same MoE input twice through ``moe_apply`` on the card: bit-equal
    outputs (the combine adds each token's rows in a fixed order; no
    atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-30b-a3b")
    p = moe.init_experts(L.seeded(0, cuda), cfg)
    x = torch.randn(4, 512, cfg.d_model, device=cuda, dtype=torch.bfloat16,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    a, aux_a = moe.moe_apply(p, cfg, x)
    b, aux_b = moe.moe_apply(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_scorer_tunes_block_m_on_the_card(cuda):
    """A scorer on the card tunes ``block_m`` on the "cuda" model (the
    smallest block: it pads no tile more), and scores as a block_m = 256
    scorer does."""
    import types

    import numpy as np

    from repro_torch import interop
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import CascadeScorer

    rng = np.random.RandomState(0)
    params = [interop.proxy_params(types.SimpleNamespace(
        w=rng.randn(64).astype(np.float32), b=np.float32(0.1),
        mean=np.zeros(64, np.float32), scale=np.ones(64, np.float32)), cuda) for _ in range(2)]
    tuned = CascadeScorer(params, [0.0, 0.2], device=cuda)
    fixed = CascadeScorer(params, [0.0, 0.2], block_m=256, device=cuda)
    assert tuned.block_m == autotune.choose_block_m(64, int(tuned.w1.shape[1]), 2,
                                                    backend="cuda").block_m == 128
    for n in (3000, 100):
        xs = rng.randn(n, 64).astype(np.float32)
        _, m_a, pk_a, c_a = tuned.score_compact(xs)
        _, m_b, pk_b, c_b = fixed.score_compact(xs)
        assert np.array_equal(m_a, m_b) and np.array_equal(c_a, c_b)
        assert all(np.array_equal(u, v) for u, v in zip(pk_a, pk_b))


@pytest.mark.parametrize("case", [c for c in chip_smoke.BWD_CASES],
                         ids=[str(c) for c in chip_smoke.BWD_CASES])
def test_bwd_kernel_matches_plain_version(cuda, case):
    chip_smoke.check_bwd_case(case, cuda, seed=sum(case[:6]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_planted_fault_is_caught(cuda, dtype):
    assert chip_smoke.bwd_planted_fault(cuda, dtype)["caught"]


def test_bwd_launch_counter_function_and_no_fallback(cuda):
    """One ``flash_attention_backward`` launch a backward through the
    autograd Function, its gradients those of the direct call; an operand
    the kernel does not take raises before any launch."""
    from repro_torch.kernels import flash_attention as fa

    case = (1, 256, 256, 8, 2, 64, True, "bfloat16")
    q, k, v, dout = chip_smoke.make_bwd_case(case, cuda, seed=1)
    fa.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    out.backward(dout)
    assert (fa.flash_attention.launches, fa.flash_attention.backward_launches) == (1, 1)
    _, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    want = fa.flash_attention_backward(q, k, v, out.detach(), dout, lse, causal=True)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, k, v, out.detach(), dout.float(), lse, causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, k, v, out.detach(), dout.transpose(1, 2), lse,
                                    causal=True)
    with pytest.raises(ValueError, match="lse"):  # the card's kernels need the forward's lse
        fa.flash_attention_backward(q, k, v, out.detach(), dout, causal=True)
    assert fa.flash_attention.backward_launches == 2


@pytest.mark.parametrize("D,dtype,want", [(64, "bfloat16", "tensor_cores"),
                                           (128, "bfloat16", "tensor_cores"),
                                           (256, "bfloat16", "tensor_cores"),
                                           (32, "bfloat16", "tensor_cores"),
                                           (64, "float32", "tensor_cores"),
                                           (128, "float32", "tensor_cores"),
                                           (256, "float32", "tensor_cores"),
                                           (32, "float32", "tensor_cores"),
                                           (16, "bfloat16", "tensor_cores"),
                                           (16, "float32", "tensor_cores")])
def test_bwd_routes_and_their_launch_counts(cuda, D, dtype, want):
    """Each (D, dtype) takes ``backward_route``'s kernels: one launch a
    backward through the autograd Function, counted on that route alone
    (D 16 and 32 on the tensor cores too since their swizzle follows the
    forward's; f32 with its four ``split_bf16`` launches in the same C
    call, all four tensors in one launch)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, dout = chip_smoke.make_bwd_case((1, 192, 192, 4, 2, D, True, dtype), cuda, seed=2)
    assert fa.backward_route(D, q.dtype) == want
    fa.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=True).backward(dout)
    torch.cuda.synchronize()
    assert fa.flash_attention.backward_route_launches == {**dict.fromkeys(fa.ROUTES, 0), want: 1}
    assert fa.split_bf16.launches == (2 + 1 if dtype == "float32" else 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_reduced_two_calls_are_equal_bit_for_bit(cuda, dtype):
    """The restart check's reduced (2, 256, 256, 4, 2, 16) on the tensor
    cores in both types, twice on the same inputs: the same bits (the
    restart replays steps on it)."""
    rep = chip_smoke.bwd_repeat(cuda, shape=chip_smoke.BWD_REDUCED_SHAPE, dtype=dtype)
    assert rep["route"] == "tensor_cores" and all(rep["bitwise_equal"])


def test_bwd_two_calls_are_equal_bit_for_bit(cuda):
    """The backward at deepseek-67b's training shape, twice on the same
    inputs: no atomics, the same bits."""
    assert all(chip_smoke.bwd_repeat(cuda)["bitwise_equal"])


def test_bwd_two_f32_calls_are_equal_bit_for_bit(cuda):
    """The same in f32, on the split route: per-stage sums and the dQ
    consumers' partial sums added in a fixed order, no atomics."""
    rep = chip_smoke.bwd_repeat(cuda, dtype="float32")
    assert rep["route"] == "tensor_cores" and all(rep["bitwise_equal"])


def test_bwd_two_f32_d256_calls_are_equal_bit_for_bit(cuda):
    """The same at paligemma's shape in f32, on the split route's D 256
    kernels (the head dim in chunks through the ring, a fixed order)."""
    rep = chip_smoke.bwd_repeat(cuda, shape=chip_smoke.VLM_SHAPE, dtype="float32")
    assert rep["route"] == "tensor_cores" and all(rep["bitwise_equal"])


def test_bwd_f32_d256_planted_fault_is_caught(cuda):
    """A skipped KV tile at paligemma's shape in f32 (the split route at D
    256) fails the check."""
    out = chip_smoke.bwd_planted_fault(cuda, "float32", chip_smoke.VLM_SHAPE)
    assert out["route"] == "tensor_cores" and out["caught"]


@pytest.mark.parametrize("case", [c for c in chip_smoke.BWD_CASES
                                  if c[7] == "float32" and c[5] == 256],
                         ids=lambda c: str(c))
def test_bwd_f32_d256_on_the_split_route(cuda, case):
    """Each f32 D 256 case on the split route's kernels (one launch,
    counted there and with its one ``split_bf16`` launch over q, k, v and
    dO) within 1e-4 of each gradient's largest plain value."""
    from repro_torch.kernels import flash_attention as fa

    fa.reset_launches()
    out = chip_smoke.check_bwd_case(case, cuda, seed=5)
    assert out["route"] == "tensor_cores"
    assert fa.flash_attention.backward_route_launches["tensor_cores"] == 1
    assert fa.split_bf16.launches == 2 * 2 + 1  # two forwards' K and V; the backward's one


@pytest.mark.parametrize("D,dtype", [(16, "bfloat16"), (64, "bfloat16"), (128, "bfloat16"),
                                     (256, "bfloat16"), (64, "float32"), (128, "float32"),
                                     (256, "float32")])
def test_forward_lse_matches_plain_on_every_route(cuda, D, dtype):
    """The forward's lse (bf16 and the split f32 tensor-core kernels, the
    f32 CUDA-core kernel at D 256) against ``flash_attention_plain``'s
    within LSE_TOL, ragged and causal, with its output unchanged."""
    from repro_torch.kernels import flash_attention as fa

    for causal in (True, False):
        case = (2, 200, 136, 4, 2, D, causal, dtype)
        q, k, v = chip_smoke.make_flash_case(case, cuda, seed=D)
        out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        _, ref = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        chip_smoke.check_lse(str(case), lse, ref)
        assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("shape", chip_smoke.ISOLATION_SHAPES)
def test_packed_units_are_isolated(cuda, shape):
    """Records that share a packed tile do not leak into each other: each
    output row is its own unit's constant V, and records with dO = 0 get
    gradients exactly 0 (``chip_smoke.packed_isolation``)."""
    out = chip_smoke.packed_isolation(cuda, shape)
    assert out["forward_max_steps"] <= 1.0 and out["zero_records_nonzero"] == [0, 0, 0]


def test_packed_route_counts_repeat_and_refusals(cuda):
    """At a UDF shape the forward and the backward (through the autograd
    Function) launch once each on the packed route alone; two backward
    calls are equal bit for bit; an ``out`` the kernel cannot read by
    16-byte loads raises before any launch."""
    from repro_torch.kernels import flash_attention as fa

    case = (300, 8, 8, 32, 4, 128, True, "bfloat16")
    q, k, v, dout = chip_smoke.make_bwd_case(case, cuda, seed=4)
    assert fa.route(q, k, v) == fa.backward_route(128, q.dtype, case[:5]) == "packed"
    fa.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=True).backward(dout)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(fa.ROUTES, 0), "packed": 1}
    assert fa.flash_attention.route_launches == fa.flash_attention.backward_route_launches == want
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    a = fa.flash_attention_backward(q, k, v, out, dout, lse, causal=True)
    b = fa.flash_attention_backward(q, k, v, out, dout, lse, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y.grad) for x, y in zip(a, leaves))
    shifted = torch.empty(out.numel() + 1, dtype=out.dtype, device=cuda)[1:].view(out.shape)
    shifted.copy_(out)
    with pytest.raises(ValueError, match="out"):
        fa.flash_attention_backward(q, k, v, shifted, dout, lse, causal=True)
    assert fa.flash_attention.backward_route_launches["packed"] == 3


def test_train_step_short(cuda):
    """One AdamW step of deepseek-67b's widths at one layer, two
    micro-batches of one 256-token sequence, remat: 2 forward and 1
    backward launches a layer a micro-batch, and the f32 step against the
    plain attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import make_batch, make_data
    from repro_torch.training.train_loop import init_train_state, make_train_step

    cfg = get_config("deepseek-67b").replace(num_layers=1, accum_steps=2)
    params, opt = init_train_state(cfg, 0, cuda)
    batch = make_batch(cfg, make_data(cfg, 256, rows=2), 0, cuda)
    fa.reset_launches()
    _, opt, m = make_train_step(cfg)(params, opt, batch)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.backward_launches) == (4, 2)
    assert torch.isfinite(m["loss"]) and all(bool(torch.isfinite(t).all())
                                             for t in opt.mu.values())


# ------------------------------------------------------------ slice O
@pytest.mark.parametrize("case", chip_smoke.SSD_BWD_CASES, ids=[str(c) for c in
                                                                 chip_smoke.SSD_BWD_CASES])
def test_ssd_bwd_kernel_matches_plain_version(cuda, case):
    chip_smoke.check_ssd_bwd_case(case, cuda, seed=sum(case[:6]))


@pytest.mark.parametrize("shape,route", [(chip_smoke.SSD_FAULT_SHAPE, "tensor_cores"),
                                         (chip_smoke.SSD_REDUCED_SHAPE, "one_pass")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_bwd_planted_faults_are_caught(cuda, dtype, shape, route):
    out = chip_smoke.ssd_bwd_planted_faults(cuda, dtype, shape)
    assert out["route"] == route and all(out["caught"].values())


def test_ssd_bwd_two_calls_are_equal_bit_for_bit(cuda):
    assert all(chip_smoke.ssd_bwd_repeat(cuda)["bitwise_equal"].values())


def test_ssd_bwd_two_f32_calls_are_equal_bit_for_bit(cuda):
    """f32 at the training shape on the tensor cores: fixed-order sums, no
    atomics, the same bits."""
    assert all(chip_smoke.ssd_bwd_repeat(cuda, "float32")["bitwise_equal"].values())


@pytest.mark.parametrize("shape,route", [(chip_smoke.SSD_REDUCED_SHAPE, "one_pass"),
                                         ((2, 48, 4, 2, 24, 40), "tensor_cores")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_bwd_off_shape_calls_are_equal_bit_for_bit(cuda, dtype, shape, route):
    """The calls off the wgmma head and state dims, on the one-pass kernel
    (the reduced mamba2's chunks of 16: the warps' partial sums of dS added
    in warp order) and on the wgmma kernels after padding (chunks of 48),
    twice on the same inputs: the same bits."""
    rep = chip_smoke.ssd_bwd_repeat(cuda, dtype, shape)
    assert rep["route"] == route and all(rep["bitwise_equal"].values())


@pytest.mark.parametrize("case,want", [
    ((2, 256, 8, 1, 64, 128, "published", "bfloat16", "sliced"), "tensor_cores"),
    ((3, 80, 6, 3, 16, 16, "jax_test", "bfloat16"), "tensor_cores"),
    ((2, 48, 4, 2, 24, 40, "near_zero", "bfloat16"), "tensor_cores"),  # P 24, N 40: padded
    ((2, 256, 8, 1, 64, 128, "published", "float32", "sliced"), "tensor_cores"),
    ((3, 80, 6, 3, 16, 16, "jax_test", "float32"), "tensor_cores"),
    ((2, 48, 4, 2, 24, 40, "jax_test", "float32"), "tensor_cores"),
    ((16, 16, 16, 1, 8, 16, "published", "bfloat16"), "one_pass"),  # the reduced mamba2's
    ((16, 16, 16, 1, 8, 16, "published", "float32"), "one_pass"),
    ((3, 32, 6, 3, 24, 40, "jax_test", "bfloat16", "sliced"), "one_pass")])
def test_ssd_bwd_routes_and_their_launch_counts(cuda, case, want):
    """Each call takes ``route``'s kernels, counted on that route
    alone, and matches the plain formulas at the card limits: the wgmma
    kernels at their head and state dims and, padded, at longer chunks off
    them; the one-pass kernel at chunks of at most 32 tokens off them."""
    from repro_torch.kernels import ssd_scan

    x, _dA, B, C = chip_smoke.ssd_inputs(case, cuda, seed=4)[:4]
    assert ssd_scan.route(x, B, C) == want
    ssd_scan.reset_launches()
    chip_smoke.check_ssd_bwd_case(case, cuda, seed=4)
    assert ssd_scan.ssd_chunk_backward.route_launches == {r: int(r == want)
                                                          for r in ssd_scan.ROUTES}


def test_ssd_bwd_launch_counter_function_and_no_fallback(cuda):
    """One ``ssd_chunk_backward`` launch a backward through ``SSDChunk``, its
    gradients those of the direct call; serving (no graph) launches the
    forward only; an operand the kernel does not take raises before any
    launch."""
    from repro_torch.kernels import ssd_scan

    case = (2, 128, 4, 2, 64, 64, "jax_test", "bfloat16", "sliced")
    x, dA, B, C, dy, dst, ddec = chip_smoke.ssd_bwd_inputs(case, cuda, seed=1)
    ssd_scan.reset_launches()
    with torch.no_grad():
        ssd_scan.ssd_chunk(x, dA, B, C)
    assert (ssd_scan.ssd_chunk.launches, ssd_scan.ssd_chunk_backward.launches) == (1, 0)
    leaves = [t.clone().requires_grad_() for t in (x, dA)]
    out = ssd_scan.ssd_chunk(*leaves, B, C)
    torch.autograd.backward(out, (dy, dst, ddec))
    assert (ssd_scan.ssd_chunk.launches, ssd_scan.ssd_chunk_backward.launches) == (2, 1)
    want = ssd_scan.ssd_chunk_backward(x, dA, B, C, dy, dst, ddec)
    assert torch.equal(leaves[0].grad, want[0]) and torch.equal(leaves[1].grad, want[1])
    with pytest.raises(ValueError):
        ssd_scan.ssd_chunk_backward(x, dA, B, C, dy[:, :, :2], dst, ddec)
    with pytest.raises(ValueError):
        ssd_scan.ssd_chunk_backward(x.double(), dA, B.double(), C.double(), dy, dst, ddec)
    assert ssd_scan.ssd_chunk_backward.launches == 2


def test_ssm_train_path_short(cuda):
    """``chip_smoke.run_ssm_train_path`` at two layers: 2 forward and 1
    backward ``ssd_chunk`` launch a layer a step, each layer's backward
    against the plain formulas, the loss falling, the f32 step against the
    plain route."""
    out = chip_smoke.run_ssm_train_path(cuda, layers=2)
    steps = chip_smoke.SSM_TRAIN["steps"]
    assert (out["launches"], out["backward_launches"]) == (4 * steps, 2 * steps)
    assert out["backward_route_launches"] == {"tensor_cores": 2 * steps, "one_pass": 0}
    assert out["float32"]["backward_launches"] == 1
    assert out["float32"]["backward_route_launches"] == {"tensor_cores": 1, "one_pass": 0}


@pytest.mark.parametrize("spec,phase,want", [(chip_smoke.ENCDEC, "encdec_path", 2),
                                             (chip_smoke.HYBRID, "hybrid_path", 0)])
def test_encdec_and_hybrid_paths_short_prompt(cuda, spec, phase, want):
    """seamless-m4t-medium and recurrentgemma-2b at their widths, two
    layers (encdec: two each side) or three (hybrid: one (rec, rec, attn)
    group) and a short prompt: flash_attention once a decoder layer in the
    encdec prefill (its encoder and cross attention stay on the einsum
    path), never for the hybrid's local attention, never in decode; the
    attention and logits checks of ``chip_smoke.run_model_path``."""
    layers = 2 if spec is chip_smoke.ENCDEC else 3
    out = chip_smoke.run_model_path(cuda, dict(spec, layers=layers, batch=2, prompt=512,
                                               new_tokens=4), phase)
    assert out["launches"] == out["prefill_launches"] == want


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "recurrentgemma-2b"])
def test_train_side_steps_of_the_new_families(cuda, arch):
    out = chip_smoke.side_step(cuda, arch)
    assert out["backward_launches"] == (2 if arch == "seamless-m4t-medium" else 0)
    assert out["gradients_finite"]


def test_mesh_train_step_on_one_card_matches_the_unsharded_step(cuda):
    """The sharded train step on a (1, 1) ("data", "model") mesh of an NCCL
    world of one (params, optimizer state and batch DTensors laid out by
    ``sharding.py``) against ``make_train_step`` from the same start: one
    step at deepseek-67b's width (one layer, two micro-batches), the loss
    and every updated leaf bit for bit, with the same flash launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (batch_sharding, distribute, opt_shardings,
                                                  params_shardings)
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train import make_batch, make_data
    from repro_torch.training.train_loop import (init_leaf_opt_state, init_train_state,
                                                 leaf_params, make_sharded_train_step,
                                                 make_train_step)

    cfg = get_config("deepseek-67b").replace(num_layers=1, accum_steps=2)
    batch = make_batch(cfg, make_data(cfg, 512, rows=2, seed=1), 0, cuda)
    params, opt = init_train_state(cfg, 0, cuda)
    start = leaf_params(params)
    fm.reset_launches()
    _, opt, m = make_train_step(cfg, lr=1e-4)(params, opt, batch)
    want, want_loss = leaf_params(params), float(m["loss"])
    want_launches = (fm.flash_attention.launches, fm.flash_attention.backward_launches)
    del params, opt
    chip_smoke.nccl_world(cuda)
    try:
        mesh = make_dev_mesh(1, 1, device_type="cuda")
        sp = distribute(start, params_shardings(start, mesh, "train"), requires_grad=True)
        o = init_leaf_opt_state(cfg, start)
        so = distribute(o, opt_shardings(o, mesh))
        sb = distribute(batch, batch_sharding(batch, mesh))
        fm.reset_launches()
        with ctx.use_mesh(mesh):
            _, so, sm = make_sharded_train_step(cfg, lr=1e-4)(sp, so, sb)
        assert (fm.flash_attention.launches, fm.flash_attention.backward_launches) == \
            want_launches
        assert float(sm["loss"].full_tensor()) == want_loss
        for k, w in want.items():
            assert torch.equal(sp[k].to_local().detach(), w), k
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ threefry
@pytest.mark.parametrize("shape", chip_smoke.THREEFRY_SHAPES)
def test_threefry_kernel_matches_plain_version(cuda, shape):
    """Every transform of the kernel against ``util/prng.py``'s numpy draw
    bit for bit, one launch a draw, the result on the card in its dtype."""
    from repro_torch.kernels import threefry
    from repro_torch.util import prng

    for name, draw in chip_smoke.threefry_draws(prng.key(sum(shape))):
        before = threefry.fill.launches
        got = draw(shape, cuda)
        assert got.is_cuda and threefry.fill.launches == before + 1, name
        assert chip_smoke.bits_equal(got, draw(shape, "cpu")), name


def test_threefry_kernel_past_two_to_the_32_and_its_refusals(cuda):
    """Bits of a draw of 2^32 + 8 elements at sampled indices around 2^32
    against ``Draw.at``; the wrapper refuses a dtype or layout the kernel
    does not write, before any launch."""
    import numpy as np

    from repro_torch.kernels import threefry
    from repro_torch.util import prng

    k = prng.key(1)
    with prng.recording() as drawn:
        prng.bits(k, (chip_smoke.THREEFRY_BIG,), device=cuda)
    (t, draw), = drawn
    idx = chip_smoke.sample_indices(t.numel(), np.random.RandomState(1), around=(2**32,))
    assert len(idx) > chip_smoke.THREEFRY_SAMPLES and (idx >= 2**32).any()
    assert chip_smoke.check_sampled("bits past 2^32", t, draw, idx) == 0.0
    del t, drawn
    before = threefry.fill.launches
    with pytest.raises(ValueError):
        prng.normal(k, (4,), device=cuda, out=torch.empty(4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        prng.uniform(k, (4, 4), device=cuda, out=torch.empty(4, 8, device=cuda)[:, :4])
    assert threefry.fill.launches == before


from repro_torch.configs.archs import ALL as ARCHS  # noqa: E402


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_threefry_family_init_on_card_equals_cpu(cuda, arch):
    for seed in (0, 1):
        chip_smoke.family_on_card_vs_cpu(cuda, arch, seed)
