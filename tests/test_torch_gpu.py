"""Card-only checks of the port (marker ``gpu``; they skip without a CUDA
device): the CUDA ``cascade_score``, ``flash_attention`` and ``ssd_chunk``
against their plain versions over ``chip_smoke.py``'s shapes and
tolerances, their launch counters (``flash_attention``'s and ``ssd_chunk``'s
per route, with the route each dtype, shape and layout takes), the f32
tensor-core routes and ``split_bf16`` bit for bit, the optimize-and-execute
path on a short stream, the dense serving path at deepseek-67b's width and
the SSM serving path at mamba2-2.7b's, each with two layers and a short
prompt.  On the card: ``python -m pytest -m gpu tests/test_torch_gpu.py``
(``-k f32`` for the f32 routes)."""
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
                                          (256, "float32", "cuda_cores")])
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
    ((2, 64, 4, 2, 8, 32, "published", "bfloat16"), "cuda_cores"),  # P = 8
    ((2, 64, 4, 2, 16, 48, "published", "bfloat16"), "cuda_cores"),  # N = 48
    ((2, 64, 4, 2, 16, 32, "published", "float32"), "tensor_cores"),
    ((3, 208, 4, 1, 64, 128, "published", "float32"), "tensor_cores"),
    ((2, 64, 4, 2, 8, 32, "published", "float32"), "cuda_cores"),  # P = 8
])
def test_ssd_routes_and_their_launch_counts(cuda, case, want):
    """Each call launches on the route its dtype, shape and layout pick, and
    only that route's count moves; both routes match the plain version."""
    from repro_torch.kernels.ssd_scan import route, ssd_chunk

    x, dA, B, C = chip_smoke.ssd_inputs(case, cuda, seed=1)
    assert route(x, B, C) == want
    before = dict(ssd_chunk.route_launches)
    errs = chip_smoke.check_ssd_case(case, cuda, seed=1)
    assert errs["route"] == want
    assert {r: n - before[r] for r, n in ssd_chunk.route_launches.items()} == {
        r: int(r == want) for r in before}


def test_ssd_tensor_core_route_refuses_a_misaligned_layout(cuda):
    """x 2 bytes past a 16-byte boundary cannot be read by TMA: the call
    takes the CUDA-core route, decided before the launch, and the C entry
    refuses the tensor-core route for it without launching."""
    from repro_torch.kernels import ssd_scan

    x, dA, B, C = chip_smoke.ssd_inputs((2, 64, 4, 2, 16, 32, "published", "bfloat16"), cuda,
                                        seed=2)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert ssd_scan.route(shifted, B, C) == "cuda_cores"
    before = dict(ssd_scan.ssd_chunk.route_launches)
    got = ssd_scan.ssd_chunk(shifted, dA, B, C)
    assert chip_smoke.route_taken(ssd_scan.ssd_chunk, before) == "cuda_cores"
    chip_smoke.check_ssd_output("misaligned x", got, ssd_scan.ssd_chunk_plain(shifted, dA, B, C),
                                dA)
    out = [torch.empty(s, dtype=torch.float32, device=cuda)
           for s in ((2, 64, 4, 16), (2, 4, 16, 32), (2, 4))]
    rc = ssd_scan._lib().ssd_chunk_launch(
        shifted.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
        *(t.data_ptr() for t in out), 2, 64, 4, 2, 16, 32, 64, 64, 64, 1, 1,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert rc != 0


def test_ssm_path_short_prompt(cuda):
    out = chip_smoke.run_ssm_path(cuda, layers=2, batch=2, prompt=512, new_tokens=16)
    assert out["launches"] == out["prefill_launches"] == 2
    assert out["route_launches"] == {"tensor_cores": 2, "cuda_cores": 0}
    assert out["f32_route_launches"] == {"tensor_cores": 2, "cuda_cores": 0}
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
