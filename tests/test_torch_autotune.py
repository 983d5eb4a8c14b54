"""The port's ``kernels/autotune.py`` against the JAX package's, and the
port's ``CascadeScorer`` tuning ``block_m`` as the JAX package's does.

* The JAX package's own autotune tests (tests/test_quantization.py) run
  through both modules (``pkg``): the static heuristic, small hints,
  feasibility, the cache and its disk file (merge-on-save, a corrupt file,
  calibrated winners never persisted), calibration.
* On ``"cpu"`` the two modules compute every ``cell_model`` field and every
  ``choose_block_m`` pick identically over a grid of shapes, dtypes, blocks
  and hints; a scorer on the CPU picks the JAX package's block for the same
  plan, and both packages write the same COREWIRE bytes with nothing primed.
* The ``"cuda"`` model's bytes and feasibility are those of the scorer's
  real ``_TileBuffers`` (built here on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import OptimizeOptions as JOptions, build_plan as j_build_plan
from repro.data import synthetic as jsyn
from repro.kernels import autotune as jat
from repro.kernels import ops as jops

from repro_torch import interop
from repro_torch.core.query import MLUDF, Predicate, Query
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import proxy_score
from repro_torch.kernels.ops import CascadeScorer, _TileBuffers, serialize_scorer
from _one_thread import one_thread  # noqa: F401


PKGS = pytest.mark.parametrize("pkg", [jat, tat], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def clean_backends(monkeypatch):
    """Every case starts and ends with empty caches and no registered
    constants in both modules, and no disk file unless it sets one."""
    monkeypatch.delenv("CORE_AUTOTUNE_CACHE", raising=False)
    for m in (jat, tat):
        m.reset_backend_constants()
        m.clear_autotune_cache()
        m.reset_autotune_stats()
    yield
    for m in (jat, tat):
        m.reset_backend_constants()
        m.clear_autotune_cache()


@pytest.fixture(scope="module")
def plans():
    """The JAX package's mixed plan (linear / mlp1 over three predicates, as
    tests/test_quantization.py builds it) and the port's copy of it."""
    ds = jsyn.make_dataset(n=3000, n_features=64, n_columns=3, correlation=0.9,
                           feature_noise=0.9, label_noise=0.2, seed=41)
    udfs = jsyn.make_udfs(ds, hidden=8, depth=1, train_rows=600, seed=41,
                          declared_cost_ms=10.0)
    jq = jsyn.make_query(ds, udfs, columns=[0, 1, 2], target_selectivity=0.5,
                         accuracy_target=0.9, seed=42)
    jplan = j_build_plan(jq, ds.x[:1200], JOptions(mode="core-a", step=0.05, kind="mixed"))
    tq = Query([Predicate(udf=MLUDF(name=p.udf.name, fn=None, cost=p.udf.cost,
                                    n_classes=p.udf.n_classes), values=p.values)
                for p in jq.predicates], accuracy_target=jq.accuracy_target)
    return dict(x=ds.x, jplan=jplan, tplan=interop.physical_plan(jplan, tq, "cpu"))


def _scorer(pkg, plans):
    if pkg is jat:
        return jops.CascadeScorer.from_plan(plans["jplan"])
    return CascadeScorer.from_plan(plans["tplan"], device="cpu")


# ------------------------------------- the JAX package's cases, both modules
@PKGS
def test_full_tile_matches_static_heuristic(pkg):
    for (f, hp, p) in [(64, 128, 2), (64, 256, 4), (256, 1024, 8), (32, 64, 2),
                       (128, 2048, 16)]:
        static = pkg.static_heuristic_block_m(f, hp, p)
        cfg = pkg.choose_block_m(f, hp, p, "float32", backend="test")
        assert cfg.block_m == static == cfg.static_block_m, (f, hp, p)


@PKGS
def test_small_chunk_picks_smaller_block(pkg):
    static = pkg.static_heuristic_block_m(64, 128, 2)
    assert static >= 2048
    cfg = pkg.choose_block_m(64, 128, 2, "int8", n_rows_hint=256, backend="test")
    assert cfg.block_m <= 256
    stat_cell = pkg.cell_model(64, 128, 2, "int8", static, 256)
    assert cfg.t_model_s < stat_cell.t_model_s and cfg.bytes_moved < stat_cell.bytes_moved


@PKGS
def test_feasibility_and_weight_bytes(pkg):
    for hint in (None, 256, 8192):
        cfg = pkg.choose_block_m(256, 4096, 32, "float32", n_rows_hint=hint, backend="test")
        per_row = 4 * (256 + 4096) + 9 * 128
        assert per_row * cfg.block_m <= pkg.VMEM_BLOCK_BUDGET
    c_f = pkg.cell_model(64, 512, 4, "float32", 256, 256)
    c_q = pkg.cell_model(64, 512, 4, "int8", 256, 256)
    assert c_f.bytes_moved > c_q.bytes_moved


@PKGS
def test_cache_hits_and_disk_persistence(pkg, tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("CORE_AUTOTUNE_CACHE", str(path))
    cfg1 = pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="test")
    cfg2 = pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="test")
    assert cfg1.source == "sweep" and cfg2.source == "cache" and cfg2.block_m == cfg1.block_m
    assert pkg.autotune_stats() == {"sweeps": 1, "hits": 1} and path.exists()
    pkg.clear_autotune_cache()  # a fresh process
    pkg.reset_autotune_stats()
    cfg3 = pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="test")
    assert cfg3.source == "cache" and cfg3.block_m == cfg1.block_m
    assert pkg.autotune_stats()["sweeps"] == 0


@PKGS
def test_disk_cache_concurrent_writer_merges(pkg, tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("CORE_AUTOTUNE_CACHE", str(path))
    cfg_b = pkg.choose_block_m(64, 384, 8, "float32", n_rows_hint=256, backend="test")
    assert len(pkg._read_disk_table(str(path))) == 1
    pkg.clear_autotune_cache()
    pkg._DISK_LOADED = True  # loaded before the peer's save landed
    cfg_a = pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="test")
    assert cfg_a.source == "sweep"
    merged = pkg._read_disk_table(str(path))
    assert {(k[1], k[3]): v.block_m for k, v in merged.items()} == {
        (384, "float32"): cfg_b.block_m, (256, "int8"): cfg_a.block_m}
    assert [p.name for p in tmp_path.iterdir()] == ["autotune.json"]


@PKGS
def test_disk_cache_tolerates_corrupt_file(pkg, tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    path.write_text('{"torn prefix: [1, 2')
    monkeypatch.setenv("CORE_AUTOTUNE_CACHE", str(path))
    with pytest.warns(RuntimeWarning, match="corrupt or partial"):
        cfg = pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="test")
    assert cfg.source == "sweep"
    table = pkg._read_disk_table(str(path))
    assert len(table) == 1 and next(iter(table.values())).block_m == cfg.block_m


@PKGS
def test_set_backend_constants_reprices_and_invalidates(pkg):
    assert pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512,
                              backend="calib").source == "sweep"
    assert pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512,
                              backend="calib").source == "cache"
    pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="other")
    pkg.set_backend_constants("calib", pkg.BackendConstants(
        hbm_bytes_per_s=1.2e10, peak_flops=7.0e11, source="measured"))
    assert pkg.backend_constants("calib").source == "measured"
    base = pkg.cell_model(64, 256, 4, "int8", 256, 512)
    assert pkg.cell_model(64, 256, 4, "int8", 256, 512,
                          backend="calib").t_model_s > 5 * base.t_model_s
    assert pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512,
                              backend="calib").source == "sweep"
    assert pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512,
                              backend="other").source == "cache"


@PKGS
def test_calibrated_backend_never_touches_disk_cache(pkg, tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("CORE_AUTOTUNE_CACHE", str(path))
    pkg.set_backend_constants("calib", pkg.BackendConstants(source="measured"))
    pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="calib")
    assert not path.exists()
    pkg.choose_block_m(64, 256, 4, "int8", n_rows_hint=512, backend="default-bk")
    assert {k[4] for k in pkg._read_disk_table(str(path))} == {"default-bk"}


@PKGS
def test_calibrate_backend_fits_and_registers(pkg, plans):
    scorer = _scorer(pkg, plans)
    bc = pkg.calibrate_backend(scorer, backend="calib-e2e", rows=(256, 4096), repeats=1)
    assert bc.source == "measured" and bc.hbm_bytes_per_s > 0 and bc.launch_overhead_s > 0
    assert bc.peak_flops / bc.hbm_bytes_per_s == pytest.approx(
        pkg.PEAK_FLOPS / pkg.HBM_BYTES_PER_S)
    assert pkg.backend_constants("calib-e2e") == bc
    cfg = pkg.choose_block_m(scorer.n_features, int(scorer.w1.shape[1]), scorer.n_proxies,
                             str(scorer.dtype), n_rows_hint=512, backend="calib-e2e")
    assert cfg.source == "sweep" and cfg.block_m >= 128
    dry = pkg.calibrate_backend(scorer, backend="calib-dry", rows=(256, 2048), repeats=1,
                                register=False)
    assert dry.source == "measured" and pkg.backend_constants("calib-dry").source == "default"


# --------------------------------------------------- the same numbers on "cpu"
GRID_SHAPES = [(16, 64, 1), (64, 64, 2), (64, 128, 4), (64, 96, 3), (64, 192, 6),
               (256, 1024, 8), (128, 4096, 32), (1024, 8192, 130)]


@pytest.mark.parametrize("shape", GRID_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cell_model_and_choice_equal_on_cpu(shape):
    """Every field of every cell, and every pick, equal between the two
    modules on "cpu" (floats exactly: the same arithmetic in one order)."""
    f, hp, p = shape
    for dtype in ("float32", "int8", "fp8"):
        for max_tile in (512, 8192):
            for hint in (None, 1, 100, 256, 1000, 1024, 4096, 20000):
                want = jat.choose_block_m(f, hp, p, dtype, n_rows_hint=hint,
                                          max_tile=max_tile, backend="cpu")
                got = tat.choose_block_m(f, hp, p, dtype, n_rows_hint=hint,
                                         max_tile=max_tile, backend="cpu")
                assert got == want, (dtype, max_tile, hint)
                rows = max_tile if hint is None else hint
                for bm in jat._candidates(max_tile):
                    assert (tat.cell_model(f, hp, p, dtype, bm, rows, max_tile=max_tile,
                                           backend="cpu")
                            == jat.cell_model(f, hp, p, dtype, bm, rows, max_tile=max_tile,
                                              backend="cpu"))
    assert tat.sweep_table([("s", f, hp, p)]) == jat.sweep_table([("s", f, hp, p)])


def test_scorer_tunes_as_the_reference_does(plans):
    """No block_m: the port's CPU scorer takes the JAX package's tuned block,
    with and without a row hint; results do not depend on the block."""
    jsc = jops.CascadeScorer.from_plan(plans["jplan"])
    tsc = CascadeScorer.from_plan(plans["tplan"], device="cpu")
    assert tsc.block_m == jsc.block_m == jat.choose_block_m(
        jsc.n_features, int(jsc.w1.shape[1]), jsc.n_proxies, backend="cpu").block_m
    assert tsc.buckets == tuple(jsc.buckets)
    for hint in (256, 1024):
        params = [s.proxy.params for s in plans["tplan"].stages if s.proxy is not None]
        thr = [s.threshold for s in plans["tplan"].stages if s.proxy is not None]
        jparams = [s.proxy.params for s in plans["jplan"].stages if s.proxy is not None]
        hinted = CascadeScorer(params, thr, n_rows_hint=hint, device="cpu")
        assert hinted.block_m == jops.CascadeScorer(jparams, thr, n_rows_hint=hint).block_m
    x = plans["x"][1200:2500]
    fixed = CascadeScorer.from_plan(plans["tplan"], block_m=256, device="cpu")
    assert fixed.block_m != tsc.block_m
    a, b = tsc.score_compact(x), fixed.score_compact(x)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[3], b[3])
    for pa, pb in zip(a[2], b[2]):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_corewire_bytes_equal_without_priming(plans, dtype):
    """Each package serializes the plan at its own default scorer: the
    same bytes, the same block_m in the header."""
    jplan, tplan = plans["jplan"], plans["tplan"]
    if dtype != "float32":
        jplan = dataclasses.replace(jplan, meta={**jplan.meta, "quant_dtype": dtype})
        tplan = dataclasses.replace(tplan, meta={**tplan.meta, "quant_dtype": dtype})
    want = jops.serialize_scorer(jplan, max_tile=8192)
    assert serialize_scorer(tplan) == want
    assert serialize_scorer(tplan, CascadeScorer.from_plan(tplan, device="cpu")) == want


# --------------------------------------------------------- the card's model
@pytest.mark.parametrize("F,P", [(64, 2), (64, 6), (17, 3), (1024, 130)])
def test_cuda_model_bytes_are_the_tile_buffers(F, P):
    """The "cuda" cell's fetch is the bucket's real result buffer, its
    upload the chunk's rows of the real x buffer, its blocks the kernel's
    64-row blocks, and its feasibility the bucket's pinned + device bytes
    against the budget."""
    assert tat.TILE_ROWS == proxy_score.ROWS_PER_BLOCK
    for rows in (128, 256, 1024, 8192):
        for C, with_scores in ((None, False), (P, False), (1, True), (P, True)):
            buf = _TileBuffers(rows, F, P, C, with_scores, tat.torch.device("cpu"))
            assert buf.result.numel() == tat.result_layout(rows, P, C, with_scores)[3]
    for bm in (128, 512, 8192):
        for hint in (1, 300, 1024, 8192):
            cell = tat.cell_model(F, 64, P, "float32", bm, hint, backend="cuda")
            npad = tat.padded_rows(hint, bm, 8192)
            buf = _TileBuffers(npad, F, P, None, False, tat.torch.device("cpu"))
            upload = hint * F * buf.x.element_size()
            assert (cell.npad, cell.nb) == (npad, -(-npad // 64))
            assert cell.bytes_moved == upload + buf.result.numel()
            assert cell.feasible == (2 * (buf.x.nbytes + buf.result.numel())
                                     <= tat.TILE_BUFFER_BUDGET)


def test_cuda_choices():
    """On "cuda" the kernel's blocks do not change with block_m, so the
    least padding wins and ties go to the smaller block, whose ladder pads
    no ragged chunk more: the smallest candidate with or without a hint,
    a larger block only where it pads the hint's chunk less; a buffer over
    the budget is infeasible.  The "cuda" key is not the JAX package's
    "gpu" key."""
    full = tat.choose_block_m(64, 64, 2, backend="cuda")
    assert full.block_m == 128 and full.static_block_m == tat.static_heuristic_block_m(64, 64, 2)
    assert tat.choose_block_m(64, 192, 6, n_rows_hint=1024, backend="cuda").block_m == 128
    assert tat.choose_block_m(64, 192, 6, n_rows_hint=1000, backend="cuda").block_m == 128
    for bm in (128, 256, 1024, 8192):  # the smaller block never pads a chunk more
        for n in (1, 100, 129, 513, 1000, 4096, 8192):
            assert tat.padded_rows(n, 128, 8192) <= tat.padded_rows(n, bm, 8192)
    wide = tat.choose_block_m(4096, 256, 4, backend="cuda")  # 8192 rows: 256 MiB a bucket
    assert wide.block_m < 8192
    assert not tat.cell_model(4096, 256, 4, "float32", 8192, 8192, backend="cuda").feasible
    assert tat.backend_constants("cuda").source == "default"
    keys = {k[4] for k in tat._CACHE}
    assert keys == {"cuda"} and "gpu" not in keys
