"""The ``cascade_score`` route on the CPU: the scorer's buffered tile path,
and the kernel's one-launch survivor scan emulated in plain numpy.

* ``CascadeScorer`` on ``device="cpu"`` runs through the same per-bucket
  buffers and result layout (``[counts | packed | mask | scores]``) that the
  card's route uses.  Its results must equal, bit for bit, what the route
  gave before those buffers existed: each tile zero-padded to its bucket,
  ``cascade_score_plain`` on it, and the survivor lists assembled from its
  outputs (``_reference_score_compact``).  Ragged tiles, several tiles,
  ``compact_cols`` subsets, no and all survivors, P = 130, int8 and fp8.
  One case is also held to the JAX package's oracle.
* ``_emulate_scan`` replays the kernel's look-back (csrc/cascade_score.cu)
  on a mask: blocks of ``ROWS_PER_BLOCK`` rows draw tickets in order, then
  publish and look back in a random interleaving, over status words that
  hold stale values from an earlier epoch, in windows of 128 predecessors
  used up to the nearest inclusive prefix once every word before it is
  ready; survivors go to base + rank, rejects to the reversed tail.  It must give exactly
  ``cascade_score_plain``'s ``packed`` and ``counts``, every slot written
  once.  An emulation that ignores the epoch reads a stale word and fails.
  This is an emulation, not the kernel, which runs only on the card
  (``tests/test_torch_gpu.py``).
* The executor hands the scorer each tile as a view of the stream, with
  results equal to scoring a copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import proxy_family as jpf
from repro.kernels import ref as jref

from repro_torch import quickstart
from repro_torch.core import execute_plan
from repro_torch.core.proxy_family import (PackedCascade, cascade_kernel_operands,
                                           quantize_cascade)
from repro_torch.kernels import ops
from repro_torch.kernels.ops import CascadeScorer
from repro_torch.kernels.proxy_score import ROWS_PER_BLOCK, cascade_score_plain
from _one_thread import one_thread  # noqa: F401


FMAX = float(np.finfo(np.float32).max)
TOL = 1e-5


def _packed(F, H, P, dtype, seed):
    rng = np.random.RandomState(seed)
    packed = PackedCascade(
        w1=(rng.randn(F, H, P) / np.sqrt(F)).astype(np.float32),
        b1=(0.1 * rng.randn(H, P)).astype(np.float32),
        w2=(rng.randn(H, P) / np.sqrt(H)).astype(np.float32),
        b2=(0.1 * rng.randn(P)).astype(np.float32),
        hidden=(H,) * P, families=("mlp1",) * P)
    return packed if dtype == "float32" else quantize_cascade(packed, dtype)


def _thresholds(packed, x, mode):
    P = packed.w1.shape[2]
    if mode == "none":
        return np.full(P, FMAX, np.float32)
    if mode == "all":
        return np.full(P, -FMAX, np.float32)
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in cascade_kernel_operands(packed))
    scale = None if packed.out_scale is None else torch.from_numpy(packed.out_scale)
    s, _m, _p, _c = cascade_score_plain(torch.from_numpy(x), w1, b1, w2, b2,
                                        torch.zeros(P), len(x), out_scale=scale,
                                        with_compaction=False)
    return s.median(dim=0).values.numpy().astype(np.float32)


def _reference_score_compact(scorer, x, need_scores, compact_cols):
    """The route as it was before the buffered path: pad each tile to its
    bucket, score it with the plain version, assemble the lists."""
    P = scorer.n_proxies
    cols = tuple(range(P)) if compact_cols is None else tuple(compact_cols)
    scores, masks, counts = [], [], np.zeros(P, np.int32)
    parts = {col: [] for col in cols}
    for start in range(0, len(x), scorer.max_tile):
        tile = x[start:start + scorer.max_tile]
        n = len(tile)
        xp = np.zeros((scorer._bucket(n), tile.shape[1]), np.float32)
        xp[:n] = tile
        s, m, pk, cnt = cascade_score_plain(
            torch.from_numpy(xp), scorer.w1, scorer.b1, scorer.w2, scorer.b2, scorer.thr, n,
            out_scale=scorer.out_scale, compact_cols=cols)
        scores.append(s[:n].numpy())
        masks.append(m[:n].numpy())
        counts += cnt.numpy()
        for ci, col in enumerate(cols):
            parts[col].append(pk[ci, :cnt[col]].numpy() + start)
    packed = [None] * P
    for col in cols:
        packed[col] = np.concatenate(parts[col])
    return (np.concatenate(scores) if need_scores else None, np.concatenate(masks), packed,
            counts)


# (N, F, H, P, weights, max_tile, compact_cols, thresholds, with scores)
ROUTE_CASES = [
    (1, 16, 4, 3, "float32", 8192, None, "median", True),
    (255, 16, 4, 3, "int8", 8192, (1,), "median", False),
    (257, 24, 8, 2, "fp8", 8192, (0, 1), "median", True),
    (8191, 64, 32, 3, "float32", 8192, (0,), "median", False),
    (3 * 512 + 7, 20, 4, 3, "float32", 512, (0, 2), "median", True),  # four tiles
    (700, 12, 2, 130, "float32", 512, (0, 64, 129), "median", True),
    (700, 12, 2, 130, "int8", 8192, None, "median", False),
    (600, 16, 4, 3, "int8", 256, (), "median", False),  # counts only, three tiles
    (257, 16, 4, 3, "float32", 8192, None, "none", True),
    (1000, 16, 4, 3, "fp8", 256, None, "all", False),
]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_buffered_route_equals_plain_assembly(case):
    N, F, H, P, weights, max_tile, cols, thr_mode, need_scores = case
    seed = N + F + P
    packed = _packed(F, H, P, weights, seed)
    x = np.random.RandomState(seed + 1).randn(N, F).astype(np.float32)
    thr = _thresholds(packed, x, thr_mode)
    scorer = CascadeScorer([None] * P, thr, packed=packed, block_m=128, max_tile=max_tile,
                           device="cpu")
    got = scorer.score_compact(x, need_scores=need_scores, compact_cols=cols)
    want = _reference_score_compact(scorer, x, need_scores, cols)
    if need_scores:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        assert got[0] is None
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    for col in range(P):
        if want[2][col] is None:
            assert got[2][col] is None
        else:
            np.testing.assert_array_equal(got[2][col], want[2][col])
            assert got[2][col].dtype == np.int32
    if thr_mode == "none":
        assert not got[1].any() and not got[3].any()
    if thr_mode == "all":
        assert got[1].all() and (got[3] == N).all()
    np.testing.assert_array_equal(scorer.score_masks(x), want[1])


def test_buffered_route_matches_the_jax_oracle():
    """P = 130 int8 over three tiles, against ``repro.kernels.ref``."""
    F, H, P, N = 12, 2, 130, 1100
    rng = np.random.RandomState(3)
    jpacked = jpf.quantize_cascade(jpf.PackedCascade(
        w1=rng.randn(F, H, P).astype(np.float32), b1=rng.randn(H, P).astype(np.float32),
        w2=rng.randn(H, P).astype(np.float32), b2=rng.randn(P).astype(np.float32),
        hidden=(H,) * P, families=("mlp1",) * P), "int8")
    tpacked = PackedCascade(w1=jpacked.w1, b1=jpacked.b1, w2=jpacked.w2, b2=jpacked.b2,
                            hidden=jpacked.hidden, families=jpacked.families,
                            dtype=jpacked.dtype, out_scale=jpacked.out_scale)
    x = rng.randn(N, F).astype(np.float32)
    thr = (0.5 * rng.randn(P)).astype(np.float32)
    scorer = CascadeScorer([None] * P, thr, packed=tpacked, block_m=128, max_tile=512,
                           device="cpu")
    s, masks, packed, counts = scorer.score_compact(x, need_scores=True)
    rs, rm, _ = jref.cascade_score_ref(
        jnp.asarray(x), *(jnp.asarray(a) for a in jpf.cascade_kernel_operands(jpacked)),
        jnp.asarray(thr), out_scale=jnp.asarray(jpacked.out_scale))
    rs, rm = np.asarray(rs), np.asarray(rm)
    np.testing.assert_allclose(s, rs, rtol=TOL, atol=TOL)
    tie = np.abs(rs - thr) <= TOL * np.maximum(1.0, np.abs(thr))
    assert not np.any((masks != rm) & ~tie)
    for col in range(P):
        np.testing.assert_array_equal(packed[col], np.flatnonzero(masks[:, col]))
        assert counts[col] == len(packed[col])


def test_rows_past_the_tile_do_not_reach_the_results():
    """A short tile after a longer one of non-finite values in the same
    bucket: the rows the longer tile left behind are masked out by
    ``n_valid`` and change nothing against the zero-padded reference."""
    packed = _packed(8, 2, 2, "float32", 0)
    scorer = CascadeScorer([None] * 2, np.zeros(2, np.float32), packed=packed, block_m=128,
                           device="cpu")
    rng = np.random.RandomState(1)
    long = np.full((120, 8), np.nan, np.float32)
    long[::3] = np.inf
    short = rng.randn(70, 8).astype(np.float32)
    scorer.score_compact(long, need_scores=True)
    got = scorer.score_compact(short, need_scores=True)
    assert not np.isfinite(scorer._tile_buffers(128, 2, True).x[70:120].numpy()).any()
    want = _reference_score_compact(scorer, short, True, None)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    for col in range(2):
        np.testing.assert_array_equal(got[2][col], want[2][col])


def test_results_do_not_alias_the_reused_buffers():
    packed = _packed(8, 2, 2, "float32", 2)
    scorer = CascadeScorer([None] * 2, np.zeros(2, np.float32), packed=packed, block_m=128,
                           device="cpu")
    rng = np.random.RandomState(2)
    a, b = rng.randn(100, 8).astype(np.float32), rng.randn(100, 8).astype(np.float32)
    first = scorer.score_compact(a, need_scores=True)
    kept = [first[0].copy(), first[1].copy(), [p.copy() for p in first[2]], first[3].copy()]
    scorer.score_compact(b, need_scores=True)
    np.testing.assert_array_equal(first[0], kept[0])
    np.testing.assert_array_equal(first[1], kept[1])
    np.testing.assert_array_equal(first[3], kept[3])
    for p, q in zip(first[2], kept[2]):
        np.testing.assert_array_equal(p, q)


# ------------------------------------------------ the kernel's look-back
AGGREGATE, PREFIX = 1, 2
WINDOW = 4 * 32  # predecessors a warp reads at once (kWindows lanes' words)


def _emulate_scan(mask, cols, rng, *, epoch=5, honour_epoch=True):
    """The kernel's survivor scan and compaction over ``mask`` (N, P) bool
    (see the module doc).  Returns (packed (C, N), counts (P,))."""
    N, P = mask.shape
    nb = -(-N // ROWS_PER_BLOCK)
    agg = np.add.reduceat(mask.astype(np.int64), np.arange(0, N, ROWS_PER_BLOCK), axis=0)
    status = np.stack([np.full((nb, P), epoch - 1),  # stale words of an earlier call
                       rng.randint(1, 3, (nb, P)), rng.randint(0, N + 1, (nb, P))], -1)
    excl = np.full((nb, P), -1, np.int64)
    drawn, published = 0, set()
    pending = {}  # tile -> {column: [window top, prefix so far]}

    def ready(j, p):
        if j < 0:
            return True, PREFIX, 0
        e, flag, value = status[j, p]
        return (e == epoch or not honour_epoch) and flag != 0, flag, value

    while drawn < nb or pending or len(published) < drawn:
        moves = (["draw"] if drawn < nb else []) + \
                [("publish", t) for t in range(drawn) if t not in published] + \
                [("look", t) for t in pending]
        move = moves[rng.randint(len(moves))]
        if move == "draw":  # a block draws the next ticket and starts scoring
            drawn += 1
        elif move[0] == "publish":
            t = move[1]
            published.add(t)
            for p in range(P):
                status[t, p] = (epoch, PREFIX if t == 0 else AGGREGATE, agg[t, p])
            if t == 0:
                excl[0] = 0
            else:
                pending[t] = {p: [t - 1, 0] for p in range(P)}
        else:  # one warp's read of one column's window of predecessors
            t = move[1]
            p = list(pending[t])[rng.randint(len(pending[t]))]
            top, prefix = pending[t][p]
            window = [ready(top - d, p) for d in range(WINDOW)]
            waiting = [d for d, (ok, _f, _v) in enumerate(window) if not ok]
            prefixes = [d for d, (ok, f, _v) in enumerate(window) if ok and f == PREFIX]
            first_wait = waiting[0] if waiting else WINDOW
            first_prefix = prefixes[0] if prefixes else WINDOW
            if first_wait < WINDOW and first_prefix > first_wait:
                continue  # spin: a word before the nearest prefix is not ready
            prefix += sum(v for _ok, _f, v in window[:first_prefix + 1])
            if first_prefix < WINDOW:
                excl[t, p] = prefix
                status[t, p] = (epoch, PREFIX, prefix + agg[t, p])
                del pending[t][p]
                if not pending[t]:
                    del pending[t]
            else:
                pending[t][p] = [top - WINDOW, prefix]
    counts = excl[-1] + agg[-1]
    packed = np.full((len(cols), N), -7, np.int64)
    writes = np.zeros((len(cols), N), np.int64)
    for t in range(nb):
        r0 = t * ROWS_PER_BLOCK
        keep = mask[r0:r0 + ROWS_PER_BLOCK]
        for c, p in enumerate(cols):
            base, below = excl[t, p], 0
            for i, kept in enumerate(keep[:, p]):
                slot = base + below if kept else N - 1 - (r0 - base) - (i - below)
                assert 0 <= slot < N, f"slot {slot} outside the list"
                packed[c, slot] = r0 + i if kept else -1
                writes[c, slot] += 1
                below += int(kept)
    assert (writes == 1).all(), "a packed slot was written other than once"
    return packed, counts


@pytest.mark.parametrize("N,P,cols,seed", [
    (1, 1, (0,), 0), (63, 2, (1,), 1), (64, 3, (0, 2), 2), (65, 3, (), 3),
    (2100, 3, (0, 1, 2), 4), (2100, 130, (0, 64, 129), 5), (4160, 2, (0,), 6),
    (20000, 2, (1,), 7)])  # 313 tiles: windows of 128 end without a prefix
def test_look_back_emulation_equals_plain_compaction(N, P, cols, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, 8).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(8, 2 * P).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(2 * P, P).astype(np.float32))
    thr = torch.from_numpy((0.5 * rng.randn(P)).astype(np.float32))
    n_valid = N - N // 7
    _s, mask, packed, counts = cascade_score_plain(
        x, w1, torch.zeros(2 * P), w2, torch.zeros(P), thr, n_valid, compact_cols=cols)
    got_packed, got_counts = _emulate_scan(mask.numpy(), cols, rng)
    np.testing.assert_array_equal(got_counts, counts.numpy())
    np.testing.assert_array_equal(got_packed, packed.numpy().reshape(len(cols), N))


def test_look_back_without_the_epoch_reads_stale_words():
    """The same schedule with stale words taken as ready: wrong slots."""
    rng = np.random.RandomState(0)
    mask = rng.rand(2100, 2) < 0.5
    _s, _m, packed, counts = cascade_score_plain(
        torch.from_numpy(mask.astype(np.float32)), torch.eye(2), torch.zeros(2),
        torch.eye(2), torch.zeros(2), torch.full((2,), 0.5), 2100)
    ok = _emulate_scan(mask, (0, 1), np.random.RandomState(9))
    np.testing.assert_array_equal(ok[0], packed.numpy())
    with pytest.raises(AssertionError):
        bad = _emulate_scan(mask, (0, 1), np.random.RandomState(9), honour_epoch=False)
        np.testing.assert_array_equal(bad[1], counts.numpy())
        np.testing.assert_array_equal(bad[0], packed.numpy())


# ------------------------------------------------------------ the executor
@pytest.fixture(scope="module")
def small_quickstart():
    return quickstart.run(3000, "cpu", verbose=False)


def test_executor_scores_tiles_as_views(small_quickstart, monkeypatch):
    plan = small_quickstart["plan"]
    from repro_torch.data.synthetic import make_dataset
    x = make_dataset(name="tweets", n=3000, correlation=0.9, seed=0).x[1500:]
    seen = []
    real = ops.CascadeScorer.score_compact

    def spy(self, tile, **kw):
        seen.append(np.shares_memory(tile, x))
        return real(self, tile, **kw)

    monkeypatch.setattr(ops.CascadeScorer, "score_compact", spy)
    res = execute_plan(plan, x, batch_size=512, use_kernel=True, device="cpu")
    assert len(seen) == 3 and all(seen)

    def copying(self, tile, **kw):
        return real(self, np.array(tile, copy=True), **kw)

    monkeypatch.setattr(ops.CascadeScorer, "score_compact", copying)
    ref = execute_plan(plan, x, batch_size=512, use_kernel=True, device="cpu")
    np.testing.assert_array_equal(res.passed, ref.passed)
    assert [(s.n_in, s.n_proxy_kept, s.n_pass) for s in res.stages] == \
        [(s.n_in, s.n_proxy_kept, s.n_pass) for s in ref.stages]
    assert all(s.used_kernel for s, st in zip(res.stages, plan.stages) if st.proxy is not None)
