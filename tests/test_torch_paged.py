"""The port's paged-serving host modules and paged attention against the
JAX package, on the CPU.

* ``serving/kvpool.py`` and ``serving/scheduler.py``: the port's copy and
  the reference's run one seeded trace of calls each and must return the
  same admissions, stats, ledgers and reports at every step (exact).
* ``mixfp4_attn_decode_paged``'s plain version: bitwise the fixed-slot
  plain version on the gathered rows, and within 1e-5 (absolute, the
  reference's own attention tolerance) of the reference's paged kernel in
  interpret mode over the reference's paged cases, with junk wire bytes in
  the trash page.  ``ref.ref_attn_decode_packed(block_tables=)`` against
  the reference's oracle, 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.serving import kvpool as jkvpool  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch.kernels import mixfp4_attn, ops, ref  # noqa: E402
from repro_torch.serving import kvpool, scheduler  # noqa: E402


# ---------------------------------------------------------------------------
# KVPool
# ---------------------------------------------------------------------------
def _pool_trace(seed: int, n_ops: int = 300):
    """A seeded call trace over prompts built from a few shared prefixes
    (so full-page and partial-page hits both occur) on a pool small
    enough to evict and to refuse admissions."""
    rng = np.random.RandomState(seed)
    bases = [rng.randint(0, 50, 14).tolist() for _ in range(3)]
    ops_ = []
    n_live = 0
    for _ in range(n_ops):
        if n_live and rng.rand() < 0.4:
            ops_.append(("release", int(rng.randint(n_live))))
            n_live -= 1
            continue
        base = bases[rng.randint(len(bases))][:rng.randint(0, 15)]
        prompt = base + rng.randint(0, 50, rng.randint(1, 7)).tolist()
        ops_.append(("acquire", prompt, int(rng.randint(1, 6)),
                     bool(rng.rand() < 0.85)))
        n_live += 1
    return ops_


def _run_pool(pool, trace):
    """Replay ``trace`` on ``pool``; returns what every call returned and
    the stats after it."""
    live, seen = [], []
    for op in trace:
        if op[0] == "release":
            if op[1] < len(live):
                pool.release(live.pop(op[1]))
            seen.append(("release", pool.stats()))
            continue
        _, prompt, max_new, insert = op
        adm = pool.acquire(prompt, max_new)
        got = None if adm is None else dataclasses.astuple(adm)
        if adm is not None:
            if insert:
                pool.insert(prompt, adm.pages)
            live.append(adm.pages)
        seen.append((got, pool.pages_needed(len(prompt), max_new),
                     pool.stats()))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("page_len", [4, 16])
def test_kvpool_replays_reference_trace(seed, page_len):
    trace = _pool_trace(seed)
    n_pages = 12 if page_len == 4 else 4
    got = _run_pool(kvpool.KVPool(n_pages, page_len), trace)
    want = _run_pool(jkvpool.KVPool(n_pages, page_len), trace)
    assert got == want
    if page_len == 4:        # the trace reaches every branch of the pool
        final = got[-1][-1]
        assert final["prefix_hits"] > 0 and final["cow_copies"] > 0
        assert final["evictions"] > 0 and final["alloc_failures"] > 0


def test_kvpool_plain_allocator_and_errors_match_reference():
    # with no prompt ever inserted the pool is a plain page allocator: no
    # hits, no cached pages, released pages go straight back to the free
    # list, and a full pool refuses admissions
    trace = [op if op[0] == "release" else op[:3] + (False,)
             for op in _pool_trace(5, n_ops=80)]
    got = _run_pool(kvpool.KVPool(10, 4), trace)
    assert got == _run_pool(jkvpool.KVPool(10, 4), trace)
    stats = [step[-1] for step in got]
    assert all(st["prefix_hits"] == 0 and st["pages_cached"] == 0
               for st in stats)
    assert stats[-1]["alloc_failures"] > 0
    for mod in (kvpool, jkvpool):
        with pytest.raises(ValueError, match="trash"):
            mod.KVPool(1, 16)
        with pytest.raises(ValueError, match="page_len"):
            mod.KVPool(4, 0)
    pool = kvpool.KVPool(4, 16)
    assert 0 not in pool.acquire(list(range(40)), 8).pages   # never page 0


# ---------------------------------------------------------------------------
# ChunkedPrefillScheduler
# ---------------------------------------------------------------------------
def _run_scheduler(sched, seed: int):
    """Enqueue seeded jobs (some starting past a cached prefix), run one
    chunk a step with a varying decode batch, and record everything the
    scheduler reports."""
    rng = np.random.RandomState(seed)
    seen, uid = [], 0
    for _step in range(60):
        if rng.rand() < 0.3:
            p_len = int(rng.randint(1, 40))
            start = int(rng.randint(0, p_len)) if rng.rand() < 0.3 else 0
            job = sched.enqueue(uid, uid % 4, None, p_len, start_pos=start)
            seen.append(("enqueue", job.uid, job.cursor, job.remaining))
            uid += 1
        job = sched.head()
        spent = 0
        if job is not None:
            spent = min(sched.chunk, job.p_len - job.cursor)
            done = sched.advance(job, spent)
            seen.append(("advance", job.uid, job.cursor, job.chunks_done,
                         done, sched.get(job.uid) is None))
        sched.note_step(spent, int(rng.randint(0, 4)))
        seen.append(("report", sched.report(), sched.step_log[-1]))
    return seen


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_scheduler_replays_reference_ledger(chunk):
    got = _run_scheduler(scheduler.ChunkedPrefillScheduler(chunk), chunk)
    want = _run_scheduler(jscheduler.ChunkedPrefillScheduler(chunk), chunk)
    assert got == want
    assert got[-1][1]["jobs_completed"] > 0


def test_scheduler_errors_match_reference():
    for mod in (scheduler, jscheduler):
        with pytest.raises(ValueError, match=">= 1"):
            mod.ChunkedPrefillScheduler(0)
        s = mod.ChunkedPrefillScheduler(4)
        s.enqueue(7, 0, None, 10)
        with pytest.raises(ValueError, match="already has"):
            s.enqueue(7, 1, None, 10)


# ---------------------------------------------------------------------------
# paged decode attention (plain version)
# ---------------------------------------------------------------------------
PAGED_CASES = [
    # (b, s, hkv, group, dh, window, softcap, page_len) — the reference's
    # tests/test_attn_kernel.py PAGED_CASES (their key-block sizes are the
    # TPU kernel's tiling, which the port's kernel does not have)
    (2, 64, 2, 2, 32, 0, 0.0, 16),
    (2, 64, 2, 2, 32, 0, 0.0, 32),
    (2, 64, 1, 4, 48, 7, 30.0, 16),
    (1, 32, 2, 1, 32, 0, 0.0, 16),
]


def _page_slabs(a: np.ndarray, page_len: int, seed: int, junk: np.ndarray):
    """Scatter a fixed (B, S, ...) cache into permuted pool slabs
    (1 + B*S/page_len, page_len, ...) with ``junk`` in page 0, the trash
    page, and the block tables that map them back."""
    b, s = a.shape[:2]
    mp = s // page_len
    bt = 1 + np.random.RandomState(seed).permutation(b * mp).reshape(b, mp)
    slab = np.zeros((1 + b * mp, page_len) + a.shape[2:], a.dtype)
    slab[0] = junk
    for i in range(b):
        for j in range(mp):
            slab[bt[i, j]] = a[i, j * page_len:(j + 1) * page_len]
    return slab, bt.astype(np.int32)


def _paged_case(case):
    b, s, hkv, g, dh, window, softcap, page_len = case
    rng = np.random.RandomState(sum(case[:5]))
    q = rng.randn(b, hkv * g, dh).astype(np.float32)
    fixed = []
    for _ in range(2):
        p, sc = jbase.quantize_kv_rows(jnp.asarray(
            rng.randn(b, s, hkv, dh).astype(np.float32)))
        fixed += [np.array(p), np.array(sc)]
    jp, js = jbase.quantize_kv_rows(jnp.asarray(
        3.0 * rng.randn(page_len, hkv, dh).astype(np.float32)))
    junk = [np.array(jp), np.array(js)] * 2
    slabs, bt = [], None
    for a, j in zip(fixed, junk):
        slab, bt = _page_slabs(a, page_len, seed=s, junk=j)
        slabs.append(slab)
    lengths = np.random.RandomState(s).randint(1, s + 1, (b,)).astype(
        np.int32)
    return q, fixed, slabs, bt, lengths


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_is_fixed_plain_on_gathered_rows(case):
    window, softcap = case[5], case[6]
    q, fixed, slabs, bt, lengths = _paged_case(case)
    t = torch.from_numpy
    got = mixfp4_attn.mixfp4_attn_decode_paged(
        t(q), *map(t, slabs), t(bt), t(lengths), window=window,
        softcap=softcap)
    want = mixfp4_attn.mixfp4_attn_decode(
        t(q), *map(t, fixed), t(lengths), window=window, softcap=softcap)
    assert torch.equal(got, want)
    gathered = [mixfp4_attn.gather_pages(t(a), t(bt)) for a in slabs]
    assert all(torch.equal(g, t(f)) for g, f in zip(gathered, fixed))


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_vs_reference_paged_kernel(case):
    window, softcap = case[5], case[6]
    q, _, slabs, bt, lengths = _paged_case(case)
    got = ops.attn_decode_paged(
        *map(torch.from_numpy, (q, *slabs, bt, lengths)), window=window,
        softcap=softcap)
    want = jops.attn_decode_paged(
        *map(jnp.asarray, (q, *slabs, bt, lengths)), window=window,
        softcap=softcap, interpret=True)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_paged_plain_ignores_trash_page_contents():
    """A table whose unused tail points at page 0 gives the same output
    whatever wire bytes page 0 holds (idle lanes write real quantizer
    output there, never arbitrary bit patterns): rows at or past a length
    are masked."""
    case = (1, 32, 2, 2, 32, 0, 0.0, 16)
    q, _, slabs, bt, _ = _paged_case(case)
    lengths = np.array([13], np.int32)          # page 1 of 2 only
    bt_trash = np.array([[bt[0, 0], 0]], np.int32)
    t = torch.from_numpy
    outs = []
    for scale in (0.0, 40.0):
        rows = scale * np.random.RandomState(3).randn(16, 2, 32)
        p, sc = jbase.quantize_kv_rows(jnp.asarray(rows.astype(np.float32)))
        junked = [a.copy() for a in slabs]
        for a, j in zip(junked, (p, sc, p, sc)):
            a[0] = np.asarray(j)
        outs.append(ops.attn_decode_paged(t(q), *map(t, junked),
                                          t(bt_trash), t(lengths)))
    assert torch.equal(outs[0], outs[1])
    assert torch.isfinite(outs[0]).all()


@pytest.mark.parametrize("case", PAGED_CASES[:3])
def test_paged_oracle_matches_reference_oracle(case):
    window, softcap = case[5], case[6]
    q, _, slabs, bt, lengths = _paged_case(case)
    got = ref.ref_attn_decode_packed(
        *map(torch.from_numpy, (q, *slabs, lengths)), window=window,
        softcap=softcap, block_tables=torch.from_numpy(bt))
    want = jref.ref_attn_decode_packed(
        *map(jnp.asarray, (q, *slabs, lengths)), window=window,
        softcap=softcap, block_tables=jnp.asarray(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_paged_wrapper_checks_shapes():
    case = (1, 32, 2, 1, 32, 0, 0.0, 16)
    q, _, slabs, bt, lengths = _paged_case(case)
    t = torch.from_numpy
    args = [t(q), *map(t, slabs), t(bt), t(lengths)]
    with pytest.raises(ValueError, match="page_len"):
        bad = [a[:, :8].contiguous() for a in args[1:5]]
        mixfp4_attn.mixfp4_attn_decode_paged(args[0], *bad, *args[5:])
    with pytest.raises(ValueError, match="block_tables"):
        mixfp4_attn.mixfp4_attn_decode_paged(*args[:5], args[5][0],
                                             args[6])
    with pytest.raises(ValueError, match="k_scales"):
        mixfp4_attn.mixfp4_attn_decode_paged(args[0], args[1], args[1],
                                             *args[3:])
    with pytest.raises(ValueError, match="unsupported device"):
        mixfp4_attn.mixfp4_attn_decode_paged(
            *[a.to("meta") for a in args[:5]],
            args[5].to("meta"), args[6].to("meta"))
