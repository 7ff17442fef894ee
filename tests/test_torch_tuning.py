"""The port's split selectors (``repro_torch/kernels/tuning.py``).

CPU only.  The CUDA GEMMs take the variant and the K split depth from
``tuning.select``; these tests hold its contracts: splits from K alone (so
a row's output is bitwise independent of M and N), boundaries on the
32-deep slab grid and ending at K, the decode/prefill threshold, column
tile and split depth equal to the C header's constants, and enough CTAs
at decode M for every SM of an H100 on every gemma2-2b projection.

Decode attention takes its key split from ``tuning.attn_splits`` and
``tuning.attn_split_range``: boundaries from key position alone (so a
sequence's output is bitwise independent of B and of the cache's
capacity, and paged equals fixed), ``SPLIT_S`` a multiple of the KV
pool's page and equal to the C source's, and at least one non-empty CTA
per SM at ``chip_smoke.py``'s phase-2 shape.

The expert stack's decode kernel takes its column tile, threads and ring
depth from ``tuning.expert_plan``: a pure function of (C, K, N) within
the C launcher's limits (constants against ``mixfp4_gemm_experts.cuh``),
its tiles covering every column once, its splits ``select``'s (K alone),
and at the served B = 4 decode at least one CTA per SM from the 16
experts that hold a row.

  PYTHONPATH=src python -m pytest -q tests/test_torch_tuning.py
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import mixfp4_gemm, tuning

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "src" / "repro_torch" / "csrc" / "mixfp4_gemm_tile.cuh"
ATTN_SRC = HEADER.parent / "mixfp4_attn_decode.cu"
KS = [16, 32, 48, 208, 256, 272, 2048, 2304, 4096, 9216, 9232]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _header_constants(path: Path = HEADER) -> dict[str, int]:
    text = path.read_text()
    found = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    return {k: int(v) for k, v in found.items()}


H100_SMS = 132


def _bounds(plan, k: int) -> tuple[int, ...]:
    """The split boundaries the C side derives from split_k and K."""
    return (*range(0, k, plan.split_k), k)


@pytest.mark.parametrize("k", KS)
def test_split_bounds_depend_on_k_alone(k):
    """The same splits at every M, on both sides of the variant threshold
    (``select`` takes no N at all)."""
    plans = {tuning.select(m, k)[1:] for m in (1, 4, 16, 64, 65, 4544)}
    assert plans == {(tuning.SPLIT_K, -(-k // tuning.SPLIT_K))}


@pytest.mark.parametrize("k", KS)
def test_split_bounds_on_the_slab_grid_and_end_at_k(k):
    plan = tuning.select(4, k)
    bounds = _bounds(plan, k)
    assert len(bounds) - 1 == plan.splits
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert all(b % 32 == 0 for b in bounds[:-1])


@pytest.mark.parametrize("k", [0, -16, 8, 2300])
def test_split_bounds_reject_k_off_the_block_grid(k):
    with pytest.raises(ValueError):
        tuning.select(4, k)


def test_variant_threshold_and_tiles_match_the_c_header():
    c = _header_constants()
    assert c["DECODE_MAX_M"] == tuning.DECODE_MAX_M
    assert c["DBN"] == tuning.BN
    assert tuning.SPLIT_K % c["BK"] == 0
    assert c["BK"] <= tuning.SPLIT_K <= c["MAX_SPLIT_K"]
    for m, decode in ((0, True), (1, True), (64, True), (65, False),
                      (4544, False)):
        assert tuning.select(m, 2304).decode is decode


def test_c_launchers_check_the_plan():
    """Every C entry validates split_k and the decode threshold through
    check_plan before it launches."""
    csrc = HEADER.parent
    text = HEADER.read_text()
    assert "decode && m > DECODE_MAX_M" in text
    for src in ("mixfp4_gemm_w4a16.cu", "mixfp4_gemm_w4a4.cu"):
        assert "check_plan(m, " in (csrc / src).read_text()


@pytest.mark.parametrize("kn", _chip_smoke().LAYER,
                         ids=["wq", "wk", "wv", "wo", "gate", "up", "down"])
def test_gemma_projections_fill_every_sm_at_decode(kn):
    k, n = kn
    plan = tuning.select(4, k)
    assert plan.decode
    assert -(-n // tuning.BN) * plan.splits >= H100_SMS   # grid of a launch


@pytest.mark.parametrize("mkn", [(4, 2304, 1024), (64, 9216, 2304),
                                 (1, 208, 272)])
def test_decode_plan_arguments_and_workspace(mkn):
    """The wrappers' plan arguments: split depth, the decode flag, an f32
    workspace of at least splits x M x 64 column-tile floats and zeroed
    counters, one per column tile at least, both kept per device and
    reused by the next call."""
    m, k, n = mkn
    dev = torch.device("cpu")
    split_k, decode, work_ptr, counters_ptr = mixfp4_gemm._plan(m, k, n, dev)
    tiles = -(-n // 64)
    assert (split_k, decode) == (tuning.SPLIT_K, 1)
    counters, work = mixfp4_gemm._SCRATCH[dev]
    assert work.dtype == torch.float32 and work_ptr == work.data_ptr()
    assert work.numel() >= (-(-k // tuning.SPLIT_K)) * m * 64 * tiles
    assert counters_ptr == counters.data_ptr()
    assert counters.numel() >= tiles and not counters.any()
    assert mixfp4_gemm._plan(m, k, n, dev) == (split_k, decode, work_ptr,
                                               counters_ptr)


def test_prefill_plan_has_no_workspace():
    assert mixfp4_gemm._plan(65, 2304, 1024, torch.device("cpu")) == (
        tuning.SPLIT_K, 0, None, None)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
def _keys(length: int, window: int, s_len: int) -> list[int]:
    lo = max(0, length - window) if window > 0 else 0
    return list(range(lo, min(length, s_len)))


ATTN_SEQS = [(1, 0), (255, 0), (256, 0), (257, 0), (512, 0), (8192, 0),
             (600, 100), (1000, 300), (4532, 4096), (8192, 4096), (0, 0)]


@pytest.mark.parametrize("seq", ATTN_SEQS)
def test_attn_splits_depend_on_key_position_alone(seq):
    """A sequence's non-empty splits hold exactly its valid keys, split
    at multiples of SPLIT_S, and are the same at every capacity that holds
    the sequence, however many splits the capacity has."""
    length, window = seq
    ranges = set()
    for s_len in (max(length, 1), length + 16, length + 300, 4 * 8192):
        plan = tuning.attn_splits(s_len)
        assert plan.split_s == tuning.SPLIT_S
        assert plan.splits == max(1, -(-s_len // tuning.SPLIT_S))
        rng = tuning.attn_split_range(length, window, s_len)
        assert all(0 <= sp < plan.splits for sp in rng)
        keys = _keys(length, window, s_len)
        assert {k // tuning.SPLIT_S for k in keys} == set(rng)
        ranges.add((rng.start, rng.stop) if rng else None)
    assert len(ranges) == 1


def test_attn_split_and_page_constants_match_the_c_source():
    from repro_torch.serving.engine import ServeEngine
    import inspect

    c = _header_constants(ATTN_SRC)
    assert c["SPLIT_S"] == tuning.SPLIT_S
    assert c["SPLIT_S"] == c["NT"] // 32 * c["BS"]   # 32 keys per warp
    page = inspect.signature(ServeEngine).parameters["kv_page_len"].default
    assert tuning.SPLIT_S % page == 0
    assert tuning.SPLIT_S % _chip_smoke().PAGE_LEN == 0


def test_attn_phase2_shapes_fill_every_sm():
    """chip_smoke.py's phase-2 attention shapes (B = 4, S = 8192, Hkv = 4,
    global layer) launch at least one non-empty CTA per SM of an H100."""
    import numpy as np

    fixed = np.random.RandomState(4).randint(1, 8193, (4,))
    fixed[0] = 8192
    rng = np.random.RandomState(7)
    rng.randn(4, 8, 256)                                # q
    for _ in range(2):
        rng.randn(4, 8192, 4, 256)                      # K, then V rows
    paged = [8192, *rng.randint(1, 8193, 3)]
    for lengths in (fixed, paged):
        ctas = 4 * sum(len(tuning.attn_split_range(int(n), 0, 8192))
                       for n in lengths)
        assert ctas >= H100_SMS, (lengths, ctas)


@pytest.mark.parametrize("s_len", [-1, -256])
def test_attn_splits_reject_negative_capacity(s_len):
    with pytest.raises(ValueError):
        tuning.attn_splits(s_len)


@pytest.mark.parametrize("bshd", [(4, 8192, 8, 256), (1, 16, 2, 32),
                                  (3, 600, 24, 48)])
def test_attn_plan_arguments_and_workspace(bshd):
    """The attention wrappers' plan and scratch: an f32 workspace of at
    least B * H * (dh + 2) floats per split and zeroed counters, one per
    (sequence, kv head) at least, kept per device and reused."""
    from repro_torch.kernels import mixfp4_attn

    b, s, h, dh = bshd
    dev = torch.device("cpu")
    plan, work_ptr, counters_ptr = mixfp4_attn._plan(b, s, h, dh, dev)
    assert plan == tuning.attn_splits(s)
    counters, work = mixfp4_attn._SCRATCH[dev]
    assert work.dtype == torch.float32 and work_ptr == work.data_ptr()
    assert work.numel() >= b * h * (dh + 2) * plan.splits
    assert counters_ptr == counters.data_ptr()
    assert counters.numel() >= b * h and not counters.any()
    assert mixfp4_attn._plan(b, s, h, dh, dev) == (plan, work_ptr,
                                                   counters_ptr)


ROW_SCALE_SRC = HEADER.parent / "fwht_rows.cu"


@pytest.mark.parametrize("m", [0, 1, 4, 16, 17, 64, 65, 4544])
@pytest.mark.parametrize("k", KS)
def test_row_scale_plan_within_the_kernel_limits(m, k):
    """CTAs per row a power of two the C entry takes (1 to 8, one cluster),
    threads a power of two within its block limit, a cluster only at
    M <= 16, and every thread of a CTA with at most one 16-lane group
    unless the CTA is at the thread limit."""
    plan = tuning.row_scale_plan(m, k)
    limit = _header_constants(ROW_SCALE_SRC)["kRowScaleMaxThreads"]
    assert plan.ctas in (1, 2, 4, 8) and plan.threads in (128, 256)
    assert tuning.ROW_SCALE_MAX_THREADS == limit
    assert plan.ctas == 1 or m <= tuning.ROW_SCALE_CLUSTER_MAX_M
    per_cta = -(-(k // 16) // plan.ctas)
    assert per_cta <= plan.threads or plan.threads == limit


# the fastest (CTAs per row, threads) of ``decode_study.py rowscale-sweep``
# on the H100 (PERF.md §6), by (M, K)
ROW_SCALE_MEASURED = {(4, 2048): (1, 128), (4, 2304): (1, 256),
                      (4, 9216): (4, 256), (64, 9216): (1, 256),
                      (4544, 2048): (1, 128), (4544, 9216): (1, 256)}


@pytest.mark.parametrize("mk", sorted(ROW_SCALE_MEASURED))
def test_row_scale_plan_is_the_measured_fastest(mk):
    assert tuple(tuning.row_scale_plan(*mk)) == ROW_SCALE_MEASURED[mk]


@pytest.mark.parametrize("mk", [(4, 0), (4, 40), (-1, 64)])
def test_row_scale_plan_rejects_bad_shapes(mk):
    with pytest.raises(ValueError):
        tuning.row_scale_plan(*mk)


# ---------------------------------------------------------------------------
# the expert stack's decode kernel
# ---------------------------------------------------------------------------
EXPERT_SRC = HEADER.parent / "mixfp4_gemm_experts.cuh"
# qwen2-moe's expert projections: up/gate, down
MOE_KN = [(2048, 1408), (1408, 2048)]
EXPERT_CS = [0, 1, 4, 5, 16, 17, 32, 33, 63, 64]


@pytest.mark.parametrize("c", EXPERT_CS)
@pytest.mark.parametrize("kn", [*MOE_KN, (2304, 9216), (176, 48), (16, 16)])
def test_expert_plan_is_a_pure_function_within_the_kernel_limits(c, kn):
    """The plan depends on (C, K, N) alone (the same answer every call, no
    other input), takes a column tile and ring depth the C launcher
    accepts, one warp per 16 columns, and fits a CTA's shared memory."""
    import inspect

    k, n = kn
    assert list(inspect.signature(tuning.expert_plan).parameters) == [
        "c", "k", "n"]
    plan = tuning.expert_plan(c, k, n)
    assert plan == tuning.expert_plan(c, k, n)
    consts = _header_constants(EXPERT_SRC)
    assert consts["EXPERT_MIN_STAGES"] == tuning.EXPERT_MIN_STAGES
    assert consts["EXPERT_MAX_STAGES"] == tuning.EXPERT_MAX_STAGES
    assert consts["EXPERT_SMEM_LIMIT"] == tuning.EXPERT_SMEM_LIMIT
    assert plan in tuning.expert_plans(c, k)
    for cand in tuning.expert_plans(c, k):
        assert cand.tile_n in tuning.EXPERT_TILES
        assert cand.threads == 2 * cand.tile_n
        assert tuning.EXPERT_MIN_STAGES <= cand.stages <= \
            tuning.EXPERT_MAX_STAGES
        assert tuning.expert_smem_bytes(c, k, cand.tile_n, cand.stages) <= \
            tuning.EXPERT_SMEM_LIMIT


def test_expert_launcher_takes_the_plans_tiles():
    """The C launcher instantiates the expert kernel for the column tiles
    of ``tuning.EXPERT_TILES`` (16 columns, one warp, per scale block)."""
    text = (HEADER.parent / "mixfp4_gemm_w4a16.cu").read_text()
    warps = set(re.findall(r"w4a16_experts_decode_kernel<R, (\d+)>", text))
    assert warps == {str(t // 16) for t in tuning.EXPERT_TILES}
    assert all(f"tile_n == {t}" in text for t in tuning.EXPERT_TILES)


@pytest.mark.parametrize("c", EXPERT_CS)
@pytest.mark.parametrize("n", [16, 48, 1408, 2048, 2050, 9216])
def test_expert_plan_covers_every_column_once(c, n):
    """The column tiles of the launch (ceil(N / tile_n) CTAs per expert)
    hold every output column exactly once."""
    plan = tuning.expert_plan(c, 1408, n)
    tiles = -(-n // plan.tile_n)
    cols = [col for t in range(tiles)
            for col in range(t * plan.tile_n, min((t + 1) * plan.tile_n, n))]
    assert cols == list(range(n))


@pytest.mark.parametrize("kn", MOE_KN)
def test_expert_splits_come_from_k_alone(kn):
    """The expert kernel walks ``tuning.select``'s splits: the same depth
    and count at every decode C and N, as the 2-D entry's, so each expert's
    rows are bitwise the 2-D launch's and independent of C; the plan
    itself holds no split."""
    k, n = kn
    assert {tuning.select(c, k)[1:] for c in EXPERT_CS} == {
        (tuning.SPLIT_K, -(-k // tuning.SPLIT_K))}
    assert not set(tuning.ExpertPlan._fields) & {"split_k", "splits"}
    assert "split_k" in (HEADER.parent / "mixfp4_gemm_w4a16.cu").read_text()


@pytest.mark.parametrize("kn", MOE_KN)
def test_expert_plan_spreads_the_served_experts_over_every_sm(kn):
    """At the served B = 4 decode (C = 5) at most 16 experts hold a row;
    their CTAs alone must number at least one per SM of an H100."""
    k, n = kn
    plan = tuning.expert_plan(5, k, n)
    assert 16 * -(-n // plan.tile_n) >= H100_SMS


def test_expert_smem_bytes_counts_ring_scales_and_list():
    """C = 5, K = 1408 (6 splits), 64-column tile, 4 slots: 4 x (128 rows
    x 80 payload bytes + 5 x 264 bf16) + 6 x 16 x 4 scale pairs of 4
    bytes + (2 x 6 + 1) ints."""
    assert tuning.expert_smem_bytes(5, 1408, 64, 4) == \
        4 * (128 * 80 + 5 * 264 * 2) + 6 * 16 * 4 * 4 + 13 * 4


# the fastest plan (column tile, threads, ring slots) of ``decode_study.py
# experts-sweep`` on the H100 at qwen2-moe's expert projections, by C
# (64 experts of random rows; PERF.md §6)
EXPERT_MEASURED = {5: (64, 128, 2), 16: (128, 256, 2), 64: (128, 256, 2)}


@pytest.mark.parametrize("c", sorted(EXPERT_MEASURED))
@pytest.mark.parametrize("kn", MOE_KN)
def test_expert_plan_is_the_measured_fastest(c, kn):
    assert tuple(tuning.expert_plan(c, *kn)) == EXPERT_MEASURED[c]


@pytest.mark.parametrize("ckn", [(65, 2048, 1408), (-1, 2048, 1408),
                                 (5, 1400, 1408), (5, 0, 16)])
def test_expert_plan_rejects_shapes_off_the_decode_variant(ckn):
    with pytest.raises(ValueError):
        tuning.expert_plan(*ckn)
