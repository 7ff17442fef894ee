"""Variant and split selection for the MixFP4 GEMMs and decode attention
on Hopper.

Counterpart of ``repro/kernels/tuning.py`` as far as the CUDA GEMMs
(``csrc/mixfp4_gemm_tile.cuh``) need it.  The reference scores tiles with
a VMEM cost model of a TPU core; the CUDA kernels have two fixed designs
and one free choice, the K split, so the selector here is a pure function
of (M, K) with no profile file and no environment variable.  It returns
what the C launchers take:

* ``decode``: the decode variant for M <= :data:`DECODE_MAX_M` (one CTA
  per :data:`BN`-column tile and K split, the split partials reduced in
  the launch by the last CTA of each column tile), else the prefill
  variant (a 64x64 tile per CTA walking all of K);
* ``split_k``: the split depth.  The splits start at multiples of it and
  the last ends at K, in both variants: each is summed from zero and the
  splits are added in order, so a row's output is bitwise the same
  whatever M is;
* ``splits``: how many there are, which sizes the decode workspace.

Contracts (``tests/test_torch_tuning.py``): the splits depend on K alone,
never on M or N (the reference's "bk independent of N" contract, which
here also makes rows independent of M); they start on the 32-deep slab
grid and end at K; the threshold, the column tile and the split depth
agree with the C header's constants; at M = 4 every gemma2-2b projection
launches at least one CTA per SM of an H100.

Decode attention (``csrc/mixfp4_attn_decode.cu``) splits the keys of
each sequence into runs of :data:`SPLIT_S` logical positions, one CTA per
(sequence, kv head, split), and merges the splits inside the launch.
:func:`attn_splits` gives the launcher its split depth and the number of
splits of a cache, which sizes the workspace; :func:`attn_split_range`
the splits that hold a sequence's valid keys, the only ones that compute
and take part in the merge.  Both depend on key positions alone, so a
sequence's output is bitwise independent of its batchmates, of B and of
the cache's capacity, and the paged entry equals the fixed one.

The expert stack's decode variant (``csrc/mixfp4_gemm_experts.cuh``,
C <= :data:`DECODE_MAX_M` rows per expert) runs one CTA per (expert,
column tile) that walks every K split of its tile through a ring of
cp.async stages; :func:`expert_plan` gives it the column tile, the threads
per CTA and the ring's depth, from (C, K, N) alone.  The splits stay
:func:`select`'s, so each expert's rows are bitwise the 2-D entry's.

The RHT row scale (``fwht_row_scale`` in ``csrc/fwht_rows.cu``) reduces
each row in one launch; :func:`row_scale_plan` gives the CTAs per row
(one thread-block cluster) and the threads per CTA.  At M <= 16 a long
row (K = 9216) is split over a cluster; otherwise one CTA per row is
faster, as a cluster launch costs about a microsecond more.  The choice
changes which CTA reads which group, never a result bit (a max is exact
in any order).
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["GemmPlan", "select", "SPLIT_K", "DECODE_MAX_M", "BN",
           "AttnPlan", "attn_splits", "attn_split_range", "SPLIT_S",
           "RowScalePlan", "row_scale_plan", "ExpertPlan", "expert_plan",
           "expert_smem_bytes", "expert_plans"]

#: K split depth: 9 splits at K = 2304, 36 at K = 9216.  A multiple of the
#: prefill tile's 32-deep slab and at most ``MAX_SPLIT_K`` of the C side.
SPLIT_K = 256
#: the decode variant's largest M (``DECODE_MAX_M`` in the C header)
DECODE_MAX_M = 64
#: the decode variant's column tile (``DBN``): the workspace's row pitch is
#: this times the number of column tiles
BN = 64
#: decode attention's key split (``SPLIT_S`` in the C source): 32 splits
#: at 8192 keys; a multiple of the KV pool's 16-row page
SPLIT_S = 256


class GemmPlan(NamedTuple):
    """What the wrappers pass to the C launchers for one GEMM call."""

    decode: bool
    split_k: int
    splits: int


def select(m: int, k: int) -> GemmPlan:
    """The plan for y (m, n) = x (m, k) @ W (k, n); N plays no part."""
    if m < 0 or k <= 0 or k % 16:
        raise ValueError(f"M={m}, K={k}: K must be a positive multiple "
                         "of 16")
    return GemmPlan(m <= DECODE_MAX_M, SPLIT_K, -(-k // SPLIT_K))


class AttnPlan(NamedTuple):
    """What the attention wrappers pass to the C launchers for one call."""

    split_s: int
    splits: int


def attn_splits(s_len: int) -> AttnPlan:
    """The plan for a cache of ``s_len`` logical rows per sequence (S, or
    max_pages * page_len): splits start at multiples of :data:`SPLIT_S`;
    ``splits`` (at least 1) is the grid's split axis."""
    if s_len < 0:
        raise ValueError(f"S={s_len}: expected a row count >= 0")
    return AttnPlan(SPLIT_S, max(1, -(-s_len // SPLIT_S)))


def attn_split_range(length: int, window: int, s_len: int) -> range:
    """The splits holding a valid key of a sequence of ``length`` rows
    (``kpos < length`` and, for ``window > 0``,
    ``kpos > length - 1 - window``) in a cache of ``s_len`` rows."""
    hi = min(length, s_len)
    lo = max(0, length - window) if window > 0 else 0
    if lo >= hi:
        return range(0)
    return range(lo // SPLIT_S, (hi - 1) // SPLIT_S + 1)


class RowScalePlan(NamedTuple):
    """What the row-scale wrapper passes to its C launcher."""

    ctas: int      # CTAs per row, one cluster (1 to 8)
    threads: int   # threads per CTA


#: the most CTAs a row's cluster takes, and the M up to which a row is
#: split at all (above it the rows alone fill the card)
ROW_SCALE_MAX_CTAS = 8
ROW_SCALE_CLUSTER_MAX_M = 16
#: threads per CTA: the fewest powers of two in this range that give each
#: thread at most one 16-lane group (kRowScaleMaxThreads in the C source)
ROW_SCALE_MIN_THREADS = 128
ROW_SCALE_MAX_THREADS = 256


def row_scale_plan(m: int, k: int) -> RowScalePlan:
    """The plan for the row scale of x (m, k).  At M <= 16 a row of more
    than 256 groups is split over the fewest CTAs (a power of two, at most
    8) that leave each at most 256 groups; threads per CTA are the fewest
    (a power of two, 128 to 256) that give each thread one group.  These
    are the fastest plans of ``decode_study.py rowscale-sweep`` at every
    gemma2-2b K and M in (1, 4, 16, 64, 4544) (``PERF.md`` §6)."""
    if m < 0 or k <= 0 or k % 16:
        raise ValueError(f"M={m}, K={k}: K must be a positive multiple "
                         "of 16")
    groups = k // 16
    ctas = 1
    if m <= ROW_SCALE_CLUSTER_MAX_M:
        while (ctas < ROW_SCALE_MAX_CTAS
               and groups > ctas * ROW_SCALE_MAX_THREADS):
            ctas *= 2
    per_cta = -(-groups // ctas)
    threads = ROW_SCALE_MIN_THREADS
    while threads < min(per_cta, ROW_SCALE_MAX_THREADS):
        threads *= 2
    return RowScalePlan(ctas, threads)


class ExpertPlan(NamedTuple):
    """What the expert wrapper passes to the C launcher's decode variant."""

    tile_n: int    # columns per CTA: 16 per warp (one scale block each)
    threads: int   # threads per CTA: 2 * tile_n
    stages: int    # ring slots, each one K split's payload and activations


#: the column tiles and ring depths the C launcher takes
EXPERT_TILES = (64, 128)
EXPERT_MIN_STAGES, EXPERT_MAX_STAGES = 2, 4
#: dynamic shared memory a CTA can use on sm_90 (``EXPERT_SMEM_LIMIT``)
EXPERT_SMEM_LIMIT = 232448
#: the largest C that takes the 64-column tile (``decode_study.py
#: experts-sweep``: 64 columns fastest at C = 5, 128 at C = 16 and 64)
EXPERT_NARROW_MAX_C = 8


def expert_smem_bytes(c: int, k: int, tile_n: int, stages: int) -> int:
    """The decode CTA's dynamic shared memory (``expert_smem_bytes`` in the
    C header): ``stages`` ring slots of one split's payload rows (tile_n +
    16 bytes each) and C activation rows (SPLIT_K + 8 bf16), the scale
    table, the split flags and the work list."""
    splits = -(-k // SPLIT_K)
    stage = SPLIT_K // 2 * (tile_n + 16) + c * (SPLIT_K + 8) * 2
    return (stages * stage + splits * (SPLIT_K // 16) * (tile_n // 16) * 4
            + (2 * splits + 1) * 4)


def expert_plans(c: int, k: int) -> list[ExpertPlan]:
    """Every plan the C launcher takes at (C, K): each column tile with a
    ring of 2 to 4 slots, within a CTA's shared memory."""
    return [ExpertPlan(tile, 2 * tile, st) for tile in EXPERT_TILES
            for st in range(EXPERT_MIN_STAGES, EXPERT_MAX_STAGES + 1)
            if expert_smem_bytes(c, k, tile, st) <= EXPERT_SMEM_LIMIT]


def expert_plan(c: int, k: int, n: int) -> ExpertPlan:
    """The plan of the expert stack's decode variant for C rows per expert
    and a (K, N) projection: a 64-column tile up to C = 8 (every weight of
    a qwen2-moe projection over 22 or 32 tiles, so the 16 experts with a
    row at the served decode give 352 or 512 CTAs that carry weights), 128
    columns above (half the activation reads per weight byte), and a ring
    of 2 slots: the next split lands while the current one is multiplied.
    These are the fastest plans of ``decode_study.py experts-sweep`` at C
    = 5 (64 experts of random rows), 16 and 64 (``PERF.md`` §6); deeper
    rings hold more shared memory, so fewer CTAs share an SM, and were
    slower at every C measured."""
    if not 0 <= c <= DECODE_MAX_M or k <= 0 or k % 16 or n < 0:
        raise ValueError(f"C={c}, K={k}, N={n}: expected C <= "
                         f"{DECODE_MAX_M} and K a positive multiple of 16")
    tile_n = 64 if c <= EXPERT_NARROW_MAX_C else 128
    return ExpertPlan(tile_n, 2 * tile_n, EXPERT_MIN_STAGES)
