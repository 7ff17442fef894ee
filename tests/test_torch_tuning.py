"""The port's GEMM split selector (``repro_torch/kernels/tuning.py``).

CPU only.  The CUDA GEMMs take the variant and the K split depth from
``tuning.select``; these tests hold its contracts: splits from K alone (so
a row's output is bitwise independent of M and N), boundaries on the
32-deep slab grid and ending at K, the decode/prefill threshold, column
tile and split depth equal to the C header's constants, and enough CTAs
at decode M for every SM of an H100 on every gemma2-2b projection.

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
KS = [16, 32, 48, 208, 256, 272, 2048, 2304, 4096, 9216, 9232]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _header_constants() -> dict[str, int]:
    text = HEADER.read_text()
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
