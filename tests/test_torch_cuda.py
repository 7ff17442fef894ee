"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

  PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: quantizer, RHT, the RHT row scale (any CTAs per row) and the
KV-cache write (fixed slots and paged pool, decode and prefill, aligned
and unaligned leaves) bitwise; W4A16 and W4A4 1e-3 of max|plain|
(the two sum the same exact bf16 products in f32, in different orders);
each GEMM's rows bitwise independent of M, across its decode (M <= 64)
and prefill variants, and repeat calls bitwise equal;
attention 1e-4; the fused W4A4 kernel bitwise equal to the quantizer
followed by the packed W4A4 kernel on the card; the paged attention
kernel bitwise equal to the fixed-slot one on the gathered rows, and a
sequence's attention output bitwise independent of B and of the cache's
capacity (the key splits come from key positions alone).  The expert
W4A16 entry (one launch for a stack of experts) bitwise the 2-D entry on
each expert's slice (int32 views, so signed zeros count), within 1e-3 of
max|plain| of its plain version, exact zeros for zero (dummy) experts, on
random rows and on the MoE layer's dispatch buffers with -0.0, NaN, Inf
and last-split-only rows (experts without a non-zero row +0, every plan
of its decode kernel bitwise the same); an MoE decode step bitwise equal to itself
on the same state; attention and the KV write at Qwen1.5-MoE's heads
(dh 128, g 1); attention at StarCoder2-15B's heads (dh 128, g 12, walked
in passes of at most 8 heads).  The serving lifecycle on the card: the
fused W4A4 rung with exact launch counts on both sides of it, poison
isolation (survivors bitwise the card's own fault-free run) and the chaos
sweep on a paged engine.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.kernels import (fwht, mixfp4_attn,  # noqa: E402
                                 mixfp4_gemm, mixfp4_quant, ops)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.base import quantize_kv_rows  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

QUANT_MODES = [{}, {"per_row": True}, {"scale32": 1.0},
               {"scale32": 0.37, "per_row": True}]
ATTN_CASES = [
    # (b, s, hkv, group, dh, window, softcap[, lengths]); lengths drawn
    # from the seed where not given.  SPLIT_S = 256 keys per split.
    (2, 32, 2, 2, 32, 0, 0.0),
    (3, 24, 1, 4, 48, 0, 0.0),
    (2, 130, 2, 1, 32, 7, 30.0),
    (1, 16, 3, 2, 16, 5, 0.0),
    (4, 600, 4, 2, 256, 64, 50.0),      # gemma2-2b heads, local window
    (3, 640, 2, 2, 64, 0, 50.0, [640, 577, 300]),    # 2.5 splits
    (3, 700, 2, 3, 32, 300, 30.0, [700, 400, 513]),  # window over a boundary
    (3, 768, 1, 2, 48, 0, 0.0, [256, 512, 768]),     # multiples of SPLIT_S
    (2, 300, 1, 8, 256, 0, 50.0, [300, 257]),        # g = 8 at dh = 256
    (3, 300, 2, 2, 32, 0, 30.0, [0, 300, 1]),        # no valid key: zeros
    (4, 700, 16, 1, 128, 0, 0.0, [700, 333, 1, 512]),  # qwen2-moe heads
    # g = 12 (starcoder2-15b heads): two passes of the query heads, 8 + 4
    (4, 700, 4, 12, 128, 0, 0.0, [700, 333, 1, 512]),
]


def _attn_lengths(case, s: int, gen) -> torch.Tensor:
    b, lens = case[0], case[7:]
    if lens:
        return torch.tensor(lens[0], dtype=torch.int32)
    return torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rows(m: int, k: int, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(m // 3, k) * 3.0,
                        rng.standard_t(2, (m // 3, k)),
                        rng.choice([0, .5, 1, 1.5, 2, 3, 4, 6, -2, -6],
                                   (m - 2 * (m // 3), k)) * 0.7])
    x[::5] = 0.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("mode", QUANT_MODES, ids=["tensor", "row", "pinned",
                                                   "pinned_row"])
def test_quant_kernel_bitwise_vs_plain(cuda, mode):
    x = _rows(300, 256, seed=1)
    before = mixfp4_quant.launches
    p, s, s32 = mixfp4_quant.mixfp4_quant_rows(x.to(cuda), **mode)
    assert mixfp4_quant.launches == before + 1
    pp, sp, s32p = mixfp4_quant.mixfp4_quant_rows(x, **mode)
    assert torch.equal(p.cpu(), pp) and torch.equal(s.cpu(), sp)
    assert torch.equal(s32.cpu(), s32p)


@pytest.mark.parametrize("mkn", [(1, 2304, 2048), (4, 9216, 2304),
                                 (70, 208, 272), (129, 2304, 1024)])
def test_gemm_kernel_vs_plain(cuda, mkn):
    m, k, n = mkn
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, k, generator=gen)
    qw = ops.pack_weight_qt(torch.randn(k, n, generator=gen) / k ** 0.5)
    y = mixfp4_gemm.mixfp4_gemm_w4a16(
        x.to(cuda), qw.payload.to(cuda), qw.scales.to(cuda),
        qw.scale32.to(cuda)).cpu()
    yp = mixfp4_gemm.gemm_w4a16_plain(x, qw.payload, qw.scales, qw.scale32,
                                      n)
    assert float((y - yp).abs().max()) <= 1e-3 * float(yp.abs().max())


def _signs(k: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.where(torch.rand(k, generator=gen) < 0.5, -1.0, 1.0)


@pytest.mark.parametrize("mkg", [(1, 2304, 16), (300, 256, 16),
                                 (33, 9216, 16), (7, 128, 4), (5, 192, 64)])
def test_fwht_kernel_bitwise_vs_plain(cuda, mkg):
    m, k, g = mkg
    x, signs = _rows(m, k, seed=m), _signs(k, seed=k)
    before = fwht.launches
    got = fwht.fwht_rows(x.to(cuda), signs.to(cuda), group=g)
    assert fwht.launches == before + 1
    assert torch.equal(got.cpu(), fwht.fwht_rows(x, signs, group=g))


def _special_rows(m: int, k: int, seed: int) -> torch.Tensor:
    """``_rows`` and then rows that are zero, hold a NaN, one Inf, two Infs
    in one 16-lane group, or Inf beside NaN."""
    special = torch.ones(5, k)
    special[0] = 0.0
    special[1, 3] = float("nan")
    special[2, k - 1] = float("inf")
    special[3, 16:18] = float("inf")
    special[4, 0], special[4, 5] = float("inf"), float("nan")
    return torch.cat([_rows(m, k, seed), special])


@pytest.mark.parametrize("mk", [(1, 2304), (4, 2048), (4, 9216), (59, 208),
                                (64, 2304), (300, 9216)])
@pytest.mark.parametrize("rht", [True, False], ids=["rht", "plain"])
def test_fwht_row_scale_kernel_bitwise_vs_plain(cuda, mk, rht):
    """The row scale equals its plain version bit for bit, NaN, Inf and
    zero rows included, at every cluster size and thread count (which CTA
    reads which group never changes a max)."""
    m, k = mk
    x = _special_rows(m, k, seed=m + k)
    signs = _signs(k, seed=k) if rht else None
    want = fwht.fwht_row_scale(x, signs).view(torch.int32)
    xd, sd = x.to(cuda), None if signs is None else signs.to(cuda)
    before = fwht.launches_row_scale
    got = fwht.fwht_row_scale(xd, sd)
    assert fwht.launches_row_scale == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want)
    for ctas in (1, 2, 4, 8):
        for threads in (64, 256):
            got = fwht._row_scale_launch(xd, sd, ctas, threads)
            assert torch.equal(got.cpu().view(torch.int32), want), (
                ctas, threads)


def _kv_case(seed: int, b: int, s: int, hkv: int, dh: int, rows: tuple):
    """bf16 K/V rows (B, S, Hkv, dh) and four cache leaves of random wire
    bytes with ``rows`` = (D0, D1) storage rows."""
    gen = torch.Generator().manual_seed(seed)
    kv = [(3 * torch.randn(b, s, hkv, dh, generator=gen)).to(torch.bfloat16)
          for _ in range(2)]
    leaves = [torch.randint(0, 256, (*rows, hkv, w), generator=gen,
                            dtype=torch.uint8)
              for w in (dh // 2, dh // 16, dh // 2, dh // 16)]
    return kv, leaves


def _unaligned(t: torch.Tensor, cuda) -> torch.Tensor:
    """A contiguous copy of ``t`` on the card whose base address is odd."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (name, b, s, hkv, dh, storage rows, positions, block tables): positions
# a list (a decode step) or an int (a prefill from that row)
KV_CASES = [
    ("fixed_decode", 4, 1, 4, 256, (4, 40), [0, 17, 39, 5], None),
    ("fixed_decode_dh48", 3, 1, 2, 48, (3, 9), [8, 0, 3], None),
    ("fixed_prefill", 1, 37, 2, 16, (1, 64), 20, None),
    ("paged_decode_idle", 4, 1, 2, 32, (9, 16), [31, 0, 16, 0],
     [[4, 2, 7], [0, 0, 0], [1, 8, 0], [0, 0, 0]]),
    ("paged_prefill", 1, 50, 3, 48, (8, 16), 30, [[3, 5, 2, 6, 0]]),
    ("fixed_decode_moe", 4, 1, 16, 128, (4, 40), [0, 17, 39, 5], None),
    ("paged_decode_moe", 4, 1, 16, 128, (9, 16), [31, 0, 16, 40],
     [[4, 2, 7], [0, 0, 0], [1, 8, 0], [3, 5, 6]]),
]


@pytest.mark.parametrize("unaligned", [False, True],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", KV_CASES, ids=[c[0] for c in KV_CASES])
def test_quant_kv_kernel_bitwise_vs_plain(cuda, case, unaligned):
    """The KV write's bytes equal the plain version's (the quantizer, then
    the indexed writes) in every row but the trash page's, which idle
    lanes write concurrently; leaves whose base is odd take byte stores."""
    name, b, s, hkv, dh, rows, pos, tables = case
    (k, v), leaves = _kv_case(len(name), b, s, hkv, dh, rows)
    one = torch.ones(())
    bt = None if tables is None else torch.tensor(tables, dtype=torch.int32)
    p = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    want = [a.clone() for a in leaves]
    mixfp4_quant.mixfp4_quant_kv(k, v, *want, one, one, p, block_tables=bt)
    dev = [_unaligned(a, cuda) if unaligned else a.to(cuda) for a in leaves]
    kd, vd = (_unaligned(a, cuda) if unaligned else a.to(cuda)
              for a in (k, v))
    before = mixfp4_quant.launches_kv
    mixfp4_quant.mixfp4_quant_kv(
        kd, vd, *dev, one.to(cuda), one.to(cuda),
        p.to(cuda) if isinstance(p, torch.Tensor) else p,
        block_tables=None if bt is None else bt.to(cuda))
    assert mixfp4_quant.launches_kv == before + 1
    first = 1 if name.endswith("_idle") else 0
    for got, w, old in zip(dev, want, leaves):
        assert torch.equal(got.cpu()[first:], w[first:])
        assert not torch.equal(w, old)


def test_quant_kv_kernel_traps_on_a_row_outside_the_cache(cuda):
    """A decode position past the cache stops the kernel with a device
    trap (a skipped row would leave stale bytes); run in a child process,
    whose CUDA context the trap ends."""
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from repro_torch.kernels import mixfp4_quant as Q\n"
        "d = torch.device('cuda')\n"
        "k = torch.ones(2, 1, 1, 16, dtype=torch.bfloat16, device=d)\n"
        "leaves = [torch.zeros(2, 4, 1, w, dtype=torch.uint8, device=d)\n"
        "          for w in (8, 1, 8, 1)]\n"
        "one = torch.ones((), device=d)\n"
        "pos = torch.tensor([0, 4], dtype=torch.int32, device=d)\n"
        "try:\n"
        "    Q.mixfp4_quant_kv(k, k, *leaves, one, one, pos)\n"
        "    torch.cuda.synchronize()\n"
        "    print('NO TRAP')\n"
        "except RuntimeError as e:\n"
        "    print('TRAPPED', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert "TRAPPED" in out.stdout, out.stdout + out.stderr


W4A4_MKN = [(1, 2304, 2048), (4, 9216, 2304), (70, 208, 272),
            (129, 2304, 1024)]


def _w4a4_case(mkn):
    m, k, n = mkn
    gen = torch.Generator().manual_seed(m + k)
    x = torch.randn(m, k, generator=gen) * torch.rand(m, 1, generator=gen)
    x[m // 2] = 0.0
    return x, ops.pack_weight_qt(torch.randn(k, n, generator=gen) / k ** 0.5)


def _on(cuda, *ts):
    return [t.to(cuda) for t in ts]


@pytest.mark.parametrize("per_row", [False, True], ids=["tensor", "row"])
@pytest.mark.parametrize("mkn", W4A4_MKN)
def test_gemm_w4a4_kernel_vs_plain(cuda, mkn, per_row):
    x, qw = _w4a4_case(mkn)
    qx = qtensor.quantize_rows(x, per_row=per_row)
    args = (qx.payload, qx.scales, qx.scale32, qw.payload, qw.scales,
            qw.scale32)
    before = mixfp4_gemm.launches_w4a4
    y = mixfp4_gemm.mixfp4_gemm_w4a4(*_on(cuda, *args),
                                     per_row=per_row).cpu()
    assert mixfp4_gemm.launches_w4a4 == before + 1
    yp = mixfp4_gemm.mixfp4_gemm_w4a4(*args, per_row=per_row)
    assert float((y - yp).abs().max()) <= 1e-3 * float(yp.abs().max())


@pytest.mark.parametrize("mode", [(False, False), (True, False),
                                  (True, True)],
                         ids=["tensor", "row", "row_rht"])
@pytest.mark.parametrize("mkn", W4A4_MKN)
def test_gemm_w4a4_fused_kernel_vs_plain_and_two_pass(cuda, mkn, mode):
    per_row, rht = mode
    x, qw = _w4a4_case(mkn)
    signs = _signs(mkn[1], seed=1) if rht else None
    xd, wd = x.to(cuda), qw.to(cuda)
    sd = None if signs is None else signs.to(cuda)
    before = mixfp4_gemm.launches_w4a4_fused
    y = qtensor.qmm(xd, wd, fuse_act_quant=True, per_row_act=per_row,
                    act_rht_signs=sd)
    assert mixfp4_gemm.launches_w4a4_fused == before + 1
    yp = qtensor.qmm(x, qw, fuse_act_quant=True, per_row_act=per_row,
                     act_rht_signs=signs)
    assert float((y.cpu() - yp).abs().max()) <= 1e-3 * float(
        yp.abs().max())
    xt = xd if sd is None else ops.rht_rows(xd, sd)
    two = qtensor.qmm(qtensor.quantize_rows(xt, per_row=per_row), wd)
    assert torch.equal(y, two)


GEMMA_PAIRS = [(2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304)]
GEMM_KINDS = ["w4a16", "w4a4_tensor", "w4a4_row", "fused_tensor",
              "fused_row", "fused_row_rht"]


def _gemm_call(kind, x, qw, signs):
    """fn(m): the GEMM ``kind`` on the first m rows of x (on the card).
    Row scales come from each row; a per-tensor scale from all rows."""
    G = mixfp4_gemm
    from repro_torch.core import scaling
    if kind == "w4a16":
        return lambda m: G.mixfp4_gemm_w4a16(x[:m], qw.payload, qw.scales,
                                             qw.scale32)
    if kind.startswith("w4a4"):
        per_row = kind == "w4a4_row"
        qx = qtensor.quantize_rows(x, per_row=per_row)
        return lambda m: G.mixfp4_gemm_w4a4(
            qx.payload[:m], qx.scales[:m],
            qx.scale32[:m] if per_row else qx.scale32, qw.payload,
            qw.scales, qw.scale32, per_row=per_row)
    if kind == "fused_tensor":
        s = scaling.tensor_scale(x)
        return lambda m: G.mixfp4_gemm_w4a4_fused(x[:m], s, qw.payload,
                                                  qw.scales, qw.scale32)
    sg = signs if kind == "fused_row_rht" else None
    s = scaling.row_scale(x if sg is None else fwht.fwht_rows(x, sg))
    return lambda m: G.mixfp4_gemm_w4a4_fused(
        x[:m], s[:m], qw.payload, qw.scales, qw.scale32, per_row=True,
        rht_signs=sg)


@pytest.mark.parametrize("kind", GEMM_KINDS)
@pytest.mark.parametrize("kn", GEMMA_PAIRS)
def test_gemm_rows_bitwise_independent_of_m(cuda, kn, kind):
    """The first rows of a call at M = 4 (decode variant, split partials
    reduced in the launch) equal the same rows of calls at M in {1, 16,
    32, 64, 65, 4544}, across the decode/prefill boundary; repeat calls
    are bitwise equal."""
    k, n = kn
    x, qw = _w4a4_case((4544, k, n))
    x, qw, signs = x.to(cuda), qw.to(cuda), _signs(k, seed=k).to(cuda)
    fn = _gemm_call(kind, x, qw, signs)
    ref = fn(4)
    for m in (4, 64):
        assert torch.equal(fn(m), fn(m))
    for m in (1, 16, 32, 64, 65, 4544):
        r = min(m, 4)
        assert torch.equal(fn(m)[:r], ref[:r]), m


@pytest.mark.parametrize("kind", GEMM_KINDS)
@pytest.mark.parametrize("m", [1, 4, 16, 32, 64, 65])
def test_gemm_kernels_vs_plain_on_both_variants(cuda, m, kind):
    """Each GEMM against its plain version (the wrapper on CPU tensors) on
    both sides of the decode variant's M <= 64, at a ragged N and a K of
    two and a half splits."""
    k, n = 640, 272
    x, qw = _w4a4_case((m, k, n))
    signs = _signs(k, seed=3)
    got = _gemm_call(kind, x.to(cuda), qw.to(cuda), signs.to(cuda))(m)
    want = _gemm_call(kind, x, qw, signs)(m)
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attn_kernel_vs_plain(cuda, case):
    b, s, hkv, g, dh, window, softcap = case[:7]
    gen = torch.Generator().manual_seed(s)
    q = torch.randn(b, hkv * g, dh, generator=gen)
    kp, ks = quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen))
    vp, vs = quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen))
    lengths = _attn_lengths(case, s, gen)
    args = (q, kp, ks, vp, vs, lengths)
    got = mixfp4_attn.mixfp4_attn_decode(*[a.to(cuda) for a in args],
                                         window=window, softcap=softcap)
    want = mixfp4_attn.attn_decode_plain(*args, window=window,
                                         softcap=softcap)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_attn_kernel_bitwise_vs_fixed(cuda, case):
    """The rows of a fixed cache scattered over a permuted pool (junk wire
    bytes in the trash page 0, which the tables' unused tail points at):
    the paged kernel equals the fixed kernel bit for bit."""
    b, s, hkv, g, dh, window, softcap = case[:7]
    page_len = 16
    gen = torch.Generator().manual_seed(s + 1)
    q = torch.randn(b, hkv * g, dh, generator=gen)
    fixed = [*quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen)),
             *quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen))]
    lengths = _attn_lengths(case, s, gen)
    mp = -(-s // page_len)
    n_used = -(-lengths // page_len)
    perm = 1 + torch.randperm(b * mp, generator=gen)
    bt = torch.zeros(b, mp, dtype=torch.int32)
    junk = quantize_kv_rows(40 * torch.randn(page_len, hkv, dh,
                                             generator=gen))
    slabs = []
    for a, j in zip(fixed, (*junk, *junk)):
        slab = torch.zeros((1 + b * mp, page_len, *a.shape[2:]), dtype=a.dtype)
        slab[0] = j
        slabs.append(slab)
    for i in range(b):
        for p in range(int(n_used[i])):
            bt[i, p] = perm[i * mp + p]
            rows = slice(p * page_len, min((p + 1) * page_len, s))
            for slab, a in zip(slabs, fixed):
                slab[bt[i, p], :rows.stop - rows.start] = a[i, rows]
    got = mixfp4_attn.mixfp4_attn_decode_paged(
        q.to(cuda), *[a.to(cuda) for a in slabs], bt.to(cuda),
        lengths.to(cuda), window=window, softcap=softcap)
    want = mixfp4_attn.mixfp4_attn_decode(
        q.to(cuda), *[a.to(cuda) for a in fixed], lengths.to(cuda),
        window=window, softcap=softcap)
    assert torch.equal(got, want)
    plain = mixfp4_attn.attn_decode_paged_plain(q, *slabs, bt, lengths,
                                                window=window,
                                                softcap=softcap)
    assert float((got.cpu() - plain).abs().max()) <= 1e-4


@pytest.mark.parametrize("window", [0, 300])
def test_attn_rows_bitwise_independent_of_batch_and_capacity(cuda, window):
    """Each sequence's output of a B = 4 call equals its B = 1 call at the
    same capacity, at a smaller one (its rows cut to a page past its
    length) and at a larger one (junk rows appended), bitwise, fixed and
    paged; repeat calls are bitwise equal."""
    b, s, hkv, g, dh, page_len = 4, 1100, 2, 2, 64, 16
    gen = torch.Generator().manual_seed(11)
    q = torch.randn(b, hkv * g, dh, generator=gen).to(cuda)
    fixed = [a.to(cuda) for a in (
        *quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen)),
        *quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen)))]
    junk = [a.to(cuda) for a in (
        *quantize_kv_rows(30 * torch.randn(b, 333, hkv, dh, generator=gen)),
        *quantize_kv_rows(30 * torch.randn(b, 333, hkv, dh, generator=gen)))]
    lengths = torch.tensor([1100, 256, 513, 1], dtype=torch.int32,
                           device=cuda)
    kw = {"window": window, "softcap": 50.0}
    ref = mixfp4_attn.mixfp4_attn_decode(q, *fixed, lengths, **kw)
    assert torch.equal(ref, mixfp4_attn.mixfp4_attn_decode(
        q, *fixed, lengths, **kw))
    # the same rows in a pool: page i of sequence b is pool page
    # 1 + b * mp + i, the tables' tail points at the trash page 0
    mp = -(-s // page_len)
    slabs = []
    for a in fixed:
        pad = torch.zeros((b, mp * page_len - s, *a.shape[2:]),
                          dtype=a.dtype, device=cuda)
        pages = torch.cat([a, pad], 1).reshape(b * mp, page_len,
                                               *a.shape[2:])
        slabs.append(torch.cat([torch.zeros_like(pages[:1]), pages]))
    bt = (1 + torch.arange(b * mp, dtype=torch.int32,
                           device=cuda)).reshape(b, mp)
    paged = mixfp4_attn.mixfp4_attn_decode_paged(q, *slabs, bt, lengths,
                                                 **kw)
    assert torch.equal(paged, ref)
    for i in range(b):
        n = int(lengths[i])
        one = lengths[i:i + 1]
        cut = -(-n // page_len) * page_len + page_len
        for cache in ([a[i:i + 1] for a in fixed],
                      [a[i:i + 1, :cut] for a in fixed],
                      [torch.cat([a[i:i + 1], j[i:i + 1]], 1)
                       for a, j in zip(fixed, junk)]):
            got = mixfp4_attn.mixfp4_attn_decode(q[i:i + 1], *cache, one,
                                                 **kw)
            assert torch.equal(got[0], ref[i]), (i, cache[0].shape[1])
        wide = torch.cat([bt[i:i + 1], torch.zeros(
            (1, 40), dtype=torch.int32, device=cuda)], 1)
        for table in (bt[i:i + 1], bt[i:i + 1, :-(-n // page_len)], wide):
            got = mixfp4_attn.mixfp4_attn_decode_paged(
                q[i:i + 1], *slabs, table, one, **kw)
            assert torch.equal(got[0], ref[i]), (i, table.shape[1])


def test_paged_chunked_engine_on_the_card_launches_the_paged_kernel(cuda):
    """Paged + chunked serving: every decode pass launches the paged
    attention kernel once per layer and never the fixed one, and the
    streams equal the fixed-slot whole-prompt engine's."""
    cfg = configs.smoke_config("gemma2-2b")
    params = build_model(cfg).init(0, device=cuda)
    shared = list(range(1, 18))
    prompts = [np.array(shared + [40 + i] * (2 + 3 * i), np.int32)
               for i in range(4)]
    streams, counts = [], []
    for kw in ({}, {"kv_pool": 17, "prefill_chunk": 8}):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          kv_quant="mixfp4", device=cuda, **kw)
        ops.reset_launch_counts()
        reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        pending = list(reqs)
        while pending or eng.has_work():
            while pending and eng.add_request(pending[0]):
                pending.pop(0)
            eng.step()
        streams.append([r.generated for r in reqs])
        counts.append((ops.launch_counts(), eng))
    assert streams[0] == streams[1]
    got, eng = counts[1]
    n_l = cfg.n_layers
    passes = eng.prefill_dispatches + eng.decode_steps
    assert eng.pool_report()["prefix_hits"] > 0
    assert got == {
        "mixfp4_quant_rows": 0,
        "mixfp4_gemm_w4a16": 7 * n_l * passes,
        "mixfp4_gemm_w4a16_experts": 0,
        "mixfp4_attn_decode": 0,
        "mixfp4_attn_decode_paged": n_l * eng.decode_steps,
        "mixfp4_gemm_w4a4": 0, "mixfp4_gemm_w4a4_fused": 0,
        "fwht_rows": 0, "mixfp4_quant_kv": n_l * passes,
        "fwht_row_scale": 0}


def test_engine_on_the_card_launches_every_kernel(cuda):
    """A served decode step costs 7 W4A16 GEMMs, one attention and one KV
    write per layer; a prefill 7 GEMMs and one KV write per layer."""
    cfg = configs.smoke_config("gemma2-2b")
    eng = ServeEngine(cfg, build_model(cfg).init(0, device=cuda),
                      batch_size=2, max_len=32, kv_quant="mixfp4",
                      device=cuda)
    ops.reset_launch_counts()
    reqs = [Request(uid=i, prompt=np.arange(3 + 4 * i, dtype=np.int32),
                    max_new_tokens=5) for i in range(3)]
    pending = list(reqs)
    while pending or eng.has_work():
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        eng.step()
    assert all(len(r.generated) == 5 and r.finish_reason == "max_new_tokens"
               for r in reqs)
    n_l, passes = cfg.n_layers, eng.admissions + eng.decode_steps
    assert ops.launch_counts() == {
        "mixfp4_quant_rows": 0,
        "mixfp4_gemm_w4a16": 7 * n_l * passes,
        "mixfp4_gemm_w4a16_experts": 0,
        "mixfp4_attn_decode": n_l * eng.decode_steps,
        "mixfp4_attn_decode_paged": 0,
        "mixfp4_gemm_w4a4": 0, "mixfp4_gemm_w4a4_fused": 0,
        "fwht_rows": 0, "mixfp4_quant_kv": n_l * passes,
        "fwht_row_scale": 0}


def test_w4a4_rht_engine_on_the_card_launches_its_kernels(cuda):
    """With act_quant="mixfp4", act_rht=True every projection is one fused
    W4A4 launch plus one fwht_row_scale launch (its per-row scale); the KV
    rows take one KV-write launch per layer and decode one attention
    launch per layer."""
    cfg = configs.smoke_config("gemma2-2b")
    eng = ServeEngine(cfg, build_model(cfg).init(0, device=cuda),
                      batch_size=2, max_len=32, kv_quant="mixfp4",
                      act_quant="mixfp4", act_rht=True, device=cuda)
    ops.reset_launch_counts()
    reqs = [Request(uid=i, prompt=np.arange(3 + 4 * i, dtype=np.int32),
                    max_new_tokens=5) for i in range(3)]
    pending = list(reqs)
    while pending or eng.has_work():
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        eng.step()
    assert all(len(r.generated) == 5 and r.finish_reason == "max_new_tokens"
               for r in reqs)
    n_l, passes = cfg.n_layers, eng.admissions + eng.decode_steps
    assert ops.launch_counts() == {
        "mixfp4_quant_rows": 0,
        "mixfp4_gemm_w4a16": 0,
        "mixfp4_gemm_w4a16_experts": 0,
        "mixfp4_attn_decode": n_l * eng.decode_steps,
        "mixfp4_attn_decode_paged": 0,
        "mixfp4_gemm_w4a4": 0,
        "mixfp4_gemm_w4a4_fused": 7 * n_l * passes,
        "fwht_rows": 0, "mixfp4_quant_kv": n_l * passes,
        "fwht_row_scale": 7 * n_l * passes}


# ---------------------------------------------------------------------------
# the expert W4A16 entry and the MoE family
# ---------------------------------------------------------------------------
EXPERT_KN = [(2048, 1408), (1408, 2048)]    # qwen2-moe up/gate, down
EXPERT_CS = [1, 5, 64, 65, 380]


@functools.lru_cache(maxsize=None)
def _expert_stack(k: int, n: int):
    """64 stored experts (the last 4 zero, as qwen2-moe's dummy experts)
    packed on the card."""
    from repro_torch.models.base import pack_projections
    gen = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.randn(64, k, n, generator=gen, device="cuda") / k ** 0.5
    w[60:] = 0.0
    return pack_projections({"w_up": w})[0]["w_up"]


@pytest.mark.parametrize("c", EXPERT_CS)
@pytest.mark.parametrize("kn", EXPERT_KN)
def test_gemm_experts_kernel_bitwise_per_expert_and_vs_plain(cuda, kn, c):
    """One launch for all 64 experts equals the 2-D launch on each
    expert's slice bitwise (C <= 64: the decode variant; above: the
    prefill tile), is within 1e-3 of max|plain| of its plain version, and
    gives exact zeros for the zero experts.  K = 1408 is 5.5 splits."""
    k, n = kn
    qw = _expert_stack(k, n)
    gen = torch.Generator(device="cuda").manual_seed(c)
    x = torch.randn(64, c, k, generator=gen, device=cuda).to(torch.bfloat16)
    before = mixfp4_gemm.launches_experts
    y = qtensor.qmm_experts(x, qw)
    assert mixfp4_gemm.launches_experts == before + 1
    assert y.shape == (64, c, n) and y.dtype == torch.float32
    for e in range(64):
        assert torch.equal(y[e], qtensor.qmm(x[e], qw.replace(
            payload=qw.payload[e], scales=qw.scales[e],
            scale32=qw.scale32[e]))), e
    assert not y[60:].any()
    yp = mixfp4_gemm.gemm_w4a16_experts_plain(x, qw.payload, qw.scales,
                                              qw.scale32, n)
    assert float((y - yp).abs().max()) <= 1e-3 * float(yp.abs().max())
    # rows independent of C, and repeat calls bitwise equal
    assert torch.equal(qtensor.qmm_experts(x[:, :1], qw), y[:, :1])
    assert torch.equal(qtensor.qmm_experts(x, qw), y)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it lies beside the package, not in
    it)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _routed_rows(k: int, c: int, seed: int) -> torch.Tensor:
    """``chip_smoke.routed_rows``: the (64, C, K) bf16 buffer
    ``moe.dispatch_buffer`` builds for seeded random tokens routed top-4
    over 60 experts with cap = C - 1, then experts 56-59 holding a row
    non-zero only in K's last split (56), an Inf (57), a NaN (58) and -0.0
    everywhere (59)."""
    return _chip_smoke().routed_rows(k, c, torch.device("cuda"), seed)


def _live(x: torch.Tensor) -> torch.Tensor:
    """(E,) True where an expert's rows hold an element other than +-0."""
    return ((x.view(torch.int16) & 0x7FFF) != 0).flatten(1).any(1)


@pytest.mark.parametrize("c", EXPERT_CS)
@pytest.mark.parametrize("kn", EXPERT_KN)
def test_gemm_experts_on_dispatch_buffers_bitwise_per_expert(cuda, kn, c):
    """On the MoE layer's own capacity buffers: every expert's rows bitwise
    the 2-D launch on its slice as int32 (signed zeros and NaN bits
    count), +0 for every expert without a non-zero row (the -0.0 expert
    and the experts that received no token), the NaN and Inf rows
    non-finite, the last-split-only row computed, and the finite outputs
    within 1e-3 of max|plain|."""
    k, n = kn
    qw = _expert_stack(k, n)
    x = _routed_rows(k, c, 100 + c)
    y = qtensor.qmm_experts(x, qw)
    live = _live(x)
    assert not live[59] and live[56:59].all()
    for e in range(64):
        two_d = qtensor.qmm(x[e], qw.replace(payload=qw.payload[e],
                                             scales=qw.scales[e],
                                             scale32=qw.scale32[e]))
        assert torch.equal(y[e].view(torch.int32),
                           two_d.view(torch.int32)), e
        if not live[e]:
            assert not y[e].view(torch.int32).any(), e
    assert not y[58, c - 1].isfinite().any()
    assert not y[57, c - 1].isfinite().any()
    assert y[56, c - 1].any()
    yp = mixfp4_gemm.gemm_w4a16_experts_plain(x, qw.payload, qw.scales,
                                              qw.scale32, n)
    fin = yp.isfinite()
    assert torch.equal(fin, y.isfinite())
    err = float((y[fin] - yp[fin]).abs().max())
    assert err <= 1e-3 * float(yp[fin].abs().max())


@pytest.mark.parametrize("kn", EXPERT_KN)
def test_gemm_experts_every_plan_gives_the_same_bits(cuda, kn):
    """The expert decode kernel's plan (column tile, ring depth) changes
    which CTA computes a column and how far its loads run ahead, never a
    bit, at C = 1, 5 (the served decode), 16 and 64."""
    from repro_torch.kernels import tuning
    k, n = kn
    qw = _expert_stack(k, n)
    for c in (1, 5, 16, 64):
        x = _routed_rows(k, c, 7) if c != 16 else torch.randn(
            64, c, k, device=cuda).to(torch.bfloat16)
        want = qtensor.qmm_experts(x, qw).view(torch.int32)
        for plan in tuning.expert_plans(c, k):
            y = mixfp4_gemm._experts_launch(x, qw.payload, qw.scales,
                                            qw.scale32, n, plan)
            assert torch.equal(y.view(torch.int32), want), (c, plan)


def test_gemm_experts_launcher_refuses_a_bad_plan(cuda):
    from repro_torch.kernels import tuning
    qw = _expert_stack(1408, 2048)
    x = torch.zeros(64, 5, 1408, dtype=torch.bfloat16, device=cuda)
    # a 32- and a 48-column tile; threads other than 2 per column; a ring
    # of 1 and of 5 slots
    for plan in ((32, 64, 2), (48, 96, 2), (64, 256, 2), (128, 128, 2),
                 (64, 128, 1), (64, 128, 5)):
        with pytest.raises(RuntimeError, match="cudaError"):
            mixfp4_gemm._experts_launch(x, qw.payload, qw.scales,
                                        qw.scale32, 2048,
                                        tuning.ExpertPlan(*plan))


def test_gemm_experts_wrapper_refuses_bad_operands(cuda):
    qw = _expert_stack(1408, 2048)
    x = torch.zeros(64, 5, 1408, dtype=torch.bfloat16, device=cuda)
    G = mixfp4_gemm.mixfp4_gemm_w4a16_experts
    with pytest.raises(ValueError, match="uint8"):
        G(x, qw.payload.to(torch.int8), qw.scales, qw.scale32)
    with pytest.raises(ValueError, match="experts"):
        G(x[:63], qw.payload, qw.scales, qw.scale32)
    with pytest.raises(ValueError):
        G(x[..., :1024], qw.payload, qw.scales, qw.scale32)
    with pytest.raises(ValueError, match="contiguous on"):
        G(x, qw.payload.cpu(), qw.scales, qw.scale32)
    strided = torch.empty((*qw.scales.shape[:2], 2 * qw.scales.shape[2]),
                          dtype=torch.uint8, device=cuda)[..., ::2]
    strided.copy_(qw.scales)
    with pytest.raises(ValueError, match="contiguous on"):
        G(x, qw.payload, strided, qw.scale32)


def _moe_engine(cuda, arch="qwen2-moe-a2.7b", **kw):
    cfg = configs.smoke_config(arch)
    params = build_model(cfg).init(0, device=cuda, pack="mixfp4")
    return cfg, ServeEngine(cfg, params, batch_size=2, max_len=64,
                            kv_quant="mixfp4", device=cuda, **kw)


def test_moe_decode_step_is_deterministic(cuda):
    """The same MoE decode step twice on the same state: bitwise equal
    logits and KV bytes (dispatch and combine use no atomics)."""
    cfg, eng = _moe_engine(cuda)
    for i, n in enumerate((7, 12)):
        eng.add_request(Request(uid=i, prompt=np.arange(1, n + 1,
                                                        dtype=np.int32),
                                max_new_tokens=8))
    eng.step()
    toks = torch.tensor([3, 5], device=cuda)
    lens = torch.as_tensor(eng.lengths, device=cuda)
    out = []
    for _ in range(2):
        cache = {k: (v.replace(payload=v.payload.clone(),
                               scales=v.scales.clone())
                     if isinstance(v, qtensor.QTensor) else v.clone())
                 for k, v in eng.cache.items()}
        logits, cache = eng.model.decode_step(eng.params, toks, cache, lens,
                                              act=eng.act)
        out.append((logits, cache["k"].payload, cache["v"].payload))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("kw", [{}, {"kv_pool": 17},
                                {"kv_pool": 17, "prefill_chunk": 8}],
                         ids=["fixed", "pool", "pool_chunked"])
def test_moe_engine_on_the_card_launches_every_kernel(cuda, kw, arch):
    """Per pass each layer launches 4 2-D W4A16 GEMMs for attention (and 3
    for a shared expert), one expert launch per expert projection (3), one
    KV write; per decode pass one attention (paged on the pool)."""
    cfg, eng = _moe_engine(cuda, arch, **kw)
    ops.reset_launch_counts()
    reqs = [Request(uid=i, prompt=np.arange(3 + 4 * i, dtype=np.int32),
                    max_new_tokens=5) for i in range(3)]
    pending = list(reqs)
    while pending or eng.has_work():
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        eng.step()
    assert all(len(r.generated) == 5 for r in reqs)
    n_l = cfg.n_layers
    passes = eng.prefill_dispatches + eng.decode_steps
    attn = "mixfp4_attn_decode_paged" if kw else "mixfp4_attn_decode"
    want = {name: 0 for name in ops.KERNELS}
    n_2d = 4 + (3 if cfg.shared_expert_ff else 0)
    want.update({"mixfp4_gemm_w4a16": n_2d * n_l * passes,
                 "mixfp4_gemm_w4a16_experts": 3 * n_l * passes,
                 "mixfp4_quant_kv": n_l * passes,
                 attn: n_l * eng.decode_steps})
    assert ops.launch_counts() == want


# ---------------------------------------------------------------------------
# the serving lifecycle on the card
# ---------------------------------------------------------------------------
def test_fused_rung_on_the_card_moves_the_launches(cuda):
    """An injected dispatch fault at the second decode moves the fused
    W4A4 + RHT path to ``mixfp4-2pass-rowscale``: each step's launches
    are exact on both sides of the rung, and the streams equal the
    fault-free run's."""
    from repro_torch.serving import faults

    cfg = configs.smoke_config("gemma2-2b")
    params = build_model(cfg).init(0, device=cuda)
    prompts = [np.arange(3 + 4 * i, dtype=np.int32) for i in range(3)]

    def mk(inj=None):
        return ServeEngine(cfg, params, batch_size=2, max_len=32,
                           kv_quant="mixfp4", act_quant="mixfp4",
                           act_rht=True, device=cuda, faults=inj)

    oracle = faults.drive(mk(), prompts, max_new_tokens=5)
    eng = mk(faults.FaultInjector(0, [faults.FaultRule(
        "decode", "dispatch", at=(1,), times=1)]))
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    streams, sides = _chip_smoke().step_w4a4_exact(eng)
    assert eng.act_quant == "mixfp4-2pass-rowscale"
    assert eng.counters["degraded_fused_to_2pass"] == 1
    assert sides["mixfp4"] >= 1 and sides["mixfp4-2pass-rowscale"] >= 1
    assert streams == oracle["streams"]


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b"])
def test_poison_isolation_on_the_card(cuda, arch):
    """A NaN-poisoned decode row fails its request only: the survivors'
    streams are bitwise the card's own fault-free run, the victim's a
    strict prefix."""
    from repro_torch.serving import faults
    from repro_torch.serving.engine import RequestState

    cfg = configs.smoke_config(arch)
    params = build_model(cfg).init(0, device=cuda, pack="mixfp4")
    prompts = [np.arange(1, 5 + 2 * i, dtype=np.int32) for i in range(4)]

    def mk(inj=None):
        return ServeEngine(cfg, params, batch_size=4, max_len=32,
                           kv_quant="mixfp4", device=cuda, faults=inj)

    oracle = faults.drive(mk(), prompts, max_new_tokens=5)
    inj = faults.FaultInjector(1, [faults.FaultRule("decode", "nan",
                                                    at=(1,))])
    got = faults.drive(mk(inj), prompts, max_new_tokens=5)
    (victim,) = inj.fatal_victims()
    assert (got["states"][victim], got["reasons"][victim]) == (
        RequestState.FAILED, "nan_logits")
    vs = got["streams"][victim]
    assert vs == oracle["streams"][victim][:len(vs)] and len(vs) < 5
    for uid, s in got["streams"].items():
        if uid != victim:
            assert s == oracle["streams"][uid]
            assert got["states"][uid] is RequestState.FINISHED


def test_chaos_sweep_on_a_paged_engine_on_the_card(cuda):
    from repro_torch.serving import faults

    cfg = configs.smoke_config("gemma2-2b")
    params = build_model(cfg).init(0, device=cuda, pack="mixfp4")
    prompts = [np.arange(2, 20 + 3 * i, dtype=np.int32) for i in range(4)]

    def mk(faults=None):
        return ServeEngine(cfg, params, batch_size=2, max_len=64,
                           kv_quant="mixfp4", kv_pool=17, kv_page_len=16,
                           device=cuda, faults=faults)

    report = faults.chaos_sweep(mk, prompts, seeds=(0, 1, 2),
                                max_new_tokens=4)
    assert report["ok"]
    assert all(s["events"] >= 1 for s in report["schedules"])
