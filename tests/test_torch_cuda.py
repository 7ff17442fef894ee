"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

  PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: quantizer and RHT bitwise; W4A16 and W4A4 1e-3 of max|plain|
(the two sum the same exact bf16 products in f32, in different orders);
attention 1e-4; the fused W4A4 kernel bitwise equal to the quantizer
followed by the packed W4A4 kernel on the card.
"""
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
    # (b, s, hkv, group, dh, window, softcap)
    (2, 32, 2, 2, 32, 0, 0.0),
    (3, 24, 1, 4, 48, 0, 0.0),
    (2, 130, 2, 1, 32, 7, 30.0),
    (1, 16, 3, 2, 16, 5, 0.0),
    (4, 600, 4, 2, 256, 64, 50.0),      # gemma2-2b heads, local window
]


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


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attn_kernel_vs_plain(cuda, case):
    b, s, hkv, g, dh, window, softcap = case
    gen = torch.Generator().manual_seed(s)
    q = torch.randn(b, hkv * g, dh, generator=gen)
    kp, ks = quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen))
    vp, vs = quantize_kv_rows(torch.randn(b, s, hkv, dh, generator=gen))
    lengths = torch.randint(1, s + 1, (b,), generator=gen,
                            dtype=torch.int32)
    args = (q, kp, ks, vp, vs, lengths)
    got = mixfp4_attn.mixfp4_attn_decode(*[a.to(cuda) for a in args],
                                         window=window, softcap=softcap)
    want = mixfp4_attn.attn_decode_plain(*args, window=window,
                                         softcap=softcap)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


def test_engine_on_the_card_launches_every_kernel(cuda):
    """A served decode step costs 7 W4A16 GEMMs, one attention and two
    quantizer launches per layer; a prefill 7 GEMMs and 2 quantizer
    launches per layer."""
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
        "mixfp4_quant_rows": 2 * n_l * passes,
        "mixfp4_gemm_w4a16": 7 * n_l * passes,
        "mixfp4_attn_decode": n_l * eng.decode_steps,
        "mixfp4_gemm_w4a4": 0, "mixfp4_gemm_w4a4_fused": 0,
        "fwht_rows": 0}


def test_w4a4_rht_engine_on_the_card_launches_its_kernels(cuda):
    """With act_quant="mixfp4", act_rht=True every projection is one fused
    W4A4 launch plus one fwht_rows launch (its per-row scale); the KV rows
    still take two quantizer launches per layer and decode one attention
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
        "mixfp4_quant_rows": 2 * n_l * passes,
        "mixfp4_gemm_w4a16": 0,
        "mixfp4_attn_decode": n_l * eng.decode_steps,
        "mixfp4_gemm_w4a4": 0,
        "mixfp4_gemm_w4a4_fused": 7 * n_l * passes,
        "fwht_rows": 7 * n_l * passes}
