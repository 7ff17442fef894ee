"""The port's three kernels: plain versions against the JAX package, and
(on a CUDA card only) the CUDA kernels against their plain versions.

Tolerances:
* quantizer: bitwise against ``mixfp4_quant_rows(interpret=True)``;
* W4A16: atol 1e-4 after normalising by max|oracle|.  The oracle is
  ``ref.ref_gemm_w4a16`` with scale32 pinned to 1 and the per-tensor scale
  applied to its f32 output — the kernel's own factoring (the reference
  oracle folds scale32 into the weight before its bf16 cast, a 2^-9
  relative rounding the kernel never makes); against the unfactored oracle
  the reference's own tolerance, 2e-2 (tests/test_kernels.py), holds;
* attention: atol 1e-5 against ``ref.ref_attn_decode_packed``.

The CUDA kernels themselves are held against these plain versions in
``test_torch_cuda.py``, which needs no JAX and runs on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mixfp4_quant import (  # noqa: E402
    mixfp4_quant_rows as jquant)
from repro.models import base as jbase  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.kernels import (mixfp4_attn, mixfp4_quant,  # noqa: E402
                                 ops, ref)


def _rows(m: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(m // 3, k) * 3.0,
                        rng.standard_t(2, (m // 3, k)),
                        rng.choice([0, .5, 1, 1.5, 2, 3, 4, 6, -2, -6],
                                   (m - 2 * (m // 3), k)) * 0.7])
    x[::5] = 0.0
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------
QUANT_MODES = [{}, {"per_row": True}, {"scale32": 1.0},
               {"scale32": 0.37, "per_row": True}]


@pytest.mark.parametrize("mode", QUANT_MODES, ids=["tensor", "row", "pinned",
                                                   "pinned_row"])
@pytest.mark.parametrize("shape", [(48, 256), (30, 64), (7, 1024)])
def test_quant_plain_bitwise_vs_reference_kernel(shape, mode):
    x = _rows(*shape, seed=shape[0])
    p, s, s32 = mixfp4_quant.mixfp4_quant_rows(torch.from_numpy(x), **mode)
    jp, js, js32 = jquant(jnp.asarray(x), interpret=True, **mode)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(s32.numpy(), np.asarray(js32))


def test_quant_rows_matches_qtensor_quantize_and_ref():
    """The row quantizer, the port's 1-D ``quantize`` and its oracle agree
    on data with no MSE ties."""
    x = torch.from_numpy(_rows(24, 128, seed=9))
    qt = qtensor.quantize_rows(x)
    p, s, s32 = ref.ref_quant_pack_rows(x)
    np.testing.assert_array_equal(qt.payload.numpy(), p.numpy())
    np.testing.assert_array_equal(qt.scales.numpy(), s.numpy())
    assert float(qt.scale32) == float(s32)


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(4, 32)
    ops.quantize_rows(x)
    w = ops.pack_weight_qt(torch.randn(32, 32))
    ops.gemm_w4a16(x, w.payload, w.scales, w.scale32)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


# ---------------------------------------------------------------------------
# W4A16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mkn", [(5, 208, 272), (33, 112, 48), (1, 48, 80)])
def test_gemm_plain_vs_reference_oracle(mkn):
    m, k, n = mkn                       # K, N not multiples of any tile
    rng = np.random.RandomState(sum(mkn))
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.3).astype(np.float32)
    qw = ops.pack_weight_qt(torch.from_numpy(w))
    y = ops.gemm_w4a16(torch.from_numpy(x), qw.payload, qw.scales,
                       qw.scale32).numpy()
    jp, js = jnp.asarray(qw.payload.numpy()), jnp.asarray(qw.scales.numpy())
    s32 = float(qw.scale32)
    want = np.asarray(jref.ref_gemm_w4a16(jnp.asarray(x), jp, js,
                                          jnp.float32(1.0))) * s32
    scale = np.abs(want).max()
    np.testing.assert_allclose(y / scale, want / scale, atol=1e-4, rtol=0)
    loose = np.asarray(jref.ref_gemm_w4a16(jnp.asarray(x), jp, js,
                                           jnp.float32(s32)))
    np.testing.assert_allclose(y / scale, loose / scale, atol=2e-2, rtol=0)
    # the port's own oracle agrees too
    mine = ref.ref_gemm_w4a16(torch.from_numpy(x), qw.payload, qw.scales,
                              1.0).numpy() * s32
    np.testing.assert_allclose(y / scale, mine / scale, atol=1e-4, rtol=0)


def test_qmm_pads_logical_k_and_accepts_padded_storage():
    """K=100 pads onto the 112-row packed grid; storage padded past the
    logical shape (the JAX engine's tile pre-padding) gives the same y."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 100).astype(np.float32))
    w = torch.from_numpy(rng.randn(100, 40).astype(np.float32))
    qw = ops.pack_weight_qt(w)
    assert qw.payload.shape == (56, 48) and qw.shape == (100, 40)
    y = qtensor.qmm(x, qw)
    assert y.shape == (3, 40)
    padded = qw.replace(
        payload=torch.nn.functional.pad(qw.payload, (0, 80, 0, 32)),
        scales=torch.nn.functional.pad(qw.scales, (0, 5, 0, 4)))
    np.testing.assert_array_equal(qtensor.qmm(x, padded).numpy(), y.numpy())
    want = x.to(torch.bfloat16).float() @ qw.dequantize().to(
        torch.bfloat16).float()
    np.testing.assert_allclose(y.numpy(), want.numpy(),
                               atol=2e-2 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
CASES = [
    # (b, s, hkv, group, dh, window, softcap) — tests/test_attn_kernel.py
    (2, 32, 2, 2, 32, 0, 0.0),
    (3, 24, 1, 4, 48, 0, 0.0),
    (2, 130, 2, 1, 32, 7, 30.0),
    (1, 16, 3, 2, 16, 5, 0.0),
]


def _packed_kv_case(case, seed: int):
    b, s, hkv, g, dh, window, softcap = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv * g, dh).astype(np.float32)
    k = rng.randn(b, s, hkv, dh).astype(np.float32)
    v = rng.randn(b, s, hkv, dh).astype(np.float32)
    kp, ks = jbase.quantize_kv_rows(jnp.asarray(k))
    vp, vs = jbase.quantize_kv_rows(jnp.asarray(v))
    lengths = np.random.RandomState(s).randint(1, s + 1, (b,)).astype(
        np.int32)
    return q, [np.array(a) for a in (kp, ks, vp, vs)], lengths


@pytest.mark.parametrize("case", CASES)
def test_attn_plain_vs_reference_oracle(case):
    window, softcap = case[5], case[6]
    q, packed, lengths = _packed_kv_case(case, seed=sum(case[:5]))
    got = mixfp4_attn.mixfp4_attn_decode(
        torch.from_numpy(q), *[torch.from_numpy(a) for a in packed],
        torch.from_numpy(lengths), window=window, softcap=softcap)
    want = jref.ref_attn_decode_packed(
        jnp.asarray(q), *[jnp.asarray(a) for a in packed],
        jnp.asarray(lengths), window=window, softcap=softcap)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mine = ref.ref_attn_decode_packed(
        torch.from_numpy(q), *[torch.from_numpy(a) for a in packed],
        torch.from_numpy(lengths), window=window, softcap=softcap)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=1e-5)


def test_port_quantize_kv_rows_matches_reference():
    from repro_torch.models import base
    kv = np.random.RandomState(2).randn(2, 9, 3, 32).astype(np.float32)
    p, s = base.quantize_kv_rows(torch.from_numpy(kv))
    jp, js = jbase.quantize_kv_rows(jnp.asarray(kv))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
