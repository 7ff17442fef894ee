"""Wire-format numerics of the PyTorch port against the JAX package.

Codebook decode, E4M3 rounding and bits, and the scale byte are held
bitwise.  ``qtensor.quantize`` (1-D and 2-D layouts) is held bitwise too,
except where a block's E2M1-vs-E1M2 select sits on an exact MSE tie: the
two frameworks sum the squared errors in different orders, so a block
whose two candidate errors lie within 4 ulp may pick either format.  Any
other difference fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.core import pack as jpack  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.core import scaling as jscaling  # noqa: E402
from repro_torch.core import formats, pack, qtensor, quantize  # noqa: E402
from repro_torch.core import scaling  # noqa: E402

TIE_ULPS = 4
# one compiled executable per shape instead of one per eager op
_jax_quantize = jax.jit(jqt.quantize, static_argnums=1)


def test_decode_to_e2m2_exhaustive():
    nib = np.repeat(np.arange(16, dtype=np.uint8), 2)
    t = np.tile(np.array([0, 1], np.uint8), 16)
    got = formats.decode_to_e2m2(torch.from_numpy(nib), torch.from_numpy(t))
    want = jformats.decode_to_e2m2(jnp.asarray(nib), jnp.asarray(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_e4m3_bits_and_rounding_all_magnitudes():
    bits = np.arange(128, dtype=np.uint8)          # 0x7F is NaN in e4m3fn
    vals = formats.bits_to_e4m3(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(
        vals, np.asarray(jformats.bits_to_e4m3(jnp.asarray(bits))))
    finite = vals[:127]
    np.testing.assert_array_equal(
        formats.e4m3_to_bits(torch.from_numpy(finite)).numpy(), bits[:127])
    # rounding: every magnitude, every midpoint between neighbours, and a
    # spread of values in between, clamped to [0, 448] as callers do
    mids = 0.5 * (finite[1:] + finite[:-1])
    rng = np.random.RandomState(0)
    x = np.concatenate([finite, mids, rng.uniform(0, 448, 4096),
                        rng.uniform(0, 2 ** -6, 1024)]).astype(np.float32)
    got = formats.round_to_e4m3(torch.from_numpy(x)).numpy()
    want = np.asarray(jformats.round_to_e4m3(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_pack_scale_with_type_never_emits_0x80():
    rng = np.random.RandomState(1)
    s = formats.round_to_e4m3(torch.from_numpy(np.concatenate(
        [np.zeros(64), rng.uniform(0, 448, 960)]).astype(np.float32)))
    t = torch.from_numpy(rng.randint(0, 2, s.shape[0]).astype(np.uint8))
    t[:64] = 1                                     # zero scale, E1M2 type
    packed = scaling.pack_scale_with_type(s, t)
    assert not (packed == 0x80).any()
    assert (packed[:64] == 0).all()
    want = jscaling.pack_scale_with_type(jnp.asarray(s.numpy()),
                                         jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    s_back, t_back = scaling.unpack_scale_and_type(packed)
    np.testing.assert_array_equal(s_back.numpy(), s.numpy())


def _data(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "normal":
        x = rng.randn(*shape)
    elif kind == "student_t":
        x = rng.standard_t(2, shape)
    elif kind == "lattice":
        x = rng.choice([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -1.0, -3.0,
                        5.0, -7.0], shape) * 0.25
    else:
        x = np.zeros(shape)
    return x.astype(np.float32)


def _candidate_errors(xb: torch.Tensor, s32: torch.Tensor):
    """Algorithm 1's two per-block MSEs for blocks xb (n, g), in f32."""
    xs = xb * (1.0 / s32)
    absmax = xs.abs().amax(dim=-1)
    errs = []
    for fmt in (formats.E2M1, formats.E1M2):
        s8 = scaling.block_scale_e4m3(absmax, fmt.amax_target)
        q = formats.quantize_to_codebook(xs * (1.0 / s8)[..., None], fmt)
        errs.append((q * s8[..., None] - xs).square().mean(dim=-1))
    return errs


def _assert_only_ties(xb: np.ndarray, s32, differ: np.ndarray):
    """Blocks flagged in ``differ`` must sit on an exact MSE tie."""
    if not differ.any():
        return
    e1, e2 = _candidate_errors(torch.from_numpy(xb[differ]),
                               torch.as_tensor(s32, dtype=torch.float32))
    gap = (e1 - e2).abs().numpy()
    ulp = np.spacing(np.maximum(e1.numpy(), e2.numpy()))
    assert (gap <= TIE_ULPS * ulp).all(), (
        f"{int(differ.sum())} blocks differ; gaps {gap} vs ulp {ulp}")


@pytest.mark.parametrize("kind", ["normal", "student_t", "lattice", "zeros"])
def test_quantize_1d_matches_reference(kind):
    x = _data(kind, (64, 1024), seed=3)
    spec = qtensor.QuantSpec("mixfp4", qtensor.BlockLayout1D(-1, 16))
    got = qtensor.quantize(torch.from_numpy(x), spec)
    want = _jax_quantize(jnp.asarray(x), jqt.QuantSpec(
        "mixfp4", jqt.BlockLayout1D(-1, 16)))
    assert float(got.scale32) == float(want.scale32)
    p_got, p_want = got.payload.numpy(), np.asarray(want.payload)
    s_got, s_want = got.scales.numpy(), np.asarray(want.scales)
    differ = ((p_got != p_want).reshape(64, 64, 8).any(-1)
              | (s_got != s_want))
    _assert_only_ties(x.reshape(64, 64, 16), float(want.scale32), differ)
    np.testing.assert_array_equal(got.dequantize().numpy()[~np.repeat(
        differ, 16, axis=1)], np.asarray(want.dequantize())[~np.repeat(
            differ, 16, axis=1)])


@pytest.mark.parametrize("kind", ["normal", "student_t", "lattice", "zeros"])
def test_quantize_2d_matches_reference(kind):
    k, n = 256, 512
    x = _data(kind, (k, n), seed=4)
    spec = qtensor.QuantSpec("mixfp4", qtensor.BlockLayout2D(16, 16))
    got = qtensor.quantize(torch.from_numpy(x), spec)
    want = _jax_quantize(jnp.asarray(x), jqt.QuantSpec(
        "mixfp4", jqt.BlockLayout2D(16, 16)))
    assert got.shape == tuple(want.shape)
    assert float(got.scale32) == float(want.scale32)
    p_got, p_want = got.payload.numpy(), np.asarray(want.payload)
    s_got, s_want = got.scales.numpy(), np.asarray(want.scales)
    tile_payload_differs = (p_got != p_want).reshape(
        k // 16, 8, n // 16, 16).any(axis=(1, 3))
    differ = tile_payload_differs | (s_got != s_want)
    tiles = x.reshape(k // 16, 16, n // 16, 16).transpose(0, 2, 1, 3)
    _assert_only_ties(tiles.reshape(k // 16, n // 16, 256),
                      float(want.scale32), differ)


def test_quantize_nvfp4_and_dequantize_1d_axis():
    x = _data("normal", (48, 40), seed=5)          # K padded 40 -> 48
    for method in ("nvfp4", "mixfp4"):
        spec = qtensor.QuantSpec(method, qtensor.BlockLayout1D(0, 16))
        got = qtensor.quantize(torch.from_numpy(x), spec)
        want = _jax_quantize(jnp.asarray(x), jqt.QuantSpec(
            method, jqt.BlockLayout1D(0, 16)))
        np.testing.assert_array_equal(got.payload.numpy(),
                                      np.asarray(want.payload))
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(want.scales))
        np.testing.assert_array_equal(got.dequantize().numpy(),
                                      np.asarray(want.dequantize()))


def test_pack_unpack_blocks_match_reference():
    x = _data("student_t", (8, 6, 16), seed=6)
    bq = quantize.adaptive_block_quantize(torch.from_numpy(x),
                                          quantize.METHODS["mixfp4"])
    p = pack.pack_blocks(bq)
    jbq = jquantize.adaptive_block_quantize(jnp.asarray(x),
                                            jquantize.METHODS["mixfp4"])
    jp = jpack.pack_blocks(jbq)
    np.testing.assert_array_equal(p.payload.numpy(), np.asarray(jp.payload))
    np.testing.assert_array_equal(p.scales.numpy(), np.asarray(jp.scales))
    np.testing.assert_array_equal(pack.unpack_blocks(p).numpy(),
                                  np.asarray(jpack.unpack_blocks(jp)))


def test_stack_adds_a_leading_batch_dim():
    spec = qtensor.QuantSpec("mixfp4", qtensor.BlockLayout2D())
    ws = [torch.from_numpy(_data("normal", (32, 48), seed=s)) for s in (7, 8)]
    qts = [qtensor.quantize(w, spec) for w in ws]
    st = qtensor.stack(qts)
    assert st.payload.shape == (2, 16, 48) and st.scale32.shape == (2,)
    assert st.batch_size() == 2 and st.nbytes == sum(q.nbytes for q in qts)
    for i, q in enumerate(qts):
        np.testing.assert_array_equal(st.dequantize()[i].numpy(),
                                      q.dequantize().numpy())
    with pytest.raises(ValueError):
        qtensor.stack([qts[0], qtensor.quantize(ws[1][:, :32], spec)])
