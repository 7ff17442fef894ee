"""The port's W4A4 kernels (packed and fused GEMM), the grouped RHT and the
W4A4 ``qmm`` dispatch against the JAX package, on the CPU (plain versions).

Tolerances:
* bitwise: ``fwht_rows`` against the reference kernel (interpret mode) and
  ``fwht_rows_math``; ``serve_signs``; ``rht``; the quantizer's bytes and
  per-row scale of RHT-transformed rows; ``pack_projections(act_rht=True)``
  bytes and its ``rht_signs`` record;
* W4A4 GEMMs: atol 2e-2 after normalising by max|oracle|, the reference's
  own tolerance (``tests/test_kernels.py``), against ``ref_gemm_w4a4`` and
  the reference kernels in interpret mode;
* inside the port: fused == quantizer + packed GEMM bitwise (per tensor,
  per row, per row + RHT), and row i of a per-row output bitwise
  unchanged when its batchmates change.

The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import hadamard as jhad  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fwht import fwht_rows as jfwht  # noqa: E402
from repro.kernels.fwht import fwht_rows_math as jfwht_math  # noqa: E402
from repro.kernels.mixfp4_quant import (  # noqa: E402
    mixfp4_quant_rows as jquant)
from repro.models import base as jbase  # noqa: E402
from repro_torch.core import hadamard, qtensor  # noqa: E402
from repro_torch.kernels import fwht, mixfp4_gemm, ops, ref  # noqa: E402
from repro_torch.models import base  # noqa: E402


@pytest.fixture(scope="module")
def pallas_memory_space_alias():
    """jax 0.9 renamed ``pltpu.TPUMemorySpace`` (which the reference GEMM
    uses) to ``MemorySpace``; alias it for this module only."""
    from jax.experimental.pallas import tpu as pltpu
    missing = not hasattr(pltpu, "TPUMemorySpace")
    if missing:
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    yield
    if missing:
        del pltpu.TPUMemorySpace


def _rows(m: int, k: int, seed: int) -> np.ndarray:
    """Normal, heavy-tailed and on-lattice rows, every fifth row zero."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(m // 3, k) * 3.0,
                        rng.standard_t(2, (m // 3, k)),
                        rng.choice([0, .5, 1, 1.5, 2, 3, 4, 6, -2, -6],
                                   (m - 2 * (m // 3), k)) * 0.7])
    x[::5] = 0.0
    return x.astype(np.float32)


def _signs(k: int, seed: int) -> np.ndarray:
    return np.where(np.random.RandomState(seed).rand(k) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# RHT: serve_signs, rht, fwht_rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 64, 128, 2304, 2560, 9216])
def test_serve_signs_bitwise(n):
    np.testing.assert_array_equal(hadamard.serve_signs(n),
                                  np.asarray(jhad.serve_signs(n)))


@pytest.mark.parametrize("dim,group", [(-1, 16), (0, 16), (-1, 4)])
def test_rht_bitwise(dim, group):
    x = _rows(32, 64, seed=3)
    signs = _signs(x.shape[dim], seed=4)
    got = hadamard.rht(_t(x), signs, dim=dim, group=group)
    want = jhad.rht(jnp.asarray(x), jnp.asarray(signs), axis=dim,
                    group=group)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if dim == -1:
        np.testing.assert_array_equal(
            ref.ref_fwht_rows(_t(x), signs, group).numpy(), np.asarray(
                jref.ref_fwht_rows(jnp.asarray(x), jnp.asarray(signs),
                                   group)))


@pytest.mark.parametrize("mkg", [(8, 64, 16), (30, 256, 16), (5, 96, 32),
                                 (7, 64, 4)])
def test_fwht_rows_bitwise_vs_reference(mkg):
    m, k, g = mkg
    x, signs = _rows(m, k, seed=m), _signs(k, seed=k)
    got = fwht.fwht_rows(_t(x), _t(signs), group=g)
    want = jfwht(jnp.asarray(x), jnp.asarray(signs), group=g, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        fwht.fwht_rows_math(_t(x), _t(signs), g).numpy(),
        np.asarray(jfwht_math(jnp.asarray(x), jnp.asarray(signs), g)))


@pytest.mark.parametrize("bad,match", [
    ({"group": 12}, "power of two"), ({"group": 128}, "not divisible"),
    ({"signs_len": 32}, "signs must have shape")])
def test_fwht_rows_rejects_bad_group_and_signs(bad, match):
    x = torch.zeros(2, 64)
    signs = torch.ones(bad.get("signs_len", 64))
    with pytest.raises(ValueError, match=match):
        fwht.fwht_rows(x, signs, group=bad.get("group", 16))


@pytest.mark.parametrize("k", [64, 256])
def test_quantize_rows_of_rht_rows_bitwise(k):
    """The bytes and per-row scale the 2-pass RHT path writes."""
    x, signs = _rows(24, k, seed=k), _signs(k, seed=1)
    xt = ops.rht_rows(_t(x), _t(signs))
    qx = qtensor.quantize_rows(xt, per_row=True)
    jxt = jhad.rht(jnp.asarray(x), jnp.asarray(signs), axis=-1, group=16)
    jp, js, js32 = jquant(jxt, per_row=True, interpret=True)
    np.testing.assert_array_equal(qx.payload.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(qx.scales.numpy(), np.asarray(js))
    np.testing.assert_array_equal(qx.scale32.numpy(), np.asarray(js32))
    np.testing.assert_array_equal(
        qtensor._act_scale32_like_quantize_rows(xt, per_row=True).numpy(),
        np.asarray(jqt._act_scale32_like_quantize_rows(jxt, per_row=True)))


def test_pack_projections_act_rht_bitwise():
    rng = np.random.RandomState(5)
    dense = {"wq": (rng.randn(64, 48) * 0.2).astype(np.float32),
             "w_down": (rng.randn(128, 64) * 0.1).astype(np.float32)}
    packed, nbytes, dense_bytes = base.pack_projections(
        {k: _t(v) for k, v in dense.items()}, act_rht=True)
    want, jbytes, jdense = jbase.pack_projections(
        {k: jnp.asarray(v) for k, v in dense.items()}, act_rht=True)
    assert (nbytes, dense_bytes) == (jbytes, jdense)
    for name in dense:
        for child in ("payload", "scales", "scale32"):
            np.testing.assert_array_equal(
                getattr(packed[name], child).numpy(),
                np.asarray(getattr(want[name], child)))
    assert set(packed["rht_signs"]) == set(want["rht_signs"]) == {"64",
                                                                   "128"}
    for k, s in packed["rht_signs"].items():
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(want["rht_signs"][k]))


# ---------------------------------------------------------------------------
# W4A4 GEMMs: plain versions against the reference
# ---------------------------------------------------------------------------
MKN = [(8, 128, 64), (5, 64, 48), (16, 256, 128)]


def _case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * rng.choice([0.5, 2.0, 8.0], (m, 1))).astype(
        np.float32)
    x[-1] = 0.0                                   # an all-zero row
    w = (rng.randn(k, n) * 0.3).astype(np.float32)
    return x, ops.pack_weight_qt(_t(w))


def _close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2, rtol=0)


@pytest.mark.parametrize("per_row", [False, True], ids=["tensor", "row"])
@pytest.mark.parametrize("mkn", MKN)
def test_gemm_w4a4_plain_vs_reference(mkn, per_row,
                                      pallas_memory_space_alias):
    from repro.kernels.mixfp4_gemm import mixfp4_gemm_w4a4 as jgemm
    x, qw = _case(*mkn, seed=sum(mkn))
    qx = qtensor.quantize_rows(_t(x), per_row=per_row)
    y = ops.gemm_w4a4(qx.payload, qx.scales, qx.scale32, qw.payload,
                      qw.scales, qw.scale32, per_row=per_row).numpy()
    jargs = [jnp.asarray(a.numpy()) for a in (qx.payload, qx.scales,
                                              qx.scale32, qw.payload,
                                              qw.scales, qw.scale32)]
    xs32 = jargs[2].reshape(-1, 1) if per_row else jargs[2]
    _close(y, np.asarray(jref.ref_gemm_w4a4(*jargs[:2], xs32, *jargs[3:])))
    _close(y, np.asarray(jgemm(*jargs, interpret=True, per_row=per_row)))
    mine = ref.ref_gemm_w4a4(qx.payload, qx.scales, qx.scale32, qw.payload,
                             qw.scales, qw.scale32)
    _close(y, mine.numpy())


FUSED = [({}, "tensor"), ({"per_row": True}, "row"),
         ({"per_row": True, "rht": True}, "row_rht")]


@pytest.mark.parametrize("mode", [f[0] for f in FUSED],
                         ids=[f[1] for f in FUSED])
@pytest.mark.parametrize("mkn", MKN)
def test_gemm_w4a4_fused_plain_vs_reference(mkn, mode,
                                            pallas_memory_space_alias):
    from repro.kernels.mixfp4_gemm import mixfp4_gemm_w4a4_fused as jfused
    x, qw = _case(*mkn, seed=sum(mkn) + 1)
    per_row = mode.get("per_row", False)
    signs = _signs(mkn[1], seed=2) if mode.get("rht") else None
    xt = x if signs is None else np.asarray(jfwht_math(
        jnp.asarray(x), jnp.asarray(signs), 16))
    s32 = (qtensor._act_scale32_like_quantize_rows(_t(xt), per_row)
           if per_row else qtensor._act_scale32_like_quantize_rows(_t(x)))
    y = ops.gemm_w4a4_fused(_t(x), s32, qw.payload, qw.scales, qw.scale32,
                            per_row=per_row, rht_signs=None if signs is None
                            else _t(signs)).numpy()
    jw = [jnp.asarray(a.numpy()) for a in (qw.payload, qw.scales,
                                           qw.scale32)]
    want = jfused(jnp.asarray(x), jnp.asarray(s32.numpy()), *jw,
                  interpret=True, per_row=per_row,
                  rht_signs=None if signs is None else jnp.asarray(signs))
    _close(y, np.asarray(want))
    # and against the oracle on the reference quantizer's bytes
    jp, js, js32 = jquant(jnp.asarray(xt), per_row=per_row, interpret=True)
    oracle = jref.ref_gemm_w4a4(jp, js, js32.reshape(-1, 1) if per_row
                                else js32, *jw)
    _close(y, np.asarray(oracle))


# ---------------------------------------------------------------------------
# inside the port: fused == 2-pass, per-row batch invariance, qmm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [f[0] for f in FUSED],
                         ids=[f[1] for f in FUSED])
@pytest.mark.parametrize("mkn", MKN)
def test_fused_equals_quantizer_then_gemm_bitwise(mkn, mode):
    x, qw = _case(*mkn, seed=sum(mkn) + 2)
    per_row = mode.get("per_row", False)
    signs = _t(_signs(mkn[1], seed=3)) if mode.get("rht") else None
    fused = qtensor.qmm(_t(x), qw, fuse_act_quant=True, per_row_act=per_row,
                        act_rht_signs=signs)
    xt = _t(x) if signs is None else ops.rht_rows(_t(x), signs)
    two_pass = qtensor.qmm(qtensor.quantize_rows(xt, per_row=per_row), qw)
    assert torch.equal(fused, two_pass)


@pytest.mark.parametrize("per_row", [False, True], ids=["tensor", "row"])
def test_fused_with_pinned_scale_equals_pinned_quantizer(per_row):
    """``act_scale32`` pins the activation scale (as sharded callers pin a
    global one): bitwise the quantizer under the same pinned scale."""
    x, qw = _case(8, 128, 64, seed=13)
    pinned = (torch.linspace(0.01, 0.05, 8) if per_row
              else torch.tensor(0.02))
    fused = qtensor.qmm(_t(x), qw, fuse_act_quant=True, per_row_act=per_row,
                        act_scale32=pinned)
    qx = qtensor.quantize_rows(_t(x), scale32=pinned, per_row=per_row)
    assert torch.equal(fused, qtensor.qmm(qx, qw))


@pytest.mark.parametrize("spelling", ["fused", "fused_rht", "2pass"])
def test_per_row_output_row_ignores_batchmates(spelling):
    x, qw = _case(8, 128, 64, seed=11)
    other = np.random.RandomState(12).randn(8, 128).astype(np.float32) * 50
    mixed = np.concatenate([x[:3], other[3:]])
    signs = base.rht_signs_on_grid(128, 128, torch.device("cpu"))

    def run(rows):
        if spelling == "2pass":
            return qtensor.qmm(qtensor.quantize_rows(_t(rows), per_row=True),
                               qw)
        return qtensor.qmm(_t(rows), qw, fuse_act_quant=True,
                           per_row_act=True, act_rht_signs=signs
                           if spelling == "fused_rht" else None)

    assert torch.equal(run(x)[:3], run(mixed)[:3])


def test_qmm_w4a4_pads_onto_stored_grid():
    """K=100 activations against a weight stored on the 112 grid (and wider
    storage past the logical shape) give one result."""
    rng = np.random.RandomState(7)
    x = _t(rng.randn(3, 100).astype(np.float32))
    qw = ops.pack_weight_qt(_t(rng.randn(100, 40).astype(np.float32)))
    padded = qw.replace(
        payload=torch.nn.functional.pad(qw.payload, (0, 16, 0, 32)),
        scales=torch.nn.functional.pad(qw.scales, (0, 1, 0, 4)))
    for w in (qw, padded):
        kp = 2 * w.payload.shape[0]
        y = qtensor.qmm(x, w, fuse_act_quant=True, per_row_act=True)
        assert y.shape == (3, 40)
        two = qtensor.qmm(qtensor.quantize_rows(x, pad_to=kp, per_row=True),
                          w)
        assert torch.equal(y, two)
    want = x @ qw.dequantize()
    np.testing.assert_allclose(y.numpy(), want.numpy(),
                               atol=0.2 * float(want.abs().max()))


@pytest.mark.parametrize("kw,match", [
    ({"packed": True, "fuse_act_quant": True}, "already packed"),
    ({"fuse_act_quant": True, "act_rht_signs": True}, "per_row_act"),
    ({"fuse_act_quant": True, "per_row_act": True, "act_rht_signs": 32},
     "Kp grid")])
def test_qmm_w4a4_argument_errors(kw, match):
    x = torch.randn(2, 64)
    qw = ops.pack_weight_qt(torch.randn(64, 32))
    kw = dict(kw)
    if kw.pop("packed", False):
        x = qtensor.quantize_rows(x)
    n = kw.get("act_rht_signs")
    if n is not None:
        kw["act_rht_signs"] = torch.ones(64 if n is True else n)
    with pytest.raises(ValueError, match=match):
        qtensor.qmm(x, qw, **kw)


def test_cpu_w4a4_paths_count_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(4, 32)
    w = ops.pack_weight_qt(torch.randn(32, 32))
    qx = qtensor.quantize_rows(x, per_row=True)
    ops.gemm_w4a4(qx.payload, qx.scales, qx.scale32, w.payload, w.scales,
                  w.scale32, per_row=True)
    ops.gemm_w4a4_fused(x, qx.scale32, w.payload, w.scales, w.scale32,
                        per_row=True, rht_signs=torch.ones(32))
    ops.rht_rows(x, torch.ones(32))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert set(ops.KERNELS) >= {"mixfp4_gemm_w4a4", "mixfp4_gemm_w4a4_fused",
                                "fwht_rows"}


def test_w4a4_wrappers_reject_other_devices():
    x = torch.zeros(4, 32, device="meta")
    w = ops.pack_weight_qt(torch.randn(32, 32))
    wp, ws = w.payload.to("meta"), w.scales.to("meta")
    one = torch.ones((), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.gemm_w4a4_fused(x, one, wp, ws, one)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.gemm_w4a4(torch.zeros(4, 16, dtype=torch.uint8, device="meta"),
                      torch.zeros(4, 2, dtype=torch.uint8, device="meta"),
                      one, wp, ws, one)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rht_rows(x, torch.ones(32, device="meta"))


# ---------------------------------------------------------------------------
# the reference's RHT fault on pre-padded storage, and the port's result
# ---------------------------------------------------------------------------
K_FAULT, N_FAULT, M_FAULT = 2304, 256, 4


@pytest.fixture(scope="module")
def rht_fault_case():
    """A gemma2-width projection packed by the reference with act_rht=True,
    then pre-padded by its engine's tuner step for 4 decode rows."""
    rng = np.random.RandomState(21)
    w = (rng.randn(K_FAULT, N_FAULT) / np.sqrt(K_FAULT)).astype(np.float32)
    x = rng.randn(M_FAULT, K_FAULT).astype(np.float32)
    packed, _, _ = jbase.pack_projections({"wq": jnp.asarray(w)},
                                          act_rht=True)
    padded = jqt.prepad_for_tiles(packed["wq"], "w4a4", M_FAULT)
    return x, w, packed, padded


def _port_weight(qt):
    return qtensor.QTensor(_t(qt.payload), _t(qt.scales), _t(qt.scale32),
                           layout=qtensor.BlockLayout2D(),
                           shape=tuple(qt.shape))


def test_reference_rht_signs_drift_on_prepadded_storage(rht_fault_case):
    _x, _w, packed, padded = rht_fault_case
    assert 2 * packed["wq"].payload.shape[0] == K_FAULT
    kp = 2 * padded.payload.shape[0]
    assert kp == 2560 and tuple(padded.shape) == (K_FAULT, N_FAULT)
    # the reference's qlinear draws serve_signs(2 * payload rows): another
    # diagonal than the one the weight was rotated with
    assert not np.array_equal(np.asarray(jhad.serve_signs(kp))[:K_FAULT],
                              np.asarray(jhad.serve_signs(K_FAULT)))


def test_port_serves_prepadded_rht_weight_at_unpadded_error(rht_fault_case):
    x, w, packed, padded = rht_fault_case
    want = x @ w
    scale = np.abs(want).max()
    act = base.ActQuant("mixfp4", rht=True)
    y_pad = base.qlinear(_t(x), _port_weight(padded), act).numpy()
    y_raw = base.qlinear(_t(x), _port_weight(packed["wq"]), act).numpy()
    err_pad = np.abs(y_pad - want).max() / scale
    err_raw = np.abs(y_raw - want).max() / scale
    # the 4-bit quantization error of both operands, about 0.13 here
    assert err_raw < 0.2
    np.testing.assert_allclose(y_pad / scale, y_raw / scale, atol=1e-5,
                               rtol=0)
    # what the reference's diagonal from the padded length gives instead
    kp = 2 * padded.payload.shape[0]
    wrong = _t(np.asarray(jhad.serve_signs(kp)))
    y_ref = qtensor.qmm(_t(x), _port_weight(padded), fuse_act_quant=True,
                        per_row_act=True, act_rht_signs=wrong).numpy()
    assert np.abs(y_ref - want).max() / scale > 1.0 > 5 * err_pad
