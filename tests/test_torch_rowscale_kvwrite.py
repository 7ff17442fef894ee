"""The RHT row scale (``fwht_row_scale``) and the KV-cache write
(``mixfp4_quant_kv``) against the JAX package, on the CPU (plain versions).

Tolerances, all bitwise:
* the row scale against the reference's spelling in ``qmm``'s per-row
  branch, ``_act_scale32_like_quantize_rows(fwht_rows_math(x, signs, 16),
  per_row=True)`` (``src/repro/core/qtensor.py``), on rows padded onto a
  wider K grid, without signs, and on zero, NaN and Inf rows (a subnormal
  row only against the port's former composition: XLA's CPU backend
  flushes subnormals, so the reference reads it as zero);
* the KV write against the cache bytes the reference's own packed-cache
  attention leaves behind (``_attn_packed_cached``, ``_attn_paged_cached``
  over ``quantize_kv_rows``): fixed-slot decode and prefill, paged decode
  with idle lanes in the trash page, and a paged prefill chunk that starts
  in a copy-on-write page and crosses page boundaries;
* ``qmm``'s fused W4A4 + RHT output through the new scale against the
  composition it replaces (``fwht_rows``, then the row scale).

The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jqt  # noqa: E402
from repro.kernels.fwht import fwht_rows_math as jfwht_math  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.kernels import fwht, mixfp4_quant, ops  # noqa: E402
from repro_torch.models import base  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# fwht_row_scale
# ---------------------------------------------------------------------------
def _special_rows(m: int, k: int, seed: int) -> np.ndarray:
    """Normal and heavy-tailed rows, then rows that are all zero, hold a
    NaN, one Inf, two Infs in one 16-lane group (the transform makes Inf -
    Inf = NaN), -Inf, Inf beside NaN, values whose butterfly overflows, and
    subnormals."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(m, k) * 3.0,
                        rng.standard_t(2, (m, k))]).astype(np.float32)
    special = np.tile(rng.randn(1, k).astype(np.float32), (8, 1))
    special[0] = 0.0
    special[1, 5] = np.nan
    special[2, 7] = np.inf
    special[3, 16:18] = np.inf
    special[4, k - 1] = -np.inf
    special[5, 3], special[5, k - 2] = np.inf, np.nan
    special[6, :16] = 3e38
    special[7] = np.float32(1e-40) * np.sign(special[7])
    return np.concatenate([x, special])


def _signs(k: int, seed: int) -> np.ndarray:
    return np.where(np.random.RandomState(seed).rand(k) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _reference_row_scale(x: np.ndarray, signs) -> np.ndarray:
    """The reference's per-row branch of ``qmm`` (qtensor.py:669-681)."""
    xj = jnp.asarray(x)
    xt = xj if signs is None else jfwht_math(xj, jnp.asarray(signs), 16)
    return np.asarray(jqt._act_scale32_like_quantize_rows(xt, per_row=True))


# (M, logical K, stored Kp, with signs): K padded onto Kp as qmm pads it,
# the signs extended with +1 (models.base.rht_signs_on_grid)
ROW_SCALE_CASES = [(3, 64, 64, True), (5, 256, 256, True),
                   (2, 2304, 2304, True), (4, 200, 208, True),
                   (3, 100, 112, True), (4, 256, 256, False),
                   (3, 100, 112, False)]


@pytest.mark.parametrize("case", ROW_SCALE_CASES,
                         ids=[f"m{c[0]}_k{c[1]}_kp{c[2]}_"
                              f"{'rht' if c[3] else 'plain'}"
                              for c in ROW_SCALE_CASES])
def test_row_scale_bitwise_vs_reference(case):
    m, k, kp, rht = case
    x = np.pad(_special_rows(m, k, seed=k + m), ((0, 0), (0, kp - k)))
    signs = None
    if rht:
        signs = np.ones(kp, np.float32)
        signs[:k] = _signs(k, seed=k)
    got = fwht.fwht_row_scale(torch.from_numpy(x), None if signs is None
                              else torch.from_numpy(signs))
    want = _reference_row_scale(x, signs)
    # the last row is subnormal: XLA's CPU backend flushes subnormal
    # operands to zero (its amax reads 0, its scale 1); PyTorch and the
    # CUDA kernel (built without -ftz) keep them
    np.testing.assert_array_equal(_bits(got.numpy())[:-1], _bits(want)[:-1])
    assert want[-1] == 1.0 and 0.0 < float(got[-1]) < 1.2e-38
    # the composition qmm used before: the transformed rows, then the scale
    xt = torch.from_numpy(x)
    if rht:
        xt = fwht.fwht_rows(xt, torch.from_numpy(signs))
    old = qtensor._act_scale32_like_quantize_rows(xt, per_row=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(old.numpy()))
    special = got[-8:].tolist()
    assert special[0] == 1.0 and special[1] == 1.0      # zero and NaN rows
    assert special[5] == 1.0                            # Inf beside NaN
    if not rht:
        assert special[2] == special[4] == float("inf")


def test_row_scale_of_one_inf_per_group_is_inf():
    """One Inf in a 16-lane group stays +-Inf through the butterfly (no Inf
    - Inf), so the row's scale is Inf, as in the reference; two Infs in
    one group give NaN and the scale 1."""
    x = np.zeros((2, 32), np.float32)
    x[0, 3] = np.inf
    x[1, 4:6] = np.inf
    signs = np.ones(32, np.float32)
    got = fwht.fwht_row_scale(torch.from_numpy(x), torch.from_numpy(signs))
    assert got.tolist() == [float("inf"), 1.0]
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_reference_row_scale(x, signs)))


def test_qmm_fused_rht_through_new_scale_equals_old_composition():
    """The fused W4A4 + RHT projection (and the plain per-row one) with its
    scale from ``rht_row_scale`` equals the fused kernel fed the scale of
    the transformed rows, bitwise, on a K padded onto the stored grid."""
    rng = np.random.RandomState(3)
    for k, n in ((256, 64), (200, 48)):
        x = torch.from_numpy(_special_rows(3, k, seed=k)[:6].copy())
        qw = ops.pack_weight_qt(torch.from_numpy(
            rng.randn(k, n).astype(np.float32) / np.sqrt(k)))
        kp = 2 * qw.payload.shape[0]
        x2p = torch.nn.functional.pad(x, (0, kp - k))
        for signs in (base.rht_signs_on_grid(k, kp, torch.device("cpu")),
                      None):
            y = qtensor.qmm(x, qw, fuse_act_quant=True, per_row_act=True,
                            act_rht_signs=signs)
            xt = x2p if signs is None else fwht.fwht_rows(x2p, signs)
            s_old = qtensor._act_scale32_like_quantize_rows(xt,
                                                            per_row=True)
            old = ops.gemm_w4a4_fused(x2p, s_old, qw.payload, qw.scales,
                                      qw.scale32, per_row=True,
                                      rht_signs=signs, n_out=n)
            assert torch.equal(y, old)
            assert torch.isfinite(y).all()


@pytest.mark.parametrize("bad,match", [
    ({"shape": (2, 3, 32)}, "expected \\(M, K\\) float32"),
    ({"dtype": torch.bfloat16}, "expected \\(M, K\\) float32"),
    ({"shape": (2, 40)}, "not divisible by RHT group 16"),
    ({"signs_len": 32}, "signs must have shape"),
    ({"device": "meta"}, "unsupported device")])
def test_row_scale_rejects_bad_shape_dtype_group_and_device(bad, match):
    shape = bad.get("shape", (2, 64))
    x = torch.zeros(shape, dtype=bad.get("dtype", torch.float32),
                    device=bad.get("device", "cpu"))
    signs = torch.ones(bad.get("signs_len", shape[-1]), device=x.device)
    with pytest.raises(ValueError, match=match):
        fwht.fwht_row_scale(x, signs)


# ---------------------------------------------------------------------------
# mixfp4_quant_kv
# ---------------------------------------------------------------------------
def _bf16_rows(rng, *shape) -> np.ndarray:
    """f32 values that bf16 holds exactly (the served K/V rows are bf16)."""
    x = torch.from_numpy((rng.randn(*shape) * 2.0).astype(np.float32))
    return x.to(torch.bfloat16).to(torch.float32).numpy()


def _leaves(rng, rows: tuple, dh: int):
    """Random wire bytes for a K or V leaf (stale rows a write must leave
    alone): payload, scales."""
    return (rng.randint(0, 256, rows + (dh // 2,)).astype(np.uint8),
            rng.randint(0, 256, rows + (dh // 16,)).astype(np.uint8))


def _port_write(knew, vnew, cache, pos, block_tables=None):
    """The port's KV write on CPU tensors; returns the four leaves."""
    leaves = [torch.from_numpy(a.copy()) for a in cache]
    ck = qtensor.from_packed_rows(leaves[0], leaves[1], torch.tensor(1.0))
    cv = qtensor.from_packed_rows(leaves[2], leaves[3], torch.tensor(1.0))
    before = dict(ops.launch_counts())
    ops.quantize_kv(torch.from_numpy(knew).to(torch.bfloat16),
                    torch.from_numpy(vnew).to(torch.bfloat16), ck, cv, pos,
                    block_tables=block_tables)
    assert ops.launch_counts() == before               # CPU: no launch
    return [a.numpy() for a in leaves]


def _reference_write(q, knew, vnew, cache, cache_len, block_tables=None):
    """The cache leaves after the reference's packed-cache attention step."""
    ck = jqt.from_packed_rows(jnp.asarray(cache[0]), jnp.asarray(cache[1]),
                              jbase.KV_SCALE32)
    cv = jqt.from_packed_rows(jnp.asarray(cache[2]), jnp.asarray(cache[3]),
                              jbase.KV_SCALE32)
    cfg = jbase.ArchConfig(n_heads=q.shape[2], n_kv_heads=knew.shape[2],
                           head_dim=knew.shape[3])
    args = (jnp.asarray(q), jnp.asarray(knew), jnp.asarray(vnew), (ck, cv),
            jnp.asarray(cache_len))
    if block_tables is None:
        _, (nk, nv) = jbase._attn_packed_cached(*args, 0, cfg)
    else:
        _, (nk, nv) = jbase._attn_paged_cached(
            *args, jnp.asarray(block_tables), 0, cfg)
    return [np.asarray(a) for a in (nk.payload, nk.scales, nv.payload,
                                    nv.scales)]


@pytest.mark.parametrize("dh", [16, 32, 48])
def test_kv_write_fixed_decode_bitwise_vs_reference(dh):
    rng = np.random.RandomState(dh)
    b, smax, hkv = 3, 20, 2
    cache = [*_leaves(rng, (b, smax, hkv), dh),
             *_leaves(rng, (b, smax, hkv), dh)]
    knew, vnew = (_bf16_rows(rng, b, 1, hkv, dh) for _ in range(2))
    q = rng.randn(b, 1, 2 * hkv, dh).astype(np.float32)
    lengths = np.array([0, 7, smax - 1], np.int32)
    got = _port_write(knew, vnew, cache, torch.from_numpy(lengths))
    want = _reference_write(q, knew, vnew, cache, lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    changed = [not np.array_equal(g, c) for g, c in zip(got, cache)]
    assert all(changed)


@pytest.mark.parametrize("dh", [16, 48])
def test_kv_write_fixed_prefill_bitwise_vs_reference(dh):
    """A slot's prompt rows from position 5 on (bucket padding rows
    included), written whole."""
    rng = np.random.RandomState(100 + dh)
    smax, hkv, s, start = 24, 3, 9, 5
    cache = [*_leaves(rng, (1, smax, hkv), dh),
             *_leaves(rng, (1, smax, hkv), dh)]
    knew, vnew = (_bf16_rows(rng, 1, s, hkv, dh) for _ in range(2))
    q = rng.randn(1, s, hkv, dh).astype(np.float32)
    got = _port_write(knew, vnew, cache, start)
    want = _reference_write(q, knew, vnew, cache, np.int32(start))
    for g, w, c in zip(got, want, cache):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g[:, :start], c[:, :start])
        np.testing.assert_array_equal(g[:, start + s:], c[:, start + s:])


def test_kv_write_paged_decode_with_idle_lanes_bitwise_vs_reference():
    """Two lanes write through their block tables (one at a page's last
    row, one at a page's first); two idle lanes with zeroed tables write
    into the trash page 0, which no read sees, so every page but 0 is
    compared."""
    rng = np.random.RandomState(7)
    pages, page_len, hkv, dh, b, mp = 9, 16, 2, 32, 4, 3
    cache = [*_leaves(rng, (pages, page_len, hkv), dh),
             *_leaves(rng, (pages, page_len, hkv), dh)]
    bt = np.zeros((b, mp), np.int32)
    bt[0] = [4, 2, 7]
    bt[2] = [1, 8, 0]
    lengths = np.array([31, 0, 16, 0], np.int32)  # page 2 row 15, 8 row 0
    knew, vnew = (_bf16_rows(rng, b, 1, hkv, dh) for _ in range(2))
    q = rng.randn(b, 1, 2 * hkv, dh).astype(np.float32)
    got = _port_write(knew, vnew, cache, torch.from_numpy(lengths),
                      block_tables=torch.from_numpy(bt))
    want = _reference_write(q, knew, vnew, cache, lengths, block_tables=bt)
    for g, w, c in zip(got, want, cache):
        np.testing.assert_array_equal(g[1:], w[1:])
        np.testing.assert_array_equal(np.delete(g, [2, 8], 0)[1:],
                                      np.delete(c, [2, 8], 0)[1:])


def test_kv_write_paged_prefill_across_pages_and_cow_page():
    """A prefill chunk starting mid-page in a copy-on-write page (page 5,
    a copy of the shared prefix page 4, whose first 14 rows are the
    prefix's) and running across two page boundaries: the reference's
    bytes everywhere, the shared page untouched, the copied rows kept."""
    rng = np.random.RandomState(11)
    pages, page_len, hkv, dh = 8, 16, 2, 48
    cache = [*_leaves(rng, (pages, page_len, hkv), dh),
             *_leaves(rng, (pages, page_len, hkv), dh)]
    for a in cache:
        a[5] = a[4]                                 # the eager COW copy
    bt = np.array([[3, 5, 2, 6, 0]], np.int32)
    start, s = 30, 20                               # logical rows 30..49
    knew, vnew = (_bf16_rows(rng, 1, s, hkv, dh) for _ in range(2))
    q = rng.randn(1, s, hkv, dh).astype(np.float32)
    got = _port_write(knew, vnew, cache, start,
                      block_tables=torch.from_numpy(bt))
    want = _reference_write(q, knew, vnew, cache, np.int32(start),
                            block_tables=bt)
    for g, w, c in zip(got, want, cache):
        np.testing.assert_array_equal(g, w)
        for page in (0, 1, 3, 4, 7):                # not in the chunk
            np.testing.assert_array_equal(g[page], c[page])
        np.testing.assert_array_equal(g[5, :14], c[4, :14])
        np.testing.assert_array_equal(g[6, 2:], c[6, 2:])


def test_kv_write_equals_quantizer_then_scatter():
    """The plain route is the quantizer under each leaf's scale32 followed
    by the indexed writes (``quantize_kv_rows`` when scale32 is the pinned
    KV_SCALE32)."""
    rng = np.random.RandomState(5)
    b, smax, hkv, dh = 2, 6, 2, 32
    cache = [*_leaves(rng, (b, smax, hkv), dh),
             *_leaves(rng, (b, smax, hkv), dh)]
    knew, vnew = (_bf16_rows(rng, b, 1, hkv, dh) for _ in range(2))
    got = _port_write(knew, vnew, cache, torch.tensor([2, 5],
                                                      dtype=torch.int32))
    want = [a.copy() for a in cache]
    for i, x in enumerate((knew, vnew)):
        p, sc = base.quantize_kv_rows(torch.from_numpy(x))
        want[2 * i][[0, 1], [2, 5]] = p[:, 0].numpy()
        want[2 * i + 1][[0, 1], [2, 5]] = sc[:, 0].numpy()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bad,match", [
    ("v_shape", "of one shape"), ("dh", "multiple of 16"),
    ("leaf", "v_scales must be uint8"), ("pos_s", "S == 1"),
    ("tables", "block_tables must be"), ("device", "unsupported device")])
def test_kv_write_rejects_bad_shapes_and_device(bad, match):
    b, s, hkv, dh = 2, 1, 2, 32
    dev = "meta" if bad == "device" else "cpu"
    k = torch.zeros(b, s if bad != "pos_s" else 3, hkv,
                    dh if bad != "dh" else 24, device=dev)
    v = torch.zeros(b, 2, hkv, dh) if bad == "v_shape" else k
    leaves = [torch.zeros(b, 8, hkv, w, dtype=torch.uint8, device=dev)
              for w in (dh // 2, dh // 16, dh // 2, dh // 16)]
    if bad == "leaf":
        leaves[3] = torch.zeros(b, 8, hkv, 3, dtype=torch.uint8)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    tables = (torch.zeros(1, 4, dtype=torch.int32) if bad == "tables"
              else None)
    one = torch.ones((), device=dev)
    with pytest.raises(ValueError, match=match):
        mixfp4_quant.mixfp4_quant_kv(k, v, *leaves, one, one, pos,
                                     block_tables=tables)


def test_kv_write_out_of_range_row_raises():
    """A position past the cache is an error, never a skipped row (the
    kernel traps where the indexed write raises)."""
    b, smax, hkv, dh = 2, 4, 1, 16
    leaves = [torch.zeros(b, smax, hkv, w, dtype=torch.uint8)
              for w in (dh // 2, dh // 16, dh // 2, dh // 16)]
    k = torch.ones(b, 1, hkv, dh)
    one = torch.ones(())
    with pytest.raises(IndexError):
        mixfp4_quant.mixfp4_quant_kv(k, k, *leaves, one, one,
                                     torch.tensor([0, smax],
                                                  dtype=torch.int32))
