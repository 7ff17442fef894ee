"""The expert decode kernel's walk (``kernels/mixfp4_gemm.py``
``gemm_w4a16_experts_walk``) on the CPU, on the capacity buffers that the
port's MoE layer builds (``models/moe.py`` ``dispatch_buffer``, through
``_dispatch_indices``) from a B = 4 top-4 routing over qwen2-moe's 60
experts stored as 64, at its K (2048 for up/gate, 1408 = 5.5 splits of
256 for down) and a narrow N.

The walk sums each 256-deep K split from zero and adds the splits in
order, skipping a split whose activations are all +-0, as the CUDA kernel
does.  Held here: against the plain version (``gemm_w4a16_experts_plain``,
one f32 product over all of K) within 1e-5 of max|plain| on finite outputs,
since both sum the same exact bf16 products in f32 in another order;
bitwise against itself with every split computed (skipping changes no bit,
finite weights); +0 bits for every expert without a non-zero row, a -0.0
expert included; NaN and Inf rows non-finite in both; a row non-zero only
in K = 1408's last, 128-deep split computed; and per expert against the
JAX package's ``ref_gemm_w4a16`` at its atol 2e-2, scale-normalised
(``tests/test_kernels.py``).

  PYTHONPATH=src python -m pytest -q tests/test_torch_expert_walk.py
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import mixfp4_gemm, tuning  # noqa: E402
from repro_torch.models import base, moe  # noqa: E402

CFG = configs.config("qwen2-moe-a2.7b")
E_REAL, E_STORE = CFG.n_experts, moe.stored_experts(CFG)
KN = [(2048, 48), (1408, 32)]          # qwen2-moe's K, narrow N
# rows per expert -> tokens routed: cap = max(ceil(T * 4 * 1.25 / 60), 4)
# = C - 1 (C = 1: cap 0, every choice dropped)
TOKENS = {1: 4, 5: 4, 64: 756}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work, the count it had
    restored after.  The suite runs several test processes side by side,
    and with one thread per core in every process the many small ops here
    spend their time contending for the cores (six copies of this module
    side by side on 8 cores: not done after 900 s with 8 threads each,
    17 s each with one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _stack(k: int, n: int):
    """64 stored experts of seeded random weights, the 4 dummies zero."""
    rng = np.random.RandomState(k + n)
    w = (rng.randn(E_STORE, k, n) / np.sqrt(k)).astype(np.float32)
    w[E_REAL:] = 0.0
    return base.pack_projections({"w_up": torch.from_numpy(w)})[0]["w_up"]


def _buffer(k: int, c: int, seed: int, specials: bool = True):
    """The layer's (64, C, K) capacity buffer for TOKENS[c] tokens routed
    by ``moe._route`` (B = 4 at C = 5); with ``specials``, experts 56-59
    become a row non-zero only in K's last split (56), an Inf (57), a NaN
    (58) and -0.0 everywhere (59)."""
    rng = np.random.RandomState(seed)
    t = TOKENS[c]
    x = torch.from_numpy(rng.randn(t, k).astype(np.float32)).to(
        torch.bfloat16)
    router = torch.from_numpy(rng.randn(k, E_REAL).astype(np.float32))
    _, idx = moe._route(x, router / np.sqrt(k), CFG)
    if c > 1:
        assert max(int(np.ceil(t * CFG.top_k * CFG.capacity_factor
                               / E_REAL)), 4) == c - 1
    buf = moe.dispatch_buffer(x, idx, E_REAL, E_STORE, c - 1)[0]
    if specials:
        last = (k - 1) // tuning.SPLIT_K * tuning.SPLIT_K
        buf[56:60] = 0.0
        buf[56, c - 1, last:] = torch.from_numpy(
            rng.randn(k - last).astype(np.float32)).to(buf.dtype)
        buf[57, c - 1, k - 3] = float("inf")
        buf[58, c - 1, 5] = float("nan")
        buf[59] = -0.0
    return buf


def _run(fn, x, qw, n, **kw):
    return fn(x, qw.payload, qw.scales, qw.scale32, n, **kw)


def _live(x):
    return ((x.view(torch.int16) & 0x7FFF) != 0).flatten(1).any(1)


@pytest.mark.parametrize("c", sorted(TOKENS))
@pytest.mark.parametrize("kn", KN)
def test_walk_matches_plain_on_dispatch_buffers(kn, c):
    k, n = kn
    qw = _stack(k, n)
    x = _buffer(k, c, c)
    y = _run(mixfp4_gemm.gemm_w4a16_experts_walk, x, qw, n)
    yp = _run(mixfp4_gemm.gemm_w4a16_experts_plain, x, qw, n)
    assert y.shape == (E_STORE, c, n) and y.dtype == torch.float32
    fin = yp.isfinite()
    assert torch.equal(fin, y.isfinite())
    assert not fin[57:59, c - 1].any()            # Inf and NaN propagate
    err = float((y[fin] - yp[fin]).abs().max())
    assert err <= 1e-5 * float(yp[fin].abs().max())


@pytest.mark.parametrize("c", sorted(TOKENS))
@pytest.mark.parametrize("kn", KN)
def test_walk_skipping_changes_no_bit(kn, c):
    """Skipping the all-+-0 splits against computing them: bitwise equal
    as int32 (the weights are finite, so a skipped split's partial is +-0
    and the sum, never -0, does not change)."""
    k, n = kn
    qw = _stack(k, n)
    x = _buffer(k, c, 10 + c)
    walk = mixfp4_gemm.gemm_w4a16_experts_walk
    assert torch.equal(_run(walk, x, qw, n).view(torch.int32),
                       _run(walk, x, qw, n, skip=False).view(torch.int32))


@pytest.mark.parametrize("c", sorted(TOKENS))
@pytest.mark.parametrize("kn", KN)
def test_walk_experts_without_a_row_are_plus_zero(kn, c):
    """Experts that received no token, the dummies and the -0.0 expert give
    +0 bits; at B = 4 (C = 5) at most 16 of the 60 experts hold a row."""
    k, n = kn
    qw = _stack(k, n)
    x = _buffer(k, c, 20 + c)
    y = _run(mixfp4_gemm.gemm_w4a16_experts_walk, x, qw, n)
    live = _live(x)
    assert not live[59] and not live[E_REAL:].any()
    if c == 5:
        assert int(live[:56].sum()) <= 16
    assert not y[~live].view(torch.int32).any()


@pytest.mark.parametrize("kn", KN)
def test_walk_computes_a_row_live_only_in_the_last_split(kn):
    """K = 1408's last split is 128 deep (K = 2048's a whole 256): a row
    non-zero only there, in an expert with no other row, is computed and
    equals the plain version's row."""
    k, n = kn
    qw = _stack(k, n)
    x = _buffer(k, 5, 30)
    last = (k - 1) // tuning.SPLIT_K * tuning.SPLIT_K
    assert k - last == (128 if k == 1408 else 256)
    assert not x[56, :, :last].any() and not x[56, :4].any()
    y = _run(mixfp4_gemm.gemm_w4a16_experts_walk, x, qw, n)
    yp = _run(mixfp4_gemm.gemm_w4a16_experts_plain, x, qw, n)
    assert y[56, 4].abs().max() > 0
    scale = float(yp[56, 4].abs().max())
    assert float((y[56, 4] - yp[56, 4]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("kn", KN)
def test_walk_vs_reference_per_expert(kn):
    """Each expert that holds a row against the JAX package's reference
    GEMM on the same bytes, at the reference's atol 2e-2 scale-normalised."""
    k, n = kn
    qw = _stack(k, n)
    x = _buffer(k, 5, 40, specials=False)
    y = _run(mixfp4_gemm.gemm_w4a16_experts_walk, x, qw, n)
    live = _live(x)
    assert int(live.sum()) >= 4
    for e in np.flatnonzero(live.numpy()):
        want = np.asarray(jref.ref_gemm_w4a16(
            jnp.asarray(x[e].to(torch.float32).numpy()),
            jnp.asarray(qw.payload[e].numpy()),
            jnp.asarray(qw.scales[e].numpy()),
            jnp.float32(float(qw.scale32[e]))))
        scale = np.abs(want).max()
        np.testing.assert_allclose(y[e].numpy() / scale, want / scale,
                                   atol=2e-2, rtol=0)
