"""The CPU model of the decode-attention kernel's split-S arithmetic.

``mixfp4_attn.attn_decode_split_plain`` computes what
``csrc/mixfp4_attn_decode.cu`` computes: each split of a sequence's
valid keys (``tuning.SPLIT_S`` logical positions each) gives a softmax
state (m, l, acc) over its own keys, and the states merge in split order.
It must agree within 1e-5 (absolute, the reference's own attention
tolerance) with the port's plain version ``attn_decode_plain`` and with
the reference kernel ``repro.kernels.mixfp4_attn.mixfp4_attn_decode`` in
interpret mode, on lengths at and around split boundaries, windows that
start inside a split or empty whole splits, and every query-head group
from 1 to 8; and a sequence's output must not change, bitwise, when the
cache's capacity or the batch changes.

  PYTHONPATH=src python -m pytest -q tests/test_torch_attn_split.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mixfp4_attn import mixfp4_attn_decode as jattn  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro_torch.kernels import mixfp4_attn, tuning  # noqa: E402

S = tuning.SPLIT_S
CASES = {
    # name: (s, hkv, group, dh, window, softcap, lengths)
    "length_1": (300, 2, 2, 32, 0, 50.0, [1, 300]),
    "boundary_255_256_257": (600, 1, 2, 32, 0, 30.0,
                             [S - 1, S, S + 1]),
    "boundary_511_512_513": (600, 2, 1, 16, 0, 0.0,
                             [2 * S - 1, 2 * S, 2 * S + 1]),
    "window_starts_inside_a_split": (700, 2, 2, 32, 100, 50.0, [700, 400]),
    "window_empties_whole_splits": (1100, 1, 2, 32, 200, 0.0, [1100, 900]),
    "window_at_a_boundary": (800, 1, 2, 16, S, 30.0, [2 * S + 7, 3 * S]),
}


def _case(s, hkv, g, dh, lengths, seed):
    """q and the packed cache from numpy, quantized by the reference."""
    b = len(lengths)
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv * g, dh).astype(np.float32)
    packed = []
    for _ in range(2):                                  # K, then V
        rows = rng.randn(b, s, hkv, dh).astype(np.float32)
        packed += [np.array(a) for a in jbase.quantize_kv_rows(
            jnp.asarray(rows))]
    return q, packed, np.array(lengths, np.int32)


def _model(q, packed, lengths, window, softcap):
    t = torch.from_numpy
    return mixfp4_attn.attn_decode_split_plain(
        t(q), *map(t, packed), t(lengths), window=window, softcap=softcap)


def _check(s, hkv, g, dh, window, softcap, lengths, seed):
    q, packed, lens = _case(s, hkv, g, dh, lengths, seed)
    got = _model(q, packed, lens, window, softcap)
    t = torch.from_numpy
    plain = mixfp4_attn.attn_decode_plain(
        t(q), *map(t, packed), t(lens), window=window, softcap=softcap)
    ref = jattn(jnp.asarray(q), *map(jnp.asarray, packed),
                jnp.asarray(lens), window=window, softcap=softcap,
                interpret=True)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_split_model_vs_plain_and_reference_kernel(name):
    s, hkv, g, dh, window, softcap, lengths = CASES[name]
    _check(s, hkv, g, dh, window, softcap, lengths, seed=len(name))


@pytest.mark.parametrize("g", range(1, 9))
def test_split_model_every_group(g):
    _check(2 * S + 8, 1, g, 32, 0, 50.0, [2 * S + 8, S + 2], seed=g)


def test_split_model_spans_the_expected_splits():
    """The model's splits are the ones ``attn_split_range`` names: a
    window that empties the first splits leaves exactly the rest."""
    assert list(tuning.attn_split_range(900, 200, 1100)) == [2, 3]
    assert list(tuning.attn_split_range(S, 0, 1100)) == [0]
    assert list(tuning.attn_split_range(S + 1, 0, 1100)) == [0, 1]
    assert list(tuning.attn_split_range(1, 0, 1100)) == [0]
    assert list(tuning.attn_split_range(0, 0, 1100)) == []


def test_split_model_no_valid_key_gives_zeros():
    q, packed, _ = _case(40, 2, 2, 32, [5, 9], seed=3)
    got = _model(q, packed, np.array([0, 9], np.int32), 0, 50.0)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert got[1].abs().sum() > 0


@pytest.mark.parametrize("window", [0, 300])
def test_split_model_independent_of_capacity_and_batch(window):
    """Each sequence's output, bitwise: in its B = 3 batch, alone, alone
    in a cache cut to a page past its length, and alone in a cache with
    junk rows appended."""
    s, hkv, g, dh = 3 * S + 40, 2, 2, 32
    lengths = [3 * S + 40, S, 2 * S + 3]
    q, packed, lens = _case(s, hkv, g, dh, lengths, seed=21)
    full = _model(q, packed, lens, window, 50.0)
    junk = _case(100, hkv, g, dh, lengths, seed=22)[1]
    for i, n in enumerate(lengths):
        cut = min(s, -(-n // 16) * 16 + 16)
        caches = ([a[i:i + 1] for a in packed],
                  [a[i:i + 1, :cut] for a in packed],
                  [np.concatenate([a[i:i + 1], j[i:i + 1]], 1)
                   for a, j in zip(packed, junk)])
        for cache in caches:
            one = _model(q[i:i + 1], [np.ascontiguousarray(a)
                                      for a in cache],
                         lens[i:i + 1], window, 50.0)
            assert torch.equal(one[0], full[i]), (i, cache[0].shape)
