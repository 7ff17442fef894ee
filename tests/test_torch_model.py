"""The port's dense model against the JAX ``TransformerLM`` on the same
packed bytes, and the weight converters.

The reference is ``TransformerLM.prefill_slot``/``decode_step`` under
``jax.jit`` with ``xla_allow_excess_precision`` off, so that every bf16
op rounds as it does in the port.  Tolerances: logits agree to atol 1e-5
after normalising by max|JAX|, and the KV bytes the port writes equal the
reference's bitwise.  A second test records what the default compile
does instead: its logits move past 2e-2 and its KV bytes differ (on the
2-layer smoke models the 4-bit KV quantizer turns an ulp into a code
step).  Token streams against the reference engine are held in
``test_torch_engine.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# XLA may otherwise keep a fused chain of bf16 ops in f32 and skip the
# roundings between them, which the port (op by op, as PyTorch runs) makes
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    """arch -> (config, TransformerLM, dense values, packed values)."""
    out = {}
    for arch in ("gemma2-2b", "mixfp4-476m"):
        cfg = jconfigs.smoke_config(arch)
        model = jbase.build_model(cfg)
        params = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
        packed = jax.jit(lambda p: jbase.pack_projections(p)[0])(params)
        out[arch] = (cfg, model, params, packed)
    return out


def test_params_from_numpy_round_trip(jax_models):
    _, _, params, _ = jax_models["gemma2-2b"]
    cfg = configs.smoke_config("gemma2-2b")
    tree = _np_tree(params)
    port = convert.params_from_numpy(tree, cfg, device="cpu")
    np.testing.assert_array_equal(port["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(port["ln_f"].numpy(), tree["ln_f"])
    assert len(port["layers"]) == cfg.n_layers
    for li, lp in enumerate(port["layers"]):
        for sub in ("attn", "mlp"):
            for name, w in lp[sub].items():
                np.testing.assert_array_equal(
                    w.numpy(), tree["layers"][sub][name][li])
        np.testing.assert_array_equal(lp["ln_attn"].numpy(),
                                      tree["layers"]["ln_attn"][li])


def test_packed_from_numpy_keeps_bytes_and_padded_storage(jax_models):
    cfg = configs.smoke_config("gemma2-2b")
    packed = jax_models["gemma2-2b"][3]
    packed = dict(packed, layers=dict(packed["layers"],
                                      attn=dict(packed["layers"]["attn"])))
    wq = packed["layers"]["attn"]["wq"]
    # pad the stored grid past the logical shape, as tile pre-padding does
    packed["layers"]["attn"]["wq"] = jqt.QTensor(
        jnp.pad(wq.payload, ((0, 0), (0, 8), (0, 32))),
        jnp.pad(wq.scales, ((0, 0), (0, 1), (0, 2))), wq.scale32,
        wq.method, wq.layout, wq.shape, wq.dtype)
    port = convert.packed_from_numpy(_np_tree(packed), cfg, device="cpu")
    x = torch.randn(3, cfg.d_model)
    for li, lp in enumerate(port["layers"]):
        for sub in ("attn", "mlp"):
            for name, q in lp[sub].items():
                ref = packed["layers"][sub][name]
                assert isinstance(q, qtensor.QTensor)
                assert q.shape == tuple(ref.shape)
                np.testing.assert_array_equal(q.payload.numpy(),
                                              np.asarray(ref.payload[li]))
                np.testing.assert_array_equal(q.scales.numpy(),
                                              np.asarray(ref.scales[li]))
                assert float(q.scale32) == float(ref.scale32[li])
        unpadded = qtensor.QTensor(
            torch.from_numpy(np.array(wq.payload[li])),
            torch.from_numpy(np.array(wq.scales[li])),
            lp["attn"]["wq"].scale32, layout=qtensor.BlockLayout2D(),
            shape=tuple(wq.shape))
        np.testing.assert_array_equal(
            qtensor.qmm(x, lp["attn"]["wq"]).numpy(),
            qtensor.qmm(x, unpadded).numpy())


MAX_LEN, P_LEN, STEPS = 32, 11, 3


def _reference_run(jmodel, packed, ctx, prompt, forced, compiler_options):
    """The reference's own ``prefill_slot`` then ``decode_step``s, jitted
    with ``compiler_options``; returns (logits rows, cache)."""
    kw = {} if compiler_options is None else {
        "compiler_options": compiler_options}
    prefill = jax.jit(lambda p, t, c: jmodel.prefill_slot(p, t, ctx, c, 0),
                      **kw)
    decode = jax.jit(lambda p, t, c, n: jmodel.decode_step(p, t, ctx, c, n),
                     **kw)
    cache = jmodel.init_cache(1, MAX_LEN, kv_quant="mixfp4")
    logits, cache = prefill(packed, jnp.asarray(prompt), cache)
    out = [np.asarray(logits)]
    for i, tok in enumerate(forced):
        logits, cache = decode(packed, jnp.asarray([tok]), cache,
                               jnp.asarray([P_LEN + i], jnp.int32))
        out.append(np.asarray(logits))
    return np.concatenate(out), cache


@pytest.fixture(scope="module")
def runs(jax_models, pallas_memory_space_alias):
    """arch -> {"port", "strict", "default"}: (logits rows, cache) of the
    port and of the reference compiled with and without
    ``xla_allow_excess_precision``, all on one prompt and forced tokens."""
    out = {}
    for arch, (jcfg, jmodel, _, packed) in jax_models.items():
        ctx = jbase.Ctx(jax.random.PRNGKey(0), jcfg.quant)
        rng = np.random.RandomState(0)
        prompt = rng.randint(0, jcfg.vocab, (1, P_LEN)).astype(np.int32)
        forced = rng.randint(0, jcfg.vocab, STEPS).astype(np.int32)
        res = {name: _reference_run(jmodel, packed, ctx, prompt, forced, opts)
               for name, opts in (("strict", NO_EXCESS_PRECISION),
                                  ("default", None))}
        cfg = configs.smoke_config(arch)
        model = build_model(cfg)
        port = convert.packed_from_numpy(_np_tree(packed), cfg, device="cpu")
        cache = model.init_cache(1, MAX_LEN, kv_quant="mixfp4", device="cpu")
        logits, cache = model.prefill_slot(port, torch.from_numpy(
            prompt).long(), cache, 0)
        got = [logits.numpy()]
        for i, tok in enumerate(forced):
            logits, cache = model.decode_step(
                port, torch.tensor([int(tok)]), cache,
                torch.tensor([P_LEN + i]))
            got.append(logits.numpy())
        res["port"] = (np.concatenate(got), cache)
        out[arch] = res
    return out


def _kv_bytes_equal(a, b):
    """The written rows of two packed caches (JAX or port) are bytewise
    equal."""
    written = P_LEN + STEPS
    return all(np.array_equal(
        np.asarray(getattr(a[name], child))[:, :, :written],
        np.asarray(getattr(b[name], child))[:, :, :written])
        for name in ("k", "v") for child in ("payload", "scales"))


def _gap(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixfp4-476m"])
def test_prefill_and_decode_match_reference(arch, runs):
    (got, cache), (want, jcache) = runs[arch]["port"], runs[arch]["strict"]
    assert got.shape == want.shape == (STEPS + 1,
                                       configs.smoke_config(arch).vocab)
    assert _gap(got, want) <= 1e-5
    assert _kv_bytes_equal(cache, jcache)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixfp4-476m"])
def test_default_compile_skips_bf16_roundings(arch, runs):
    """Why the reference is compiled strictly: by default XLA keeps fused
    bf16 activation chains in f32, which on these 2-layer models moves the
    written KV codes and the logits past the 2e-2 tolerance."""
    (strict, jcache), (loose, lcache) = (runs[arch]["strict"],
                                         runs[arch]["default"])
    assert _gap(loose, strict) > 2e-2
    assert not _kv_bytes_equal(lcache, jcache)
