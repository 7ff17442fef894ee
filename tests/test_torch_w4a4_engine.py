"""W4A4 serving in the port against the JAX package, on the CPU: the model's
logits and KV bytes, and the engine's greedy token streams.

The reference packs the gemma2 smoke config itself (``ServeEngine`` with
``act_quant``/``act_rht``, which rotates the weights at pack time and
pre-pads them onto its tuner's grid); the port serves the same bytes,
carried across with ``convert.packed_from_numpy`` (``rht_signs`` record
included).  The reference's jitted functions are compiled with
``xla_allow_excess_precision`` off (see ``test_torch_model.py``).
Tolerances: logits within 1e-5 of max|logit|, KV bytes bitwise, token
streams identical.  Inside the port, the fused spelling equals the
two-pass one bitwise (logits and KV bytes), with and without the RHT, and
the per-tensor two-pass spelling gives the streams of its qdq oracle.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models.base import build_model as jbuild  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.base import ActQuant  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
ARCH = "gemma2-2b"
# name -> (act_quant, act_rht) of the reference engines built here
ACTS = {"fused": ("mixfp4", False), "fused_rht": ("mixfp4", True),
        "2pass": ("mixfp4-2pass", False)}
PROMPT_LENS = (5, 6, 9)
MAX_LEN, P_LEN, STEPS = 32, 11, 3


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


@pytest.fixture(scope="module")
def jax_engines(pallas_memory_space_alias):
    """name -> the reference engine (strict jits) packing its own weights
    from one seeded dense tree under that activation setting."""
    model = jbuild(jconfigs.smoke_config(ARCH))
    dense = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
    out = {}
    for name, (aq, rht) in ACTS.items():
        eng = jengine.ServeEngine(jconfigs.smoke_config(ARCH), dense,
                                  batch_size=2, max_len=MAX_LEN,
                                  kv_quant="mixfp4", act_quant=aq,
                                  act_rht=rht)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=NO_EXCESS_PRECISION))
            eng._build_jits()
        out[name] = eng
    return out


@pytest.fixture(scope="module")
def packed(jax_engines):
    """name -> the reference engine's packed bytes in the port's layout."""
    return {name: convert.packed_from_numpy(
        jax.tree.map(np.asarray, eng.params), configs.smoke_config(ARCH),
        device="cpu") for name, eng in jax_engines.items()}


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(eng, request_cls):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts())]
    pending = list(reqs)
    while pending or eng.has_work():
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        eng.step()
    return [list(r.generated) for r in reqs]


def _port_engine(params, act_quant, act_rht=False, **kw):
    return ServeEngine(configs.smoke_config(ARCH), params, batch_size=2,
                       max_len=MAX_LEN, kv_quant="mixfp4", device="cpu",
                       act_quant=act_quant, act_rht=act_rht, **kw)


def _forced():
    rng = np.random.RandomState(1)
    return (rng.randint(0, 256, (1, P_LEN)).astype(np.int32),
            rng.randint(0, 256, STEPS).astype(np.int32))


def _port_run(params, act: ActQuant):
    """The port's prefill then teacher-forced decode steps; (logits, cache)."""
    model = build_model(configs.smoke_config(ARCH))
    prompt, forced = _forced()
    cache = model.init_cache(1, MAX_LEN, kv_quant="mixfp4", device="cpu")
    logits, cache = model.prefill_slot(params, torch.from_numpy(
        prompt).long(), cache, 0, act=act)
    out = [logits]
    for i, tok in enumerate(forced):
        logits, cache = model.decode_step(params, torch.tensor([int(tok)]),
                                          cache, torch.tensor([P_LEN + i]),
                                          act=act)
        out.append(logits)
    return torch.cat(out), cache


def _reference_run(eng, name):
    aq, rht = ACTS[name]
    jmodel = eng.model
    ctx = jbase.Ctx(jax.random.PRNGKey(0), jmodel.cfg.quant, act_quant=aq,
                    act_rht=rht)
    prefill = jax.jit(lambda p, t, c: jmodel.prefill_slot(p, t, ctx, c, 0),
                      compiler_options=NO_EXCESS_PRECISION)
    decode = jax.jit(lambda p, t, c, n: jmodel.decode_step(p, t, ctx, c, n),
                     compiler_options=NO_EXCESS_PRECISION)
    prompt, forced = _forced()
    cache = jmodel.init_cache(1, MAX_LEN, kv_quant="mixfp4")
    logits, cache = prefill(eng.params, jnp.asarray(prompt), cache)
    out = [np.asarray(logits)]
    for i, tok in enumerate(forced):
        logits, cache = decode(eng.params, jnp.asarray([tok]), cache,
                               jnp.asarray([P_LEN + i], jnp.int32))
        out.append(np.asarray(logits))
    return np.concatenate(out), cache


def _kv_rows(cache, child):
    written = P_LEN + STEPS
    return [np.asarray(getattr(cache[name], child))[:, :, :written]
            for name in ("k", "v")]


@pytest.mark.parametrize("name", ["fused", "fused_rht"])
def test_w4a4_logits_and_kv_bytes_match_reference(name, jax_engines, packed):
    want, jcache = _reference_run(jax_engines[name], name)
    got, cache = _port_run(packed[name], ActQuant(*ACTS[name]))
    got = got.numpy()
    assert got.shape == want.shape == (STEPS + 1, 256)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    for child in ("payload", "scales"):
        for a, b in zip(_kv_rows(cache, child), _kv_rows(jcache, child)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(ACTS))
def test_w4a4_token_streams_match_reference_engine(name, jax_engines,
                                                   packed):
    want = _serve(jax_engines[name], jengine.Request)
    got = _serve(_port_engine(packed[name], *ACTS[name]), Request)
    assert all(len(s) == 4 for s in got)
    assert got == want


@pytest.mark.parametrize("name", ["fused", "fused_rht"])
def test_fused_equals_two_pass_rowscale_bitwise(name, packed):
    rht = ACTS[name][1]
    fused, fcache = _port_run(packed[name], ActQuant("mixfp4", rht))
    two, tcache = _port_run(packed[name],
                            ActQuant("mixfp4-2pass-rowscale", rht))
    assert torch.equal(fused, two)
    for child in ("payload", "scales"):
        for a, b in zip(_kv_rows(fcache, child), _kv_rows(tcache, child)):
            np.testing.assert_array_equal(a, b)
    streams = [_serve(_port_engine(packed[name], aq, rht), Request)
               for aq in ("mixfp4", "mixfp4-2pass-rowscale")]
    assert streams[0] == streams[1]


def test_two_pass_streams_equal_qdq_oracle(packed):
    streams = [_serve(_port_engine(packed["2pass"], aq), Request)
               for aq in ("mixfp4-2pass", "mixfp4-qdq")]
    assert streams[0] == streams[1]


def test_engine_packs_rotated_weights_like_reference(jax_engines):
    """The port's engine, given the dense tree, packs (and rotates) the same
    bytes the reference engine serves."""
    eng = jax_engines["fused_rht"]
    dense = convert.params_from_numpy(
        jax.tree.map(np.asarray, jax.jit(lambda k: jbuild(
            jconfigs.smoke_config(ARCH)).init(k)[0])(jax.random.PRNGKey(0))),
        configs.smoke_config(ARCH), device="cpu")
    port = _port_engine(dense, "mixfp4", True)
    ref_tree = convert.packed_from_numpy(jax.tree.map(np.asarray, eng.params),
                                         configs.smoke_config(ARCH),
                                         device="cpu")
    assert (port.packed_bytes, port.dense_bytes) == (eng.packed_bytes,
                                                      eng.dense_bytes)
    for lp, rp in zip(port.params["layers"], ref_tree["layers"]):
        for sub in ("attn", "mlp"):
            for key, q in lp[sub].items():
                r = rp[sub][key]
                k2, n = q.payload.shape       # the reference pre-pads N
                assert torch.equal(q.payload, r.payload[:k2, :n])
                assert torch.equal(q.scales, r.scales[:k2 // 8, :n // 16])
    assert set(port.params["rht_signs"]) == set(ref_tree["rht_signs"])


@pytest.mark.parametrize("kw,match", [
    ({"act_quant": "int4"}, "unknown act_quant"),
    ({"act_quant": "mixfp4-2pass", "act_rht": True}, "per-row W4A4 modes"),
    ({"act_rht": True}, "per-row W4A4 modes"),
    ({"act_quant": "mixfp4", "pack_weights": False}, "needs packed weights"),
    ({"act_quant": "mixfp4-2pass-rowscale", "act_rht": True,
      "pack_weights": False}, "needs packed weights")])
def test_act_options_are_validated_as_in_reference(kw, match, packed):
    kw = dict(kw)
    args = (kw.pop("act_quant", None), kw.pop("act_rht", False))
    with pytest.raises(ValueError, match=match):
        _port_engine(packed["fused"], *args, **kw)


def test_rotation_must_match_act_rht(packed):
    with pytest.raises(ValueError, match="serve them with act_rht=True"):
        _port_engine(packed["fused_rht"], "mixfp4")
    with pytest.raises(ValueError, match="rotated at pack time"):
        _port_engine(packed["fused"], "mixfp4", True)
