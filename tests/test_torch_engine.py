"""The port's ``ServeEngine`` on the CPU against the JAX ``ServeEngine``.

Both engines serve the gemma2 smoke config from the same packed bytes
(batch 2, max_len 32, packed MixFP4 KV cache, prompts of 5, 6 and 9
tokens, 4 new tokens each, so the third request reuses a slot); greedy
token streams must be identical.  The reference engine runs unchanged,
its jitted prefill and decode compiled with ``xla_allow_excess_precision``
off so that every bf16 op rounds as in the port; a second test records
that the default compile flips a token.  Inside the port, a bucketed
prefill must be bitwise the exact-length one (first token and every real
KV row).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models.base import build_model as jbuild  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

PROMPT_LENS = (5, 6, 9)
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


def _reference_engine(packed, strict: bool):
    """The JAX engine on ``packed``; ``strict`` rebuilds its own jitted
    prefill and decode closures with excess precision off."""
    eng = jengine.ServeEngine(jconfigs.smoke_config("gemma2-2b"), packed,
                              batch_size=2, max_len=32, kv_quant="mixfp4")
    if strict:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=NO_EXCESS_PRECISION))
            eng._build_jits()
    return eng


@pytest.fixture(scope="module")
def jax_packed(pallas_memory_space_alias):
    model = jbuild(jconfigs.smoke_config("gemma2-2b"))
    # init and pack compiled once (the engine passes packed leaves through)
    params = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
    return jax.jit(lambda p: jbase.pack_projections(p)[0])(params)


@pytest.fixture(scope="module")
def jax_engine(jax_packed):
    return _reference_engine(jax_packed, strict=True)


@pytest.fixture(scope="module")
def packed(jax_engine):
    return convert.packed_from_numpy(jax.tree.map(np.asarray,
                                                  jax_engine.params),
                                     configs.smoke_config("gemma2-2b"),
                                     device="cpu")


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


def _port_engine(packed, **kw):
    return ServeEngine(configs.smoke_config("gemma2-2b"), packed,
                       batch_size=2, max_len=32, kv_quant="mixfp4",
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def port_streams(packed):
    return _serve(_port_engine(packed), Request)


def test_token_streams_match_reference_engine(jax_engine, port_streams):
    want = _serve(jax_engine, jengine.Request)
    assert all(len(s) == 4 for s in port_streams)
    assert port_streams == want


def test_default_compiled_reference_flips_a_token(jax_packed, port_streams):
    """Why the reference engine is compiled strictly: with XLA's default
    excess precision its bf16 activation chains skip roundings, and on this
    2-layer model that flips a greedy token."""
    loose = _serve(_reference_engine(jax_packed, strict=False),
                   jengine.Request)
    assert loose != port_streams


def test_bucketed_prefill_is_bitwise_exact_length(packed):
    prompt = _prompts()[2]                         # 9 tokens -> bucket 16
    assert ServeEngine.bucket_len(len(prompt), 32) == 16
    engines = [_port_engine(packed, prefill_buckets=b)
               for b in ("auto", "off")]
    for eng in engines:
        eng.add_request(Request(uid=0, prompt=prompt, max_new_tokens=4))
    a, b = engines
    assert a.slots[0]._next == b.slots[0]._next
    n = len(prompt)
    for name in ("k", "v"):
        for child in ("payload", "scales"):
            assert torch.equal(getattr(a.cache[name], child)[:, :, :n],
                               getattr(b.cache[name], child)[:, :, :n])
    assert _drain(a) == _drain(b)


def _drain(eng):
    toks = []
    while eng.has_work():
        toks += eng.step()
    return toks


@pytest.mark.parametrize("p_len", [1, 5, 8, 9, 33, 64, 65, 200, 4500])
def test_bucket_ladder_matches_reference(p_len):
    assert (ServeEngine.bucket_len(p_len, 8192)
            == jengine.ServeEngine.bucket_len(p_len, 8192))


def test_kv_cache_bytes_and_packing_match_reference(jax_engine, packed):
    eng = _port_engine(packed)
    assert eng.kv_cache_bytes() == jax_engine.kv_cache_bytes()
    assert (eng.packed_bytes, eng.dense_bytes) == jengine._packed_stats(
        jax_engine.params)


@pytest.mark.parametrize("kw", [{"journal_dir": "j"}, {"mesh": object()}])
def test_unported_options_raise(packed, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine(packed, **kw)


# a lifecycle option the port took over -> (a good value given the port's
# faults module, a check that the engine carries it)
LIFECYCLE_OPTIONS = {
    "ttft_budget_ms": (
        lambda flt: 5.0,
        lambda e: e.robustness_report()["deadlines"]["ttft_budget_ms"] == 5.0),
    "faults": (
        lambda flt: flt.FaultInjector(0, []),
        lambda e: e.clock is e.faults.clock),
    "hung_step_budget_ms": (
        lambda flt: 5.0,
        lambda e: e.robustness_report()["watchdog"]["budget_ms"] == 5.0),
    "deadline_ms": (
        lambda flt: 5.0,
        lambda e: e.robustness_report()["deadlines"]["deadline_ms"] == 5.0),
}


@pytest.mark.parametrize("option", list(LIFECYCLE_OPTIONS))
def test_lifecycle_options_build_and_are_carried(packed, option):
    """Each lifecycle option the port took over builds an engine that
    carries it.  The reference validates neither ``ttft_budget_ms`` nor
    ``deadline_ms``; its checks of the other lifecycle arguments are held
    by ``test_lifecycle_checks_raise_the_reference_messages``."""
    from repro_torch.serving import faults

    value, carries = LIFECYCLE_OPTIONS[option]
    assert carries(_port_engine(packed, **{option: value(faults)}))


# a check the reference makes of a lifecycle argument -> a bad construction
# given (engine module, config, faults module, watchdog module) of either
# package, which must raise as the reference does
LIFECYCLE_CHECKS = {
    "max_queue": lambda eng, cfg, flt, wd: eng.ServeEngine(
        cfg, None, max_queue=0),
    "degrade_after_deferrals": lambda eng, cfg, flt, wd: eng.ServeEngine(
        cfg, None, degrade_after_deferrals=0),
    "watchdog_budget": lambda eng, cfg, flt, wd: wd.StepWatchdog(0.0),
    "fault_rule_kind": lambda eng, cfg, flt, wd: flt.FaultRule("decode",
                                                               "deny"),
}


@pytest.mark.parametrize("check", list(LIFECYCLE_CHECKS))
def test_lifecycle_checks_raise_the_reference_messages(check):
    """A bad lifecycle argument raises the reference's error and message
    (``hung_step_budget_ms`` reaches the engine's ``StepWatchdog``,
    ``faults`` its ``FaultRule``s)."""
    from repro.serving import faults as jfaults
    from repro.serving import watchdog as jwatchdog
    from repro_torch.serving import engine, faults, watchdog

    bad = LIFECYCLE_CHECKS[check]
    with pytest.raises(ValueError) as want:
        bad(jengine, jconfigs.smoke_config("gemma2-2b"), jfaults, jwatchdog)
    with pytest.raises(ValueError) as got:
        bad(engine, configs.smoke_config("gemma2-2b"), faults, watchdog)
    assert str(got.value) == str(want.value)


def test_non_finite_prefill_logits_end_the_request(packed, monkeypatch):
    eng = _port_engine(packed)
    prefill = eng.model.prefill_slot

    def poisoned(*args, **kw):
        logits, cache = prefill(*args, **kw)
        return logits * float("nan"), cache

    monkeypatch.setattr(eng.model, "prefill_slot", poisoned)
    req = Request(uid=0, prompt=_prompts()[0], max_new_tokens=4)
    assert eng.add_request(req)
    assert (req.done, req.finish_reason, req.generated) == (
        True, "nan_logits", [])
    assert not eng.has_work() and eng.step() == []


def test_request_validation(packed):
    eng = _port_engine(packed)
    with pytest.raises(ValueError):
        eng.add_request(Request(uid=0, prompt=np.zeros(0, np.int32)))
    with pytest.raises(ValueError):
        eng.add_request(Request(uid=1, prompt=np.ones(30, np.int32),
                                max_new_tokens=4))
