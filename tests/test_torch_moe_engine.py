"""The port's ``ServeEngine`` on the MoE family against the JAX
``ServeEngine``, on the CPU.

Both engines serve from the same packed bytes (batch 2, max_len 32, the
packed MixFP4 KV cache, prompts of 5, 6 and 9 tokens, 4 new tokens each,
so a slot is reused); greedy token streams must be identical:

* qwen3-moe smoke (8 experts stored as 16) in fixed slots, with bucketed
  whole-prompt prefill;
* qwen2-moe smoke (a shared expert) through the paged pool, which for MoE
  is a plain page allocator (no prefix caching: the capacity router
  couples a prompt's rows), without and with chunked prefill.

The reference engines' jits are compiled with ``xla_allow_excess_precision``
off, as in ``test_torch_engine.py``.  Also: ``KVPool(enable_prefix=False)``
replays a call trace exactly as the reference's, and an MoE engine refuses
W4A4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models.base import build_model as jbuild  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import kvpool as jkvpool  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.serving import kvpool  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

PROMPT_LENS = (5, 6, 9)
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
# (arch, engine keyword arguments of both engines)
CASES = {"qwen3-fixed": ("qwen3-moe-30b-a3b", {}),
         "qwen2-pool": ("qwen2-moe-a2.7b", {"kv_pool": 9}),
         "qwen2-pool-chunked": ("qwen2-moe-a2.7b",
                                {"kv_pool": 9, "prefill_chunk": 4})}


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
def jax_packed(pallas_memory_space_alias):
    out = {}
    for name in {arch for arch, _ in CASES.values()}:
        model = jbuild(jconfigs.smoke_config(name))
        params = jax.jit(lambda k, m=model: m.init(k)[0])(
            jax.random.PRNGKey(0))
        out[name] = jax.jit(lambda p: jbase.pack_projections(p)[0])(params)
    return out


def _reference_engine(packed, arch: str, **kw):
    """The JAX engine on ``packed``, its jitted prefill and decode rebuilt
    with excess precision off."""
    eng = jengine.ServeEngine(jconfigs.smoke_config(arch), packed,
                              batch_size=2, max_len=32, kv_quant="mixfp4",
                              **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(
            jax.jit, compiler_options=NO_EXCESS_PRECISION))
        eng._build_jits()
    return eng


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


@pytest.fixture(scope="module")
def served(jax_packed):
    """Each case served by both engines: (reference streams, port streams,
    reference engine, port engine)."""
    out = {}
    for case, (arch, kw) in CASES.items():
        jeng = _reference_engine(jax_packed[arch], arch, **kw)
        packed = convert.packed_from_numpy(
            jax.tree.map(np.asarray, jeng.params),
            configs.smoke_config(arch), device="cpu")
        eng = ServeEngine(configs.smoke_config(arch), packed, batch_size=2,
                          max_len=32, kv_quant="mixfp4", device="cpu", **kw)
        out[case] = (_serve(jeng, jengine.Request), _serve(eng, Request),
                     jeng, eng)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_moe_token_streams_match_reference_engine(served, case):
    want, got, jeng, eng = served[case]
    assert all(len(s) == 4 for s in got)
    assert got == want
    assert eng.admissions == jeng.admissions == 3
    if eng.kv_pool is not None:
        rep = eng.pool_report()
        assert rep == jeng.pool_report()
        assert rep["prefix_hits"] == 0 and rep["pages_active"] == 0
        assert not eng.kv_pool.enable_prefix
    else:
        assert eng.prefill_buckets == "pow2-64"


def test_moe_engine_bytes_match_reference(served):
    _, _, jeng, eng = served["qwen3-fixed"]
    assert eng.kv_cache_bytes() == jeng.kv_cache_bytes()
    assert (eng.packed_bytes, eng.dense_bytes) == jengine._packed_stats(
        jeng.params)


def _pool_trace(seed: int, n_ops: int = 120):
    """Acquire (with insert) and release calls over prompts that share
    prefixes, on a pool small enough to refuse admissions."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 50, 20).tolist()
    trace, live = [], 0
    for _ in range(n_ops):
        if live and rng.rand() < 0.4:
            trace.append(("release", int(rng.randint(live))))
            live -= 1
            continue
        prompt = base[:rng.randint(0, 21)] + rng.randint(
            0, 50, rng.randint(1, 6)).tolist()
        trace.append(("acquire", prompt, int(rng.randint(1, 6))))
        live += 1
    return trace


def _run_pool(pool, trace):
    live, seen = [], []
    for op in trace:
        if op[0] == "release":
            if op[1] < len(live):
                pool.release(live.pop(op[1]))
        else:
            adm = pool.acquire(op[1], op[2])
            if adm is not None:
                pool.insert(op[1], adm.pages)
                live.append(adm.pages)
            op = None if adm is None else dataclasses.astuple(adm)
        seen.append((op, pool.stats()))
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_allocator_pool_replays_reference_trace(seed):
    trace = _pool_trace(seed)
    got = _run_pool(kvpool.KVPool(8, 4, enable_prefix=False), trace)
    assert got == _run_pool(jkvpool.KVPool(8, 4, enable_prefix=False),
                            trace)
    stats = [st for _, st in got]
    assert all(st["prefix_hits"] == 0 and st["pages_cached"] == 0
               for st in stats)
    assert stats[-1]["alloc_failures"] > 0
    # the same trace caches prefixes when prefix caching is on
    hits = _run_pool(kvpool.KVPool(8, 4), trace)[-1][1]["prefix_hits"]
    assert hits > 0


@pytest.mark.parametrize("act_quant", ["mixfp4", "mixfp4-2pass-rowscale",
                                       "mixfp4-2pass", "mixfp4-qdq"])
def test_moe_engine_refuses_w4a4(act_quant):
    cfg = configs.smoke_config("qwen2-moe-a2.7b")
    from repro_torch.models import build_model
    params = build_model(cfg).init(0, device="cpu", pack="mixfp4")
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 5"):
        ServeEngine(cfg, params, batch_size=2, max_len=32, device="cpu",
                    act_quant=act_quant)
