"""Paged and chunked serving in the port against the JAX package, on the CPU.

Model: ``init_cache(pages=)`` shapes and errors match the reference's;
a paged prefill in two parts (the second a suffix at ``start_pos``) and
decode steps give logits within 1e-5 of max|logit| of the reference's
jitted functions (compiled with ``xla_allow_excess_precision`` off, see
``test_torch_model.py``), and the pool bytes of the written rows are
bitwise the reference's.

Engine: on the gemma2 smoke config, from the reference engine's packed
bytes, the port's paged engine (prefix hits with COW), chunked fixed-slot
engine and chunked paged engine emit the reference engines' token streams
token for token, with equal ``pool_report()``s.  Inside the port, bitwise:
paged == fixed-slot streams; chunked == whole-prompt streams and real KV
rows for chunks {1, 3, 5, 8, 16}, with a second request decoding while the
first prefills; W4A4 chunked == whole; paged W4A4 fused == its two-pass
spelling.  Also pool-exhaustion deferral and the validation errors.
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
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "gemma2-2b"
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
MAX_LEN, PAGES = 64, 32


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


def _strict(eng):
    """Rebuild a reference engine's jitted closures with excess precision
    off, so every bf16 op rounds as in the port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(
            jax.jit, compiler_options=NO_EXCESS_PRECISION))
        eng._build_jits()
    return eng


@pytest.fixture(scope="module")
def jax_packed(pallas_memory_space_alias):
    model = jbuild(jconfigs.smoke_config(ARCH))
    params = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
    return jax.jit(lambda p: jbase.pack_projections(p)[0])(params)


# engine name -> the keyword arguments of both engines
ENGINES = {"paged": {"kv_pool": PAGES},
           "chunked": {"prefill_chunk": 4},
           "chunked_paged": {"prefill_chunk": 4, "kv_pool": PAGES}}


@pytest.fixture(scope="module")
def jax_engines(jax_packed):
    return {name: _strict(jengine.ServeEngine(
        jconfigs.smoke_config(ARCH), jax_packed, batch_size=2,
        max_len=MAX_LEN, kv_quant="mixfp4", **kw))
        for name, kw in ENGINES.items()}


@pytest.fixture(scope="module")
def packed(jax_engines):
    """The reference engine's (tile-padded) packed bytes in the port's
    layout; every reference engine here pads alike (same batch size)."""
    return convert.packed_from_numpy(
        jax.tree.map(np.asarray, jax_engines["paged"].params),
        configs.smoke_config(ARCH), device="cpu")


def _shared_prefix_prompts():
    """The reference's ragged shared-prefix mix: a 17-token prefix (one
    page and one row, so a hit takes the COW path) plus suffixes."""
    rng = np.random.RandomState(13)
    shared = rng.randint(0, 256, 17).tolist()
    return [shared + rng.randint(0, 256, k).tolist() for k in (6, 2, 9, 4)]


def _run_streams(eng, prompts, n_new=4):
    """Admit prompts as capacity frees up and collect each stream."""
    pending = [(i, np.asarray(p, np.int32)) for i, p in enumerate(prompts)]
    reqs = []
    streams = {i: [] for i in range(len(prompts))}
    guard = 0
    while pending or any(s is not None for s in eng.slots):
        while pending:
            uid, prompt = pending[0]
            cls = Request if isinstance(eng, ServeEngine) else \
                jengine.Request
            req = cls(uid=uid, prompt=prompt, max_new_tokens=n_new)
            if not eng.add_request(req):
                break
            reqs.append(req)
            pending.pop(0)
        for uid, tok in eng.step():
            streams[uid].append(tok)
        guard += 1
        assert guard < 500, "engine made no progress"
    return streams


def _port_engine(packed, **kw):
    kw.setdefault("kv_quant", "mixfp4")
    return ServeEngine(configs.smoke_config(ARCH), packed, batch_size=2,
                       max_len=kw.pop("max_len", MAX_LEN), device="cpu",
                       **kw)


# ---------------------------------------------------------------------------
# engine streams against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(ENGINES))
def test_streams_and_pool_match_reference_engine(name, jax_engines, packed):
    prompts = _shared_prefix_prompts()
    port = _port_engine(packed, **ENGINES[name])
    got = _run_streams(port, prompts)
    want = _run_streams(jax_engines[name], prompts)
    assert all(len(s) == 4 for s in got.values())
    assert got == want
    assert port.pool_report() == jax_engines[name].pool_report()
    assert port.max_concurrent == jax_engines[name].max_concurrent == 2
    assert (port.prefill_dispatches
            == jax_engines[name].prefill_dispatches)
    if "kv_pool" in ENGINES[name]:
        rep = port.pool_report()
        assert rep["prefix_hits"] > 0 and rep["cow_copies"] > 0
        assert rep["pages_active"] == 0
    if name == "chunked":
        assert (port.scheduler.report()
                == jax_engines[name].scheduler.report())
        assert (port.scheduler.step_log
                == jax_engines[name].scheduler.step_log)


def test_paged_kv_cache_bytes_match_reference(jax_engines, packed):
    assert (_port_engine(packed, kv_pool=PAGES).kv_cache_bytes()
            == jax_engines["paged"].kv_cache_bytes())


# ---------------------------------------------------------------------------
# the model over the paged pool against the reference
# ---------------------------------------------------------------------------
P_LEN, SPLIT, STEPS, N_PAGES = 11, 6, 3, 5
TABLE = np.array([[0, 0], [3, 1]], np.int32)       # lane 0 idle, lane 1


def test_paged_prefill_and_decode_match_reference(jax_engines, packed):
    jeng = jax_engines["paged"]
    jmodel, ctx = jeng.model, jeng.ctx
    model = build_model(configs.smoke_config(ARCH))
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 256, (1, P_LEN)).astype(np.int32)
    forced = rng.randint(0, 256, STEPS).astype(np.int32)

    def jit(fn):
        return jax.jit(fn, compiler_options=NO_EXCESS_PRECISION)

    jcache = dict(jmodel.init_cache(2, 32, kv_quant="mixfp4",
                                    pages=(N_PAGES, 16)),
                  pages=jnp.asarray(TABLE))
    cache = model.init_cache(2, 32, kv_quant="mixfp4", device="cpu",
                             pages=(N_PAGES, 16))
    cache["pages"][:] = torch.from_numpy(TABLE)
    want, got = [], []
    for lo, hi in ((0, SPLIT), (SPLIT, P_LEN)):      # prefix, then suffix
        logits, jcache = jit(lambda p, t, c, s0=lo: jmodel.prefill_slot(
            p, t, ctx, c, 1, start_pos=s0))(
                jeng.params, jnp.asarray(prompt[:, lo:hi]), jcache)
        want.append(np.asarray(logits))
        logits, cache = model.prefill_slot(
            packed, torch.from_numpy(prompt[:, lo:hi]).long(), cache, 1,
            start_pos=lo)
        got.append(logits.numpy())
    decode = jit(lambda p, t, c, n: jmodel.decode_step(p, t, ctx, c, n))
    for i, tok in enumerate(forced):
        lens = np.array([0, P_LEN + i], np.int32)
        toks = np.array([0, tok], np.int32)
        logits, jcache = decode(jeng.params, jnp.asarray(toks), jcache,
                                jnp.asarray(lens))
        want.append(np.asarray(logits)[1:])
        logits, cache = model.decode_step(
            packed, torch.from_numpy(toks).long(), cache,
            torch.from_numpy(lens))
        got.append(logits.numpy()[1:])
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    pos = np.arange(P_LEN + STEPS)
    pages, offs = TABLE[1][pos // 16], pos % 16
    for name in ("k", "v"):
        for child in ("payload", "scales"):
            np.testing.assert_array_equal(
                getattr(cache[name], child).numpy()[:, pages, offs],
                np.asarray(getattr(jcache[name], child))[:, pages, offs])


def test_paged_init_cache_matches_reference(jax_engines):
    jmodel = jax_engines["paged"].model
    model = build_model(configs.smoke_config(ARCH))
    cache = model.init_cache(3, 64, kv_quant="mixfp4", device="cpu",
                             pages=(9, 16))
    jcache = jmodel.init_cache(3, 64, kv_quant="mixfp4", pages=(9, 16))
    assert set(cache) == set(jcache) == {"k", "v", "pages"}
    for name in ("k", "v"):
        for child in ("payload", "scales", "scale32"):
            assert (tuple(getattr(cache[name], child).shape)
                    == getattr(jcache[name], child).shape)
        assert cache[name].shape == tuple(jcache[name].shape)
    assert tuple(cache["pages"].shape) == jcache["pages"].shape
    assert cache["pages"].dtype == torch.int32 and not cache["pages"].any()
    cache["pages"][1] = 4
    model.reset_slot(cache, 1)
    assert not cache["pages"].any()
    for kw, match in (({"kv_quant": None}, "kv_quant"),
                      ({"kv_quant": "mixfp4", "pages": (9, 8)},
                       "multiple of 16"),
                      ({"kv_quant": "mixfp4", "pages": (9, 48)},
                       "divide max_len")):
        kw.setdefault("pages", (9, 16))
        with pytest.raises(ValueError, match=match):
            jmodel.init_cache(3, 64, **kw)
        with pytest.raises(ValueError, match=match):
            model.init_cache(3, 64, device="cpu", **kw)


# ---------------------------------------------------------------------------
# bitwise contracts inside the port
# ---------------------------------------------------------------------------
def test_paged_streams_equal_fixed_slot(packed):
    prompts = _shared_prefix_prompts()
    paged = _port_engine(packed, kv_pool=PAGES)
    assert (_run_streams(paged, prompts)
            == _run_streams(_port_engine(packed), prompts))
    assert paged.pool_report()["prefix_hit_tokens"] > 0


def _rows(eng, slot: int, n: int) -> dict:
    """The packed K/V bytes of logical rows [0, n) of ``slot``."""
    out = {}
    for name in ("k", "v"):
        for child in ("payload", "scales"):
            a = getattr(eng.cache[name], child)
            if "pages" in eng.cache:
                pos = torch.arange(n)
                bt = eng.cache["pages"][slot].long()
                out[name, child] = a[:, bt[pos // eng.kv_page_len],
                                     pos % eng.kv_page_len].clone()
            else:
                out[name, child] = a[:, slot, :n].clone()
    return out


def _long_admission_under_load(eng):
    """A short request decodes while a 40-token one is admitted (and, when
    chunked, prefills chunk by chunk); returns both streams and the long
    prompt's KV rows as they stand once its prefill is done."""
    vocab = eng.cfg.vocab
    short = Request(uid=0, prompt=np.array([5, 4, 3], np.int32),
                    max_new_tokens=24)
    long = Request(uid=1, prompt=(np.arange(40, dtype=np.int32) * 7 + 1)
                   % vocab, max_new_tokens=3)
    assert eng.add_request(short)
    eng.step()
    eng.step()                         # the short request is decoding
    assert eng.add_request(long)
    slot = next(i for i, s in enumerate(eng.slots) if s is long)
    rows = None
    while eng.has_work():
        if rows is None and long._next is not None:
            rows = _rows(eng, slot, len(long.prompt))
        eng.step()
        if rows is None and long._next is not None and not long.done:
            rows = _rows(eng, slot, len(long.prompt))
    return (list(short.generated), list(long.generated)), rows


@pytest.mark.parametrize("chunk", [1, 3, 5, 8, 16])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_chunked_equals_whole_prompt_with_a_batchmate(packed, chunk, paged):
    kw = {"kv_pool": PAGES} if paged else {}
    got, got_rows = _long_admission_under_load(
        _port_engine(packed, prefill_chunk=chunk, **kw))
    want, want_rows = _long_admission_under_load(_port_engine(packed, **kw))
    assert got == want
    assert got_rows.keys() == want_rows.keys()
    for key in want_rows:
        assert torch.equal(got_rows[key], want_rows[key]), key


def test_w4a4_chunked_equals_whole_prompt(packed):
    prompts = [np.array([9, 8, 7, 3, 1], np.int32),
               (np.arange(30, dtype=np.int32) * 7 + 1) % 256,
               np.array([1, 2], np.int32)]
    streams = [_run_streams(_port_engine(packed, kv_quant=None,
                                         act_quant="mixfp4", max_len=48,
                                         prefill_chunk=chunk), prompts)
               for chunk in (4, None)]
    assert streams[0] == streams[1]


def test_paged_w4a4_fused_equals_two_pass_rowscale(packed):
    prompts = _shared_prefix_prompts()
    streams = [_run_streams(_port_engine(packed, kv_pool=PAGES,
                                         act_quant=aq), prompts)
               for aq in ("mixfp4", "mixfp4-2pass-rowscale")]
    assert streams[0] == streams[1]


def test_pool_exhaustion_defers_then_admits(packed):
    """Three usable pages, two requests of two pages each: the second
    admission is refused with nothing consumed, then admitted once the
    first request's pages are released."""
    eng = _port_engine(packed, kv_pool=4, max_len=32)
    rng = np.random.RandomState(4)
    first, second = (Request(uid=i, prompt=rng.randint(0, 256, 20).astype(
        np.int32), max_new_tokens=4) for i in range(2))
    assert eng.add_request(first)
    before = eng.pool_report()
    assert not eng.add_request(second)
    after = eng.pool_report()
    assert after == dict(before, alloc_failures=before["alloc_failures"] + 1)
    assert eng.slots.count(None) == 1 and not second.generated
    while not second.generated:
        eng.step()
        if all(s is not second for s in eng.slots) and not second.done:
            eng.add_request(second)
    while eng.has_work():
        eng.step()
    assert len(first.generated) == len(second.generated) == 4
    assert eng.max_concurrent == 1
    assert eng.pool_report()["pages_active"] == 0


def test_paged_and_chunked_validation(packed):
    cases = [({"kv_quant": None, "kv_pool": 8}, "kv_quant"),
             ({"kv_pool": 8, "kv_page_len": 8}, "multiple of 16"),
             ({"kv_pool": 8, "max_len": 40}, "multiple of 16"),
             ({"prefill_chunk": 0}, ">= 1"),
             ({"prefill_chunk": 4, "prefill_buckets": "pow2-64"},
              "prefill_buckets")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            _port_engine(packed, **kw)
    assert _port_engine(packed, prefill_chunk=4).prefill_buckets is None
    assert _port_engine(packed).prefill_buckets == "pow2-64"
    eng = _port_engine(packed, kv_pool=3, max_len=64)     # 2 usable pages
    with pytest.raises(ValueError, match="pool pages"):
        eng.add_request(Request(uid=0, prompt=np.ones(40, np.int32),
                                max_new_tokens=4))
    assert eng.pool_report()["pages_free"] == 2
