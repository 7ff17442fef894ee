"""The dense configs the port adds (Phi-3-medium-14B, StarCoder2-15B,
H2O-Danube3-4B, the paper's 114M model) against the JAX package, on the
CPU.

* Every field of each ``config()`` and ``smoke_config()`` equals the
  reference's.
* At smoke size, Phi-3 (SwiGLU, GQA) and StarCoder2 (GeLU MLP, the
  port's ``mlp_type="gelu"`` branch) on the packed MixFP4 KV cache, and
  Danube (a sliding window on every layer) on the bf16 KV cache: the
  port's prefill then teacher-forced decode logits against the
  reference's ``prefill_slot``/``decode_step`` on the same packed bytes
  (jitted with ``xla_allow_excess_precision`` off, as in
  ``test_torch_model.py``; within 1e-5 of max|logit|), the K/V the port
  writes bitwise the reference's, and the port engine's greedy streams
  those of the reference engine.
* Decode attention at a query-head group of 12 (StarCoder2-15B's 48 heads
  over 4 kv heads), which the kernel walks in passes of at most 8 heads:
  the port's plain versions (fixed slots, paged pool, and the kernel's
  split arithmetic) against the reference kernels in interpret mode, 1e-5.

  PYTHONPATH=src python -m pytest -q tests/test_torch_dense_configs.py
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import mixfp4_attn as jattn  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import mixfp4_attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
ARCHS = ["phi3-medium-14b", "starcoder2-15b", "h2o-danube-3-4b",
         "mixfp4-114m"]
# arch -> KV cache of its smoke runs (Danube's full head_dim, 120, takes
# no packed cache, so its smoke model serves the bf16 one too)
SERVED = {"phi3-medium-14b": "mixfp4", "starcoder2-15b": "mixfp4",
          "h2o-danube-3-4b": None}
MAX_LEN, P_LEN, STEPS = 32, 11, 3
PROMPT_LENS = (5, 7)              # one prefill bucket


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's torch work, the count it had
    restored after: the suite runs several test processes side by side,
    and one thread per core in every process makes small ops contend for
    the cores (see ``tests/test_torch_expert_walk.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("kind", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, kind):
    port = getattr(configs, kind)(arch)
    ref = (jconfigs.full_config(arch) if kind == "config"
           else jconfigs.smoke_config(arch))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.dh == ref.dh


# Made when the module is imported, before any test runs: a jit-cache
# context made later would drop every trace cached until then.
ALIAS_TRACES = jax.make_user_context(default_value=None)


@pytest.fixture(scope="module")
def pallas_memory_space_alias():
    """jax 0.9 renamed ``pltpu.TPUMemorySpace`` (which the reference GEMM
    uses) to ``MemorySpace``; alias it for this module only.  What is
    traced meanwhile is cached under a context of its own, so no test
    outside this module reuses a trace that needed the alias, and the
    traces cached before are kept: the module leaves JAX's caches as they
    were for every other test."""
    from jax.experimental.pallas import tpu as pltpu
    missing = not hasattr(pltpu, "TPUMemorySpace")
    if missing:
        pltpu.TPUMemorySpace = pltpu.MemorySpace
    with ALIAS_TRACES(__name__):
        yield
    if missing:
        del pltpu.TPUMemorySpace


def _strict_jit(fn):
    return jax.jit(fn, compiler_options=NO_EXCESS_PRECISION)


@pytest.fixture(scope="module")
def runs(pallas_memory_space_alias):
    """arch -> (reference logits and cache, port logits and cache, the
    reference engine's streams, the port engine's streams), all from one
    seeded packed tree."""
    out = {}
    for arch, kv in SERVED.items():
        jcfg = jconfigs.smoke_config(arch)
        jmodel = jbase.build_model(jcfg)
        dense = jax.jit(lambda k, m=jmodel: m.init(k)[0])(
            jax.random.PRNGKey(0))
        packed = jax.jit(lambda p: jbase.pack_projections(p)[0])(dense)
        ctx = jbase.Ctx(jax.random.PRNGKey(0), jcfg.quant)
        rng = np.random.RandomState(0)
        prompt = rng.randint(0, jcfg.vocab, (1, P_LEN)).astype(np.int32)
        forced = rng.randint(0, jcfg.vocab, STEPS).astype(np.int32)
        prefill = _strict_jit(
            lambda p, t, c: jmodel.prefill_slot(p, t, ctx, c, 0))
        decode = _strict_jit(
            lambda p, t, c, n: jmodel.decode_step(p, t, ctx, c, n))
        cache = jmodel.init_cache(1, MAX_LEN, kv_quant=kv)
        logits, cache = prefill(packed, jnp.asarray(prompt), cache)
        want = [np.asarray(logits)]
        for i, tok in enumerate(forced):
            logits, cache = decode(packed, jnp.asarray([tok]), cache,
                                   jnp.asarray([P_LEN + i], jnp.int32))
            want.append(np.asarray(logits))

        cfg = configs.smoke_config(arch)
        model = build_model(cfg)
        port = convert.packed_from_numpy(jax.tree.map(np.asarray, packed),
                                         cfg, device="cpu")
        pcache = model.init_cache(1, MAX_LEN, kv_quant=kv, device="cpu")
        plogits, pcache = model.prefill_slot(
            port, torch.from_numpy(prompt).long(), pcache, 0)
        got = [plogits.numpy()]
        for i, tok in enumerate(forced):
            plogits, pcache = model.decode_step(
                port, torch.tensor([int(tok)]), pcache,
                torch.tensor([P_LEN + i]))
            got.append(plogits.numpy())

        eng = jengine.ServeEngine(jcfg, packed, batch_size=2,
                                  max_len=MAX_LEN, kv_quant=kv)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=NO_EXCESS_PRECISION))
            eng._build_jits()
        out[arch] = {
            "ref": (np.concatenate(want), cache),
            "port": (np.concatenate(got), pcache),
            "ref_streams": _serve(eng, jengine.Request),
            "port_streams": _serve(ServeEngine(
                cfg, port, batch_size=2, max_len=MAX_LEN, kv_quant=kv,
                device="cpu"), Request)}
    return out


def _serve(eng, request_cls):
    rng = np.random.RandomState(1)
    reqs = [request_cls(uid=i, prompt=rng.randint(0, 256, n).astype(np.int32),
                        max_new_tokens=4)
            for i, n in enumerate(PROMPT_LENS)]
    for r in reqs:
        assert eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [list(r.generated) for r in reqs]


def _kv_children(cache):
    """name -> the written K/V rows of a cache (JAX or port) as bytes."""
    n = P_LEN + STEPS
    out = {}
    for name in ("k", "v"):
        leaf = cache[name]
        if hasattr(leaf, "payload"):
            for child in ("payload", "scales"):
                out[name, child] = np.asarray(getattr(leaf, child))[:, :, :n]
        elif isinstance(leaf, torch.Tensor):
            out[name] = leaf[:, :, :n].view(torch.int16).numpy()
        else:
            out[name] = np.asarray(leaf)[:, :, :n].view(np.int16)
    return out


@pytest.mark.parametrize("arch", list(SERVED))
def test_prefill_and_decode_match_reference(arch, runs):
    (want, jcache), (got, cache) = runs[arch]["ref"], runs[arch]["port"]
    assert got.shape == want.shape == (STEPS + 1,
                                       configs.smoke_config(arch).vocab)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    a, b = _kv_children(jcache), _kv_children(cache)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


@pytest.mark.parametrize("arch", list(SERVED))
def test_engine_streams_match_reference(arch, runs):
    streams = runs[arch]["port_streams"]
    assert all(len(s) == 4 for s in streams)
    assert streams == runs[arch]["ref_streams"]


def test_starcoder2_takes_the_gelu_mlp_and_a_group_of_12():
    cfg = configs.config("starcoder2-15b")
    assert (cfg.mlp_type, cfg.n_heads // cfg.n_kv_heads) == ("gelu", 12)
    layer = build_model(cfg.replace(
        n_layers=1, d_model=64, n_heads=12, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=64)).init(0, device="cpu")["layers"][0]
    assert sorted(layer["mlp"]) == ["w_down", "w_up"]


# decode attention at g = 12: (s, hkv, dh, window, softcap, lengths)
G12_CASES = {
    "split_boundaries": (520, 1, 16, 0, 50.0, [255, 256, 257, 520]),
    "starcoder2_heads_window": (300, 4, 128, 200, 30.0, [300, 1, 257, 100]),
}
G = 12


def _g12_case(s, hkv, dh, lengths, seed):
    """q and a packed cache from numpy (quantized by the reference), and
    the same rows scattered over a permuted pool of 64-row pages with junk
    rows in the trash page 0.  (The junk is finite wire bytes: at g = 12
    the reference's paged kernel reads the trash page under its mask, so
    an E4M3 NaN byte there would turn its output NaN, which it does not
    at g = 2.)"""
    b, page = len(lengths), 64
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hkv * G, dh).astype(np.float32)
    fixed = []
    for _ in range(2):                                  # K, then V
        rows = rng.randn(b, s, hkv, dh).astype(np.float32)
        fixed += [np.array(a) for a in jbase.quantize_kv_rows(
            jnp.asarray(rows))]
    junk = [np.array(a) for a in jbase.quantize_kv_rows(jnp.asarray(
        40 * rng.randn(page, hkv, dh).astype(np.float32)))]
    mp = -(-s // page)
    bt = (1 + rng.permutation(b * mp)).reshape(b, mp).astype(np.int32)
    slabs = []
    for a, j in zip(fixed, junk * 2):
        padded = np.zeros((b, mp * page, *a.shape[2:]), a.dtype)
        padded[:, :s] = a
        slab = np.zeros((1 + b * mp, page, *a.shape[2:]), a.dtype)
        slab[0] = j
        slab[bt.reshape(-1)] = padded.reshape(b * mp, page, *a.shape[2:])
        slabs.append(slab)
    return q, fixed, slabs, bt, np.array(lengths, np.int32)


@pytest.mark.parametrize("name", list(G12_CASES))
def test_decode_attention_group_12_matches_reference_kernels(name):
    s, hkv, dh, window, softcap, lengths = G12_CASES[name]
    q, fixed, slabs, bt, lens = _g12_case(s, hkv, dh, lengths,
                                          seed=len(name))
    t = torch.from_numpy
    kw = {"window": window, "softcap": softcap}
    ref = np.asarray(jattn.mixfp4_attn_decode(
        jnp.asarray(q), *map(jnp.asarray, fixed), jnp.asarray(lens),
        interpret=True, **kw))
    ref_paged = np.asarray(jattn.mixfp4_attn_decode_paged(
        jnp.asarray(q), *map(jnp.asarray, slabs), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True, **kw))
    got = {
        "plain": mixfp4_attn.attn_decode_plain(t(q), *map(t, fixed), t(lens),
                                               **kw),
        "split": mixfp4_attn.attn_decode_split_plain(
            t(q), *map(t, fixed), t(lens), **kw),
        # the wrappers take the plain versions for CPU tensors
        "fixed": mixfp4_attn.mixfp4_attn_decode(t(q), *map(t, fixed),
                                                t(lens), **kw),
        "paged": mixfp4_attn.mixfp4_attn_decode_paged(
            t(q), *map(t, slabs), t(bt), t(lens), **kw)}
    for key, out in got.items():
        assert out.shape == (len(lengths), hkv * G, dh)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(ref_paged, ref, atol=1e-5)
