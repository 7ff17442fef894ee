"""Packed checkpoints across the two packages, on the CPU.

The reference's ``ServeEngine`` packs three smoke trees from one seeded
dense tree each and writes them with ``save_weights``: gemma2 W4A16,
gemma2 W4A4 + serve-time RHT (its ``rht_signs`` record included) and
qwen2-moe W4A16 ((E, K, N) expert stacks, each expert with its own
``scale32``); its jits are compiled with ``xla_allow_excess_precision``
off, as in ``test_torch_engine.py``.  Then, for each tree:

* the port restores the reference's checkpoint bitwise (equal to
  ``convert.packed_from_numpy`` of the same tree), and a port engine that
  ``load_weights`` it serves the reference engine's greedy streams, with
  the reference's storage stats;
* a port engine holding those bytes writes a checkpoint whose every file
  is byte-identical to the reference's (``manifest.json`` equal once
  parsed), which the reference restores;
* ``packed_fingerprint`` is one value for both directories under both
  packages.

Corruption (the reference's own tampering: the leaf sha fixed up, so only
the per-array digests or the scale scan can catch it) raises the same
exception class naming the same array in both packages; the port also
refuses an E4M3 NaN scale byte (0x7F), which the reference accepts.  The
manager's own protocol: ``latest_step`` skips ``.tmp`` and manifest-less
directories, keep-N garbage collection, an asynchronous save then
``wait``, bf16 leaves crossing as bytes.

  PYTHONPATH=src python -m pytest -q tests/test_torch_checkpoint.py
"""
import functools
import json
import os
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models.base import build_model as jbuild  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
# tree -> (arch, engine options of both packages' engines)
TREES = {"dense": ("gemma2-2b", {}),
         "w4a4-rht": ("gemma2-2b", {"act_quant": "mixfp4", "act_rht": True}),
         "moe": ("qwen2-moe-a2.7b", {})}
# two prompts in one prefill bucket: one prefill shape, one decode shape
PROMPT_LENS = (5, 7)
NEW_TOKENS = 3
ARRAY = "layers/attn/wq"          # the array the corruption tests damage


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


def _jit_pack(params, method="mixfp4", act_rht=False):
    tree, packed, dense = jax.jit(functools.partial(
        jbase.pack_projections, method=method, act_rht=act_rht))(params)
    return tree, int(packed), int(dense)


def _serve(eng, request_cls):
    rng = np.random.RandomState(0)
    reqs = [request_cls(uid=i, prompt=rng.randint(0, 256, n).astype(np.int32),
                        max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]
    for r in reqs:
        assert eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [list(r.generated) for r in reqs]


def _port_engine(arch, params, kw):
    return ServeEngine(configs.smoke_config(arch), params, batch_size=2,
                       max_len=32, kv_quant="mixfp4", device="cpu", **kw)


@pytest.fixture(scope="module")
def saved(pallas_memory_space_alias, tmp_path_factory):
    """tree -> the reference engine's checkpoint directory (``ref``), the
    port's checkpoint of the same bytes (``port``), those bytes in the
    port's layout, the reference's packed tree and storage stats, and its
    greedy streams."""
    base = tmp_path_factory.mktemp("ckpt")
    dense, out = {}, {}
    for name, (arch, kw) in TREES.items():
        jcfg = jconfigs.smoke_config(arch)
        if arch not in dense:
            model = jbuild(jcfg)
            dense[arch] = jax.jit(lambda k, m=model: m.init(k)[0])(
                jax.random.PRNGKey(0))
        with pytest.MonkeyPatch.context() as mp:
            # the engine packs (and rotates) its weights in one compiled
            # call instead of op by op
            mp.setattr(jengine, "pack_projections", _jit_pack)
            eng = jengine.ServeEngine(jcfg, dense[arch], batch_size=2,
                                      max_len=32, kv_quant="mixfp4", **kw)
            mp.setattr(jax, "jit", functools.partial(
                jax.jit, compiler_options=NO_EXCESS_PRECISION))
            eng._build_jits()
        ref, port = str(base / f"{name}-ref"), str(base / f"{name}-port")
        eng.save_weights(ref)
        tree = convert.packed_from_numpy(jax.tree.map(np.asarray,
                                                      eng.params),
                                         configs.smoke_config(arch),
                                         device="cpu")
        _port_engine(arch, tree, kw).save_weights(port)
        out[name] = types.SimpleNamespace(
            arch=arch, kw=kw, ref=ref, port=port, tree=tree,
            jparams=eng.params, stats=jengine._packed_stats(eng.params),
            streams=_serve(eng, jengine.Request))
    return out


def _assert_same_tree(a, b):
    """Two port trees: the same structure, QTensor metadata and leaf
    bytes."""
    la, lb = manager._flatten(a)[0], manager._flatten(b)[0]
    assert len(la) == len(lb)
    qa, qb = dict(manager._named_qtensors(a)), dict(manager._named_qtensors(b))
    assert {k: (q.method, q.layout, q.shape, q.dtype) for k, q in qa.items()} \
        == {k: (q.method, q.layout, q.shape, q.dtype) for k, q in qb.items()}
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(manager._host_bytes(x), manager._host_bytes(y))


@pytest.mark.parametrize("name", list(TREES))
def test_port_restores_reference_checkpoint(saved, name):
    s = saved[name]
    tree, extra = manager.CheckpointManager(s.ref).restore_packed()
    assert extra == {}
    cfg = configs.smoke_config(s.arch)
    _assert_same_tree(convert.packed_from_numpy(tree, cfg, device="cpu"),
                      s.tree)
    # a fresh engine on other weights, then the checkpoint
    eng = _port_engine(s.arch, build_model(cfg).init(1, device="cpu"), s.kw)
    eng.load_weights(s.ref)
    _assert_same_tree(eng.params, s.tree)
    assert (eng.packed_bytes, eng.dense_bytes) == s.stats
    assert _serve(eng, Request) == s.streams


@pytest.mark.parametrize("name", list(TREES))
def test_reference_restores_port_checkpoint(saved, name):
    s = saved[name]
    step = "step_0000000000"
    files = sorted(os.listdir(os.path.join(s.ref, step)))
    assert files == sorted(os.listdir(os.path.join(s.port, step)))
    for f in files:
        with open(os.path.join(s.ref, step, f), "rb") as fa, \
                open(os.path.join(s.port, step, f), "rb") as fb:
            a, b = fa.read(), fb.read()
        if f == "manifest.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, f
    tree, _ = jmanager.CheckpointManager(s.port).restore_packed()
    want = jax.tree.leaves(s.jparams)
    got = jax.tree.leaves(tree)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", list(TREES))
def test_packed_fingerprint_equal_both_ways(saved, name):
    s = saved[name]
    fps = {(pkg.__name__, d): pkg.CheckpointManager(d).packed_fingerprint()
           for pkg in (manager, jmanager) for d in (s.ref, s.port)}
    assert len(set(fps.values())) == 1, fps


def _neg_zero(flat):
    assert flat[0] != 0x80          # the packers never write it
    flat[0] = 0x80
    return flat


def _nan(flat):
    flat[0] = (flat[0] & 0x80) | 0x7F
    return flat


def _flip(flat):
    flat[0] ^= 0x11                 # both nibbles stay valid FP4 codes
    return flat


# kind -> (plane, mutation, fix the per-array digest, the port's error,
# the reference's error or None where it restores the tree)
CORRUPTIONS = {
    "neg-zero-scale": ("scales", _neg_zero, True, (ValueError, "0x80"),
                       (ValueError, "0x80")),
    "payload-flip": ("payload", _flip, False, (IOError, "payload"),
                     (IOError, "payload")),
    "nan-scale": ("scales", _nan, True, (ValueError, "0x7F"), None),
}


@pytest.mark.parametrize("kind", list(CORRUPTIONS))
def test_corruption_names_the_same_array(saved, tmp_path, kind):
    plane, mutate, fix_packed, port_err, ref_err = CORRUPTIONS[kind]
    d = str(tmp_path / "ckpt")
    shutil.copytree(saved["dense"].ref, d)
    first = manager.damage_packed_array(d, ARRAY, plane, mutate,
                                        fix_packed=fix_packed)
    pattern = rf"{ARRAY}.+{port_err[1]}"
    with pytest.raises(port_err[0], match=pattern):
        manager.CheckpointManager(d).restore_packed()
    with pytest.raises(port_err[0], match=pattern):
        _port_engine("gemma2-2b", saved["dense"].tree, {}).load_weights(d)
    if ref_err is None:
        # the deliberate difference: the reference serves the NaN byte
        tree, _ = jmanager.CheckpointManager(d).restore_packed()
        assert np.asarray(tree["layers"]["attn"]["wq"].scales).flat[0] \
            & 0x7F == 0x7F
    else:
        with pytest.raises(ref_err[0], match=rf"{ARRAY}.+{ref_err[1]}"):
            jmanager.CheckpointManager(d).restore_packed()
    # the scan can be bypassed explicitly, as in the reference
    if fix_packed:
        tree, _ = manager.CheckpointManager(d).restore_packed(
            verify_packed=False)
        assert int(tree["layers"]["attn"]["wq"].scales.reshape(-1)[0]) \
            == first


def _small_tree(seed: int):
    """Port tree with a 2-D and a 1-D QTensor, a bf16 leaf, a list and a
    tuple: every kind of node the format knows."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(48, 32, generator=gen)
    return {"w": qtensor.quantize(w, qtensor.QuantSpec(
                "mixfp4", qtensor.BlockLayout2D())),
            "rows": qtensor.quantize(torch.randn(3, 40, generator=gen)),
            "norms": [torch.ones(4), torch.randn(2, 3, generator=gen).to(
                torch.bfloat16)],
            "pair": (torch.arange(5, dtype=torch.int32), torch.zeros(())),
            "a": torch.randn(7, generator=gen)}


def _to_jax(tree):
    """The same tree as the reference's objects (bf16 through its bits)."""
    if isinstance(tree, qtensor.QTensor):
        lay = (jqt.BlockLayout2D(tree.layout.bm, tree.layout.bn)
               if isinstance(tree.layout, qtensor.BlockLayout2D)
               else jqt.BlockLayout1D(tree.layout.axis, tree.layout.block))
        return jqt.QTensor(*[_to_jax(getattr(tree, c)) for c in
                             ("payload", "scales", "scale32")],
                           tree.method, lay, tree.shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def test_tree_spec_and_leaf_files_match_reference(tmp_path):
    tree = _small_tree(0)
    jtree = _to_jax(tree)
    spec = qtensor.tree_spec(tree)
    assert json.loads(json.dumps(spec)) == json.loads(json.dumps(
        jqt.tree_spec(jtree)))
    like = qtensor.tree_like(spec)
    assert like["w"].payload == qtensor.ShapeDtype((24, 32), "uint8")
    assert like["rows"].layout == tree["rows"].layout
    assert isinstance(like["pair"], tuple) and like["a"] == 0
    manager.CheckpointManager(str(tmp_path / "port")).save_packed(0, tree)
    jmanager.CheckpointManager(str(tmp_path / "ref")).save_packed(0, jtree)
    step = "step_0000000000"
    files = sorted(os.listdir(tmp_path / "ref" / step))
    assert files == sorted(os.listdir(tmp_path / "port" / step))
    for f in files:
        a = (tmp_path / "ref" / step / f).read_bytes()
        b = (tmp_path / "port" / step / f).read_bytes()
        assert (json.loads(a) == json.loads(b)) if f.endswith(".json") \
            else a == b, f
    # each way round, the bf16 leaf's bits survive
    back, _ = manager.CheckpointManager(str(tmp_path / "ref")).restore_packed()
    _assert_same_tree(back, tree)
    jback, _ = jmanager.CheckpointManager(
        str(tmp_path / "port")).restore_packed()
    for x, y in zip(jax.tree.leaves(jback), jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                                      np.asarray(y).reshape(-1).view(np.uint8))


def test_latest_step_skips_partial_steps(tmp_path):
    mgr = manager.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_small_tree(0)) == (None, None, None)
    mgr.save(3, _small_tree(3), blocking=True)
    # a save cut before its rename, and a step directory without manifest
    os.makedirs(tmp_path / "step_0000000009.tmp")
    (tmp_path / "step_0000000009.tmp" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_0000000007")
    for mod in (manager, jmanager):
        assert mod.CheckpointManager(str(tmp_path)).latest_step() == 3
    step, tree, extra = mgr.restore_latest(_small_tree(1))
    assert (step, extra) == (3, {})
    _assert_same_tree(tree, _small_tree(3))


def test_keep_n_and_async_save(tmp_path):
    mgr = manager.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        tree = _small_tree(step)
        mgr.save(step, tree, extra={"step": step})
        # the snapshot is taken before save returns: a later write to the
        # tree does not reach the checkpoint
        tree["a"].add_(1.0)
        mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000003"]
    for step in (2, 3):
        tree, extra = mgr.restore(step, _small_tree(0))
        assert extra == {"step": step}
        _assert_same_tree(tree, _small_tree(step))
    jstep, _, jextra = jmanager.CheckpointManager(
        str(tmp_path)).restore_latest(_to_jax(_small_tree(0)))
    assert (jstep, jextra) == (3, {"step": 3})


def test_unported_arguments_raise(saved):
    with pytest.raises(NotImplementedError, match="item 7"):
        manager.CheckpointManager(saved["dense"].ref).restore_packed(
            shardings={})
    # the checkpoint_read retry is ported (ROADMAP §1 item 4a): a read that
    # fails with an OSError is retried retry_max times, then raised
    from repro_torch.serving.faults import FaultInjector
    eng = _port_engine("gemma2-2b", saved["dense"].tree,
                       {"retry_max": 2, "faults": FaultInjector(0, [])})
    with pytest.raises(OSError):
        eng.load_weights(saved["dense"].ref, step=9)
    assert eng.counters["retries:checkpoint_read"] == 2
    assert eng.counters["retries_exhausted:checkpoint_read"] == 1


def test_load_weights_checks_the_depth(saved):
    cfg = configs.smoke_config("gemma2-2b").replace(n_layers=1)
    eng = ServeEngine(cfg, build_model(cfg).init(0, device="cpu"),
                      batch_size=2, max_len=32, kv_quant="mixfp4",
                      device="cpu")
    with pytest.raises(ValueError, match=r"stacks \[2\] layers"):
        eng.load_weights(saved["dense"].ref)


def test_launch_serve_saves_a_loadable_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    serve.main(["--smoke", "--device", "cpu", "--save-weights", d])
    assert "checkpointed to" in capsys.readouterr().out
    cfg = configs.smoke_config("gemma2-2b")
    want = _port_engine("gemma2-2b", build_model(cfg).init(0, device="cpu"),
                        {})
    eng = _port_engine("gemma2-2b", build_model(cfg).init(1, device="cpu"),
                       {})
    eng.load_weights(d)
    _assert_same_tree(eng.params, want.params)
