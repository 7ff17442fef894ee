"""The port's MoE layer (``repro_torch.models.moe``) and its expert GEMM
against the JAX package, on the CPU, at the smoke sizes of both MoE
configs (qwen2-moe: 6 experts in ``"ffn"`` mode and a shared expert;
qwen3-moe: 8 experts padded to 16, QK-norm).  The same numpy inputs go
through both.

Bitwise: top-k indices and the bf16 gates the layer consumes (from the
same logits; the f32 gates agree to 2 ulp, since XLA's CPU ``exp`` and
PyTorch's differ by an ulp on ~5 % of inputs), the dispatch indices, the
packed expert bytes (dummy experts and every expert's ``scale32``
included), ``convert.packed_from_numpy`` on the reference's (L, E, ...)
stacks, and ``moe_apply`` itself, decode and a prefill with capacity drops
(the port rounds where the reference rounds and combines in its scatter
order, so no tolerance is needed).  The expert GEMM's plain version: each
expert bitwise the 2-D plain version, and within the reference's atol
2e-2 (scale-normalised) of ``repro.kernels.ref`` per expert.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.base import build_model as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.kernels import mixfp4_gemm, ops  # noqa: E402
from repro_torch.models import base, moe  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
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


@pytest.fixture(scope="module")
def jax_trees(pallas_memory_space_alias):
    """Each arch's reference smoke model, initialised and packed once:
    {name: (dense value tree, packed tree)}."""
    out = {}
    for name in ARCHS:
        model = jbuild(jconfigs.smoke_config(name))
        params = jax.jit(lambda k, m=model: m.init(k)[0])(
            jax.random.PRNGKey(0))
        out[name] = (params, jax.jit(
            lambda p: jbase.pack_projections(p)[0])(params))
    return out


@pytest.fixture(scope="module")
def jax_packed(jax_trees):
    return {name: packed for name, (_, packed) in jax_trees.items()}


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_route_matches_reference_from_the_same_logits(name):
    cfg, jcfg = configs.smoke_config(name), jconfigs.smoke_config(name)
    e = cfg.n_experts
    rng = np.random.RandomState(3)
    logits = (rng.randn(256, e) * rng.choice([0.1, 1.0, 4.0], (256, 1))
              ).astype(np.float32)
    logits[:16] = np.round(logits[:16])            # exact ties
    logits[16:32, 1:] = logits[16:32, :1]          # all equal
    # an identity router hands both the logits unchanged
    gj, ij, _ = jmoe._route(jnp.asarray(logits), jnp.eye(e), jcfg)
    gt, it = moe._route(torch.from_numpy(logits), torch.eye(e), cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it[16:32].tolist() == [list(range(cfg.top_k))] * 16
    gj = np.asarray(gj)
    assert np.array_equal(
        gt.to(torch.bfloat16).view(torch.int16).numpy(),
        np.asarray(jnp.asarray(gj).astype(jnp.bfloat16)).view(np.int16))
    assert _ulps(gt.numpy(), gj) <= 2


@pytest.mark.parametrize("t,k,e,cap", [(1, 2, 6, 4), (7, 2, 8, 4),
                                       (40, 4, 60, 4), (64, 8, 128, 5)])
def test_dispatch_indices_bitwise(t, k, e, cap):
    rng = np.random.RandomState(t)
    # skewed choices, so some experts overflow ``cap``
    idx = np.stack([rng.choice(e, k, replace=False,
                               p=np.arange(e, 0, -1) / (e * (e + 1) / 2))
                    for _ in range(t)]).astype(np.int32)
    want = jmoe._dispatch_indices(jnp.asarray(idx), e, cap)
    got = moe._dispatch_indices(torch.from_numpy(idx).long(), e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if t >= 40:
        assert not got[3].all()                    # drops happened


# ---------------------------------------------------------------------------
# packing and conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_packed_expert_bytes_match_reference(name):
    jcfg, cfg = jconfigs.smoke_config(name), configs.smoke_config(name)
    vals = jax.jit(lambda k: jbase.unzip_params(jmoe.moe_init(k, jcfg))[0])(
        jax.random.PRNGKey(1))
    jp, jpb, jdb = jax.jit(jbase.pack_projections)(vals)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), vals)
    tp, tpb, tdb = base.pack_projections(tree)
    assert (tpb, tdb) == (int(jpb), int(jdb))
    e_store = moe.stored_experts(cfg)
    assert e_store == (16 if name.startswith("qwen3") else 6)
    for key in ("w_up", "w_gate", "w_down"):
        a, b = tp[key], jp[key]
        assert a.payload.shape[0] == e_store and a.shape == tuple(b.shape)
        for child in ("payload", "scales", "scale32"):
            np.testing.assert_array_equal(getattr(a, child).numpy(),
                                          np.asarray(getattr(b, child)))
        if e_store > cfg.n_experts:    # dummy experts: zero codes
            assert not a.payload[cfg.n_experts:].any()
    assert base.is_packable_projection("w_up", tree["w_up"])
    assert not base.is_packable_projection("router", tree["router"])
    assert isinstance(tp["router"], torch.Tensor)


@pytest.mark.parametrize("name", ARCHS)
def test_packed_from_numpy_takes_expert_stacks(jax_packed, name):
    cfg = configs.smoke_config(name)
    ref = jax.tree.map(np.asarray, jax_packed[name])
    got = convert.packed_from_numpy(ref, cfg, device="cpu")
    for li, layer in enumerate(got["layers"]):
        m, want = layer["moe"], ref["layers"]["moe"]
        assert "mlp" not in layer
        assert m["router"].dtype == torch.float32
        np.testing.assert_array_equal(m["router"].numpy(),
                                      want["router"][li])
        for key in ("w_up", "w_gate", "w_down"):
            assert m[key].payload.shape[0] == moe.stored_experts(cfg)
            for child in ("payload", "scales", "scale32"):
                np.testing.assert_array_equal(
                    getattr(m[key], child).numpy(),
                    np.asarray(getattr(want[key], child))[li])
        assert ("shared" in m) == bool(cfg.shared_expert_ff)


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_numpy_takes_expert_stacks(jax_trees, name):
    """The reference's dense (L, E, K, N) stacks carry over as per-layer
    (E, K, N) f32 stacks that pack to the reference's packed bytes."""
    cfg = configs.smoke_config(name)
    dense, packed = (jax.tree.map(np.asarray, t) for t in jax_trees[name])
    got = convert.params_from_numpy(dense, cfg, device="cpu")
    mine = base.pack_projections(got)[0]
    for li, layer in enumerate(mine["layers"]):
        assert got["layers"][li]["moe"]["w_up"].shape == (
            moe.stored_experts(cfg), cfg.d_model, cfg.d_ff_expert)
        want = packed["layers"]["moe"]
        for key in ("w_up", "w_gate", "w_down"):
            for child in ("payload", "scales", "scale32"):
                np.testing.assert_array_equal(
                    getattr(layer["moe"][key], child).numpy(),
                    np.asarray(getattr(want[key], child))[li])


def _tensors(tree):
    """Every tensor of a parameter tree, QTensor children included, in
    order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, qtensor.QTensor):
        return [tree.payload, tree.scales, tree.scale32]
    return [tree]


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "gemma2-2b"])
def test_init_packs_layer_by_layer_to_the_same_bytes(name):
    """``init(pack=...)`` draws the same values as ``init()`` and packs
    each layer as it goes: every tensor equals ``pack_projections`` of the
    dense tree."""
    from repro_torch.models import build_model
    model = build_model(configs.smoke_config(name))
    a = _tensors(model.init(3, device="cpu", pack="mixfp4"))
    b = _tensors(base.pack_projections(model.init(3, device="cpu"))[0])
    assert len(a) == len(b) and all(torch.equal(x, y)
                                    for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
MOE_CALLS = [("decode", 2, 1, 0.0), ("prefill", 1, 40, 0.0),
             ("prefill-drops", 1, 40, 3.0)]


@pytest.mark.parametrize("call", MOE_CALLS, ids=[c[0] for c in MOE_CALLS])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_bitwise_vs_reference(jax_packed, name, call):
    """Both layers from the same packed bytes and bf16 rows; ``bias`` on
    expert 0's router column overflows its capacity."""
    _, b, s, bias = call
    cfg, jcfg = configs.smoke_config(name), jconfigs.smoke_config(name)
    jp = dict(jax.tree.map(lambda a: a[0], jax_packed[name]["layers"])["moe"])
    jp["router"] = jp["router"].at[:, 0].add(bias)
    pp = dict(convert.packed_from_numpy(jax.tree.map(
        np.asarray, jax_packed[name]), cfg, device="cpu")["layers"][0]["moe"])
    pp["router"] = torch.from_numpy(np.array(jp["router"]))
    x = jnp.asarray(np.random.RandomState(b * s).randn(b, s, cfg.d_model),
                    jnp.bfloat16)
    ctx = jbase.Ctx(jax.random.PRNGKey(0), jcfg.quant)
    want = jax.jit(lambda p, x: jmoe.moe_apply(p, x, ctx, jcfg)[0],
                   compiler_options=NO_EXCESS_PRECISION)(jp, x)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = moe.moe_apply(pp, xt, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, cfg.d_model)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))
    # the biased prefill overflows expert 0's capacity
    t = b * s
    cap = max(int(np.ceil(t * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts)), 4)
    _, idx = moe._route(xt.reshape(t, -1), pp["router"], cfg)
    keep = moe._dispatch_indices(idx, cfg.n_experts, cap)[3]
    if bias:
        assert (~keep).sum() >= 4


def test_moe_layer_serves_w4a16_only():
    cfg = configs.smoke_config("qwen3-moe-30b-a3b")
    p = base.pack_projections(moe.moe_init(
        cfg, torch.Generator().manual_seed(0), torch.device("cpu")))[0]
    x = torch.zeros(1, 3, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 5"):
        moe.moe_apply(p, x, cfg, base.ActQuant("mixfp4"))
    before = ops.launch_counts()
    assert moe.moe_apply(p, x, cfg).shape == x.shape
    assert ops.launch_counts() == before            # CPU: no launch


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe._top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]]
    assert torch.equal(vals, torch.tensor([[0.3] * 3, [0.25] * 3]))


# ---------------------------------------------------------------------------
# the expert GEMM's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eckn", [(4, 5, 176, 96), (3, 1, 64, 48),
                                  (2, 33, 96, 176)])
def test_gemm_w4a16_experts_plain_vs_reference(eckn):
    """K = 176 is 5.5 slabs of 32 (ragged, as qwen2-moe's 1408 is 5.5
    splits of 256); the last expert is a zero (dummy) expert."""
    e, c, k, n = eckn
    rng = np.random.RandomState(sum(eckn))
    w = (rng.randn(e, k, n) * 0.3).astype(np.float32)
    w[-1] = 0.0
    qw = base.pack_projections({"w_up": torch.from_numpy(w)})[0]["w_up"]
    x = rng.randn(e, c, k).astype(np.float32)
    y = qtensor.qmm_experts(torch.from_numpy(x), qw)
    assert y.shape == (e, c, n) and y.dtype == torch.float32
    assert not y[-1].any()
    for i in range(e):
        two_d = mixfp4_gemm.gemm_w4a16_plain(
            torch.from_numpy(x[i]), qw.payload[i], qw.scales[i],
            qw.scale32[i], n)
        assert torch.equal(y[i], two_d)
        if i == e - 1:
            continue
        want = np.asarray(jref.ref_gemm_w4a16(
            jnp.asarray(x[i]), jnp.asarray(qw.payload[i].numpy()),
            jnp.asarray(qw.scales[i].numpy()),
            jnp.float32(float(qw.scale32[i]))))
        scale = np.abs(want).max()
        np.testing.assert_allclose(y[i].numpy() / scale, want / scale,
                                   atol=2e-2, rtol=0)


def test_expert_entry_checks_its_operands():
    w = torch.randn(3, 64, 32)
    qw = base.pack_projections({"w_up": w})[0]["w_up"]
    x = torch.randn(3, 4, 64)
    with pytest.raises(ValueError, match="unbatched"):
        qtensor.qmm(x[0], qw)                     # qmm refuses stacks
    with pytest.raises(ValueError, match="experts"):
        qtensor.qmm_experts(x[:2], qw)
    with pytest.raises(ValueError):
        ops.gemm_w4a16_experts(x[0], qw.payload, qw.scales, qw.scale32)
    with pytest.raises(ValueError, match="scale32"):
        ops.gemm_w4a16_experts(x, qw.payload, qw.scales, qw.scale32[:2])
    with pytest.raises(ValueError):
        ops.gemm_w4a16_experts(x, qw.payload[:, :, :16], qw.scales,
                               qw.scale32)
