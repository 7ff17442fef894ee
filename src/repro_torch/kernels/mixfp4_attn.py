"""One-token decode attention over the packed MixFP4 KV cache.

Counterpart of ``repro/kernels/mixfp4_attn.py :: mixfp4_attn_decode``.
Layout (the JAX package's):

  q           (B, H, dh)          bf16/f32 — the RoPE'd decode query
  k/v payload (B, S, Hkv, dh/2)   uint8
  k/v scales  (B, S, Hkv, dh/16)  uint8
  lengths     (B,)                int32 — valid rows, the current one included

GQA groups the H query heads per kv head (head h reads kv head h // g).
Masks are the reference's: ``kpos < len`` and, for ``window > 0``,
``kpos > len - 1 - window``; softcap ``c * tanh(s / c)`` after the
dh^-0.5 scale.  ``mixfp4_attn_decode`` launches
``csrc/mixfp4_attn_decode.cu`` for CUDA tensors and runs
:func:`attn_decode_plain` for CPU tensors.  Returns (B, H, dh) f32.

The kernel splits each sequence's keys at multiples of
``tuning.SPLIT_S`` and merges the splits' softmax states in split order
inside the launch, through an f32 workspace and one counter per
(sequence, kv head), both allocated once per device and reused.  Any
group size H/Hkv is taken: a group of more than 8 heads is walked in
passes of at most 8 over the keys staged once.
:func:`attn_decode_split_plain` is that arithmetic on the CPU, for tests.

``mixfp4_attn_decode_paged`` (the reference's entry of the same name)
reads the same rows from the paged pool: K/V slabs
(P, page_len, Hkv, dh/2) + (P, page_len, Hkv, dh/16) and block tables
(B, max_pages) int32, logical row t of sequence b at page
``bt[b, t // page_len]``, row ``t % page_len``; page 0 is the pool's trash
page.  Its kernel is the fixed kernel's body with another row address
(one source, the same flags), so on the gathered rows it is bitwise the
fixed kernel; :func:`attn_decode_paged_plain` gathers the logical view and
runs :func:`attn_decode_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tuning

__all__ = ["mixfp4_attn_decode", "mixfp4_attn_decode_paged",
           "attn_decode_plain", "attn_decode_paged_plain",
           "attn_decode_split_plain", "gather_pages", "dequant_kv",
           "launches", "launches_paged"]

_G = 16
_NEG_INF = -1e30

#: kernel launches (CUDA path only); read by ``kernels.ops.launch_counts``
launches = 0
#: launches of the paged entry, likewise
launches_paged = 0


def dequant_kv(payload: torch.Tensor, scales: torch.Tensor,
               scale32) -> torch.Tensor:
    """Packed rows (..., dh/2) + (..., dh/16) -> f32 (..., dh)."""
    from repro_torch.core import qtensor  # deferred: kernels below core
    return qtensor.from_packed_rows(payload, scales, scale32).dequantize()


def attn_decode_plain(q, k_payload, k_scales, v_payload, v_scales, lengths,
                      *, window: int = 0, k_scale32=1.0, v_scale32=1.0,
                      softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: dequantize the cache, masked softmax . V."""
    b, h, dh = q.shape
    s, hkv = k_payload.shape[1:3]
    g = h // hkv
    k = dequant_kv(k_payload, k_scales, k_scale32)
    v = dequant_kv(v_payload, v_scales, v_scale32)
    qr = q.to(torch.float32).reshape(b, hkv, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k) * (dh ** -0.5)
    if softcap:
        scores = softcap * torch.tanh(scores * (1.0 / softcap))
    kv_len = torch.as_tensor(lengths, dtype=torch.int32,
                             device=q.device).expand(b)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] < kv_len[:, None]
    if window > 0:
        mask &= kpos[None, :] > (kv_len - 1 - window)[:, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask[:, None, None], p, torch.zeros_like(p))
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(b, h, dh)


def attn_decode_split_plain(q, k_payload, k_scales, v_payload, v_scales,
                            lengths, *, window: int = 0, k_scale32=1.0,
                            v_scale32=1.0,
                            softcap: float = 0.0) -> torch.Tensor:
    """The kernel's split-S arithmetic in plain PyTorch (tests only): each
    split of a sequence's valid keys (``tuning.attn_split_range``) gives
    its softmax state (m, l, acc) over those keys alone; the states merge
    in split order (m = max m_i, weights exp(m_i - m)), and the output is
    acc / l where l > 0, zeros for a sequence with no valid key."""
    b, h, dh = q.shape
    s, hkv = k_payload.shape[1:3]
    g = h // hkv
    k = dequant_kv(k_payload, k_scales, k_scale32)
    v = dequant_kv(v_payload, v_scales, v_scale32)
    qr = q.to(torch.float32).reshape(b, hkv, g, dh)
    lens = torch.as_tensor(lengths, dtype=torch.int32).expand(b).tolist()
    out = torch.zeros((b, hkv, g, dh), dtype=torch.float32, device=q.device)
    for i, n in enumerate(lens):
        lo = max(0, n - window) if window > 0 else 0
        hi = min(n, s)
        parts = []
        for sp in tuning.attn_split_range(n, window, s):
            a = max(lo, sp * tuning.SPLIT_S)
            e = min(hi, (sp + 1) * tuning.SPLIT_S)
            sc = torch.einsum("kgd,skd->kgs", qr[i], k[i, a:e]) * (dh ** -0.5)
            if softcap:
                sc = softcap * torch.tanh(sc * (1.0 / softcap))
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgs,skd->kgd", p, v[i, a:e])))
        if not parts:
            continue
        m = torch.stack([m_i for m_i, _, _ in parts]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(out[i])
        for m_i, l_i, acc_i in parts:
            w = torch.exp(m_i - m)
            l = l + l_i * w
            acc = acc + acc_i * w
        out[i] = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, h, dh)


def mixfp4_attn_decode(q, k_payload, k_scales, v_payload, v_scales, lengths,
                       *, window: int = 0, k_scale32=1.0, v_scale32=1.0,
                       softcap: float = 0.0) -> torch.Tensor:
    """Decode attention -> (B, H, dh) f32.  CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    global launches
    b, h, dh = q.shape
    s, hkv, dh2 = k_payload.shape[1:]
    if dh != 2 * dh2 or dh % _G or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} vs packed K "
                         f"{tuple(k_payload.shape)}")
    for name, t, last in (("k_payload", k_payload, dh2),
                          ("v_payload", v_payload, dh2),
                          ("k_scales", k_scales, dh // _G),
                          ("v_scales", v_scales, dh // _G)):
        if tuple(t.shape) != (b, s, hkv, last) or t.dtype != torch.uint8:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{(b, s, hkv, last)} uint8")
    window = int(window)
    if q.device.type == "cpu":
        return attn_decode_plain(q, k_payload, k_scales, v_payload, v_scales,
                                 lengths, window=window, k_scale32=k_scale32,
                                 v_scale32=v_scale32, softcap=softcap)
    qf, lens, s32, out, scal = _launch_args(
        q, hkv, lengths, k_scale32, v_scale32, softcap,
        k_payload=k_payload, k_scales=k_scales, v_payload=v_payload,
        v_scales=v_scales)
    plan, work, counters = _plan(b, s, h, dh, q.device)
    err = _lib().mixfp4_attn_decode(
        qf.data_ptr(), k_payload.data_ptr(), k_scales.data_ptr(),
        v_payload.data_ptr(), v_scales.data_ptr(), lens.data_ptr(),
        s32.data_ptr(), out.data_ptr(), work, counters, b, s, h, hkv, dh,
        window, *plan, *scal,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_attn_decode launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def gather_pages(slab: torch.Tensor, block_tables: torch.Tensor):
    """Pool slab (P, page_len, ...) -> each sequence's logical rows
    (B, max_pages * page_len, ...) through its block-table row."""
    g = slab[block_tables.to(torch.int64)]
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def attn_decode_paged_plain(q, k_payload, k_scales, v_payload, v_scales,
                            block_tables, lengths, *, window: int = 0,
                            k_scale32=1.0, v_scale32=1.0,
                            softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel: gather each sequence's
    pages into the logical view, then :func:`attn_decode_plain`."""
    return attn_decode_plain(
        q, *[gather_pages(t, block_tables)
             for t in (k_payload, k_scales, v_payload, v_scales)],
        lengths, window=window, k_scale32=k_scale32, v_scale32=v_scale32,
        softcap=softcap)


def mixfp4_attn_decode_paged(q, k_payload, k_scales, v_payload, v_scales,
                             block_tables, lengths, *, window: int = 0,
                             k_scale32=1.0, v_scale32=1.0,
                             softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over the paged pool -> (B, H, dh) f32.  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    global launches_paged
    b, h, dh = q.shape
    n_pages, page_len, hkv, dh2 = k_payload.shape
    if dh != 2 * dh2 or dh % _G or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} vs packed K pages "
                         f"{tuple(k_payload.shape)}")
    if page_len % _G:
        raise ValueError(f"page_len={page_len} not a multiple of {_G}")
    for name, t, last in (("k_payload", k_payload, dh2),
                          ("v_payload", v_payload, dh2),
                          ("k_scales", k_scales, dh // _G),
                          ("v_scales", v_scales, dh // _G)):
        if (tuple(t.shape) != (n_pages, page_len, hkv, last)
                or t.dtype != torch.uint8):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{(n_pages, page_len, hkv, last)} uint8")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)}: "
                         f"expected ({b}, max_pages)")
    window = int(window)
    if q.device.type == "cpu":
        return attn_decode_paged_plain(
            q, k_payload, k_scales, v_payload, v_scales, block_tables,
            lengths, window=window, k_scale32=k_scale32,
            v_scale32=v_scale32, softcap=softcap)
    if block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables {block_tables.dtype}: expected "
                         "int32")
    qf, lens, s32, out, scal = _launch_args(
        q, hkv, lengths, k_scale32, v_scale32, softcap,
        k_payload=k_payload, k_scales=k_scales, v_payload=v_payload,
        v_scales=v_scales, block_tables=block_tables)
    max_pages = block_tables.shape[1]
    plan, work, counters = _plan(b, max_pages * page_len, h, dh, q.device)
    err = _lib().mixfp4_attn_decode_paged(
        qf.data_ptr(), k_payload.data_ptr(), k_scales.data_ptr(),
        v_payload.data_ptr(), v_scales.data_ptr(), block_tables.data_ptr(),
        lens.data_ptr(), s32.data_ptr(), out.data_ptr(), work, counters, b,
        max_pages, page_len, h, hkv, dh, window, *plan, *scal,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_attn_decode_paged launch failed: "
                           f"cudaError {err}")
    launches_paged += 1
    return out


def _launch_args(q, hkv, lengths, k_scale32, v_scale32, softcap,
                 **operands):
    """Checks and device arguments shared by both entries: the f32 query,
    (B,) int32 lengths, the two per-tensor scales, the output and the
    (scale, softcap, 1/softcap) f32 scalars."""
    b, h, dh = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if dh > 256:
        raise ValueError(f"kernel supports dh <= 256, got dh={dh}")
    for name, t in operands.items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    qf = q.to(torch.float32).contiguous()
    lens = torch.as_tensor(lengths, dtype=torch.int32,
                           device=q.device).expand(b).contiguous()
    s32 = torch.stack([
        torch.as_tensor(k_scale32, dtype=torch.float32,
                        device=q.device).reshape(()),
        torch.as_tensor(v_scale32, dtype=torch.float32,
                        device=q.device).reshape(())])
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.float32))
    inv_cap = float(torch.tensor(1.0 / softcap if softcap else 0.0,
                                 dtype=torch.float32))
    return qf, lens, s32, out, (scale, float(softcap), inv_cap)


#: per device: one zeroed counter per (sequence, kv head), which the
#: kernel leaves zero, and the f32 split workspace; grown, never shrunk,
#: and reused by every launch of both entries (one stream per device)
_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _plan(b: int, s_len: int, h: int, dh: int, device: torch.device):
    """The split plan of a cache of ``s_len`` logical rows and the
    workspace and counter pointers sized for it: B * Hkv * splits *
    (H/Hkv) * (dh + 2) floats, (m, l, acc) per head and split."""
    plan = tuning.attn_splits(s_len)
    need = b * h * (dh + 2) * plan.splits
    counters, work = _SCRATCH.get(device) or (None, None)
    if counters is None or counters.numel() < b * h:
        counters = torch.zeros(max(b * h, 4096), dtype=torch.int32,
                               device=device)
    if work is None or work.numel() < need:
        work = torch.empty(need, dtype=torch.float32, device=device)
    _SCRATCH[device] = counters, work
    return plan, work.data_ptr(), counters.data_ptr()


def _lib():
    lib = build.load("mixfp4_attn_decode")
    fixed, paged = lib.mixfp4_attn_decode, lib.mixfp4_attn_decode_paged
    if fixed.argtypes is None:
        fixed.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                          + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fixed.restype = ctypes.c_int
        paged.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                          + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        paged.restype = ctypes.c_int
    return lib
