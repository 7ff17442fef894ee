"""MixFP4 GEMMs over a packed weight, f32 out:

* W4A16: y (M, N) = bf16(x) (M, K) @ decode(W) * scale32;
* W4A16 over an expert stack: y[e] (C, N) = bf16(x[e]) @ decode(W[e]) *
  scale32[e] for every stored expert e, in one launch;
* W4A4: y = decode(X) @ decode(W) * x_scale32 * scale32, X packed rows;
* W4A4 fused: the same with X = quant(RHT?(x)) computed in the prologue
  from the dense rows x.

Counterpart of ``repro/kernels/mixfp4_gemm.py`` (``mixfp4_gemm_w4a16``,
``mixfp4_gemm_w4a4``, ``mixfp4_gemm_w4a4_fused``; the expert entry is
what the reference's ``lax.map`` of ``mixfp4_gemm_w4a16`` over an MoE
stack computes, ``repro/models/moe.py::_expert_ffn``).  The weight is payload
(K/2, NW) u8 with two K-adjacent nibbles per byte (low nibble = even row)
and scales (K/16, NW/16) u8, one per 16x16 tile; NW may exceed the logical
N (zero-padded storage).  Packed activations are payload (M, K/2) and
scales (M, K/16), 1-D g=16 blocks along K.  The wrappers launch
``csrc/mixfp4_gemm_w4a16.cu`` and ``csrc/mixfp4_gemm_w4a4.cu`` for CUDA
tensors and run the ``*_plain`` versions for CPU tensors.  All of them
decode value x block scale to bf16 (exact: at most 7 significant bits),
multiply with f32 accumulation, and apply the per-tensor or per-row scale
to the f32 result.  The fused prologue runs the row quantizer's own block
math, so fused == quantizer then W4A4, bitwise, on either device.

On the card, ``kernels/tuning.py`` picks the kernel variant and the K
split depth from (M, K): at M <= 64 the decode variant reduces its split
partials inside the one launch, through an f32 workspace and one counter
per column tile, both allocated once per device (the counters zeroed
then and left zero by every launch) and reused by every launch, so the
GEMMs of one device must run on one stream, as the port's do.  The
expert entry at C <= 64 rows per expert has a kernel of its own
(``csrc/mixfp4_gemm_experts.cuh``): one CTA per (expert, column tile)
walks the K splits of its tile in order and adds them in a sum it holds
itself, so it needs no workspace; a split whose activations are all
+-0 is skipped without reading its weight bytes
(:func:`gemm_w4a16_experts_walk` is that walk in plain PyTorch).  Its
column tile, threads and ring depth come from ``tuning.expert_plan``.
Above 64 rows it runs the prefill kernel with the expert as the grid's
third axis.  Either way each expert's rows are bitwise the 2-D entry's on
that expert's slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.fwht import fwht_rows_math
from repro_torch.kernels.mixfp4_quant import quant_block_math

__all__ = ["mixfp4_gemm_w4a16", "mixfp4_gemm_w4a16_experts",
           "mixfp4_gemm_w4a4", "mixfp4_gemm_w4a4_fused",
           "gemm_w4a16_plain", "gemm_w4a16_experts_plain",
           "gemm_w4a16_experts_walk",
           "gemm_w4a4_plain", "gemm_w4a4_fused_plain",
           "decode_weight_bf16", "decode_act_bf16", "combined_scale",
           "launches", "launches_experts",
           "launches_w4a4", "launches_w4a4_fused"]

_G = 16

#: kernel launches (CUDA path only), one count per kernel; read by
#: ``kernels.ops.launch_counts``
launches = 0
launches_experts = 0
launches_w4a4 = 0
launches_w4a4_fused = 0


def _decode_nibbles(nib: torch.Tensor, t_full: torch.Tensor) -> torch.Tensor:
    """Fig. 9 decode (the reference's shift-path arithmetic)."""
    sign = 1.0 - 2.0 * ((nib >> 3) & 1).to(torch.float32)
    p = (nib & 0x7).to(torch.float32)
    e = torch.floor(p * 0.5)
    mbit = p - 2.0 * e
    v_e2m1 = torch.where(p < 2.0, 0.5 * mbit,
                         torch.exp2(e - 1.0) * (1.0 + 0.5 * mbit))
    return sign * torch.where(t_full.to(torch.bool), p, v_e2m1)


def decode_weight_bf16(payload: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """(K/2, NW) payload + (K/16, NW/16) scale bytes -> bf16 (K, NW) with
    the block scales fused (scale32 not applied)."""
    k2, nw = payload.shape
    nib = torch.stack([payload & 0xF, (payload >> 4) & 0xF], dim=1).reshape(
        2 * k2, nw)
    s = (scales & 0x7F).contiguous().view(torch.float8_e4m3fn).to(
        torch.float32)
    t = scales >> 7
    s_full = s.repeat_interleave(_G, 0).repeat_interleave(_G, 1)
    t_full = t.repeat_interleave(_G, 0).repeat_interleave(_G, 1)
    return (_decode_nibbles(nib, t_full) * s_full).to(torch.bfloat16)


def decode_act_bf16(x_payload: torch.Tensor,
                    x_scales: torch.Tensor) -> torch.Tensor:
    """(M, K/2) payload + (M, K/16) scale bytes -> bf16 (M, K) with the
    1-D block scales fused (scale32 not applied)."""
    m, k2 = x_payload.shape
    nib = torch.stack([x_payload & 0xF, (x_payload >> 4) & 0xF],
                      dim=-1).reshape(m, 2 * k2)
    s = (x_scales & 0x7F).contiguous().view(torch.float8_e4m3fn).to(
        torch.float32)
    t = x_scales >> 7
    vals = _decode_nibbles(nib, t.repeat_interleave(_G, 1))
    return (vals * s.repeat_interleave(_G, 1)).to(torch.bfloat16)


def gemm_w4a16_plain(x: torch.Tensor, payload: torch.Tensor,
                     scales: torch.Tensor, scale32: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Plain PyTorch version: bf16 operands, f32 products and sums."""
    w = decode_weight_bf16(payload, scales)[:, :n_out]
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     w.to(torch.float32))
    return y * scale32.to(torch.float32)


def gemm_w4a16_experts_plain(x: torch.Tensor, payload: torch.Tensor,
                             scales: torch.Tensor, scale32: torch.Tensor,
                             n_out: int) -> torch.Tensor:
    """Plain PyTorch version of the expert entry: :func:`gemm_w4a16_plain`
    on each expert's slice, stacked (E, C, n_out)."""
    return torch.stack([gemm_w4a16_plain(x[e], payload[e], scales[e],
                                         scale32[e], n_out)
                        for e in range(x.shape[0])])


def gemm_w4a16_experts_walk(x: torch.Tensor, payload: torch.Tensor,
                            scales: torch.Tensor, scale32: torch.Tensor,
                            n_out: int, skip: bool = True) -> torch.Tensor:
    """The expert decode kernel's walk in plain PyTorch, for tests: per
    expert, each K split (``tuning.SPLIT_K`` deep, the last ending at K)
    summed from zero in f32 and added in split order to a zero sum, a split
    whose bf16 activations are all +-0 skipped (NaN and Inf count as
    non-zero; ``skip=False`` computes every split), the sum times scale32.
    Same function as :func:`gemm_w4a16_experts_plain`, up to the order of
    the f32 sums."""
    e, c, k = x.shape
    xb = x.to(torch.bfloat16)
    live = (xb.view(torch.int16) & 0x7FFF) != 0
    a = xb.to(torch.float32)
    w = torch.stack([decode_weight_bf16(payload[i], scales[i])[:, :n_out]
                     for i in range(e)]).to(torch.float32)
    acc = torch.zeros((e, c, n_out), dtype=torch.float32, device=x.device)
    for ks0 in range(0, k, tuning.SPLIT_K):
        sl = slice(ks0, min(ks0 + tuning.SPLIT_K, k))
        part = torch.bmm(a[:, :, sl], w[:, sl])
        take = live[:, :, sl].flatten(1).any(1) | (not skip)
        acc = torch.where(take[:, None, None], acc + part, acc)
    return acc * scale32.to(torch.float32).reshape(e, 1, 1)


def gemm_w4a4_plain(x_payload: torch.Tensor, x_scales: torch.Tensor,
                    out_s32: torch.Tensor, payload: torch.Tensor,
                    scales: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of the packed W4A4 kernel: both operands
    decoded to bf16, f32 products and sums, times ``out_s32`` (one value or
    (M, 1))."""
    a = decode_act_bf16(x_payload, x_scales).to(torch.float32)
    w = decode_weight_bf16(payload, scales)[:, :n_out].to(torch.float32)
    return torch.matmul(a, w) * out_s32


def gemm_w4a4_fused_plain(x: torch.Tensor, x_s32_rows: torch.Tensor,
                          out_s32: torch.Tensor, payload: torch.Tensor,
                          scales: torch.Tensor, n_out: int,
                          signs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel.  Its prologue: dense f32
    rows (M, K) -> the optional grouped RHT -> times 1/x_s32 (M, 1) ->
    Alg. 1 per 16-block -> bf16(q * s8), bitwise what the packed path
    decodes from the quantizer's bytes; then the packed kernel's product."""
    m, k = x.shape
    if signs is not None:
        x = fwht_rows_math(x, signs, _G)
    q, s8, _t = quant_block_math(
        (x * (1.0 / x_s32_rows)).reshape(m, k // _G, _G))
    a = (q * s8[..., None]).reshape(m, k).to(torch.bfloat16).to(
        torch.float32)
    w = decode_weight_bf16(payload, scales)[:, :n_out].to(torch.float32)
    return torch.matmul(a, w) * out_s32


def _check_weight(k: int, payload: torch.Tensor, scales: torch.Tensor,
                  n_out: int | None) -> int:
    """Validate a packed weight against the activations' K; returns n_out."""
    k2, nw = payload.shape
    n_out = nw if n_out is None else int(n_out)
    if k != 2 * k2 or k % _G or nw % _G or n_out > nw:
        raise ValueError(f"x K={k} vs payload {tuple(payload.shape)}, "
                         f"n_out={n_out}")
    if scales.shape != (k // _G, nw // _G):
        raise ValueError(f"scales {tuple(scales.shape)} vs payload "
                         f"{tuple(payload.shape)}")
    if payload.dtype != torch.uint8 or scales.dtype != torch.uint8:
        raise ValueError("payload and scales must be uint8")
    return n_out


def _on_card(device: torch.device, *tensors):
    """For a CUDA device: each (name, tensor) must be contiguous on it.
    Raises for a device that is neither the CPU nor CUDA."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector
    loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


#: per device: the decode variant's column-tile counters (zero between
#: launches) and its f32 split-partial workspace; grown, never shrunk, and
#: reused by every launch (the GEMMs of a device run on one stream)
_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _plan(m: int, k: int, n: int, device: torch.device) -> tuple:
    """The 2-D and W4A4 launchers' plan arguments: split_k, decode, and the
    decode variant's workspace and counters (None for the prefill
    variant)."""
    plan = tuning.select(m, k)
    if not plan.decode:
        return plan.split_k, 0, None, None
    tiles = -(-n // tuning.BN)
    need = plan.splits * m * tiles * tuning.BN
    counters, work = _SCRATCH.get(device) or (None, None)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 4096), dtype=torch.int32,
                               device=device)
    if work is None or work.numel() < need:
        work = torch.empty(need, dtype=torch.float32, device=device)
    _SCRATCH[device] = counters, work
    return plan.split_k, 1, work.data_ptr(), counters.data_ptr()


def combined_scale(x_scale32, scale32, m: int, per_row: bool,
               device) -> torch.Tensor:
    """The combined output scale x_s32 * w_s32 in f32, as the reference
    computes it: () per tensor, (M, 1) per row."""
    xs32 = torch.as_tensor(x_scale32, dtype=torch.float32, device=device)
    ws32 = torch.as_tensor(scale32, dtype=torch.float32,
                           device=device).reshape(())
    if per_row:
        return (xs32.reshape(-1).expand(m) * ws32).reshape(m, 1)
    return xs32.reshape(()) * ws32


def mixfp4_gemm_w4a16(x: torch.Tensor, payload: torch.Tensor,
                      scales: torch.Tensor, scale32: torch.Tensor, *,
                      n_out: int | None = None) -> torch.Tensor:
    """x (M, K) bf16/f32 with K = 2 * payload rows -> (M, n_out) f32.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    m, k = x.shape
    n_out = _check_weight(k, payload, scales, n_out)
    s32 = torch.as_tensor(scale32, dtype=torch.float32,
                          device=x.device).reshape(())
    if x.device.type == "cpu":
        return gemm_w4a16_plain(x, payload, scales, s32, n_out)
    _on_card(x.device, ("payload", payload), ("scales", scales))
    xb = _aligned(x.to(torch.bfloat16))   # one RNE rounding, as the
    s32 = s32.contiguous()                # reference does before its kernel
    payload = _aligned(payload)
    y = torch.empty((m, n_out), dtype=torch.float32, device=x.device)
    plan = _plan(m, k, n_out, x.device)
    err = _fn("mixfp4_gemm_w4a16", "mixfp4_gemm_w4a16")(
        xb.data_ptr(), payload.data_ptr(), scales.data_ptr(), s32.data_ptr(),
        y.data_ptr(), m, k, payload.shape[1], n_out, *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_gemm_w4a16 launch failed: cudaError {err}")
    launches += 1
    return y


def mixfp4_gemm_w4a16_experts(x: torch.Tensor, payload: torch.Tensor,
                              scales: torch.Tensor, scale32: torch.Tensor, *,
                              n_out: int | None = None) -> torch.Tensor:
    """Every expert of a stack in one launch: x (E, C, K) bf16/f32,
    payload (E, K/2, NW), scales (E, K/16, NW/16), scale32 (E,) ->
    (E, C, n_out) f32, expert e's rows bitwise :func:`mixfp4_gemm_w4a16`
    on its slice.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if x.ndim != 3 or payload.ndim != 3 or scales.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)}, payload "
                         f"{tuple(payload.shape)} and scales "
                         f"{tuple(scales.shape)} must be (E, ...) stacks")
    e, c, k = x.shape
    if payload.shape[0] != e or scales.shape[0] != e:
        raise ValueError(f"x holds {e} experts, payload "
                         f"{payload.shape[0]}, scales {scales.shape[0]}")
    n_out = _check_weight(k, payload[0], scales[0], n_out)
    s32 = torch.as_tensor(scale32, dtype=torch.float32, device=x.device)
    if s32.shape != (e,):
        raise ValueError(f"scale32 {tuple(s32.shape)}: expected ({e},)")
    if x.device.type == "cpu":
        return gemm_w4a16_experts_plain(x, payload, scales, s32, n_out)
    _on_card(x.device, ("payload", payload), ("scales", scales))
    return _experts_launch(x, payload, scales, s32, n_out)


def _experts_launch(x: torch.Tensor, payload: torch.Tensor,
                    scales: torch.Tensor, s32: torch.Tensor, n_out: int,
                    plan: tuning.ExpertPlan | None = None) -> torch.Tensor:
    """Launch the expert entry on checked card operands; the decode variant
    with ``plan`` (``tuning.expert_plan``'s when None; ``decode_study.py
    experts-sweep`` passes others)."""
    global launches_experts
    e, c, k = x.shape
    xb = _aligned(x.to(torch.bfloat16))   # one RNE rounding, as the 2-D entry
    s32 = s32.contiguous()
    payload = _aligned(payload)
    y = torch.empty((e, c, n_out), dtype=torch.float32, device=x.device)
    gemm = tuning.select(c, k)
    if gemm.decode and plan is None:
        plan = tuning.expert_plan(c, k, n_out)
    err = _fn("mixfp4_gemm_w4a16", "mixfp4_gemm_w4a16_experts")(
        xb.data_ptr(), payload.data_ptr(), scales.data_ptr(), s32.data_ptr(),
        y.data_ptr(), e, c, k, payload.shape[2], n_out, gemm.split_k,
        int(gemm.decode), *(plan if gemm.decode else (0, 0, 0)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_gemm_w4a16_experts launch failed: "
                           f"cudaError {err}")
    launches_experts += 1
    return y


def mixfp4_gemm_w4a4(x_payload: torch.Tensor, x_scales: torch.Tensor,
                     x_scale32, payload: torch.Tensor, scales: torch.Tensor,
                     scale32, *, per_row: bool = False,
                     n_out: int | None = None) -> torch.Tensor:
    """Packed activations x_payload (M, K/2), x_scales (M, K/16) times the
    packed weight -> (M, n_out) f32.  ``per_row`` reads ``x_scale32`` as an
    (M,) row-scale vector (each output row a function of its own row).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global launches_w4a4
    m, k2 = x_payload.shape
    k = 2 * k2
    n_out = _check_weight(k, payload, scales, n_out)
    if x_scales.shape != (m, k // _G) or x_payload.dtype != torch.uint8 \
            or x_scales.dtype != torch.uint8:
        raise ValueError(f"x_scales {tuple(x_scales.shape)} "
                         f"{x_scales.dtype} vs x_payload "
                         f"{tuple(x_payload.shape)} {x_payload.dtype}")
    out = combined_scale(x_scale32, scale32, m, per_row, x_payload.device)
    if x_payload.device.type == "cpu":
        return gemm_w4a4_plain(x_payload, x_scales, out, payload, scales,
                               n_out)
    _on_card(x_payload.device, ("x_scales", x_scales),
             ("payload", payload), ("scales", scales))
    xp, xs, out = _aligned(x_payload), _aligned(x_scales), out.contiguous()
    payload = _aligned(payload)
    y = torch.empty((m, n_out), dtype=torch.float32, device=xp.device)
    plan = _plan(m, k, n_out, xp.device)
    err = _fn("mixfp4_gemm_w4a4", "mixfp4_gemm_w4a4")(
        xp.data_ptr(), xs.data_ptr(), out.data_ptr(), int(per_row),
        payload.data_ptr(), scales.data_ptr(), y.data_ptr(), m, k,
        payload.shape[1], n_out, *plan,
        torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_gemm_w4a4 launch failed: cudaError {err}")
    launches_w4a4 += 1
    return y


def mixfp4_gemm_w4a4_fused(x: torch.Tensor, x_scale32, payload: torch.Tensor,
                           scales: torch.Tensor, scale32, *,
                           per_row: bool = False,
                           rht_signs: torch.Tensor | None = None,
                           n_out: int | None = None) -> torch.Tensor:
    """Dense rows x (M, K), already on the weight's packed K grid, quantized
    to MixFP4 in the prologue under ``x_scale32`` (per tensor, or (M,) with
    ``per_row``), times the packed weight -> (M, n_out) f32.  Bitwise the
    row quantizer followed by :func:`mixfp4_gemm_w4a4`.  ``rht_signs`` (K,)
    applies the grouped (16) RHT ahead of the quantizer; the caller derives
    the scale from the transformed rows and rotated the weight's K axis with
    the same signs at pack time.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    global launches_w4a4_fused
    m, k = x.shape
    n_out = _check_weight(k, payload, scales, n_out)
    if rht_signs is not None and tuple(rht_signs.shape) != (k,):
        raise ValueError(f"rht_signs must have shape ({k},), got "
                         f"{tuple(rht_signs.shape)}")
    dev = x.device
    x32 = x.to(torch.float32)
    xs32 = torch.as_tensor(x_scale32, dtype=torch.float32, device=dev)
    xs32 = xs32.reshape(-1).expand(m) if per_row else xs32.reshape(())
    out = combined_scale(xs32, scale32, m, per_row, dev)
    signs = None if rht_signs is None else rht_signs.to(torch.float32)
    if dev.type == "cpu":
        return gemm_w4a4_fused_plain(x32, xs32.reshape(-1, 1).expand(m, 1),
                                     out, payload, scales, n_out, signs)
    _on_card(dev, ("payload", payload), ("scales", scales),
             *(() if signs is None else (("rht_signs", signs),)))
    x32, xs32, out = _aligned(x32), xs32.contiguous(), out.contiguous()
    signs = None if signs is None else _aligned(signs)
    payload = _aligned(payload)
    y = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    plan = _plan(m, k, n_out, dev)
    err = _fn("mixfp4_gemm_w4a4", "mixfp4_gemm_w4a4_fused")(
        x32.data_ptr(), xs32.data_ptr(), out.data_ptr(), int(per_row),
        None if signs is None else signs.data_ptr(), payload.data_ptr(),
        scales.data_ptr(), y.data_ptr(), m, k, payload.shape[1], n_out,
        *plan, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mixfp4_gemm_w4a4_fused launch failed: "
                           f"cudaError {err}")
    launches_w4a4_fused += 1
    return y


# the plan arguments: split_k, decode, work, counters
_PLAN_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
_ARGTYPES = {
    # C function -> ctypes argument types
    "mixfp4_gemm_w4a16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + _PLAN_ARGS + [ctypes.c_void_p],
    "mixfp4_gemm_w4a16_experts": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "mixfp4_gemm_w4a4": [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + _PLAN_ARGS
    + [ctypes.c_void_p],
    "mixfp4_gemm_w4a4_fused": [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + _PLAN_ARGS
    + [ctypes.c_void_p],
}


_FNS: dict[str, ctypes._CFuncPtr] = {}


def _fn(source: str, fn_name: str):
    """The C entry ``fn_name`` of ``source``'s library, typed; looked up
    once (each wrapper call is on the decode step's host path)."""
    fn = _FNS.get(fn_name)
    if fn is None:
        fn = getattr(build.load(source), fn_name)
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
        _FNS[fn_name] = fn
    return fn
