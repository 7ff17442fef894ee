"""Smoke test of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the script exits non-zero):

1. build every CUDA kernel of the served paths from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at
   gemma2-2b shapes, and time kernel, plain version and one library call;
   the fused W4A4 kernel must also equal the quantizer followed by the
   packed W4A4 kernel bitwise;
3. serve six greedy requests through ``ServeEngine`` for gemma2-2b at full
   width (26 layers, packed MixFP4 weights from seeded random values,
   packed MixFP4 KV cache) on the W4A16 path, check that every launch
   counter equals what the path implies, then trace five decode steps at
   ~1024 tokens of context with ``torch.profiler`` (device time by kernel,
   device-busy share);
3b. the same on the W4A4 path (``act_quant="mixfp4", act_rht=True``);
4. run gemma2-2b at full width cut to 2 layers on the card and on the CPU
   (plain versions) from the same packed bytes, and compare the logits;
4b. the same on the W4A4 + RHT path, where the card's fused and two-pass
   (``"mixfp4-2pass-rowscale"``) logits must also be bitwise equal.

Each kernel's launch count comes from the path run that drives it, with
the counts set to 0 just before that run.  The line before the last is a
JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core rate
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
GEMMA_PAIRS = [(2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304)]   # distinct (K, N); wk/wv and up/gate repeat
# one decode layer's projections: wq, wk, wv, wo, w_gate, w_up, w_down
LAYER = [(2304, 2048), (2304, 1024), (2304, 1024), (2048, 2304),
         (2304, 9216), (2304, 9216), (9216, 2304)]
CHECK_MS = (1, 4, 64, 4544)    # decode batches and a 4544-row prefill
PREFILL_M = 4544


def log(msg: str):
    print(msg, flush=True)


def bench(fn, reps: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median ms of ``fn`` on the card by CUDA events, after a warm-up.
    ``flush`` (a large buffer) is rewritten before each rep so the L2 cache
    is cold, as it is for the weights on the served path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, ops_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_quant(dev, flush) -> dict:
    from repro_torch.kernels import mixfp4_quant as Q
    from repro_torch.models.base import KV_SCALE32

    rng = np.random.RandomState(1)
    worst = 0
    for m in (4, 16, 4 * 4544):
        x = np.concatenate([rng.randn(m // 2, 256),
                            rng.standard_t(2, (m - m // 2, 256))])
        x[::3] = 0.0                                    # all-zero rows
        xt = torch.tensor(x, dtype=torch.float32, device=dev)
        for kw in ({"scale32": KV_SCALE32}, {}, {"per_row": True}):
            p, s, s32 = Q.mixfp4_quant_rows(xt, **kw)
            s32p = Q.derive_scale32(xt, kw.get("scale32"),
                                    kw.get("per_row", False))
            pp, sp = Q.quant_rows_plain(xt, s32p.reshape(-1, 1).expand(m, 1))
            torch.cuda.synchronize()
            bad = int((p != pp).sum() + (s != sp).sum()
                      + (s32 != s32p).sum())
            worst = max(worst, bad)
            if bad:
                raise AssertionError(f"quant M={m} {kw}: {bad} bytes differ")
    log(f"[quant] M in (4, 16, 18176) x K=256, normal/Student-t/zero rows, "
        f"pinned/per-tensor/per-row scale: bitwise equal")
    m = 16                                              # decode: B * Hkv
    x = torch.randn(m, 256, device=dev)
    ones = torch.ones(m, 1, device=dev)
    ms = bench(lambda: Q.mixfp4_quant_rows(x, scale32=KV_SCALE32), 200,
               flush)
    plain_ms = bench(lambda: Q.quant_rows_plain(x, ones), 50, flush)
    xb = torch.randn(4 * 4544, 256, device=dev)
    ms_pre = bench(lambda: Q.mixfp4_quant_rows(xb, scale32=KV_SCALE32), 50,
                   flush)
    b_ms, b_by = bound(m * 256 * 4 + m * 128 + m * 16, 0, F32_OPS_PER_S)
    bp_ms, _ = bound(xb.numel() * (4 + 0.5 + 1 / 16), 0, F32_OPS_PER_S)
    log(f"[quant] decode M=16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms; prefill M=18176: kernel {ms_pre:.4f} ms, "
        f"bound {bp_ms:.4f} ms")
    return {"name": "mixfp4_quant_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_quant.cu",
            "replaces": "src/repro/kernels/mixfp4_quant.py:148",
            "max_abs_err": float(worst), "tolerance": "bitwise",
            "shape": "M=16 (B*Hkv), K=256, pinned scale32",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def check_gemm(dev, flush) -> dict:
    from repro_torch.core import qtensor
    from repro_torch.kernels import mixfp4_gemm as G

    gen = torch.Generator(device=dev).manual_seed(2)
    weights = {}
    worst = 0.0
    for k, n in GEMMA_PAIRS:
        w = torch.randn(k, n, device=dev, generator=gen) / math.sqrt(k)
        weights[(k, n)] = qtensor.quantize(
            w, qtensor.QuantSpec("mixfp4", qtensor.BlockLayout2D()))
        qt = weights[(k, n)]
        for m in (1, 4, 64, 4544):
            x = torch.randn(m, k, device=dev, generator=gen)
            y = G.mixfp4_gemm_w4a16(x, qt.payload, qt.scales, qt.scale32)
            yp = G.gemm_w4a16_plain(x, qt.payload, qt.scales, qt.scale32, n)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max() / yp.abs().max())
            worst = max(worst, err)
            if not err <= 1e-3:
                raise AssertionError(f"W4A16 K={k} N={n} M={m}: normalised "
                                     f"error {err}")
    log(f"[w4a16] 5 (K, N) pairs x M in (1, 4, 64, 4544): max error "
        f"normalised by max|plain| {worst:.3e} (tolerance 1e-3)")

    # one decode layer at M = 4
    m = 4
    layer = LAYER
    xs = {k: torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
          for k in (2048, 2304, 9216)}
    dense = {kn: G.decode_weight_bf16(qt.payload, qt.scales)
             for kn, qt in weights.items()}

    def run(fn):
        return lambda: [fn(xs[k], (k, n)) for k, n in layer]

    kern = run(lambda x, kn: G.mixfp4_gemm_w4a16(
        x, weights[kn].payload, weights[kn].scales, weights[kn].scale32))
    plain = run(lambda x, kn: G.gemm_w4a16_plain(
        x, weights[kn].payload, weights[kn].scales, weights[kn].scale32,
        kn[1]))
    lib = run(lambda x, kn: torch.matmul(x, dense[kn]))
    ms = bench(kern, 20, flush)
    plain_ms = bench(plain, 10, flush)
    lib_ms = bench(lib, 20, flush)
    n_bytes = sum(k * n / 2 + k * n / 256 + m * k * 2 + m * n * 4
                  for k, n in layer)
    n_ops = sum(2 * m * k * n for k, n in layer)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    for k, n in GEMMA_PAIRS:
        qt = weights[(k, n)]
        x = torch.randn(4544, k, device=dev, generator=gen)
        t = bench(lambda: G.mixfp4_gemm_w4a16(x, qt.payload, qt.scales,
                                              qt.scale32), 5, flush)
        log(f"[w4a16] prefill M=4544 K={k} N={n}: {t:.3f} ms "
            f"({2 * 4544 * k * n / t / 1e9:.1f} TFLOP/s)")
    log(f"[w4a16] one decode layer (7 projections, M=4): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.matmul on the decoded bf16 weight "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "mixfp4_gemm_w4a16", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_gemm_w4a16.cu",
            "replaces": "src/repro/kernels/mixfp4_gemm.py:300",
            "max_abs_err": worst, "tolerance": "1e-3 of max|plain|",
            "shape": "7 projections of one layer, M=4",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def check_attn(dev, flush) -> dict:
    from repro_torch.kernels import mixfp4_attn as A
    from repro_torch.models.base import quantize_kv_rows

    b, s, hkv, h, dh = 4, 8192, 4, 8, 256
    gen = torch.Generator(device=dev).manual_seed(3)
    kp, ks = quantize_kv_rows(torch.randn(b, s, hkv, dh, device=dev,
                                          generator=gen))
    vp, vs = quantize_kv_rows(torch.randn(b, s, hkv, dh, device=dev,
                                          generator=gen))
    q = torch.randn(b, h, dh, device=dev, generator=gen)
    lengths = torch.tensor(
        np.random.RandomState(4).randint(1, s + 1, (b,)), dtype=torch.int32,
        device=dev)
    lengths[0] = s
    worst = 0.0
    for window in (4096, 0):
        o = A.mixfp4_attn_decode(q, kp, ks, vp, vs, lengths, window=window,
                                 softcap=50.0)
        op = A.attn_decode_plain(q, kp, ks, vp, vs, lengths, window=window,
                                 softcap=50.0)
        torch.cuda.synchronize()
        err = float((o - op).abs().max())
        worst = max(worst, err)
        if not err <= 1e-4:
            raise AssertionError(f"attention window={window}: error {err}")
    log(f"[attn] B=4 S=8192 lengths {lengths.tolist()} window 4096 and 0, "
        f"softcap 50: max abs error {worst:.3e} (tolerance 1e-4)")

    kern = lambda: A.mixfp4_attn_decode(q, kp, ks, vp, vs, lengths,
                                        window=0, softcap=50.0)
    plain = lambda: A.attn_decode_plain(q, kp, ks, vp, vs, lengths,
                                        window=0, softcap=50.0)
    ms = bench(kern, 20, flush)
    plain_ms = bench(plain, 5, flush)
    ms_local = bench(lambda: A.mixfp4_attn_decode(
        q, kp, ks, vp, vs, lengths, window=4096, softcap=50.0), 20, flush)
    # yardstick: SDPA over the dequantized cache (same masks, no softcap)
    kd = A.dequant_kv(kp, ks, 1.0).transpose(1, 2)
    vd = A.dequant_kv(vp, vs, 1.0).transpose(1, 2)
    mask = (torch.arange(s, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    lib_ms = bench(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True), 20, flush)
    rows = int(lengths.clamp(max=s).sum())
    n_bytes = (2 * rows * hkv * (dh // 2 + dh // 16) + b * h * dh * 8
               + b * 4)
    n_ops = 4 * rows * (h // hkv) * hkv * dh
    b_ms, b_by = bound(n_bytes, n_ops, F32_OPS_PER_S)
    log(f"[attn] global layer: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA on the dequantized f32 cache (no softcap) {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); local layer (window 4096): kernel "
        f"{ms_local:.4f} ms")
    return {"name": "mixfp4_attn_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_attn_decode.cu",
            "replaces": "src/repro/kernels/mixfp4_attn.py:174",
            "max_abs_err": worst, "tolerance": "1e-4 absolute",
            "shape": f"B=4 S=8192 lengths {lengths.tolist()}, window 0",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def _rows_like_activations(m: int, k: int, dev, gen) -> torch.Tensor:
    """Rows with a spread of magnitudes (and, from M = 4 on, one all-zero
    row, whose scale is the guard value 1), as activations have."""
    x = torch.randn(m, k, device=dev, generator=gen) * torch.exp(
        2 * torch.rand(m, 1, device=dev, generator=gen))
    if m >= 4:
        x[m // 2] = 0.0
    return x


def check_w4a4(dev, flush) -> list[dict]:
    from repro_torch.core import qtensor, scaling
    from repro_torch.kernels import fwht
    from repro_torch.kernels import mixfp4_gemm as G
    from repro_torch.models.base import rht_signs_on_grid

    gen = torch.Generator(device=dev).manual_seed(5)
    weights = {}
    worst = {"packed": 0.0, "fused": 0.0}
    n_equal = 0
    for k, n in GEMMA_PAIRS:
        w = torch.randn(k, n, device=dev, generator=gen) / math.sqrt(k)
        qt = weights[(k, n)] = qtensor.quantize(
            w, qtensor.QuantSpec("mixfp4", qtensor.BlockLayout2D()))
        signs = rht_signs_on_grid(k, k, dev)
        for m in CHECK_MS:
            x = _rows_like_activations(m, k, dev, gen)
            for per_row in (False, True):
                qx = qtensor.quantize_rows(x, per_row=per_row)
                y = G.mixfp4_gemm_w4a4(qx.payload, qx.scales, qx.scale32,
                                       qt.payload, qt.scales, qt.scale32,
                                       per_row=per_row)
                yp = G.gemm_w4a4_plain(
                    qx.payload, qx.scales, G.combined_scale(
                        qx.scale32, qt.scale32, m, per_row, dev),
                    qt.payload, qt.scales, n)
                worst["packed"] = max(worst["packed"],
                                      _gemm_err(y, yp, "W4A4", k, n, m))
            for per_row, rht in ((False, False), (True, False),
                                 (True, True)):
                sg = signs if rht else None
                xt = fwht.fwht_rows(x, sg) if rht else x
                s32 = (scaling.row_scale(xt) if per_row
                       else scaling.tensor_scale(x))
                y = G.mixfp4_gemm_w4a4_fused(x, s32, qt.payload, qt.scales,
                                             qt.scale32, per_row=per_row,
                                             rht_signs=sg)
                yp = G.gemm_w4a4_fused_plain(
                    x, s32.reshape(-1, 1).expand(m, 1), G.combined_scale(
                        s32, qt.scale32, m, per_row, dev),
                    qt.payload, qt.scales, n, sg)
                worst["fused"] = max(worst["fused"],
                                     _gemm_err(y, yp, "fused", k, n, m))
                if per_row:
                    two = qtensor.qmm(qtensor.quantize_rows(xt, per_row=True),
                                      qt)
                    if not torch.equal(y, two):
                        raise AssertionError(
                            f"fused != quantizer + W4A4 at K={k} N={n} M={m}"
                            f" rht={rht}")
                    n_equal += 1
    log(f"[w4a4] {len(GEMMA_PAIRS)} (K, N) pairs x M in {CHECK_MS}: packed "
        f"(per tensor, per row) max error normalised by max|plain| "
        f"{worst['packed']:.3e}; fused (per tensor, per row, per row + RHT) "
        f"{worst['fused']:.3e} (tolerance 1e-3); fused == quantizer + W4A4 "
        f"bitwise in {n_equal}/{n_equal} per-row cases (RHT in half)")

    # one decode layer at M = 4, per-row scales, RHT on the fused kernel
    m = 4
    xs = {k: _rows_like_activations(m, k, dev, gen) for k, _ in LAYER}
    sg = {k: rht_signs_on_grid(k, k, dev) for k in xs}
    xt = {k: fwht.fwht_rows(x, sg[k]) for k, x in xs.items()}
    s32 = {k: scaling.row_scale(x) for k, x in xt.items()}
    qx = {k: qtensor.quantize_rows(x, per_row=True) for k, x in xt.items()}
    dense_w = {kn: G.decode_weight_bf16(qt.payload, qt.scales)
               for kn, qt in weights.items()}
    dense_x = {k: G.decode_act_bf16(q.payload, q.scales)
               for k, q in qx.items()}
    out = {kn: G.combined_scale(s32[kn[0]], qt.scale32, m, True, dev)
           for kn, qt in weights.items()}

    def run(fn):
        return lambda: [fn(k, n, weights[(k, n)]) for k, n in LAYER]

    packed = run(lambda k, n, qt: G.mixfp4_gemm_w4a4(
        qx[k].payload, qx[k].scales, qx[k].scale32, qt.payload, qt.scales,
        qt.scale32, per_row=True))
    packed_plain = run(lambda k, n, qt: G.gemm_w4a4_plain(
        qx[k].payload, qx[k].scales, out[(k, n)], qt.payload, qt.scales, n))
    fused = run(lambda k, n, qt: G.mixfp4_gemm_w4a4_fused(
        xs[k], s32[k], qt.payload, qt.scales, qt.scale32, per_row=True,
        rht_signs=sg[k]))
    fused_plain = run(lambda k, n, qt: G.gemm_w4a4_fused_plain(
        xs[k], s32[k].reshape(-1, 1), out[(k, n)], qt.payload, qt.scales, n,
        sg[k]))
    lib = run(lambda k, n, qt: torch.matmul(dense_x[k], dense_w[(k, n)]))
    times = {name: bench(fn, reps, flush) for name, fn, reps in (
        ("packed", packed, 20), ("packed_plain", packed_plain, 10),
        ("fused", fused, 20), ("fused_plain", fused_plain, 5),
        ("lib", lib, 20))}
    w_bytes = sum(k * n / 2 + k * n / 256 + m * n * 4 for k, n in LAYER)
    n_ops = sum(2 * m * k * n for k, n in LAYER)
    b_packed = bound(w_bytes + sum(m * (k / 2 + k / 16) for k, _ in LAYER),
                     n_ops, BF16_OPS_PER_S)
    b_fused = bound(w_bytes + sum(m * k * 4 + k * 4 + m * 4
                                  for k, _ in LAYER), n_ops, BF16_OPS_PER_S)
    for k, n in GEMMA_PAIRS:
        qt = weights[(k, n)]
        x = _rows_like_activations(PREFILL_M, k, dev, gen)
        q = qtensor.quantize_rows(x, per_row=True)
        r = scaling.row_scale(fwht.fwht_rows(x, sg[k]))
        t_p = bench(lambda: G.mixfp4_gemm_w4a4(
            q.payload, q.scales, q.scale32, qt.payload, qt.scales,
            qt.scale32, per_row=True), 5, flush)
        t_f = bench(lambda: G.mixfp4_gemm_w4a4_fused(
            x, r, qt.payload, qt.scales, qt.scale32, per_row=True,
            rht_signs=sg[k]), 5, flush)
        flops = 2 * PREFILL_M * k * n
        log(f"[w4a4] prefill M={PREFILL_M} K={k} N={n}: packed {t_p:.3f} ms "
            f"({flops / t_p / 1e9:.1f} TFLOP/s), fused + RHT {t_f:.3f} ms "
            f"({flops / t_f / 1e9:.1f} TFLOP/s)")
    log(f"[w4a4] one decode layer (7 projections, M=4, per-row scales): "
        f"packed kernel {times['packed']:.4f} ms, plain "
        f"{times['packed_plain']:.4f} ms, bound {b_packed[0]:.4f} ms "
        f"({b_packed[1]}); fused + RHT kernel {times['fused']:.4f} ms, plain "
        f"{times['fused_plain']:.4f} ms, bound {b_fused[0]:.4f} ms "
        f"({b_fused[1]}); torch.matmul on the decoded bf16 operands "
        f"{times['lib']:.4f} ms")
    common = {"route": "cuda",
              "source": "src/repro_torch/csrc/mixfp4_gemm_w4a4.cu",
              "tolerance": "1e-3 of max|plain|", "library_ms": times["lib"]}
    return [dict(common, name="mixfp4_gemm_w4a4",
                 replaces="src/repro/kernels/mixfp4_gemm.py:330",
                 max_abs_err=worst["packed"],
                 shape="7 projections of one layer, M=4, per-row scales",
                 ms=times["packed"], plain_ms=times["packed_plain"],
                 bound_ms=b_packed[0], bound_by=b_packed[1]),
            dict(common, name="mixfp4_gemm_w4a4_fused",
                 replaces="src/repro/kernels/mixfp4_gemm.py:380",
                 max_abs_err=worst["fused"],
                 shape="7 projections of one layer, M=4, per-row + RHT",
                 ms=times["fused"], plain_ms=times["fused_plain"],
                 bound_ms=b_fused[0], bound_by=b_fused[1])]


def _gemm_err(y, yp, what: str, k: int, n: int, m: int) -> float:
    torch.cuda.synchronize()
    err = float((y - yp).abs().max() / yp.abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"{what} K={k} N={n} M={m}: normalised error "
                             f"{err}")
    return err


def check_fwht(dev, flush) -> dict:
    from repro_torch.kernels import fwht
    from repro_torch.models.base import rht_signs_on_grid

    gen = torch.Generator(device=dev).manual_seed(6)
    for k in sorted({k for k, _ in LAYER}):
        sg = rht_signs_on_grid(k, k, dev)
        for m in CHECK_MS:
            x = _rows_like_activations(m, k, dev, gen)
            if not torch.equal(fwht.fwht_rows(x, sg),
                               fwht.fwht_rows_math(x, sg, 16)):
                raise AssertionError(f"fwht_rows M={m} K={k} not bitwise")
    log(f"[fwht] M in {CHECK_MS} x K in (2048, 2304, 9216), group 16: "
        f"bitwise equal to the plain version")
    m = 4                                    # one decode layer's 7 launches
    xs = {k: _rows_like_activations(m, k, dev, gen) for k, _ in LAYER}
    sg = {k: rht_signs_on_grid(k, k, dev) for k in xs}
    hadamard16 = torch.ones(1, 1, device=dev)
    while hadamard16.shape[0] < 16:
        hadamard16 = torch.cat([torch.cat([hadamard16, hadamard16], 1),
                                torch.cat([hadamard16, -hadamard16], 1)])
    hadamard16 = hadamard16 * 0.25
    signed = {k: (x * sg[k]).reshape(-1, 16) for k, x in xs.items()}
    ks = [k for k, _ in LAYER]
    ms = bench(lambda: [fwht.fwht_rows(xs[k], sg[k]) for k in ks], 50, flush)
    plain_ms = bench(lambda: [fwht.fwht_rows_math(xs[k], sg[k], 16)
                              for k in ks], 20, flush)
    lib_ms = bench(lambda: [torch.matmul(signed[k], hadamard16)
                            for k in ks], 50, flush)
    b_ms, b_by = bound(sum(2 * m * k * 4 + k * 4 for k in ks),
                       sum(m * k * 6 for k in ks), F32_OPS_PER_S)
    kb = max(k for k, _ in LAYER)
    xb = _rows_like_activations(PREFILL_M, kb, dev, gen)
    sgb = rht_signs_on_grid(kb, kb, dev)
    ms_pre = bench(lambda: fwht.fwht_rows(xb, sgb), 20, flush)
    bp_ms, _ = bound(2 * xb.numel() * 4, 0, F32_OPS_PER_S)
    log(f"[fwht] one decode layer's 7 launches (M=4): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.matmul of the signed rows with "
        f"H16/4 (not bitwise) {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
        f"prefill M={PREFILL_M} K={kb}: kernel {ms_pre:.4f} ms, bound "
        f"{bp_ms:.4f} ms")
    return {"name": "fwht_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/fwht_rows.cu",
            "replaces": "src/repro/kernels/fwht.py:55",
            "max_abs_err": 0.0, "tolerance": "bitwise",
            "shape": "7 launches of one decode layer, M=4, group 16",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# phase 3: the served path at full width
# ---------------------------------------------------------------------------
def serve_path(dev, seed: int, **act) -> dict:
    """Serve six greedy requests at full width and depth with the engine
    options ``act`` (the W4A16 path without them); check every launch
    counter against what the path implies; trace a decode window."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = configs.config("gemma2-2b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed, device=dev)
    engine = ServeEngine(cfg, params, batch_size=4, max_len=8192,
                         kv_quant="mixfp4", device=dev, **act)
    del params
    torch.cuda.synchronize()
    tag = "[serve]" if not act else "[serve-w4a4]"
    log(f"{tag} gemma2-2b, {cfg.n_layers} layers at full width, act_quant="
        f"{engine.act_quant}, act_rht={engine.act_rht}: init + pack "
        f"{time.perf_counter() - t0:.1f} s; packed projection bytes "
        f"{engine.packed_bytes} ({engine.compression:.2f}x below bf16); "
        f"packed KV cache bytes {engine.kv_cache_bytes()} "
        f"(B=4, max_len=8192)")
    rng = np.random.RandomState(seed)
    lens = [int(v) for v in rng.randint(9, 301, 5)] + [4500]
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab, n).astype(
        np.int32), max_new_tokens=32) for i, n in enumerate(lens)]
    pending = list(reqs)
    ops.reset_launch_counts()
    step_ms, prefill_ms, n_tok = [], [], 0
    t_start = time.perf_counter()
    while pending or engine.has_work():
        while pending:
            t = time.perf_counter()
            if not engine.add_request(pending[0]):
                break
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t) * 1e3)
            pending.pop(0)
        t = time.perf_counter()
        steps_before = engine.decode_steps
        n_tok += len(engine.step())
        if engine.decode_steps > steps_before:
            step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = ops.launch_counts()
    n_pre, n_dec, n_l = engine.admissions, engine.decode_steps, cfg.n_layers
    per_pass = {name: 0 for name in counts}      # launches per model pass
    per_pass["mixfp4_quant_rows"] = 2 * n_l      # the new K and V rows
    if engine.act_quant == "bf16":
        per_pass["mixfp4_gemm_w4a16"] = 7 * n_l
    else:                                        # "mixfp4" + RHT
        per_pass["mixfp4_gemm_w4a4_fused"] = 7 * n_l
        per_pass["fwht_rows"] = 7 * n_l          # the per-row scales
    want = {name: c * (n_pre + n_dec) for name, c in per_pass.items()}
    want["mixfp4_attn_decode"] = n_l * n_dec     # decode passes only
    for r in reqs:
        if len(r.generated) != 32 or r.finish_reason != "max_new_tokens":
            raise AssertionError(f"request {r.uid} (prompt {len(r.prompt)}): "
                                 f"{len(r.generated)} tokens, "
                                 f"{r.finish_reason}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    log(f"{tag} prompts {lens}, 32 new tokens each: {n_tok} tokens in "
        f"{wall:.2f} s ({n_tok / wall:.1f} tok/s); {n_pre} prefills "
        f"(median {statistics.median(prefill_ms):.1f} ms, max "
        f"{max(prefill_ms):.1f} ms), {n_dec} decode steps (median "
        f"{statistics.median(step_ms):.2f} ms); every logit row, prefill "
        f"and decode, finite")
    log(f"{tag} launches {counts}; per prefill pass "
        f"{ {k: v for k, v in per_pass.items() if v} }, per decode pass the "
        f"same plus {n_l} attention launches")
    profile_decode(engine, seed, tag)
    return counts


def profile_decode(engine, seed: int, tag: str):
    """Fill every slot with a 1024-token prompt, then trace five decode
    steps with ``torch.profiler``: device time by kernel, and the share of
    the traced window in which the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    steps = 5
    rng = np.random.RandomState(seed + 2)
    for i in range(engine.batch_size):
        engine.add_request(Request(
            uid=100 + i, prompt=rng.randint(0, engine.cfg.vocab, 1024).astype(
                np.int32), max_new_tokens=steps + 8))
    for _ in range(3):                     # first-token emission + warm-up
        engine.step()
    torch.cuda.synchronize()
    step_ms = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_win = time.perf_counter()
        for _ in range(steps):
            t = time.perf_counter()
            engine.step()
            step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        win_ms = (time.perf_counter() - t_win) * 1e3
    while engine.has_work():
        engine.step()
    # device rows only: an aten:: row also carries the device time of the
    # kernels it launched, and those have rows of their own
    by_kernel = {ev.key: (ev.self_device_time_total / 1e3 / steps,
                          ev.count // steps)
                 for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA
                 and ev.self_device_time_total > 0}
    busy = sum(ms for ms, _ in by_kernel.values()) * steps
    log(f"[profile] {tag} B={engine.batch_size}, ~1024 tokens of context: "
        f"{steps} decode steps, median {statistics.median(step_ms):.2f} "
        f"ms/step; "
        f"device busy {busy:.2f} of {win_ms:.2f} ms "
        f"({100 * busy / win_ms:.1f} %)")
    for name, (ms, calls) in sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile] {ms:9.4f} ms/step {calls:5d} launches/step  "
            f"{name[:90]}")


# ---------------------------------------------------------------------------
# phase 4: card vs CPU on the same packed bytes
# ---------------------------------------------------------------------------
def card_vs_cpu(dev, seed: int, w4a4: bool = False) -> dict:
    """gemma2-2b at full width cut to 2 layers, on the card and on the CPU
    from the same packed bytes: W4A16, or with ``w4a4`` the fused W4A4 +
    RHT path, whose card logits must also equal the two-pass spelling's
    bitwise.  Returns the launch counts of the two-pass card run (the
    path that drives the packed W4A4 kernel), or {}."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.base import ActQuant, pack_projections

    cfg = configs.config("gemma2-2b").replace(n_layers=2)
    model = build_model(cfg)
    packed, _, _ = pack_projections(model.init(seed, device=dev),
                                    act_rht=w4a4)
    act = ActQuant("mixfp4", rht=True) if w4a4 else ActQuant()

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.to("cpu")

    packed_cpu = to_cpu(packed)
    rng = np.random.RandomState(seed + 1)
    prompt = rng.randint(0, cfg.vocab, 64)
    forced = rng.randint(0, cfg.vocab, 4)

    def run(params, device, act):
        cache = model.init_cache(1, 128, kv_quant="mixfp4", device=device)
        toks = torch.tensor(prompt[None], device=device)
        logits, cache = model.prefill_slot(params, toks, cache, 0, act=act)
        out = [logits.float().cpu()]
        for i, tok in enumerate(forced):
            logits, cache = model.decode_step(
                params, torch.tensor([tok], device=device), cache,
                torch.tensor([64 + i], device=device), act=act)
            out.append(logits.float().cpu())
        return torch.cat(out)

    ops.reset_launch_counts()
    gpu = run(packed, dev, act)
    used = {k: v for k, v in ops.launch_counts().items() if v}
    if w4a4 and set(used) != {"mixfp4_quant_rows", "mixfp4_attn_decode",
                              "mixfp4_gemm_w4a4_fused", "fwht_rows"} or \
            not w4a4 and set(used) != {"mixfp4_quant_rows",
                                       "mixfp4_attn_decode",
                                       "mixfp4_gemm_w4a16"}:
        raise AssertionError(f"the card run took other kernels: {used}")
    cpu = run(packed_cpu, torch.device("cpu"), act)
    if not torch.isfinite(gpu).all():
        raise AssertionError("non-finite logits on the card")
    err = float(((gpu - cpu).abs() / cpu.abs().max()).max())
    agree = int((gpu.argmax(-1) == cpu.argmax(-1)).sum())
    if not err <= 2e-2:
        raise AssertionError(f"card vs CPU logits: normalised error {err}")
    tag = "[card-vs-cpu-w4a4]" if w4a4 else "[card-vs-cpu]"
    log(f"{tag} gemma2-2b width, 2 layers, act_quant={act.mode}, "
        f"act_rht={act.rht}: prefill of 64 tokens + 4 teacher-forced decode "
        f"steps; logits normalised by max|CPU| agree to {err:.3e} "
        f"(tolerance 2e-2); argmax agrees on {agree}/5 rows")
    if not w4a4:
        return {}
    ops.reset_launch_counts()
    two = run(packed, dev, ActQuant("mixfp4-2pass-rowscale", rht=True))
    counts = ops.launch_counts()
    n_l, passes = cfg.n_layers, 1 + len(forced)
    want = {"mixfp4_quant_rows": 9 * n_l * passes, "mixfp4_gemm_w4a16": 0,
            "mixfp4_attn_decode": n_l * len(forced),
            "mixfp4_gemm_w4a4": 7 * n_l * passes,
            "mixfp4_gemm_w4a4_fused": 0, "fwht_rows": 7 * n_l * passes}
    if counts != want:
        raise AssertionError(f"two-pass launch counts {counts}, expected "
                             f"{want}")
    if not torch.equal(gpu, two):
        raise AssertionError("fused and two-pass (mixfp4-2pass-rowscale) "
                             "logits differ on the card")
    log(f"{tag} fused == mixfp4-2pass-rowscale logits on the card, bitwise; "
        f"the two-pass run launched {counts}")
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(report)})")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    kernels = [check_quant(dev, flush), check_gemm(dev, flush),
               check_attn(dev, flush), *check_w4a4(dev, flush),
               check_fwht(dev, flush)]
    del flush
    # each kernel's launches: from the path run that drives it
    paths = {"w4a16": serve_path(dev, args.seed),
             "w4a4-rht": serve_path(dev, args.seed, act_quant="mixfp4",
                                    act_rht=True)}
    card_vs_cpu(dev, args.seed)
    paths["w4a4-2pass-rowscale"] = card_vs_cpu(dev, args.seed, w4a4=True)
    for entry in kernels:
        entry["path"], entry["launches"] = next(
            (name, c[entry["name"]]) for name, c in paths.items()
            if c[entry["name"]])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
