"""Smoke test of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the script exits non-zero):

1. build every CUDA kernel of the served paths from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at
   gemma2-2b shapes, and time kernel, plain version and one library call;
   the fused W4A4 kernel must also equal the quantizer followed by the
   packed W4A4 kernel bitwise, with its row scale from the RHT row-scale
   kernel; the RHT row scale (with NaN, Inf and zero rows) and the KV-cache
   write (decode and 4500-row prefill, fixed slots and permuted pool) are
   bitwise their plain versions;
   the paged attention kernel must equal the fixed one bitwise, the
   fixed one its recorded output digest, and each sequence's attention
   output must be bitwise the same at B = 1 and B = 4 and at three cache
   capacities (``[attn-invariance]``);
   every GEMM's rows must be bitwise independent of M, across its decode
   (M <= 64, split K reduced in the launch) and prefill variants, and
   repeat calls bitwise equal; decode attention at StarCoder2-15B's heads
   (B=4, H=48 over Hkv=4, g=12, dh=128; the kernel walks the group in
   passes of at most 8 heads), fixed and paged, on phase 2's lengths:
   within 1e-4 of the plain version, paged == fixed bitwise, timed beside
   its byte bound and SDPA (``[attn-g12]``);
3. serve six greedy requests (four share a 1000-token prefix; one prompt
   of 4500 tokens) through ``ServeEngine`` for gemma2-2b at full width
   (26 layers, packed MixFP4 weights from seeded random values, packed
   MixFP4 KV cache) on the W4A16 path with whole-prompt prefill, check
   that every launch counter equals what the path implies, then trace five
   decode steps at ~1024 tokens of context with ``torch.profiler`` (device
   time by kernel, device-busy share; exactly one decode-variant GEMM
   launch per projection and no memset in the trace);
3c. the same requests and weights through the paged pool (2049 pages of
   16 rows, prefix caching) with 512-token chunked prefill: the streams
   must equal phase 3's token for token, with prefix hits and COW copies;
   then fixed-slot and paged decode steps timed in alternating turns;
3b. the phase-3 requests on the W4A4 path (``act_quant="mixfp4",
   act_rht=True``);
4. run gemma2-2b at full width cut to 2 layers on the card and on the CPU
   (plain versions) from the same packed bytes, and compare the logits;
4b. the same on the W4A4 + RHT path, where the card's fused and two-pass
   (``"mixfp4-2pass-rowscale"``) logits must also be bitwise equal;
4c. at the same width and depth, a prompt prefilled whole into a fixed
   slot and in chunks after a prefix hit into the pool must write the
   same K/V bytes and give the same next-step logits, bitwise;
2m. (with phase 2) the expert W4A16 entry over 64 experts (4 of them
   zero) at qwen2-moe's (K, N) and C in (1, 5, 64, 65, 380): within 1e-3
   of max|plain| and bitwise the 2-D entry on every expert's slice (int32
   views), on random rows and on the MoE layer's own dispatch buffers with
   a -0.0 expert, NaN, Inf and last-split-only rows, experts without a
   non-zero row exact +0; one layer's three expert launches at C = 5 timed
   on (a) 64 experts of random rows and (b) the served B = 4 dispatch (16
   experts hold a row), each beside its byte bound; attention (fixed and
   paged) and the KV write at Qwen1.5-MoE's heads (B=4, H=Hkv=16, dh=128)
   against their plain versions;
3m. phase 3's requests served by qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B) at
   full width and depth (24 layers, 60 experts stored as 64, a shared
   expert; every layer drawn and packed on its own) in fixed slots:
   exact launch counts (per pass and layer 7 ``mixfp4_gemm_w4a16``, 3
   ``mixfp4_gemm_w4a16_experts``, one KV write; one attention per decode
   pass), a decode step run twice on the same state bitwise equal, five
   traced decode steps (exactly 3 expert-kernel rows per layer and step;
   the expert GEMM's device ms per step);
3m-paged. the same through the pool as a plain page allocator (MoE has no
   prefix caching): the streams must equal phase 3m's, with no prefix hit;
4m. qwen2-moe at full width cut to 2 layers, card vs CPU logits;
5. (after 3c) a packed checkpoint round trip at gemma2-2b width: the
   phase-3 weights written by ``save_weights`` under ``build/ckpt`` and
   restored into a fresh engine by ``load_weights``: every packed byte
   and the fingerprint equal, phase 3's six streams token for token, the
   save and restore rates; copies with a 0x80 scale byte and a flipped
   payload byte raise ``ValueError`` / ``IOError`` naming the array;
3d. Phi-3-medium-14B and StarCoder2-15B (packed KV cache) and
   H2O-Danube3-4B (bf16 KV cache: head_dim 120), each at full width and
   depth, drawn and packed a layer at a time and freed before the next:
   phase 3's requests with 16 new tokens each, fixed slots, W4A16; exact
   launch counts (per pass and layer 7 GEMMs, 6 for StarCoder2's GeLU MLP;
   one KV write, and one attention per decode pass, on the packed cache,
   none on Danube's), every logit row finite, and in five traced decode
   steps the wrappers' counts equal to the trace's kernel rows;
4d. each of the three cut to 2 layers, card vs CPU logits (StarCoder2
   also through a paged pool, bitwise the fixed-slot card run);
3L. the serving lifecycle at full width and depth, on the weights and
   streams of phases 3, 3b and 3m, 8 new tokens per request but in (c)
   (``[lifecycle]``): (a) gemma2-2b W4A16 in fixed slots, the six phase-3
   requests through ``submit`` with ``max_queue=6`` on the system clock:
   streams equal phase 3's first 8 tokens, TTFT and ITL p50/p99 and the
   queue gauges; (b) the same engine under ``schedule_for_seed`` 0 and 1
   (a NaN row, a prefill error, slow decodes): ``check_invariants``
   against (a) finds no violation; (c) a 300-page pool, too small for the
   4500-token request beside three mid-stream ones, with
   ``degrade_after_deferrals=1``: the paged -> fixed-slot rung fires once,
   the six streams equal phase 3's whole 32 tokens, no page stays active,
   and not one K/V byte of the migrated requests differs from (a)'s rows
   (the migration replays their generated tokens through the decode
   kernel); (d) W4A4 +
   RHT (phase 3b's weights) with a ``dispatch`` fault at the second
   decode: the fused rung fires, the streams equal phase 3b's first 8
   tokens, and every step's launch counts are exact on both sides of it;
   (e) qwen2-moe-a2.7b (phase 3m's weights) at B = 4 with a NaN-poisoned
   decode row: the victim FAILED (``nan_logits``) with a strict prefix,
   the survivors equal phase 3m's first 8 tokens; (f) phase 5's restore
   with one transient ``checkpoint_read`` fault: retried once, the bytes
   and fingerprint unchanged.
3R. crash recovery and the graceful drain at full width and depth, on
   phase 3's gemma2-2b W4A16 weights, 8 new tokens (``[recovery]``): (a)
   the six requests journaled (``journal_sync="always"``, under
   ``build/journal``) in fixed slots and a ``process_crash`` after 1, 6
   and 10 of the oracle's 14 steps (requests still queued; all four
   admitted ones at 7 of 8 tokens; four finished); the engine abandoned
   unflushed, a fresh one ``recover()``-s from the journal and drains:
   streams equal phase 3's first 8 tokens, every request FINISHED, each
   request's K/V bytes equal 3L(a)'s, and ``recover()`` launches exactly
   what its prompt prefills and replay decode passes imply; (b) the same
   on 3c's pool with 512-token chunks at 2 boundaries, no page left
   active; (c) ``drain(max_steps=4)`` mid-stream, then the survivors
   recovered with equal streams and rows; (d) the wall ms of each
   ``recover()`` and of its replay, and the replay's decode passes.

Each kernel's launch count comes from the path run that drives it, with
the counts set to 0 just before that run.  The line before the last is a
JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import collections
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
# decode batches on both sides of the decode variant's M <= 64 (and its
# three row-tile counts), and a 4544-row prefill
CHECK_MS = (1, 4, 16, 32, 64, 65, 4544)
PREFILL_M = 4544


def log(msg: str):
    print(msg, flush=True)


def bench(fn, reps: int = 20, flush: torch.Tensor | None = None,
          keep_ahead: bool = False) -> float:
    """Median ms of ``fn`` on the card by CUDA events, after a warm-up.
    ``flush`` (a large buffer) is rewritten before each rep so the L2 cache
    is cold, as it is for the weights on the served path.  The events
    bracket the host's enqueue of ``fn`` as well as the card's work, so
    work that the card runs faster than the host enqueues it times the
    host.  ``keep_ahead`` first has the stream sleep on the card for twice
    the host time ``fn`` takes to enqueue its work, so the events time the
    card's work alone (the GEMM layers report both)."""
    fn()
    torch.cuda.synchronize()
    sleep = 0
    if keep_ahead:
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1 << 22)
        torch.cuda.synchronize()
        cycles_per_s = (1 << 22) / (time.perf_counter() - t)
        sleep = int(min(2 * host_s, 0.1) * cycles_per_s)
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if sleep:
            torch.cuda._sleep(sleep)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20) -> float:
    """Median host ms to enqueue ``fn``'s work (the card idle before each
    rep): what the wrappers cost the host-bound decode step."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, ops_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
# f32 operations per quantized value (the scale multiply, the block max and
# two candidates' scale, round, decode, error and sum), for the bound
QUANT_OPS_PER_VALUE = 15


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
    s32_dev = torch.tensor(KV_SCALE32, device=dev)
    ms = bench(lambda: Q.mixfp4_quant_rows(x, scale32=s32_dev), 200, flush)
    dev_ms = bench(lambda: Q.mixfp4_quant_rows(x, scale32=s32_dev), 200,
                   flush, keep_ahead=True)
    plain_ms = bench(lambda: Q.quant_rows_plain(x, ones), 50, flush)
    xb = torch.randn(4 * 4544, 256, device=dev)
    ms_pre = bench(lambda: Q.mixfp4_quant_rows(xb, scale32=s32_dev), 50,
                   flush)
    b_ms, b_by = bound(m * 256 * 4 + m * 128 + m * 16 + 4,
                       QUANT_OPS_PER_VALUE * m * 256, F32_OPS_PER_S)
    bp_ms, _ = bound(xb.numel() * (4 + 0.5 + 1 / 16), 0, F32_OPS_PER_S)
    log(f"[quant] decode M=16: kernel {ms:.4f} ms (card alone "
        f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms; "
        f"prefill M=18176: kernel {ms_pre:.4f} ms, bound {bp_ms:.4f} ms")
    return {"name": "mixfp4_quant_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_quant.cu",
            "replaces": "src/repro/kernels/mixfp4_quant.py:148",
            "max_abs_err": float(worst), "tolerance": "bitwise",
            "shape": "M=16 (B*Hkv), K=256, pinned scale32 on the card",
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _kv_leaves(rows: tuple, hkv: int, dh: int, dev, gen) -> list:
    """K and V cache leaves (payload, scales each) of random wire bytes
    with ``rows`` = (D0, D1) storage rows."""
    return [torch.randint(0, 256, (*rows, hkv, w), dtype=torch.uint8,
                          device=dev, generator=gen)
            for w in (dh // 2, dh // 16, dh // 2, dh // 16)]


def check_quant_kv(dev, flush) -> dict:
    """The KV write against its plain version (the quantizer, then the
    indexed writes) on the card, bitwise: the phase-3 decode shape (B=4,
    Hkv=4, dh=256) into fixed slots of 8192 rows and into a permuted
    2049-page pool (one idle lane writing the trash page 0, the one page
    not compared), and a 4500-row prefill, fixed from row 0 and paged from
    mid-page row 1000.  Times the decode write against its plain version."""
    from repro_torch.kernels import mixfp4_quant as Q

    b, hkv, dh, s_max, pages = 4, 4, 256, 8192, 2049
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(9)
    perm = 1 + rng.permutation(pages - 1)
    bt = torch.tensor(perm[:b * (s_max // PAGE_LEN)].reshape(b, -1),
                      dtype=torch.int32, device=dev)
    bt_idle = bt.clone()
    bt_idle[3] = 0
    one = torch.ones((), device=dev)
    lens = torch.tensor([1190, 1200, 332, 4532], dtype=torch.int32,
                        device=dev)
    lens_idle = lens.clone()
    lens_idle[3] = 0

    def rows_of(n):
        return [(3 * torch.randn(1 if n > 1 else b, n, hkv, dh, device=dev,
                                 generator=gen)).to(torch.bfloat16)
                for _ in range(2)]

    cases = [("fixed decode", rows_of(1), (b, s_max), lens, None),
             ("paged decode", rows_of(1), (pages, PAGE_LEN), lens_idle,
              bt_idle),
             ("fixed prefill 4500", rows_of(4500), (1, s_max), 0, None),
             ("paged prefill 4500", rows_of(4500), (pages, PAGE_LEN), 1000,
              bt[:1])]
    for name, (k, v), rows, pos, tables in cases:
        leaves = _kv_leaves(rows, hkv, dh, dev, gen)
        want = [a.clone() for a in leaves]
        Q.quant_kv_plain(k, v, *want, one, one, pos, tables)
        Q.mixfp4_quant_kv(k, v, *leaves, one, one, pos, block_tables=tables)
        torch.cuda.synchronize()
        first = 1 if tables is not None and name.endswith("decode") else 0
        bad = sum(int((g[first:] != w[first:]).sum())
                  for g, w in zip(leaves, want))
        if bad:
            raise AssertionError(f"KV write {name}: {bad} bytes differ")
    log("[quant-kv] B=4 x Hkv=4 x dh=256 decode rows into 8192 fixed slots "
        "and a permuted 2049-page pool (idle lane in the trash page), "
        "4500-row prefills fixed from row 0 and paged from row 1000: bytes "
        "bitwise equal to the quantizer + indexed writes")
    k, v = rows_of(1)
    leaves = _kv_leaves((b, s_max), hkv, dh, dev, gen)
    ms = bench(lambda: Q.mixfp4_quant_kv(k, v, *leaves, one, one, lens),
               200, flush)
    dev_ms = bench(lambda: Q.mixfp4_quant_kv(k, v, *leaves, one, one, lens),
                   200, flush, keep_ahead=True)
    plain_ms = bench(lambda: Q.quant_kv_plain(k, v, *leaves, one, one, lens),
                     50, flush)
    kb, vb = rows_of(4500)
    pre = _kv_leaves((1, s_max), hkv, dh, dev, gen)
    ms_pre = bench(lambda: Q.mixfp4_quant_kv(kb, vb, *pre, one, one, 0), 50,
                   flush)
    values = 2 * b * hkv * dh
    b_ms, b_by = bound(values * 2 + values * (0.5 + 1 / 16) + b * 4 + 8,
                       QUANT_OPS_PER_VALUE * values, F32_OPS_PER_S)
    vp = 2 * 4500 * hkv * dh
    bp_ms, _ = bound(vp * (2 + 0.5 + 1 / 16), QUANT_OPS_PER_VALUE * vp,
                     F32_OPS_PER_S)
    log(f"[quant-kv] decode K+V write (B=4, Hkv=4, dh=256, fixed): kernel "
        f"{ms:.4f} ms (card alone {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}); prefill 4500 rows: kernel "
        f"{ms_pre:.4f} ms, bound {bp_ms:.5f} ms")
    return {"name": "mixfp4_quant_kv", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_quant.cu",
            "replaces": "src/repro/kernels/mixfp4_quant.py:148",
            "max_abs_err": 0.0, "tolerance": "bitwise",
            "shape": "one layer's K and V decode rows, B=4, Hkv=4, dh=256, "
                     "into fixed slots",
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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
        for m in CHECK_MS:
            x = torch.randn(m, k, device=dev, generator=gen)
            y = G.mixfp4_gemm_w4a16(x, qt.payload, qt.scales, qt.scale32)
            yp = G.gemm_w4a16_plain(x, qt.payload, qt.scales, qt.scale32, n)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max() / yp.abs().max())
            worst = max(worst, err)
            if not err <= 1e-3:
                raise AssertionError(f"W4A16 K={k} N={n} M={m}: normalised "
                                     f"error {err}")
    log(f"[w4a16] 5 (K, N) pairs x M in {CHECK_MS}: max error "
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
    dev_ms = bench(kern, 20, flush, keep_ahead=True)
    lib_dev_ms = bench(lib, 20, flush, keep_ahead=True)
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
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); with the host "
        f"kept ahead (card time alone): kernel {dev_ms:.4f} ms, "
        f"torch.matmul {lib_dev_ms:.4f} ms; host time to enqueue the 7: "
        f"kernel wrappers {host_ms(kern):.4f} ms, torch.matmul "
        f"{host_ms(lib):.4f} ms")
    return {"name": "mixfp4_gemm_w4a16", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_gemm_w4a16.cu",
            "replaces": "src/repro/kernels/mixfp4_gemm.py:300",
            "max_abs_err": worst, "tolerance": "1e-3 of max|plain|",
            "shape": "7 projections of one layer, M=4",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms}


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

    # timed as the served path calls it: the per-tensor scales on the card
    one = torch.ones((), device=dev)
    s32 = {"k_scale32": one, "v_scale32": one, "softcap": 50.0}
    kern = lambda: A.mixfp4_attn_decode(q, kp, ks, vp, vs, lengths,
                                        window=0, **s32)
    plain = lambda: A.attn_decode_plain(q, kp, ks, vp, vs, lengths,
                                        window=0, **s32)
    ms = bench(kern, 20, flush)
    dev_ms = bench(kern, 20, flush, keep_ahead=True)
    plain_ms = bench(plain, 5, flush)
    ms_local = bench(lambda: A.mixfp4_attn_decode(
        q, kp, ks, vp, vs, lengths, window=4096, **s32), 20, flush)
    # yardstick: SDPA over the dequantized cache (same masks, no softcap)
    kd = A.dequant_kv(kp, ks, 1.0).transpose(1, 2)
    vd = A.dequant_kv(vp, vs, 1.0).transpose(1, 2)
    sdpa = {w: (lambda m=attn_mask(lengths, s, w):
                torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], kd, vd, attn_mask=m, enable_gqa=True))
            for w in (0, 4096)}
    lib_ms = bench(sdpa[0], 20, flush)
    lib_dev_ms = bench(sdpa[0], 20, flush, keep_ahead=True)
    lib_local = bench(sdpa[4096], 20, flush)
    b_ms, b_by = attn_bound(attn_rows(lengths, s, 0), b, h, hkv, dh)
    bl_ms, _ = attn_bound(attn_rows(lengths, s, 4096), b, h, hkv, dh)
    log(f"[attn] global layer: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA on the dequantized f32 cache (no softcap) {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); with the host kept ahead (card "
        f"time alone): kernel {dev_ms:.4f} ms, SDPA {lib_dev_ms:.4f} ms; "
        f"local layer (window 4096): kernel {ms_local:.4f} ms, SDPA "
        f"{lib_local:.4f} ms, bound {bl_ms:.4f} ms")
    return {"name": "mixfp4_attn_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_attn_decode.cu",
            "replaces": "src/repro/kernels/mixfp4_attn.py:174",
            "max_abs_err": worst, "tolerance": "1e-4 absolute",
            "shape": f"B=4 S=8192 lengths {lengths.tolist()}, window 0",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms}


def attn_rows(lengths: torch.Tensor, s: int, window: int) -> int:
    """The cache rows a decode-attention call must read per kv head: each
    sequence's keys under ``kpos < len`` and the window."""
    hi = lengths.clamp(max=s)
    lo = (lengths - window).clamp(min=0) if window > 0 else 0 * lengths
    return int((hi - lo).clamp(min=0).sum())


def attn_bound(rows: int, b: int, h: int, hkv: int, dh: int,
               extra_bytes: int = 0):
    """Least card time of a decode-attention call: each valid K/V row's
    payload and scale bytes once, q in and the output out (f32), the
    lengths and ``extra_bytes`` (block tables); ~4 flops per row, head and
    dim."""
    n_bytes = (2 * rows * hkv * (dh // 2 + dh // 16) + b * h * dh * 8
               + b * 4 + extra_bytes)
    return bound(n_bytes, 4 * rows * (h // hkv) * hkv * dh, F32_OPS_PER_S)


def attn_mask(lengths: torch.Tensor, s: int, window: int) -> torch.Tensor:
    """The decode masks as an SDPA boolean mask (B, 1, 1, S)."""
    kpos = torch.arange(s, device=lengths.device)[None, :]
    mask = kpos < lengths[:, None]
    if window > 0:
        mask &= kpos > (lengths - 1 - window)[:, None]
    return mask[:, None, None, :]


# sha256 of the fixed-slot attention kernel's output bytes on
# paged_attn_inputs() (softcap 50), per window, as the split-S kernel
# computes them: a change to its arithmetic (the split depth, the order of
# a sum, the merge) shows here.  The bytes of an expf/tanhf kernel belong
# to the toolkit that compiled it; these were recorded under
# FIXED_ATTN_NVCC (PERF.md §6 names the run), and another toolkit needs
# its own record.
FIXED_ATTN_NVCC = "Cuda compilation tools, release 12.9, V12.9.86"
FIXED_ATTN_SHA256 = {
    4096: "8b7bfac2df253e334a20628fdf89f915e5e05e64de2a932d4d86a42ddb682358",
    0: "89c6de2796301c50adcbb7b15a5889baca4e8ceb4546a310345fd27bad41b361"}
PAGE_LEN = 16
# decode lengths of the phase-3 mix near the end of its decode: three
# lanes of the shared-prefix and 300-token requests, one of the
# 4500-token prompt
SERVED_LENGTHS = (1190, 1200, 332, 4532)


def paged_attn_inputs(dev, h: int = 8, dh: int = 256, lengths=None):
    """The phase-2 paged-attention case, from numpy with a fixed seed:
    q (4, h, dh); a fixed packed cache of B=4 x 8192 rows x 4 kv heads
    (rows quantized on the card under the pinned KV scale); its rows
    scattered over a 2049-page pool in a random permutation, with junk
    wire bytes in the trash page 0; the block tables; the lengths (drawn,
    or ``lengths``).  The defaults are gemma2-2b's heads."""
    from repro_torch.models.base import quantize_kv_rows

    b, s, hkv = 4, 8192, 4
    rng = np.random.RandomState(7)
    q = torch.tensor(rng.randn(b, h, dh), dtype=torch.float32, device=dev)
    fixed = []
    for _ in range(2):                                  # K, then V
        rows = torch.tensor(rng.randn(b, s, hkv, dh), dtype=torch.float32,
                            device=dev)
        fixed += list(quantize_kv_rows(rows))
    drawn = [s, *rng.randint(1, s + 1, b - 1)]
    lengths = torch.tensor(drawn if lengths is None else lengths,
                           dtype=torch.int32, device=dev)
    mp = s // PAGE_LEN
    bt = torch.tensor(1 + rng.permutation(b * mp).reshape(b, mp),
                      dtype=torch.int32, device=dev)
    junk = quantize_kv_rows(torch.tensor(
        40.0 * rng.randn(PAGE_LEN, hkv, dh), dtype=torch.float32,
        device=dev))
    slabs = []
    flat = bt.reshape(-1).long()
    for a, j in zip(fixed, (*junk, *junk)):
        slab = torch.empty((1 + b * mp, PAGE_LEN, *a.shape[2:]),
                           dtype=a.dtype, device=dev)
        slab[0] = j
        slab[flat] = a.reshape(b * mp, PAGE_LEN, *a.shape[2:])
        slabs.append(slab)
    return q, fixed, lengths, slabs, bt


def nvcc_release() -> str:
    """The release line of the nvcc that builds the kernels."""
    from repro_torch.kernels import build

    out = subprocess.run([build.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True).stdout
    return next(line.strip() for line in out.splitlines()
                if "release" in line)


def check_attn_paged(dev, flush) -> dict:
    import hashlib

    from repro_torch.kernels import mixfp4_attn as A

    q, fixed, lengths, slabs, bt = paged_attn_inputs(dev)
    if tuple(lengths.tolist()) != PHASE2_LENGTHS:
        raise AssertionError(f"phase 2 lengths {lengths.tolist()}")
    b, s = fixed[0].shape[:2]
    hkv, dh, h = fixed[0].shape[2], q.shape[2], q.shape[1]
    worst = 0.0
    nvcc = nvcc_release()
    for window in (4096, 0):
        kw = {"window": window, "softcap": 50.0}
        o = A.mixfp4_attn_decode_paged(q, *slabs, bt, lengths, **kw)
        of = A.mixfp4_attn_decode(q, *fixed, lengths, **kw)
        op = A.attn_decode_paged_plain(q, *slabs, bt, lengths, **kw)
        torch.cuda.synchronize()
        if not torch.equal(o, of):
            raise AssertionError(f"paged attention window={window}: not "
                                 "bitwise the fixed kernel")
        digest = hashlib.sha256(of.cpu().numpy().tobytes()).hexdigest()
        log(f"[attn-paged] fixed kernel output sha256, window {window}: "
            f"{digest} (built by nvcc {nvcc!r})")
        if digest != FIXED_ATTN_SHA256[window]:
            raise AssertionError(
                f"fixed attention window={window}: output digest {digest} "
                f"is not the one recorded under nvcc {FIXED_ATTN_NVCC!r}"
                + ("" if nvcc == FIXED_ATTN_NVCC else
                   f"; this build's nvcc is {nvcc!r}: record this "
                   "kernel's digest for it"))
        err = float((o - op).abs().max())
        worst = max(worst, err)
        if not err <= 1e-4:
            raise AssertionError(f"paged attention window={window}: error "
                                 f"{err}")
    log(f"[attn-paged] B=4, 8192 logical rows over a 2049-page pool "
        f"(page_len 16, permuted, junk in page 0), lengths "
        f"{lengths.tolist()}, window 4096 and 0, softcap 50: equal to the "
        f"fixed kernel bitwise; fixed kernel output bitwise its recorded "
        f"digest; max abs error vs plain {worst:.3e} (tolerance 1e-4)")
    check_attn_invariance(q, fixed, lengths, slabs, bt)
    # timed as the served path calls it: the per-tensor scales on the card
    one = torch.ones((), device=dev)
    s32 = {"k_scale32": one, "v_scale32": one, "softcap": 50.0}
    kw = {"window": 0, **s32}
    ms = bench(lambda: A.mixfp4_attn_decode_paged(q, *slabs, bt, lengths,
                                                  **kw), 20, flush)
    plain_ms = bench(lambda: A.attn_decode_paged_plain(q, *slabs, bt,
                                                       lengths, **kw), 5,
                     flush)
    # yardstick: SDPA over the dequantized cache (no softcap); the gathered
    # pool rows are the fixed cache's rows
    kd = A.dequant_kv(fixed[0], fixed[1], 1.0).transpose(1, 2)
    vd = A.dequant_kv(fixed[2], fixed[3], 1.0).transpose(1, 2)
    times = {}
    for shape, lens in (("phase-2", lengths),
                        ("served", torch.tensor(SERVED_LENGTHS,
                                                dtype=torch.int32,
                                                device=dev))):
        for window in (0, 4096):
            kw = {"window": window, **s32}
            mask = attn_mask(lens, s, window)
            t = {
                "paged": bench(lambda: A.mixfp4_attn_decode_paged(
                    q, *slabs, bt, lens, **kw), 20, flush),
                "fixed": bench(lambda: A.mixfp4_attn_decode(
                    q, *fixed, lens, **kw), 20, flush),
                "paged_device": bench(lambda: A.mixfp4_attn_decode_paged(
                    q, *slabs, bt, lens, **kw), 20, flush, keep_ahead=True),
                "fixed_device": bench(lambda: A.mixfp4_attn_decode(
                    q, *fixed, lens, **kw), 20, flush, keep_ahead=True),
                "sdpa": bench(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q[:, :, None], kd, vd, attn_mask=mask,
                        enable_gqa=True), 20, flush),
                "bound": attn_bound(attn_rows(lens, s, window), b, h, hkv,
                                    dh, bt.numel() * 4)[0]}
            times[(shape, window)] = t
            log(f"[attn-paged] {shape} lengths {lens.tolist()}, "
                f"{'global' if window == 0 else 'local (window 4096)'}: "
                f"paged kernel {t['paged']:.4f} ms (card alone "
                f"{t['paged_device']:.4f}), fixed kernel on the same rows "
                f"{t['fixed']:.4f} ms (card alone {t['fixed_device']:.4f}), "
                f"SDPA on the dequantized f32 cache "
                f"(no softcap) {t['sdpa']:.4f} ms, bound {t['bound']:.4f} ms")
    g2 = times[("phase-2", 0)]
    b_ms, b_by = attn_bound(attn_rows(lengths, s, 0), b, h, hkv, dh,
                            bt.numel() * 4)
    log(f"[attn-paged] global layer: kernel {ms:.4f} ms (the fixed kernel "
        f"on the same rows {g2['fixed']:.4f} ms; card alone "
        f"{g2['paged_device']:.4f} against {g2['fixed_device']:.4f}), plain "
        f"{plain_ms:.4f} ms, SDPA {g2['sdpa']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    return {"name": "mixfp4_attn_decode_paged", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_attn_decode.cu",
            "replaces": "src/repro/kernels/mixfp4_attn.py:253",
            "max_abs_err": worst, "tolerance": "bitwise the fixed kernel; "
            "1e-4 absolute vs plain",
            "shape": f"B=4, 8192 logical rows, 2049 pages of 16, lengths "
                     f"{lengths.tolist()}, window 0",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": g2["sdpa"],
            "device_ms": g2["paged_device"]}


# phase 2's paged-attention lengths (paged_attn_inputs draws them)
PHASE2_LENGTHS = (8192, 2480, 7170, 7059)


def check_attn_g12(dev, flush) -> list[dict]:
    """Decode attention at StarCoder2-15B's heads (48 over 4 kv heads, g =
    12, dh = 128, no softcap), which the kernel walks in passes of 8 and 4
    heads, fixed slots and paged pool, on phase 2's lengths: within 1e-4
    of the plain version, paged == fixed bitwise (window 4096 and 0);
    timed on the global layer beside its byte bound and SDPA."""
    from repro_torch.kernels import mixfp4_attn as A

    h, dh = 48, 128
    q, fixed, lengths, slabs, bt = paged_attn_inputs(
        dev, h=h, dh=dh, lengths=PHASE2_LENGTHS)
    b, s, hkv = fixed[0].shape[:3]
    worst = {"fixed": 0.0, "paged": 0.0}
    for window in (4096, 0):
        o = A.mixfp4_attn_decode(q, *fixed, lengths, window=window)
        op = A.mixfp4_attn_decode_paged(q, *slabs, bt, lengths,
                                        window=window)
        plain = A.attn_decode_plain(q, *fixed, lengths, window=window)
        torch.cuda.synchronize()
        if not torch.equal(o, op):
            raise AssertionError(f"g=12 attention window={window}: paged "
                                 "not bitwise the fixed kernel")
        for name, out in (("fixed", o), ("paged", op)):
            err = float((out - plain).abs().max())
            worst[name] = max(worst[name], err)
            if not err <= 1e-4:
                raise AssertionError(f"g=12 {name} attention window="
                                     f"{window}: error {err}")
    one = torch.ones((), device=dev)
    kw = {"window": 0, "k_scale32": one, "v_scale32": one}
    calls = {"fixed": lambda: A.mixfp4_attn_decode(q, *fixed, lengths, **kw),
             "paged": lambda: A.mixfp4_attn_decode_paged(q, *slabs, bt,
                                                         lengths, **kw)}
    plains = {"fixed": lambda: A.attn_decode_plain(q, *fixed, lengths, **kw),
              "paged": lambda: A.attn_decode_paged_plain(q, *slabs, bt,
                                                         lengths, **kw)}
    kd = A.dequant_kv(fixed[0], fixed[1], 1.0).transpose(1, 2)
    vd = A.dequant_kv(fixed[2], fixed[3], 1.0).transpose(1, 2)
    mask = attn_mask(lengths, s, 0)
    lib_ms = bench(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True), 20, flush)
    rows = attn_rows(lengths, s, 0)
    out = []
    for name, replaces in (("fixed", "src/repro/kernels/mixfp4_attn.py:174"),
                           ("paged", "src/repro/kernels/mixfp4_attn.py:253")):
        ms = bench(calls[name], 20, flush)
        dev_ms = bench(calls[name], 20, flush, keep_ahead=True)
        plain_ms = bench(plains[name], 5, flush)
        b_ms, b_by = attn_bound(rows, b, h, hkv, dh,
                                bt.numel() * 4 if name == "paged" else 0)
        log(f"[attn-g12] {name}: B=4, H=48 over Hkv=4 (g=12), dh=128, "
            f"8192 rows, lengths {lengths.tolist()}, global: kernel "
            f"{ms:.4f} ms (card alone {dev_ms:.4f}), plain {plain_ms:.4f} "
            f"ms, SDPA on the dequantized f32 cache {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); max abs error vs plain "
            f"{worst[name]:.3e} (tolerance 1e-4, window 4096 and 0)")
        entry = "mixfp4_attn_decode" + ("" if name == "fixed" else "_paged")
        out.append({
            "name": f"{entry}[g=12]", "counter": entry, "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_attn_decode.cu",
            "replaces": replaces, "max_abs_err": worst[name],
            "tolerance": "1e-4 absolute vs plain; paged bitwise fixed",
            "shape": f"B=4 H=48 Hkv=4 dh=128 S=8192 lengths "
                     f"{lengths.tolist()}, window 0",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "device_ms": dev_ms})
    log(f"[attn-g12] paged == fixed bitwise at window 4096 and 0")
    return out


def check_attn_invariance(q, fixed, lengths, slabs, bt):
    """Each sequence's output of the B = 4 calls on the phase-2 inputs,
    fixed and paged, equals its B = 1 call at the same capacity, at a
    smaller one (rows cut to one page past its length) and at a larger one
    (512 junk rows appended; 32 more table entries at the trash page),
    bitwise, for the global and the local layer: the key splits come from
    key positions alone."""
    from repro_torch.kernels import mixfp4_attn as A

    s = fixed[0].shape[1]
    gen = torch.Generator(device=q.device).manual_seed(9)
    junk = [torch.randint(0, 256, (1, 512, *a.shape[2:]), generator=gen,
                          dtype=torch.uint8, device=q.device)
            for a in fixed]
    calls = 0
    for window in (4096, 0):
        kw = {"window": window, "softcap": 50.0}
        ref = A.mixfp4_attn_decode(q, *fixed, lengths, **kw)
        for i, n in enumerate(lengths.tolist()):
            one = lengths[i:i + 1]
            pages = -(-n // PAGE_LEN)
            cut = min(s, (pages + 1) * PAGE_LEN)
            runs = [A.mixfp4_attn_decode(q[i:i + 1], *cache, one, **kw)
                    for cache in ([a[i:i + 1] for a in fixed],
                                  [a[i:i + 1, :cut] for a in fixed],
                                  [torch.cat([a[i:i + 1], j], 1)
                                   for a, j in zip(fixed, junk)])]
            wide = torch.cat([bt[i:i + 1], torch.zeros(
                (1, 32), dtype=torch.int32, device=q.device)], 1)
            runs += [A.mixfp4_attn_decode_paged(q[i:i + 1], *slabs, table,
                                                one, **kw)
                     for table in (bt[i:i + 1],
                                   bt[i:i + 1, :min(pages + 1,
                                                    bt.shape[1])], wide)]
            calls += len(runs)
            for k, got in enumerate(runs):
                if not torch.equal(got[0], ref[i]):
                    raise AssertionError(
                        f"attention window={window}: sequence {i} at B=1 "
                        f"(run {k}) differs from its row at B=4")
    log(f"[attn-invariance] phase-2 inputs, window 4096 and 0: each "
        f"sequence's B=1 output at capacities S, one page past its length "
        f"and S+512 (fixed), and through its table, cut and widened by 32 "
        f"trash entries (paged), bitwise equal to its row of the B=4 "
        f"call: {calls} calls")


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
                # the served path's row scale (one launch); fused must
                # equal the quantizer's own scale and bytes below
                s32 = (fwht.fwht_row_scale(x, sg) if per_row
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
    times |= {f"{name}_dev": bench(fn, 20, flush, keep_ahead=True)
              for name, fn in (("packed", packed), ("fused", fused),
                               ("lib", lib))}
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
        f"{times['lib']:.4f} ms; with the host kept ahead (card time "
        f"alone): packed {times['packed_dev']:.4f} ms, fused + RHT "
        f"{times['fused_dev']:.4f} ms, torch.matmul {times['lib_dev']:.4f} "
        f"ms; host time to enqueue the 7: packed "
        f"{host_ms(packed):.4f} ms, fused + RHT {host_ms(fused):.4f} ms")
    common = {"route": "cuda",
              "source": "src/repro_torch/csrc/mixfp4_gemm_w4a4.cu",
              "tolerance": "1e-3 of max|plain|", "library_ms": times["lib"],
              "library_device_ms": times["lib_dev"]}
    return [dict(common, name="mixfp4_gemm_w4a4",
                 replaces="src/repro/kernels/mixfp4_gemm.py:330",
                 max_abs_err=worst["packed"],
                 shape="7 projections of one layer, M=4, per-row scales",
                 ms=times["packed"], device_ms=times["packed_dev"],
                 plain_ms=times["packed_plain"],
                 bound_ms=b_packed[0], bound_by=b_packed[1]),
            dict(common, name="mixfp4_gemm_w4a4_fused",
                 replaces="src/repro/kernels/mixfp4_gemm.py:380",
                 max_abs_err=worst["fused"],
                 shape="7 projections of one layer, M=4, per-row + RHT",
                 ms=times["fused"], device_ms=times["fused_dev"],
                 plain_ms=times["fused_plain"],
                 bound_ms=b_fused[0], bound_by=b_fused[1])]


def _gemm_err(y, yp, what: str, k: int, n: int, m: int) -> float:
    torch.cuda.synchronize()
    err = float((y - yp).abs().max() / yp.abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"{what} K={k} N={n} M={m}: normalised error "
                             f"{err}")
    return err


# held against M = 4: the decode variant's three row-tile counts (M <= 16,
# <= 32, <= 64), the prefill tile just past it, and a whole prompt
INVARIANCE_MS = (1, 16, 32, 64, 65, PREFILL_M)


def check_m_invariance(dev):
    """Rows bitwise independent of M, and repeat calls bitwise equal, for
    the three GEMMs on every gemma2-2b (K, N) pair: the first rows of a
    call at M = 4 (the decode variant) must equal the same rows of calls at
    M in INVARIANCE_MS, across the decode/prefill boundary.  Row scales
    come from each row alone; a per-tensor scale is computed once from all
    4544 rows and shared by every call."""
    from repro_torch.core import qtensor, scaling
    from repro_torch.kernels import fwht
    from repro_torch.kernels import mixfp4_gemm as G
    from repro_torch.models.base import rht_signs_on_grid

    gen = torch.Generator(device=dev).manual_seed(8)
    n_cases = 0
    for k, n in GEMMA_PAIRS:
        w = torch.randn(k, n, device=dev, generator=gen) / math.sqrt(k)
        qt = qtensor.quantize(
            w, qtensor.QuantSpec("mixfp4", qtensor.BlockLayout2D()))
        x = _rows_like_activations(PREFILL_M, k, dev, gen)
        sg = rht_signs_on_grid(k, k, dev)
        q_t = qtensor.quantize_rows(x)
        q_r = qtensor.quantize_rows(x, per_row=True)
        s_t = scaling.tensor_scale(x)
        s_r = scaling.row_scale(x)
        s_h = scaling.row_scale(fwht.fwht_rows(x, sg))
        calls = {
            "w4a16": lambda m: G.mixfp4_gemm_w4a16(
                x[:m], qt.payload, qt.scales, qt.scale32),
            "w4a4 per tensor": lambda m: G.mixfp4_gemm_w4a4(
                q_t.payload[:m], q_t.scales[:m], q_t.scale32, qt.payload,
                qt.scales, qt.scale32),
            "w4a4 per row": lambda m: G.mixfp4_gemm_w4a4(
                q_r.payload[:m], q_r.scales[:m], q_r.scale32[:m],
                qt.payload, qt.scales, qt.scale32, per_row=True),
            "fused per tensor": lambda m: G.mixfp4_gemm_w4a4_fused(
                x[:m], s_t, qt.payload, qt.scales, qt.scale32),
            "fused per row": lambda m: G.mixfp4_gemm_w4a4_fused(
                x[:m], s_r[:m], qt.payload, qt.scales, qt.scale32,
                per_row=True),
            "fused per row + RHT": lambda m: G.mixfp4_gemm_w4a4_fused(
                x[:m], s_h[:m], qt.payload, qt.scales, qt.scale32,
                per_row=True, rht_signs=sg),
        }
        for name, fn in calls.items():
            ref = fn(4)
            for m in (4, 64):
                if not torch.equal(fn(m), fn(m)):
                    raise AssertionError(f"{name} K={k} N={n} M={m}: two "
                                         "identical calls differ")
            for m in INVARIANCE_MS:
                r = min(m, 4)
                if not torch.equal(fn(m)[:r], ref[:r]):
                    raise AssertionError(f"{name} K={k} N={n}: rows of the "
                                         f"M={m} call differ from M=4's")
                n_cases += 1
    torch.cuda.synchronize()
    one_launch(calls)
    log(f"[m-invariance] W4A16, packed W4A4 (per tensor, per row), fused "
        f"W4A4 (per tensor, per row, per row + RHT) on {len(GEMMA_PAIRS)} "
        f"(K, N) pairs: the first rows of M in {INVARIANCE_MS} bitwise "
        f"M=4's in {n_cases}/{n_cases} cases; repeat calls at M=4 and 64 "
        f"bitwise equal")


# host idle time between the profiler's start of recording and the first
# traced call
TRACE_PAD_S = 0.05


def traced(fn, n: int):
    """Call ``fn`` once as the profiler's warm-up, then ``n`` times traced
    by ``torch.profiler`` (CPU and CUDA activity), the card synchronised
    after each call.  Returns the profile, the host ms of each traced call
    and of the traced window, and the wrappers' launches in that window.
    The profiler loses the records of kernels launched in the first few
    hundred microseconds after its recording starts, now and then, even
    after a warm-up call (``decode_study.py trace-clock``: 12 of 600
    one-call windows short without a pad at the start, none of 600 with
    one), so the host idles ``TRACE_PAD_S`` before the first traced
    call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops

    call_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        before = ops.launch_counts()
        t_win = time.perf_counter()
        for i in range(n):
            t = time.perf_counter()
            fn()
            call_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            if i < n - 1:
                prof.step()
        win_ms = (time.perf_counter() - t_win) * 1e3
        after = ops.launch_counts()
    launched = {k: v - before[k] for k, v in after.items() if v - before[k]}
    return prof, call_ms, win_ms, launched


def kernel_rows(prof) -> list:
    """The device rows of a profile that are kernels (or memsets, copies),
    not the GPU-side spans of annotations such as ``ProfilerStep#``."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith("ProfilerStep")]


def one_launch(calls: dict):
    """Trace one decode-M call of each GEMM alone: the card must run one
    kernel of the GEMM sources, the decode variant, and no memset (the
    split partials are reduced inside that launch)."""
    others = set()
    for name, fn in calls.items():
        prof = traced(lambda: fn(4), 1)[0]
        rows = {ev.key: ev.count for ev in kernel_rows(prof)}
        gemm = {k: c for k, c in rows.items() if "w4a" in k}
        bad = [k for k in rows if "memset" in k.lower()]
        if list(gemm.values()) != [1] or bad or \
                "_decode_kernel" not in next(iter(gemm)):
            raise AssertionError(f"{name} at M=4 ran {rows}")
        others |= {k[:40] for k in rows if k not in gemm}
    log(f"[one-launch] each GEMM at M=4, traced alone: one decode-variant "
        f"kernel, no memset; other device rows (the wrappers' scale "
        f"arithmetic): {sorted(others)}")


def _special_rows(m: int, k: int, dev, gen) -> torch.Tensor:
    """Activation-like rows, then rows that are zero, hold a NaN, one Inf,
    two Infs in one 16-lane group (Inf - Inf = NaN after the RHT), or Inf
    beside NaN: the row scale must keep torch.amax's NaN and Inf."""
    x = _rows_like_activations(m, k, dev, gen)
    special = torch.ones(5, k, device=dev)
    special[0] = 0.0
    special[1, 3] = float("nan")
    special[2, k - 1] = float("inf")
    special[3, 16:18] = float("inf")
    special[4, 0], special[4, 5] = float("inf"), float("nan")
    return torch.cat([x, special])


# f32 operations per value of the RHT row scale: the sign multiply, four
# butterfly adds, the normalising multiply, the max
ROW_SCALE_OPS_PER_VALUE = 7


def check_fwht(dev, flush) -> list[dict]:
    from repro_torch.kernels import fwht
    from repro_torch.models.base import rht_signs_on_grid

    gen = torch.Generator(device=dev).manual_seed(6)
    n_scale = 0
    for k in sorted({k for k, _ in LAYER}):
        sg = rht_signs_on_grid(k, k, dev)
        for m in CHECK_MS:
            x = _rows_like_activations(m, k, dev, gen)
            if not torch.equal(fwht.fwht_rows(x, sg),
                               fwht.fwht_rows_math(x, sg, 16)):
                raise AssertionError(f"fwht_rows M={m} K={k} not bitwise")
            x = _special_rows(m, k, dev, gen)
            for signs in (sg, None):
                got = fwht.fwht_row_scale(x, signs).view(torch.int32)
                want = fwht.row_scale_plain(x, signs).view(torch.int32)
                if not torch.equal(got, want):
                    raise AssertionError(f"fwht_row_scale M={m} K={k} "
                                         f"rht={signs is not None} not "
                                         "bitwise")
                n_scale += 1
    log(f"[fwht] M in {CHECK_MS} x K in (2048, 2304, 9216), group 16: "
        f"bitwise equal to the plain version; fwht_row_scale with and "
        f"without signs, with zero, NaN and Inf rows: bitwise equal to "
        f"row_scale(fwht_rows_math) in {n_scale}/{n_scale} cases")
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

    def layer(fn):
        return lambda: [fn(xs[k], sg[k]) for k in ks]

    rows, scale = layer(fwht.fwht_rows), layer(fwht.fwht_row_scale)
    t = {"rows": bench(rows, 50, flush),
         "rows_dev": bench(rows, 50, flush, keep_ahead=True),
         "rows_plain": bench(layer(lambda x, s: fwht.fwht_rows_math(x, s,
                                                                    16)),
                             20, flush),
         "lib": bench(lambda: [torch.matmul(signed[k], hadamard16)
                               for k in ks], 50, flush),
         "scale": bench(scale, 50, flush),
         "scale_dev": bench(scale, 50, flush, keep_ahead=True),
         "scale_plain": bench(layer(fwht.row_scale_plain), 20, flush)}
    b_ms, b_by = bound(sum(2 * m * k * 4 + k * 4 for k in ks),
                       sum(m * k * 6 for k in ks), F32_OPS_PER_S)
    bs_ms, bs_by = bound(sum(m * k * 4 + k * 4 + m * 4 for k in ks),
                         sum(ROW_SCALE_OPS_PER_VALUE * m * k for k in ks),
                         F32_OPS_PER_S)
    kb = max(k for k, _ in LAYER)
    xb = _rows_like_activations(PREFILL_M, kb, dev, gen)
    sgb = rht_signs_on_grid(kb, kb, dev)
    ms_pre = bench(lambda: fwht.fwht_rows(xb, sgb), 20, flush)
    ms_pre_scale = bench(lambda: fwht.fwht_row_scale(xb, sgb), 20, flush)
    bp_ms, _ = bound(2 * xb.numel() * 4, 0, F32_OPS_PER_S)
    bps_ms, _ = bound(xb.numel() * 4, ROW_SCALE_OPS_PER_VALUE * xb.numel(),
                      F32_OPS_PER_S)
    log(f"[fwht] one decode layer's 7 launches (M=4): fwht_rows kernel "
        f"{t['rows']:.4f} ms (card alone {t['rows_dev']:.4f}), plain "
        f"{t['rows_plain']:.4f} ms, torch.matmul of the signed rows with "
        f"H16/4 (not bitwise) {t['lib']:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}); fwht_row_scale kernel {t['scale']:.4f} ms (card alone "
        f"{t['scale_dev']:.4f}), plain {t['scale_plain']:.4f} ms, bound "
        f"{bs_ms:.6f} ms ({bs_by}); prefill M={PREFILL_M} K={kb}: fwht_rows "
        f"{ms_pre:.4f} ms (bound {bp_ms:.4f}), fwht_row_scale "
        f"{ms_pre_scale:.4f} ms (bound {bps_ms:.4f})")
    common = {"route": "cuda", "source": "src/repro_torch/csrc/fwht_rows.cu",
              "replaces": "src/repro/kernels/fwht.py:55",
              "max_abs_err": 0.0, "tolerance": "bitwise"}
    return [dict(common, name="fwht_rows",
                 shape="7 launches of one decode layer, M=4, group 16",
                 ms=t["rows"], device_ms=t["rows_dev"],
                 plain_ms=t["rows_plain"], bound_ms=b_ms, bound_by=b_by,
                 library_ms=t["lib"]),
            dict(common, name="fwht_row_scale",
                 shape="7 launches of one decode layer, M=4, RHT group 16",
                 ms=t["scale"], device_ms=t["scale_dev"],
                 plain_ms=t["scale_plain"], bound_ms=bs_ms, bound_by=bs_by,
                 library_ms=None)]


# ---------------------------------------------------------------------------
# phase 2m: the expert W4A16 entry and Qwen1.5-MoE's heads
# ---------------------------------------------------------------------------
# qwen2-moe: 64 stored experts (60 + 4 zero); up/gate (2048, 1408), down
# (1408, 2048); one decode layer's three expert projections
MOE_EXPERTS, MOE_REAL, MOE_TOP_K = 64, 60, 4
MOE_LAYER = [(2048, 1408), (2048, 1408), (1408, 2048)]
# rows per expert: 1; 5 (B = 4 decode: cap 4 + the discard row); the
# decode variant's last M; the prefill tile's first; a 4544-token prefill
# (cap 379 + 1)
MOE_CS = (1, 5, 64, 65, 380)
# tokens routed for each C: cap = max(ceil(T * 4 * 1.25 / 60), 4) = C - 1
# (C = 1: cap 0, every choice dropped into the discard row)
MOE_TOKENS = {1: 4, 5: 4, 64: 756, 65: 768, 380: 4544}
# experts that hold a row at the served B = 4 decode (4 tokens, top-4)
MOE_SERVED_EXPERTS = 16


def moe_stacks(dev, gen) -> dict:
    """qwen2-moe's expert stacks of one layer, {(K, N): packed QTensor}:
    64 experts of seeded random weights, the last 4 zero."""
    from repro_torch.models.base import pack_projections

    stacks = {}
    for k, n in sorted(set(MOE_LAYER)):
        w = torch.randn(MOE_EXPERTS, k, n, device=dev, generator=gen) \
            / math.sqrt(k)
        w[MOE_REAL:] = 0.0
        stacks[(k, n)] = pack_projections({"w_up": w})[0]["w_up"]
        del w
    return stacks


def moe_buffer(k: int, c: int, dev, idx: np.ndarray, seed: int):
    """The (64, C, K) bf16 capacity buffer that the MoE layer builds for
    len(idx) seeded random tokens routed to the experts ``idx`` (T, 4),
    with cap = C - 1 (``models/moe.py dispatch_buffer``)."""
    from repro_torch.models.moe import dispatch_buffer

    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(len(idx), k), dtype=torch.float32,
                     device=dev).to(torch.bfloat16)
    return dispatch_buffer(x, torch.tensor(idx, device=dev), MOE_REAL,
                           MOE_EXPERTS, c - 1)[0]


def routed_rows(k: int, c: int, dev, seed: int) -> torch.Tensor:
    """``moe_buffer`` of MOE_TOKENS[c] tokens routed top-4 by seeded random
    logits; then experts 56-59 are set to: a row non-zero only in K's
    last split (56), an Inf (57), a NaN (58), and -0.0 everywhere (59)."""
    rng = np.random.RandomState(seed)
    t = MOE_TOKENS[c]
    idx = np.argsort(-rng.rand(t, MOE_REAL), axis=1, kind="stable")
    buf = moe_buffer(k, c, dev, idx[:, :MOE_TOP_K], seed + 1)
    last = (k - 1) // 256 * 256
    buf[56:60] = 0.0
    buf[56, c - 1, last:] = torch.tensor(rng.randn(k - last), device=dev,
                                         dtype=torch.float32).to(buf.dtype)
    buf[57, c - 1, k - 3] = float("inf")
    buf[58, c - 1, 5] = float("nan")
    buf[59] = -0.0
    return buf


def served_rows(k: int, dev, seed: int) -> torch.Tensor:
    """Input (b): the served B = 4 decode dispatch, 4 tokens routed to 16
    distinct experts of 60 (cap 4, C = 5); every other buffer zero."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(MOE_REAL)[:MOE_SERVED_EXPERTS].reshape(
        4, MOE_TOP_K)
    return moe_buffer(k, 5, dev, idx, seed + 1)


def moe_layer_bytes(c: int, active: int) -> float:
    """Bytes one decode layer's three expert launches must move: the packed
    weights of the ``active`` experts that hold a row, every expert's
    activations, outputs and scale32."""
    return sum(active * (k * n / 2 + k * n / 256)
               + MOE_EXPERTS * (4 + c * k * 2 + c * n * 4)
               for k, n in MOE_LAYER)


def check_gemm_experts(dev, flush) -> dict:
    """The expert entry over 64 experts (the last 4 zero) at every C of
    ``MOE_CS``: on dense random rows within 1e-3 of max|plain| of its plain
    version, bitwise the 2-D entry on each expert's slice, zero experts
    exact zeros; on the MoE layer's own dispatch buffers (with a -0.0
    expert, a NaN row, an Inf row and a row non-zero only in the last K
    split) bitwise the 2-D entry per expert as int32 and +0 for every
    expert without a non-zero row.  Then one decode layer's three expert
    launches at C = 5, timed on (a) 64 experts of random rows against the
    plain version and ``torch.bmm`` on the pre-decoded bf16 experts, and
    (b) the served dispatch (16 experts hold a row), each beside its byte
    bound; and the prefill at C = 380."""
    from repro_torch.core import qtensor
    from repro_torch.kernels import mixfp4_gemm as G

    gen = torch.Generator(device=dev).manual_seed(11)
    stacks = moe_stacks(dev, gen)
    worst = 0.0
    for (k, n), qw in stacks.items():
        for c in MOE_CS:
            x = torch.randn(MOE_EXPERTS, c, k, device=dev,
                            generator=gen).to(torch.bfloat16)
            y = qtensor.qmm_experts(x, qw)
            yp = G.gemm_w4a16_experts_plain(x, qw.payload, qw.scales,
                                            qw.scale32, n)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max() / yp.abs().max())
            worst = max(worst, err)
            if not err <= 1e-3:
                raise AssertionError(f"experts K={k} N={n} C={c}: "
                                     f"normalised error {err}")
            if y[MOE_REAL:].any():
                raise AssertionError(f"experts K={k} N={n} C={c}: a zero "
                                     "expert gave a non-zero output")
            xr = routed_rows(k, c, dev, 100 + c)
            yr = qtensor.qmm_experts(xr, qw)
            live = ((xr.view(torch.int16) & 0x7FFF) != 0).flatten(1).any(1)
            for e in range(MOE_EXPERTS):
                for xe, ye in ((x, y), (xr, yr)):
                    two_d = G.mixfp4_gemm_w4a16(xe[e], qw.payload[e],
                                                qw.scales[e], qw.scale32[e])
                    if not torch.equal(ye[e].view(torch.int32),
                                       two_d.view(torch.int32)):
                        raise AssertionError(
                            f"experts K={k} N={n} C={c}: expert {e} is not "
                            "bitwise the 2-D launch")
                if not live[e] and yr[e].view(torch.int32).any():
                    raise AssertionError(f"experts K={k} N={n} C={c}: expert "
                                         f"{e} has no non-zero row but a "
                                         "non-+0 output")
            bad = yr[58, c - 1].isfinite().any() or yr[57, c - 1].isfinite(
            ).any() or not yr[56, c - 1].any()
            if bad:
                raise AssertionError(f"experts K={k} N={n} C={c}: the NaN or "
                                     "Inf row did not propagate, or the "
                                     "last-split row was not computed")
    log(f"[w4a16-experts] 64 experts (4 zero) x (K, N) in "
        f"{sorted(stacks)} x C in {MOE_CS}: max error normalised by "
        f"max|plain| {worst:.3e} (tolerance 1e-3); every expert bitwise the "
        f"2-D launch on its slice (int32 views), on random rows and on the "
        f"MoE layer's dispatch buffers with a -0.0 expert, NaN, Inf and "
        f"last-split-only rows; experts without a non-zero row exact +0")

    c = 5
    xs = {k: torch.randn(MOE_EXPERTS, c, k, device=dev,
                         generator=gen).to(torch.bfloat16)
          for k in (2048, 1408)}
    served = {k: served_rows(k, dev, 21) for k in (2048, 1408)}
    dense = {kn: torch.stack([G.decode_weight_bf16(qw.payload[e],
                                                   qw.scales[e])
                              for e in range(MOE_EXPERTS)])
             for kn, qw in stacks.items()}

    def run(fn, inputs=xs):
        return lambda: [fn(inputs[k], (k, n)) for k, n in MOE_LAYER]

    kern = run(lambda x, kn: qtensor.qmm_experts(x, stacks[kn]))
    kern_b = run(lambda x, kn: qtensor.qmm_experts(x, stacks[kn]), served)
    plain = run(lambda x, kn: G.gemm_w4a16_experts_plain(
        x, stacks[kn].payload, stacks[kn].scales, stacks[kn].scale32,
        kn[1]))
    lib = run(lambda x, kn: torch.bmm(x, dense[kn]))
    ms = bench(kern, 20, flush)
    dev_ms = bench(kern, 20, flush, keep_ahead=True)
    served_ms = bench(kern_b, 20, flush)
    served_dev_ms = bench(kern_b, 20, flush, keep_ahead=True)
    plain_ms = bench(plain, 3, flush)
    lib_ms = bench(lib, 20, flush)
    lib_dev_ms = bench(lib, 20, flush, keep_ahead=True)
    n_bytes = moe_layer_bytes(c, MOE_EXPERTS)
    n_ops = sum(2 * MOE_EXPERTS * c * k * n for k, n in MOE_LAYER)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    active = int(((served[2048].view(torch.int16) & 0x7FFF) != 0).flatten(
        1).any(1).sum())
    if active != MOE_SERVED_EXPERTS:
        raise AssertionError(f"input (b) has {active} experts with a row")
    sb_bytes = moe_layer_bytes(c, active)
    sb_ms, sb_by = bound(sb_bytes, n_ops * active / MOE_EXPERTS,
                         BF16_OPS_PER_S)
    cp = MOE_CS[-1]
    for (k, n), qw in sorted(stacks.items()):
        x = torch.randn(MOE_EXPERTS, cp, k, device=dev,
                        generator=gen).to(torch.bfloat16)
        t = bench(lambda: qtensor.qmm_experts(x, qw), 5, flush)
        flops = 2 * MOE_EXPERTS * cp * k * n
        log(f"[w4a16-experts] prefill C={cp} K={k} N={n}: {t:.3f} ms "
            f"({flops / t / 1e9:.1f} TFLOP/s)")
    log(f"[w4a16-experts] one decode layer's 3 expert launches (C=5), (a) "
        f"64 experts of random rows: kernel {ms:.4f} ms (card alone "
        f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, torch.bmm on the decoded "
        f"bf16 experts {lib_ms:.4f} ms (card alone {lib_dev_ms:.4f}), bound "
        f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB); (b) the served B=4 "
        f"dispatch, {active} experts with a row: kernel {served_ms:.4f} ms "
        f"(card alone {served_dev_ms:.4f}), bound {sb_ms:.4f} ms ({sb_by}, "
        f"{sb_bytes / 1e6:.1f} MB)")
    return {"name": "mixfp4_gemm_w4a16_experts", "route": "cuda",
            "source": "src/repro_torch/csrc/mixfp4_gemm_experts.cuh",
            "replaces": "src/repro/kernels/mixfp4_gemm.py:300",
            "max_abs_err": worst, "tolerance": "1e-3 of max|plain|; "
            "bitwise the 2-D launch per expert",
            "shape": "3 expert projections of one qwen2-moe layer, 64 "
                     "experts, C=5",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms,
            "served_shape": "the same at the served B=4 dispatch, 16 of 64 "
                            "experts with a row",
            "served_ms": served_ms, "served_device_ms": served_dev_ms,
            "served_bound_ms": sb_ms}


def check_moe_heads(dev, flush):
    """Attention, fixed and paged, and the KV write at Qwen1.5-MoE's decode
    shape (B=4, H=Hkv=16, dh=128, g=1) against their plain versions: the
    paged kernel bitwise the fixed one, both within 1e-4 of the plain
    version, the KV bytes bitwise; the non-empty CTAs of the attention
    grid at phase 3m's decode lengths."""
    from repro_torch.kernels import mixfp4_attn as A
    from repro_torch.kernels import mixfp4_quant as Q
    from repro_torch.kernels import tuning
    from repro_torch.models.base import quantize_kv_rows

    b, s, hkv, h, dh = 4, 8192, 16, 16, 128
    rng = np.random.RandomState(12)
    q = torch.tensor(rng.randn(b, h, dh), dtype=torch.float32, device=dev)
    fixed = []
    for _ in range(2):
        fixed += list(quantize_kv_rows(torch.tensor(
            rng.randn(b, s, hkv, dh), dtype=torch.float32, device=dev)))
    mp = s // PAGE_LEN
    bt = torch.tensor(1 + rng.permutation(b * mp).reshape(b, mp),
                      dtype=torch.int32, device=dev)
    slabs = []
    for a in fixed:
        slab = torch.zeros((1 + b * mp, PAGE_LEN, *a.shape[2:]),
                           dtype=a.dtype, device=dev)
        slab[bt.reshape(-1).long()] = a.reshape(b * mp, PAGE_LEN,
                                                *a.shape[2:])
        slabs.append(slab)
    one = torch.ones((), device=dev)
    worst = 0.0
    for lens in (SERVED_LENGTHS, (s, 1, 2048, 300)):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = {"window": 0, "k_scale32": one, "v_scale32": one}
        o = A.mixfp4_attn_decode(q, *fixed, lengths, **kw)
        op = A.mixfp4_attn_decode_paged(q, *slabs, bt, lengths, **kw)
        plain = A.attn_decode_plain(q, *fixed, lengths, **kw)
        torch.cuda.synchronize()
        if not torch.equal(o, op):
            raise AssertionError(f"dh=128 attention {lens}: paged is not "
                                 "bitwise the fixed kernel")
        err = float((o - plain).abs().max())
        worst = max(worst, err)
        if not err <= 1e-4:
            raise AssertionError(f"dh=128 attention {lens}: error {err}")
    ctas = hkv * sum(len(tuning.attn_split_range(n, 0, s))
                     for n in SERVED_LENGTHS)
    lengths_served = torch.tensor(SERVED_LENGTHS, dtype=torch.int32,
                                  device=dev)
    ms = bench(lambda: A.mixfp4_attn_decode(q, *fixed, lengths_served,
                                            **kw), 20, flush)
    b_ms, b_by = attn_bound(attn_rows(lengths_served, s, 0), b, h, hkv, dh)
    log(f"[attn-moe] B=4 H=Hkv=16 (g=1) dh=128, S=8192, lengths "
        f"{SERVED_LENGTHS} and (8192, 1, 2048, 300), global: paged bitwise "
        f"the fixed kernel, max abs error vs plain {worst:.3e} (tolerance "
        f"1e-4); {ctas} non-empty CTAs at the served lengths (132 SMs); "
        f"fixed kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if ctas < 132:
        log(f"[attn-moe] fewer non-empty CTAs ({ctas}) than SMs (132)")

    gen = torch.Generator(device=dev).manual_seed(13)
    lens = torch.tensor(SERVED_LENGTHS, dtype=torch.int32, device=dev)
    for name, rows, tables in (("fixed", (b, s), None),
                               ("paged", (1 + b * mp, PAGE_LEN), bt)):
        k, v = ((3 * torch.randn(b, 1, hkv, dh, device=dev, generator=gen)
                 ).to(torch.bfloat16) for _ in range(2))
        leaves = _kv_leaves(rows, hkv, dh, dev, gen)
        want = [a.clone() for a in leaves]
        Q.quant_kv_plain(k, v, *want, one, one, lens, tables)
        Q.mixfp4_quant_kv(k, v, *leaves, one, one, lens, block_tables=tables)
        torch.cuda.synchronize()
        bad = sum(int((g != w).sum()) for g, w in zip(leaves, want))
        if bad:
            raise AssertionError(f"dh=128 KV write {name}: {bad} bytes "
                                 "differ")
    log("[quant-kv-moe] B=4 x Hkv=16 x dh=128 decode rows into fixed slots "
        "and a permuted pool: bytes bitwise equal to the quantizer + "
        "indexed writes")


# ---------------------------------------------------------------------------
# phase 3: the served path at full width
# ---------------------------------------------------------------------------
def shared_prefix_requests(vocab: int, seed: int, new_tokens: int = 32):
    """Phase 3's six requests, ``new_tokens`` each, in arrival order: a
    seeded 1000-token prefix (62.5 pages of 16, so a hit takes the
    copy-on-write path) with suffixes of 40-250 tokens for four of them,
    one unrelated 300-token prompt and one of 4500 tokens (decode crosses
    the 4096 window).  On a four-slot engine the first two shared-prefix
    requests arrive together; the last two arrive once a slot frees, after
    the first one's prefill completed."""
    from repro_torch.serving.engine import Request

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 1000)
    suffix = [int(v) for v in rng.randint(40, 251, 4)]
    prompts = [np.concatenate([prefix, rng.randint(0, vocab, suffix[0])]),
               rng.randint(0, vocab, 300),
               np.concatenate([prefix, rng.randint(0, vocab, suffix[1])]),
               rng.randint(0, vocab, 4500),
               np.concatenate([prefix, rng.randint(0, vocab, suffix[2])]),
               np.concatenate([prefix, rng.randint(0, vocab, suffix[3])])]
    return [Request(uid=i, prompt=p.astype(np.int32),
                    max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]


LONG_UID = 3                       # the 4500-token request


def serve_path(dev, seed: int, tag: str, params=None,
               arch: str = "gemma2-2b", new_tokens: int = 32,
               kv_quant: str | None = "mixfp4", **kw) -> dict:
    """Serve phase 3's six greedy requests (``new_tokens`` each) at full
    width and depth of ``arch`` with the engine options ``kw`` (the
    fixed-slot W4A16 path without them) over the ``kv_quant`` KV cache,
    from seeded random weights or from ``params`` (packed leaves pass
    through); check every launch counter against what the path implies;
    on an MoE model run one decode step twice on the same state; trace a
    decode window.  Returns the launch counts, the streams and the
    engine's packed parameters.  Weights drawn here are packed one layer
    at a time as they are drawn (the larger models' f32 weights would not
    fit on the card), but for ``act_rht``: its engine rotates the dense
    weights before it packs them."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine

    cfg = configs.config(arch)
    moe = cfg.family == "moe"
    packed_kv = kv_quant == "mixfp4"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if params is None:
        params = build_model(cfg).init(
            seed, device=dev, pack=None if kw.get("act_rht") else "mixfp4")
    engine = ServeEngine(cfg, params, batch_size=4, max_len=8192,
                         kv_quant=kv_quant, device=dev, **kw)
    del params
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name}, {cfg.n_layers} layers at full width, act_quant="
        f"{engine.act_quant}, act_rht={engine.act_rht}, kv_pool="
        f"{kw.get('kv_pool')}, prefill_chunk={engine.prefill_chunk}: init + "
        f"pack {time.perf_counter() - t0:.1f} s; packed projection bytes "
        f"{engine.packed_bytes} ({engine.compression:.2f}x below bf16); "
        f"{engine.kv_quant} KV cache bytes {engine.kv_cache_bytes()} "
        f"(B=4, max_len=8192)")
    reqs = shared_prefix_requests(cfg.vocab, seed, new_tokens)
    pending = list(reqs)
    ops.reset_launch_counts()
    step_ms, admit_ms, long_ms, n_tok = [], {}, [], 0
    t_start = time.perf_counter()
    while pending or engine.has_work():
        while pending:
            t = time.perf_counter()
            if not engine.add_request(pending[0]):
                break
            torch.cuda.synchronize()
            admit_ms[pending.pop(0).uid] = (time.perf_counter() - t) * 1e3
        head = None if engine.scheduler is None else engine.scheduler.head()
        t = time.perf_counter()
        steps_before = engine.decode_steps
        n_tok += len(engine.step())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if head is not None and head.uid == LONG_UID:
            long_ms.append(ms)
        if engine.decode_steps > steps_before:
            step_ms.append(ms)
    wall = time.perf_counter() - t_start
    counts = ops.launch_counts()
    n_pre, n_dec, n_l = (engine.prefill_dispatches, engine.decode_steps,
                         cfg.n_layers)
    per_pass = {name: 0 for name in counts}      # launches per model pass
    # the new K and V rows, into the packed cache
    per_pass["mixfp4_quant_kv"] = n_l if packed_kv else 0
    n_proj = layer_projections(cfg)
    if moe:                  # attention 4 + shared expert 3; experts 3
        per_pass["mixfp4_gemm_w4a16"] = n_proj * n_l
        per_pass["mixfp4_gemm_w4a16_experts"] = 3 * n_l
    elif engine.act_quant == "bf16":
        per_pass["mixfp4_gemm_w4a16"] = n_proj * n_l
    else:                                        # "mixfp4" + RHT
        per_pass["mixfp4_gemm_w4a4_fused"] = n_proj * n_l
        per_pass["fwht_row_scale"] = n_proj * n_l  # the per-row scales
    want = {name: c * (n_pre + n_dec) for name, c in per_pass.items()}
    attn = ("mixfp4_attn_decode" if engine.kv_pool is None
            else "mixfp4_attn_decode_paged")
    # decode passes only, on the packed cache (the bf16 one is read by
    # the plain attention)
    want[attn] = n_l * n_dec if packed_kv else 0
    for r in reqs:
        if len(r.generated) != new_tokens or \
                r.finish_reason != "max_new_tokens":
            raise AssertionError(f"request {r.uid} (prompt {len(r.prompt)}): "
                                 f"{len(r.generated)} tokens, "
                                 f"{r.finish_reason}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if engine.scheduler is None:
        prefill = (f"{n_pre} whole-prompt prefills (median "
                   f"{statistics.median(admit_ms.values()):.1f} ms, the "
                   f"4500-token one {admit_ms[LONG_UID]:.1f} ms)")
    else:
        prefill = (f"{n_pre} prefill chunks of <= {engine.prefill_chunk} "
                   f"tokens, at most "
                   f"{engine.scheduler.max_prefill_tokens_per_step()} "
                   f"prompt tokens in one step (scheduler ledger); steps "
                   f"running the 4500-token prompt's {len(long_ms)} chunks: "
                   f"median {statistics.median(long_ms):.1f} ms, max "
                   f"{max(long_ms):.1f} ms")
    log(f"{tag} prompts {[len(r.prompt) for r in reqs]}, {new_tokens} new "
        f"tokens each: {n_tok} tokens in {wall:.2f} s ({n_tok / wall:.1f} "
        f"tok/s); "
        f"{prefill}; {n_dec} decode steps (median "
        f"{statistics.median(step_ms):.2f} ms); every logit row finite; "
        f"peak device memory {torch.cuda.max_memory_allocated()} B")
    log(f"{tag} launches {counts}; per prefill pass "
        f"{ {k: v for k, v in per_pass.items() if v} }, per decode pass the "
        f"same plus {n_l if packed_kv else 0} {attn} launches")
    if engine.kv_pool is not None:
        rep = engine.pool_report()
        log(f"{tag} pool {rep}; peak concurrency {engine.max_concurrent}")
        if engine.kv_pool.enable_prefix and not (
                rep["prefix_hits"] > 0 and rep["cow_copies"] > 0
                and rep["pages_active"] == 0):
            raise AssertionError(f"pool report {rep}: expected prefix hits, "
                                 "COW copies and no active page at the end")
        if not engine.kv_pool.enable_prefix and (
                rep["prefix_hits"] or rep["cow_copies"]
                or rep["pages_active"]):
            raise AssertionError(f"pool report {rep}: a plain page "
                                 "allocator takes no prefix hit and ends "
                                 "with no active page")
    if moe:
        step_twice(engine, seed, tag)
    profile_decode(engine, seed, tag)
    return {"counts": counts, "params": engine.params,
            "streams": {r.uid: list(r.generated) for r in reqs}}


def layer_projections(cfg) -> int:
    """Packed 2-D projections a layer runs per pass: attention's 4 and the
    MLP's 3 (SwiGLU, GeGLU; an MoE layer's shared expert) or 2 (GeLU)."""
    return 4 + (2 if cfg.mlp_type == "gelu" and not cfg.n_experts else 3)


def step_twice(engine, seed: int, tag: str):
    """Fill every slot with a 300-token prompt, emit the first tokens, then
    run the same decode step twice on copies of one cache state: the
    logits and the new K/V bytes must be bitwise equal (routing, dispatch
    and the combine use no atomics)."""
    from repro_torch.core import qtensor
    from repro_torch.serving.engine import Request

    rng = np.random.RandomState(seed + 5)
    for i in range(engine.batch_size):
        if not engine.add_request(Request(
                uid=200 + i, prompt=rng.randint(
                    0, engine.cfg.vocab, 300).astype(np.int32),
                max_new_tokens=4)):
            raise AssertionError("step_twice requests were not admitted")
    engine.step()
    toks = torch.tensor([r.generated[-1] for r in engine.slots],
                        device=engine.device)
    lens = torch.as_tensor(engine.lengths, device=engine.device)
    out = []
    for _ in range(2):
        cache = {k: (v.replace(payload=v.payload.clone(),
                               scales=v.scales.clone())
                     if isinstance(v, qtensor.QTensor) else v.clone())
                 for k, v in engine.cache.items()}
        logits, cache = engine.model.decode_step(engine.params, toks, cache,
                                                 lens, act=engine.act)
        out.append([logits, cache["k"].payload, cache["v"].payload])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*out)):
        raise AssertionError(f"{tag} the same decode step twice: logits or "
                             "K/V bytes differ")
    while engine.has_work():
        engine.step()
    log(f"{tag} one decode step (B=4, 300-token prompts) run twice on the "
        f"same state: logits and K/V bytes bitwise equal")


# the operators of a decode step whose PyTorch kernels include a memset
# (greedy sampling and the finite-logits check); none is in a GEMM wrapper
STEP_MEMSET_OPS = {"aten::argmax", "aten::all"}


# trace row substring -> the wrappers whose launches run those kernels
TRACE_WRAPPERS = {
    "w4a16_": ("mixfp4_gemm_w4a16", "mixfp4_gemm_w4a16_experts"),
    "w4a4_": ("mixfp4_gemm_w4a4", "mixfp4_gemm_w4a4_fused"),
    "attn_decode_kernel": ("mixfp4_attn_decode", "mixfp4_attn_decode_paged"),
    "quant_rows_kernel": ("mixfp4_quant_rows",),
    "quant_kv_kernel": ("mixfp4_quant_kv",),
    "fwht_rows_kernel": ("fwht_rows",),
    "fwht_row_scale_kernel": ("fwht_row_scale",),
}


def profile_decode(engine, seed: int, tag: str):
    """Fill every slot with a 1024-token prompt, then trace five decode
    steps with ``torch.profiler``: device time by kernel, and the share of
    the traced window in which the device was busy.  A chunked engine
    first runs every prefill chunk, so the window holds decode only."""
    from repro_torch.core import qtensor
    from repro_torch.serving.engine import Request

    steps = 5
    chunk_steps = (0 if engine.scheduler is None
                   else engine.batch_size * -(-1024 // engine.prefill_chunk))
    rng = np.random.RandomState(seed + 2)
    for i in range(engine.batch_size):
        if not engine.add_request(Request(
                uid=100 + i, prompt=rng.randint(
                    0, engine.cfg.vocab, 1024).astype(np.int32),
                max_new_tokens=steps + 8 + chunk_steps)):
            raise AssertionError("profile requests were not admitted")
    for _ in range(3 + chunk_steps):       # prefill, first tokens, warm-up
        engine.step()
    if engine.scheduler is not None and engine.scheduler.pending_jobs:
        raise AssertionError("prefill chunks left in the traced window")
    prof, step_ms, win_ms, wrapped = traced(engine.step, steps)
    while engine.has_work():
        engine.step()
    # device rows only: an aten:: row also carries the device time of the
    # kernels it launched, and those have rows of their own
    by_kernel = {ev.key: (ev.self_device_time_total / 1e3 / steps,
                          ev.count // steps)
                 for ev in kernel_rows(prof) if ev.self_device_time_total > 0}
    busy = sum(ms for ms, _ in by_kernel.values()) * steps
    # one GEMM launch per projection, all of them the decode variant (a
    # second kernel of the GEMM sources, such as a split reduction, would
    # show as another w4a* row); the memsets of the step, by the operator
    # that launched them (phase 2 traces one call of each GEMM alone)
    rows = {ev.key: ev.count for ev in kernel_rows(prof)}
    gemm = {key: c for key, c in rows.items()
            if "w4a16_" in key or "w4a4_" in key}
    n_gemm = sum(gemm.values())
    per_layer = layer_projections(engine.cfg) + (3 if engine.cfg.n_experts
                                                 else 0)
    want = per_layer * engine.cfg.n_layers * steps
    memsets = collections.Counter(
        ev.name for ev in prof.events() for kern in ev.kernels
        if "memset" in kern.name.lower())
    trace_rows = {k: sum(c for key, c in rows.items() if k in key)
                  for k in ("w4a16_", "experts_decode", "w4a4_",
                            "attn_decode_kernel",
                            "quant_rows_kernel", "quant_kv_kernel",
                            "fwht_rows_kernel", "fwht_row_scale_kernel")}
    launches = sum(rows.values()) / steps
    log(f"[profile] {tag} launches in the window: wrappers {wrapped}; "
        f"trace rows {trace_rows} ('experts_decode': the expert GEMM's "
        f"decode kernel); device launches per decode step "
        f"{launches:.1f} (every kernel, memset and copy row)")
    want_experts = (3 if engine.cfg.n_experts else 0) * \
        engine.cfg.n_layers * steps
    if n_gemm != want or not all("_decode_kernel" in key for key in gemm) \
            or trace_rows["experts_decode"] != want_experts:
        raise AssertionError(f"{tag} traced GEMM rows {gemm} ({n_gemm}, "
                             f"expected {want} decode-variant launches, "
                             f"{want_experts} of them the expert kernel)")
    # every launch a wrapper counted shows in the trace, and no other
    want_attn = (engine.cfg.n_layers * steps
                 if isinstance(engine.cache["k"], qtensor.QTensor) else 0)
    for key, names in TRACE_WRAPPERS.items():
        n_wrapped = sum(wrapped.get(name, 0) for name in names)
        if trace_rows[key] != n_wrapped:
            raise AssertionError(f"{tag} trace rows {key!r}: "
                                 f"{trace_rows[key]}, the wrappers counted "
                                 f"{n_wrapped} ({names})")
    if trace_rows["attn_decode_kernel"] != want_attn or \
            trace_rows["quant_kv_kernel"] != want_attn:
        raise AssertionError(f"{tag} traced attention / KV write rows "
                             f"{trace_rows}: expected {want_attn} each")
    if not set(memsets) <= STEP_MEMSET_OPS:
        raise AssertionError(f"{tag} memsets by {dict(memsets)}: only the "
                             f"step's {sorted(STEP_MEMSET_OPS)} may launch "
                             "one")
    log(f"[profile] {tag} B={engine.batch_size}, ~1024 tokens of context: "
        f"{steps} decode steps, median {statistics.median(step_ms):.2f} "
        f"ms/step; "
        f"device busy {busy:.2f} of {win_ms:.2f} ms "
        f"({100 * busy / win_ms:.1f} %); {n_gemm // steps} GEMM launches "
        f"per step, all decode-variant; memsets over the {steps} steps by "
        f"launching operator {dict(memsets)}")
    if engine.cfg.n_experts:
        experts = sum(ms for name, (ms, _) in by_kernel.items()
                      if "experts_decode_kernel" in name)
        log(f"[profile] {tag} expert GEMM device time {experts:.4f} "
            f"ms/step ({3 * engine.cfg.n_layers} launches), the rest "
            f"{busy / steps - experts:.4f} ms/step")
    for name, (ms, calls) in sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile] {ms:9.4f} ms/step {calls:5d} launches/step  "
            f"{name[:90]}")


def decode_step_ab(dev, params, seed: int, rounds: int = 8):
    """Host-clock decode step time of the fixed-slot and the paged engine
    (each B = 4, four 1024-token prompts) in alternating turns (fixed,
    paged, paged, fixed), in one process on one card: the phases' own
    medians run minutes apart on a shared host."""
    from repro_torch import configs
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = configs.config("gemma2-2b")
    engines = {}
    for name, kw in (("fixed", {}), ("paged", {"kv_pool": 2049,
                                               "kv_page_len": PAGE_LEN})):
        engine = ServeEngine(cfg, params, batch_size=4, max_len=8192,
                             kv_quant="mixfp4", device=dev, **kw)
        rng = np.random.RandomState(seed + 4)
        for i in range(engine.batch_size):
            engine.add_request(Request(uid=i, prompt=rng.randint(
                0, cfg.vocab, 1024).astype(np.int32),
                max_new_tokens=4 * rounds + 8))
        for _ in range(3):
            engine.step()
        engines[name] = engine
    times = {name: [] for name in engines}
    for name in ("fixed", "paged", "paged", "fixed") * (rounds // 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engines[name].step()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) * 1e3)
    log(f"[serve-paged] decode step at B=4, 1024 tokens of context, "
        f"{2 * rounds} steps each in alternating turns: fixed-slot median "
        f"{statistics.median(times['fixed']):.2f} ms (min "
        f"{min(times['fixed']):.2f}), paged median "
        f"{statistics.median(times['paged']):.2f} ms (min "
        f"{min(times['paged']):.2f})")


# ---------------------------------------------------------------------------
# phase 4: card vs CPU on the same packed bytes
# ---------------------------------------------------------------------------
def card_vs_cpu(dev, seed: int, w4a4: bool = False,
                arch: str = "gemma2-2b", kv_quant: str | None = "mixfp4",
                paged: bool = False) -> dict:
    """``arch`` at full width cut to 2 layers, on the card and on the CPU
    from the same packed bytes, over the ``kv_quant`` KV cache: W4A16, or
    with ``w4a4`` the fused W4A4 + RHT path, whose card logits must also
    equal the two-pass spelling's bitwise; with ``paged`` the card also
    runs through a paged pool (a permuted block table), whose logits must
    equal the fixed-slot ones bitwise.  Returns the launch counts of the
    two-pass card run (the path that drives the packed W4A4 kernel,
    ``fwht_rows`` and the activation quantizer) or of the paged one, or
    {}."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.base import ActQuant, pack_projections

    cfg = configs.config(arch).replace(n_layers=2)
    model = build_model(cfg)
    packed, _, _ = pack_projections(model.init(seed, device=dev),
                                    act_rht=w4a4)
    moe = cfg.family == "moe"
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

    def run(params, device, act, pages: bool = False):
        cache = model.init_cache(1, 128, kv_quant=kv_quant, device=device,
                                 pages=(9, PAGE_LEN) if pages else None)
        if pages:                       # the lane's 8 pages, permuted
            cache["pages"][0] = torch.tensor(
                1 + rng.permutation(8), dtype=torch.int32, device=device)
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
    if w4a4:
        path = {"mixfp4_gemm_w4a4_fused", "fwht_row_scale"}
    else:
        path = {"mixfp4_gemm_w4a16"} | (
            {"mixfp4_gemm_w4a16_experts"} if moe else set())
    if kv_quant == "mixfp4":
        path |= {"mixfp4_quant_kv", "mixfp4_attn_decode"}
    if set(used) != path:
        raise AssertionError(f"the card run took other kernels: {used}")
    cpu = run(packed_cpu, torch.device("cpu"), act)
    if not torch.isfinite(gpu).all():
        raise AssertionError("non-finite logits on the card")
    err = float(((gpu - cpu).abs() / cpu.abs().max()).max())
    agree = int((gpu.argmax(-1) == cpu.argmax(-1)).sum())
    if not err <= 2e-2:
        raise AssertionError(f"card vs CPU logits: normalised error {err}")
    tag = ("[card-vs-cpu-w4a4]" if w4a4 else
           "[card-vs-cpu-moe]" if moe else
           "[card-vs-cpu]" if arch == "gemma2-2b" else
           f"[card-vs-cpu-{arch}]")
    log(f"{tag} {cfg.name} width, 2 layers, act_quant={act.mode}, "
        f"act_rht={act.rht}, {kv_quant or 'bf16'} KV cache: prefill of 64 "
        f"tokens + 4 teacher-forced decode steps; logits normalised by "
        f"max|CPU| agree to {err:.3e} (tolerance 2e-2); argmax agrees on "
        f"{agree}/5 rows")
    if paged:
        ops.reset_launch_counts()
        through_pool = run(packed, dev, act, pages=True)
        counts = ops.launch_counts()
        n_l = cfg.n_layers
        if counts["mixfp4_attn_decode_paged"] != n_l * len(forced) or \
                counts["mixfp4_attn_decode"]:
            raise AssertionError(f"paged card run launched {counts}")
        if not torch.equal(through_pool, gpu):
            raise AssertionError(f"{tag} logits through the paged pool "
                                 "differ from the fixed-slot ones")
        log(f"{tag} through a paged pool (8 permuted pages of 16): logits "
            f"bitwise the fixed-slot card run's; "
            f"{counts['mixfp4_attn_decode_paged']} paged attention "
            "launches")
        return counts
    if not w4a4:
        return {}
    ops.reset_launch_counts()
    two = run(packed, dev, ActQuant("mixfp4-2pass-rowscale", rht=True))
    counts = ops.launch_counts()
    n_l, passes = cfg.n_layers, 1 + len(forced)
    want = {"mixfp4_quant_rows": 7 * n_l * passes, "mixfp4_gemm_w4a16": 0,
            "mixfp4_gemm_w4a16_experts": 0,
            "mixfp4_attn_decode": n_l * len(forced),
            "mixfp4_attn_decode_paged": 0,
            "mixfp4_gemm_w4a4": 7 * n_l * passes,
            "mixfp4_gemm_w4a4_fused": 0, "fwht_rows": 7 * n_l * passes,
            "mixfp4_quant_kv": n_l * passes, "fwht_row_scale": 0}
    if counts != want:
        raise AssertionError(f"two-pass launch counts {counts}, expected "
                             f"{want}")
    if not torch.equal(gpu, two):
        raise AssertionError("fused and two-pass (mixfp4-2pass-rowscale) "
                             "logits differ on the card")
    log(f"{tag} fused == mixfp4-2pass-rowscale logits on the card, bitwise; "
        f"the two-pass run launched {counts}")
    return counts


def kv_rows(engine, slot: int, n: int) -> dict:
    """The packed K/V bytes of logical rows [0, n) of ``slot``, read
    through the block table on a paged engine."""
    out = {}
    for name in ("k", "v"):
        for child in ("payload", "scales"):
            a = getattr(engine.cache[name], child)
            if "pages" in engine.cache:
                pos = torch.arange(n, device=a.device)
                bt = engine.cache["pages"][slot].long()
                out[name, child] = a[:, bt[pos // engine.kv_page_len],
                                     pos % engine.kv_page_len]
            else:
                out[name, child] = a[:, slot, :n]
    return out


def chunked_prefix_vs_whole(dev, seed: int):
    """gemma2-2b at full width cut to 2 layers: an 1100-token prompt that
    shares its first 1000 tokens with an earlier one, prefilled (a) whole
    into a fixed slot and (b) in 512-token chunks into the paged pool,
    suffix only after the prefix hit.  Its first token and every real K/V
    row's bytes must be equal, and so must the logits of the next decode
    step: a query row's prefill result may not depend on how many rows
    share its call."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.base import pack_projections
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = configs.config("gemma2-2b").replace(n_layers=2)
    packed, _, _ = pack_projections(build_model(cfg).init(seed, device=dev))
    rng = np.random.RandomState(seed + 3)
    first = rng.randint(0, cfg.vocab, 1000).astype(np.int32)
    second = np.concatenate([first, rng.randint(0, cfg.vocab, 100).astype(
        np.int32)])
    common = {"batch_size": 2, "max_len": 8192, "kv_quant": "mixfp4",
              "device": dev}
    whole = ServeEngine(cfg, packed, **common)
    paged = ServeEngine(cfg, packed, kv_pool=1025, kv_page_len=16,
                        prefill_chunk=512, **common)
    paged.add_request(Request(uid=0, prompt=first, max_new_tokens=1))
    while paged.has_work():                   # its pages become a prefix
        paged.step()
    reqs = [Request(uid=1, prompt=second, max_new_tokens=8)
            for _ in range(2)]
    for engine, req in zip((whole, paged), reqs):
        if not engine.add_request(req):
            raise AssertionError("phase 4c admission refused")
        while req._next is None:
            engine.step()
    # the paged engine's last chunk step also emitted the first token and
    # decoded once; one step brings the whole-prompt engine level
    whole.step()
    rep = paged.pool_report()
    if rep["prefix_hit_tokens"] != 1000 or rep["cow_copies"] != 1:
        raise AssertionError(f"phase 4c pool report {rep}")
    if reqs[0].generated != reqs[1].generated:
        raise AssertionError(f"first tokens differ: whole "
                             f"{reqs[0].generated}, chunked "
                             f"{reqs[1].generated}")
    slot = [next(i for i, x in enumerate(e.slots) if x is r)
            for e, r in zip((whole, paged), reqs)]
    n = len(second) + 1                 # the prompt and one decoded row
    rows = [kv_rows(e, i, n) for e, i in zip((whole, paged), slot)]
    bad = [k for k in rows[0] if not torch.equal(rows[0][k], rows[1][k])]
    if bad:
        raise AssertionError(f"K/V rows differ between whole and chunked "
                             f"prefix-hit prefill: {bad}")
    logits = []
    for e, r in zip((whole, paged), reqs):
        toks = torch.zeros(e.batch_size, dtype=torch.int64, device=dev)
        toks[slot[0]] = r.generated[-1]
        out, e.cache = e.model.decode_step(
            e.params, toks, e.cache, torch.as_tensor(e.lengths, device=dev),
            act=e.act)
        logits.append(out[slot[0]])
    if slot[0] != slot[1] or not torch.equal(logits[0], logits[1]):
        raise AssertionError("decode logits after whole and chunked "
                             "prefix-hit prefill differ")
    log(f"[chunked-vs-whole] gemma2-2b width, 2 layers: a 1100-token prompt "
        f"sharing 1000 tokens with an earlier one, prefilled whole (fixed "
        f"slot, bucket 1152) and as a 100-token suffix in one 512-row chunk "
        f"after a prefix hit (62 shared pages + 1 COW page): first tokens "
        f"{reqs[0].generated}, all {n} K/V rows of 2 layers bitwise equal, "
        f"next decode step's logits bitwise equal")


# phase 3d: arch -> (tag, KV cache); Danube's head_dim (120) takes no
# packed cache
DENSE = {"phi3-medium-14b": ("phi3", "mixfp4"),
         "starcoder2-15b": ("starcoder2", "mixfp4"),
         "h2o-danube-3-4b": ("danube", None)}


# ---------------------------------------------------------------------------
# phase 3L: the serving lifecycle at full width
# ---------------------------------------------------------------------------
LIFE_NEW = 8                       # new tokens per request in phase 3L
# pages of the pool that must defer the 4500-token request (282 pages)
# while the first three requests (90-116 pages) decode, yet could hold it
# alone
LIFE_POOL = 300


def first_tokens(streams: dict) -> dict:
    return {uid: s[:LIFE_NEW] for uid, s in streams.items()}


def life_engine(dev, params, arch: str = "gemma2-2b", **kw):
    """A four-slot engine over the packed MixFP4 KV cache at full width,
    on packed weights an earlier phase holds."""
    from repro_torch import configs
    from repro_torch.serving.engine import ServeEngine
    return ServeEngine(configs.config(arch), params, batch_size=4,
                       max_len=8192, kv_quant="mixfp4", device=dev, **kw)


def capture_rows(engine, uids) -> dict:
    """uid -> the packed K/V bytes of every row that request wrote, read
    from its slot as it finishes (the engine's terminal transition is
    wrapped; the slot is reused afterwards)."""
    rows = {}
    finish = engine._finish_request

    def capture(i, state, reason, error=None):
        req = engine.slots[i]
        if req.uid in uids:
            rows[req.uid] = {k: v.clone() for k, v in kv_rows(
                engine, i, int(engine.lengths[i])).items()}
        finish(i, state, reason, error=error)

    engine._finish_request = capture
    return rows


def drain(engine, streams: dict, steps: int | None = None) -> dict:
    """Step ``engine`` until it has no work (or ``steps`` times), adding
    the emitted tokens to ``streams``."""
    n = 0
    while engine.has_work() and (steps is None or n < steps):
        for uid, tok in engine.step():
            streams.setdefault(uid, []).append(tok)
        n += 1
    return streams


def lifecycle_dense(dev, seed: int, params, streams: dict, smi: str):
    """Phase 3L (a)-(c) on gemma2-2b's W4A16 weights (phase 3's): (a) the
    six requests through ``submit`` with ``max_queue=6`` on the system
    clock, streams equal to phase 3's first 8 tokens, TTFT/ITL and the
    queue gauges; (b) the chaos schedules of seeds 0 and 1, no violated
    invariant against (a); (c) a pool too small for the mix with
    ``degrade_after_deferrals=1``: the paged -> fixed-slot rung fires
    while three requests are mid-stream, every stream equal to phase 3's
    whole 32 tokens, and the K/V bytes of the migrated requests bitwise
    (a)'s rows.  Returns (a)'s rows of all six requests (uid -> packed
    K/V bytes), phase 3R's oracle."""
    from repro_torch import configs
    from repro_torch.serving import faults
    from repro_torch.serving.engine import RequestState

    cfg = configs.config("gemma2-2b")
    want = first_tokens(streams)
    # (a) the bounded queue on the system clock
    eng = life_engine(dev, params, max_queue=6)
    rows_a = capture_rows(eng, set(range(len(streams))))
    reqs = shared_prefix_requests(cfg.vocab, seed, LIFE_NEW)
    for r in reqs:
        eng.submit(r)
    depth = []
    t = time.perf_counter()
    while eng.has_work():
        eng.step()
        depth.append(int(eng.metrics_report()["gauges"]["queue_depth"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = {r.uid: list(r.generated) for r in reqs}
    if got != want or any(r.state is not RequestState.FINISHED
                          for r in reqs):
        raise AssertionError(f"[lifecycle] (a) streams {got} differ from "
                             "phase 3's first tokens, or a request did not "
                             "finish")
    rep = eng.metrics_report()
    ttft, itl = rep["histograms"]["ttft_ms"], rep["histograms"]["itl_ms"]
    log(f"[lifecycle] (a) gemma2-2b W4A16, fixed slots, system clock, "
        f"max_queue=6: six requests submitted at once, {LIFE_NEW} new "
        f"tokens each, streams equal phase 3's first {LIFE_NEW} tokens; "
        f"{wall:.2f} s; TTFT p50 {ttft['p50']:.2f} ms p99 "
        f"{ttft['p99']:.2f} ms (n={ttft['count']}); ITL p50 "
        f"{itl['p50']:.2f} ms p99 {itl['p99']:.2f} ms (n={itl['count']}); "
        f"queue depth after each step {depth}, gauges "
        f"{ {k: rep['gauges'][k] for k in ('queue_depth', 'max_queue', 'active_slots')} }; "
        f"card {smi}")
    del eng
    # (b) seeded chaos schedules against (a)
    prompts = [r.prompt for r in reqs]
    for s in (0, 1):
        inj = faults.FaultInjector(s, faults.schedule_for_seed(
            s, n_requests=len(prompts)))
        eng = life_engine(dev, params, max_queue=6, faults=inj)
        out = faults.drive(eng, prompts, max_new_tokens=LIFE_NEW)
        bad = faults.check_invariants({"streams": want}, out, inj,
                                      eng.pool_report())
        if bad:
            raise AssertionError(f"[lifecycle] (b) seed {s}: {bad}")
        log(f"[lifecycle] (b) seed {s}: schedule_for_seed, {len(inj.log)} "
            f"events {inj.summary()['by_kind']}; states "
            f"{ {u: str(st) for u, st in out['states'].items()} }; no "
            f"violated invariant against (a); counters {dict(eng.counters)}")
        del eng
    # (c) the paged -> fixed-slot rung with three requests mid-stream
    eng = life_engine(dev, params, max_queue=6, kv_pool=LIFE_POOL,
                      kv_page_len=PAGE_LEN, degrade_after_deferrals=1)
    rows_c = capture_rows(eng, {0, 1, 2})
    reqs = shared_prefix_requests(cfg.vocab, seed)
    got = {}
    for r in reqs[:3]:
        eng.submit(r)
    drain(eng, got, steps=2)
    held = eng.pool_report()
    for r in reqs[3:]:
        eng.submit(r)
    drain(eng, got)
    if eng.counters["degraded_paged_to_fixed"] != 1 or got != streams:
        raise AssertionError(f"[lifecycle] (c) counters "
                             f"{dict(eng.counters)}; streams {got} vs "
                             f"{streams}")
    if eng.pool_report() is not None or "pages" in eng.cache:
        raise AssertionError("[lifecycle] (c) the engine still holds a "
                             "pool after the rung")
    differ = total = 0
    for uid in (0, 1, 2):
        for key, a in rows_a[uid].items():
            # (a)'s rows: the prompt and its first 7 generated tokens
            differ += int((a != rows_c[uid][key][:, :a.shape[1]]).sum())
            total += a.numel()
    if differ:
        raise AssertionError(f"[lifecycle] (c) {differ} of {total} K/V "
                             "bytes of the migrated requests differ from "
                             "(a)'s rows")
    log(f"[lifecycle] (c) pool of {LIFE_POOL} pages: {held['pages_active']} "
        f"pages active under three mid-stream requests, the 4500-token "
        f"admission deferred {reqs[3]._deferrals} time(s), "
        f"degraded_paged_to_fixed=1; after the drain no pool (0 pages "
        f"active) and all six streams equal phase 3's, all "
        f"{len(streams[0])} tokens; the migration replayed "
        f"{eng.replay_decode_steps} decode passes; K/V bytes of the three "
        f"migrated requests that differ from (a)'s rows (prompt and first "
        f"{LIFE_NEW - 1} generated, written one decode at a time): "
        f"{differ} of {total}")
    return rows_a


# ---------------------------------------------------------------------------
# phase 3R: crash recovery and the graceful drain at full width
# ---------------------------------------------------------------------------
JOURNAL_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "journal")
# crash boundaries (steps completed before the crash) of the fixed-slot
# mix, whose 14 steps admit four requests at step 1 and two at step 8:
# two requests queued behind four at 2 tokens; the four at 7 of 8 tokens
# (the longest replay, six decode passes) with two queued; four finished
# and two at 4 tokens
CRASH_FIXED = (1, 6, 10)
# the same mix on the pool with 512-token chunks
CRASH_PAGED = (4, 12)


def w4a16_pass(n_l: int, decode: bool, paged: bool) -> dict:
    """Launches of one W4A16 model pass over the packed KV cache: 7 GEMMs
    and one KV write per layer, and on a decode pass one attention."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.KERNELS, 0)
    want["mixfp4_gemm_w4a16"] = 7 * n_l
    want["mixfp4_quant_kv"] = n_l
    if decode:
        want["mixfp4_attn_decode_paged" if paged
             else "mixfp4_attn_decode"] = n_l
    return want


def fresh_journal(name: str) -> str:
    import shutil
    path = os.path.join(JOURNAL_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def free_engine(engine):
    """Drop an engine's device memory before the next one is built (the
    row-capture wrapper holds a reference cycle to it)."""
    import gc
    engine.cache = engine.params = None
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def timed_recover(engine) -> dict:
    """``engine.recover()`` with its wall time, its replays' wall times
    and decode passes, and its launches held to what its prefill and
    replay passes imply (no plain version, no CPU)."""
    from repro_torch.kernels import ops

    replays = []
    replay = engine._replay_histories

    def timed(lanes, **kw):
        torch.cuda.synchronize()
        n, t = engine.replay_decode_steps, time.perf_counter()
        replay(lanes, **kw)
        torch.cuda.synchronize()
        replays.append({"lanes": len(lanes),
                        "ms": (time.perf_counter() - t) * 1e3,
                        "decode_passes": engine.replay_decode_steps - n})

    engine._replay_histories = timed
    ops.reset_launch_counts()
    n_pre = engine.prefill_dispatches
    torch.cuda.synchronize()
    t = time.perf_counter()
    report = engine.recover()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    engine._replay_histories = replay
    n_l, paged = engine.cfg.n_layers, engine.kv_pool is not None
    n_pre = engine.prefill_dispatches - n_pre
    n_dec = sum(r["decode_passes"] for r in replays)
    pre, dec = w4a16_pass(n_l, False, paged), w4a16_pass(n_l, True, paged)
    want = {k: n_pre * pre[k] + n_dec * dec[k] for k in pre}
    if ops.launch_counts() != want:
        raise AssertionError(f"[recovery] recover() launched "
                             f"{ops.launch_counts()}, expected {want} "
                             f"({n_pre} prefill, {n_dec} replay passes)")
    return {"report": report, "ms": wall, "replays": replays,
            "prefills": n_pre, "launches": sum(want.values())}


def check_rows(tag: str, rows: dict, want: dict):
    """Every captured request's K/V bytes equal the uninterrupted run's."""
    for uid, got in rows.items():
        bad = [k for k, a in want[uid].items() if not torch.equal(a, got[k])]
        if bad:
            raise AssertionError(f"[recovery] {tag} uid {uid}: K/V bytes "
                                 f"{bad} differ from the uninterrupted run")


def crash_and_recover(dev, seed: int, params, boundary: int, tag: str,
                      want: dict, rows_want: dict, **kw) -> dict:
    """Journal phase 3's six requests (8 new tokens, ``"always"``) and
    crash at ``boundary``: the engine is abandoned unflushed, a fresh one
    built on the same journal recovers and drains.  Gates: every stream
    (tokens before the crash and after) equal to ``want``, every request
    FINISHED, each request's K/V bytes equal to ``rows_want`` (the
    resumed ones' rows rebuilt by the replay), and on a pool no page left
    active."""
    from repro_torch import configs
    from repro_torch.serving import faults
    from repro_torch.serving.engine import RequestState

    jdir = fresh_journal(f"{tag}-{boundary}")
    inj = faults.FaultInjector(boundary, [faults.FaultRule(
        "process_crash", "error", at=(boundary,))])
    eng = life_engine(dev, params, max_queue=6, faults=inj, journal_dir=jdir,
                      journal_sync="always", **kw)
    rows = capture_rows(eng, set(want))
    reqs = shared_prefix_requests(configs.config("gemma2-2b").vocab, seed,
                                  LIFE_NEW)
    for r in reqs:
        eng.submit(r)
    streams = {}
    try:
        drain(eng, streams)
        raise AssertionError(f"[recovery] {tag}: no crash at {boundary}")
    except faults.InjectedFault as e:
        if e.site != "process_crash":
            raise
    at_crash = collections.Counter(
        "queued" if r.state is RequestState.QUEUED else
        "finished" if r.state is RequestState.FINISHED else
        "prefilling" if not r.generated else "mid-stream" for r in reqs)
    free_engine(eng)
    eng = life_engine(dev, params, max_queue=6, journal_dir=jdir,
                      journal_sync="always", **kw)
    rows_after = capture_rows(eng, set(want))
    rec = timed_recover(eng)
    drain(eng, streams)
    rows.update(rows_after)
    pool = eng.pool_report()
    done = all(eng.requests[u].state is RequestState.FINISHED
               for u in eng.recovered_uids)
    free_engine(eng)
    if streams != want or not done or sorted(rows) != sorted(want):
        raise AssertionError(f"[recovery] {tag} crash at {boundary}: "
                             f"streams {streams} vs {want}; all finished "
                             f"{done}; rows of {sorted(rows)}")
    if pool is not None and pool["pages_active"]:
        raise AssertionError(f"[recovery] {tag}: {pool['pages_active']} "
                             "pages still active")
    check_rows(f"{tag} crash at {boundary}", rows, rows_want)
    rec["at_crash"] = dict(at_crash)
    return rec


def recovery_phase(dev, seed: int, params, streams: dict, rows_a: dict,
                   smi: str):
    """Phase 3R on phase 3's (and 3c's) gemma2-2b W4A16 weights, 8 new
    tokens: (a) crashes of the fixed-slot mix at ``CRASH_FIXED``, (b) of
    the mix on 3c's pool with 512-token chunks at ``CRASH_PAGED``, each
    recovered by a fresh engine (:func:`crash_and_recover`) against phase
    3's first 8 tokens and 3L(a)'s K/V rows; (c) a drain cut by
    ``max_steps`` mid-stream, its survivors recovered with equal streams
    and rows; (d) the wall ms of each ``recover()`` and of its replay, and
    the replay's decode passes."""
    from repro_torch.serving.engine import RequestState

    want = first_tokens(streams)
    t0 = time.perf_counter()
    runs = []
    for k in CRASH_FIXED:
        runs.append(("(a) fixed slots", k, crash_and_recover(
            dev, seed, params, k, "fixed", want, rows_a)))
    for k in CRASH_PAGED:
        runs.append(("(b) pool + 512-token chunks", k, crash_and_recover(
            dev, seed, params, k, "paged", want, rows_a, kv_pool=2049,
            kv_page_len=PAGE_LEN, prefill_chunk=512)))
    kinds = [set(r[2]["at_crash"]) for r in runs[:len(CRASH_FIXED)]]
    if not ({"queued", "mid-stream"} <= kinds[0]
            and "finished" in kinds[-1] and "mid-stream" in kinds[-1]):
        raise AssertionError(f"[recovery] (a) crash states {kinds}")
    for what, k, r in runs:
        rp = r["report"]
        log(f"[recovery] {what}: process_crash after {k} steps "
            f"({r['at_crash']}); fresh engine recover(): {rp['resumed']} "
            f"resumed, {rp['already_terminal']} already terminal, "
            f"{r['prefills']} prompt prefills and {len(r['replays'])} "
            f"replay(s) of {[x['decode_passes'] for x in r['replays']]} "
            f"decode passes over {[x['lanes'] for x in r['replays']]} "
            f"lanes; {r['launches']} launches, exactly those passes'; "
            f"streams equal phase 3's first {LIFE_NEW} tokens, every "
            f"request FINISHED, every request's K/V bytes equal 3L(a)'s")
    # (c) the drain cut mid-stream, its survivors recovered
    from repro_torch import configs
    jdir = fresh_journal("drain")
    eng = life_engine(dev, params, max_queue=6, journal_dir=jdir)
    rows = capture_rows(eng, set(want))
    reqs = shared_prefix_requests(configs.config("gemma2-2b").vocab, seed,
                                  LIFE_NEW)
    for r in reqs:
        eng.submit(r)
    drained = eng.drain(max_steps=4)
    got = {r.uid: list(r.generated) for r in reqs}
    fsyncs = eng.journal.fsyncs
    free_engine(eng)
    if drained["drained"] or len(drained["survivors"]) != len(reqs):
        raise AssertionError(f"[recovery] (c) drain report {drained}")
    eng = life_engine(dev, params, max_queue=6, journal_dir=jdir)
    rows_after = capture_rows(eng, set(want))
    rec = timed_recover(eng)
    drain(eng, got)
    rows.update(rows_after)
    done = all(r.state is RequestState.FINISHED
               for r in eng.requests.values())
    free_engine(eng)
    if got != want or not done:
        raise AssertionError(f"[recovery] (c) streams {got} vs {want}")
    if sorted(rows) != sorted(want):
        raise AssertionError(f"[recovery] (c) rows of {sorted(rows)}")
    check_rows("(c)", rows, rows_a)
    runs.append(("(c) drain", 4, rec))
    log(f"[recovery] (c) drain(max_steps=4): {drained['completed']} "
        f"completed, survivors {drained['survivors']} journaled with the "
        f"ledger ({fsyncs} fsync(s) under 'batch'); a fresh engine "
        f"resumed {rec['report']['resumed']}, replay passes "
        f"{[x['decode_passes'] for x in rec['replays']]}; streams equal "
        f"phase 3's first {LIFE_NEW} tokens, K/V bytes equal 3L(a)'s")
    # (d) what recovery costs
    for what, k, r in runs:
        log(f"[recovery] (d) {what} at {k}: recover() {r['ms']:.2f} ms "
            f"wall, of it replay "
            f"{sum(x['ms'] for x in r['replays']):.2f} ms over "
            f"{sum(x['decode_passes'] for x in r['replays'])} decode "
            f"passes, {r['prefills']} prompt prefills; card {smi}")
    log(f"[recovery] phase 3R {time.perf_counter() - t0:.2f} s")


def w4a4_pass(n_l: int, mode: str, decode: bool) -> dict:
    """Launches of one W4A4 + RHT model pass: per projection the fused
    GEMM and its row scale, or after the fused rung the RHT, the row
    quantizer and the packed GEMM; one KV write per layer, and one
    attention launch per layer on a decode pass."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.KERNELS, 0)
    if mode == "mixfp4":
        names = ("mixfp4_gemm_w4a4_fused", "fwht_row_scale")
    else:
        names = ("fwht_rows", "mixfp4_quant_rows", "mixfp4_gemm_w4a4")
    for name in names:
        want[name] = 7 * n_l
    want["mixfp4_quant_kv"] = n_l
    want["mixfp4_attn_decode"] = n_l if decode else 0
    return want


def step_w4a4_exact(eng) -> tuple[dict, collections.Counter]:
    """Step a W4A4 + RHT engine (fixed slots) until it has no work, each
    step's launches exactly its passes' (:func:`w4a4_pass`, in the mode
    before the step for its prefills and after it for its decode, since
    the fused rung fires inside the decode).  Returns the emitted streams
    and the decode steps run in each ``act_quant`` mode."""
    from repro_torch.kernels import ops

    n_l = eng.cfg.n_layers
    streams, sides = {}, collections.Counter()
    ops.reset_launch_counts()
    while eng.has_work():
        before, mode = ops.launch_counts(), eng.act_quant
        n_pre, n_dec = eng.prefill_dispatches, eng.decode_steps
        for uid, tok in eng.step():
            streams.setdefault(uid, []).append(tok)
        n_pre, n_dec = eng.prefill_dispatches - n_pre, eng.decode_steps - n_dec
        pre = w4a4_pass(n_l, mode, False)
        dec = w4a4_pass(n_l, eng.act_quant, True)
        want = {k: n_pre * pre[k] + n_dec * dec[k] for k in pre}
        got = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if got != want:
            raise AssertionError(f"step launches {got}, expected {want} "
                                 f"({n_pre} prefill, {n_dec} decode "
                                 f"passes, {mode} -> {eng.act_quant})")
        sides[eng.act_quant] += n_dec
    return streams, sides


def lifecycle_fused_rung(dev, seed: int, params, streams: dict):
    """Phase 3L (d): gemma2-2b on W4A4 + RHT (phase 3b's weights) with one
    injected ``dispatch`` fault at the second decode: the engine moves to
    ``mixfp4-2pass-rowscale``, the streams equal phase 3b's first 8
    tokens, and every step's launches are exact on both sides of the
    rung."""
    from repro_torch import configs
    from repro_torch.serving import faults

    cfg = configs.config("gemma2-2b")
    inj = faults.FaultInjector(0, [faults.FaultRule(
        "decode", "dispatch", at=(1,), times=1)])
    eng = life_engine(dev, params, act_quant="mixfp4", act_rht=True,
                      faults=inj)
    reqs = shared_prefix_requests(cfg.vocab, seed, LIFE_NEW)
    for r in reqs:
        eng.submit(r)
    _, sides = step_w4a4_exact(eng)
    got = {r.uid: list(r.generated) for r in reqs}
    if got != first_tokens(streams) or \
            eng.act_quant != "mixfp4-2pass-rowscale" or \
            eng.counters["degraded_fused_to_2pass"] != 1 or len(sides) != 2:
        raise AssertionError(f"[lifecycle] (d) act_quant {eng.act_quant}, "
                             f"counters {dict(eng.counters)}, decode steps "
                             f"{dict(sides)}; streams {got}")
    log(f"[lifecycle] (d) gemma2-2b W4A4 + RHT, decode dispatch fault at "
        f"the second decode: fused -> {eng.act_quant}; decode steps per "
        f"side {dict(sides)}; every step's launches exact (per pass and "
        f"layer: fused 7 mixfp4_gemm_w4a4_fused + 7 fwht_row_scale, then "
        f"7 fwht_rows + 7 mixfp4_quant_rows + 7 mixfp4_gemm_w4a4; 1 "
        f"mixfp4_quant_kv, and 1 mixfp4_attn_decode per decode pass); "
        f"streams equal phase 3b's first {LIFE_NEW} tokens")


def lifecycle_moe_poison(dev, seed: int, params, streams: dict):
    """Phase 3L (e): qwen2-moe-a2.7b W4A16 at B = 4 with one poisoned
    decode row: the victim ends FAILED (``nan_logits``) with a strict
    prefix of its stream, the survivors equal phase 3m's first 8 tokens
    (at B <= 4 the capacity, 4, drops no choice, so no row couples)."""
    from repro_torch import configs
    from repro_torch.serving import faults
    from repro_torch.serving.engine import RequestState

    arch = "qwen2-moe-a2.7b"
    cfg = configs.config(arch)
    inj = faults.FaultInjector(seed, [faults.FaultRule("decode", "nan",
                                                       at=(1,))])
    eng = life_engine(dev, params, arch=arch, faults=inj)
    prompts = [r.prompt for r in shared_prefix_requests(cfg.vocab, seed,
                                                        LIFE_NEW)]
    out = faults.drive(eng, prompts, max_new_tokens=LIFE_NEW)
    want = first_tokens(streams)
    (victim,) = inj.fatal_victims()
    vs = out["streams"][victim]
    if (out["states"][victim], out["reasons"][victim]) != (
            RequestState.FAILED, "nan_logits") or \
            vs != want[victim][:len(vs)] or len(vs) >= LIFE_NEW:
        raise AssertionError(f"[lifecycle] (e) victim {victim}: "
                             f"{out['states'][victim]} "
                             f"{out['reasons'][victim]} {vs}")
    for uid, s in out["streams"].items():
        if uid != victim and (s != want[uid] or out["states"][uid]
                              is not RequestState.FINISHED):
            raise AssertionError(f"[lifecycle] (e) survivor {uid}: {s} vs "
                                 f"{want[uid]}")
    log(f"[lifecycle] (e) qwen2-moe-a2.7b W4A16, B=4, a NaN-poisoned "
        f"decode row: uid {victim} FAILED (nan_logits) after {len(vs)} "
        f"tokens, a strict prefix; the five survivors equal phase 3m's "
        f"first {LIFE_NEW} tokens")


# ---------------------------------------------------------------------------
# phase 5: a packed checkpoint round trip at gemma2-2b width
# ---------------------------------------------------------------------------
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "ckpt")
CKPT_ARRAY = "layers/attn/wq"      # the array the corrupt copies damage


def _leaf_bytes(tree) -> list:
    from repro_torch.checkpoint import manager
    return [t.reshape(-1).view(torch.uint8) for t in manager._flatten(tree)[0]]


def corrupt_copy(src: str, dst: str, plane: str, fix_packed: bool):
    """A copy of checkpoint ``src`` (hard links) with the first byte of
    ``CKPT_ARRAY``'s ``plane`` damaged by ``damage_packed_array``: a scale
    byte set to 0x80, or a payload byte flipped (``^ 0x11``); the leaf's
    sha is fixed up, and with ``fix_packed`` the array's digest too, so
    only the scale scan can catch it."""
    from repro_torch.checkpoint import manager

    def damage(flat):
        flat[0] = 0x80 if plane == "scales" else flat[0] ^ 0x11
        return flat

    step = "step_0000000000"
    os.makedirs(os.path.join(dst, step))
    for name in os.listdir(os.path.join(src, step)):
        os.link(os.path.join(src, step, name), os.path.join(dst, step, name))
    manager.damage_packed_array(dst, CKPT_ARRAY, plane, damage,
                                fix_packed=fix_packed)


def checkpoint_round_trip(dev, seed: int, params, streams: dict):
    """gemma2-2b at full width: an engine on phase 3's packed weights
    writes them with ``save_weights``; a fresh engine (other seeded
    weights) restores them with ``load_weights``.  Every packed byte and
    the fingerprint must be equal, and the restored engine must serve
    phase 3's six streams token for token; copies with a 0x80 scale byte
    and with a flipped payload byte must raise ``ValueError`` and
    ``IOError`` naming the array.  Prints the save and restore rates."""
    import shutil

    from repro_torch import configs, convert
    from repro_torch.checkpoint import CheckpointManager, manager
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.faults import FaultInjector, FaultRule

    cfg = configs.config("gemma2-2b")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    d = os.path.join(CKPT_DIR, "gemma2-2b")
    kw = {"batch_size": 4, "max_len": 8192, "kv_quant": "mixfp4",
          "device": dev}
    saver = ServeEngine(cfg, params, **kw)
    t = time.perf_counter()
    saver.save_weights(d)
    save_s = time.perf_counter() - t
    step_dir = os.path.join(d, "step_0000000000")
    n_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                  for f in os.listdir(step_dir))
    # the first read fails once (an injected transient): the engine
    # backs off on the injector's clock and reads again
    loader = ServeEngine(cfg, build_model(cfg).init(
        seed + 1, device=dev, pack="mixfp4"), **kw,
        faults=FaultInjector(0, [FaultRule("checkpoint_read", "transient",
                                           at=(0,))]))
    t = time.perf_counter()
    loader.load_weights(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    if loader.counters["retries:checkpoint_read"] != 1:
        raise AssertionError(f"checkpoint_read retries: "
                             f"{dict(loader.counters)}")
    want, got = _leaf_bytes(saver.params), _leaf_bytes(loader.params)
    if len(want) != len(got) or not all(
            torch.equal(a, b) for a, b in zip(want, got)):
        raise AssertionError("restored packed bytes differ from the saved "
                             "engine's")
    fp = CheckpointManager(d).packed_fingerprint()
    fp_restored = manager._sha16(json.dumps(manager.packed_checksums(
        convert.packed_to_stacked(loader.params)),
        sort_keys=True).encode())
    if fp != fp_restored or (saver.packed_bytes, saver.dense_bytes) != (
            loader.packed_bytes, loader.dense_bytes):
        raise AssertionError(f"fingerprint {fp} vs restored {fp_restored}; "
                             f"packed bytes {saver.packed_bytes} vs "
                             f"{loader.packed_bytes}")
    del saver, want, got
    reqs = shared_prefix_requests(cfg.vocab, seed)
    pending = list(reqs)
    while pending or loader.has_work():
        while pending and loader.add_request(pending[0]):
            pending.pop(0)
        loader.step()
    got = {r.uid: list(r.generated) for r in reqs}
    if got != streams:
        raise AssertionError("the restored engine's streams differ from "
                             "phase 3's")
    log(f"[checkpoint] gemma2-2b at full width: {n_bytes} B in "
        f"{len(os.listdir(step_dir)) - 1} leaves ({loader.packed_bytes} B "
        f"of packed projections, the rest the f32 embedding and norms); "
        f"save_weights {save_s:.2f} s ({n_bytes / save_s / 1e9:.2f} GB/s), "
        f"load_weights into a fresh engine {load_s:.2f} s "
        f"({n_bytes / load_s / 1e9:.2f} GB/s), its first read failed by "
        f"an injected transient and retried once (retries:checkpoint_read"
        f"=1, [lifecycle] (f)), so two reads; every packed byte equal, "
        f"fingerprint {fp} equal; the six phase-3 streams equal phase 3's "
        f"token for token")
    for plane, fix, err, what in (("scales", True, ValueError, "0x80"),
                                  ("payload", False, IOError, "payload")):
        bad = os.path.join(CKPT_DIR, f"bad-{plane}")
        corrupt_copy(d, bad, plane, fix)
        retries = loader.counters["retries:checkpoint_read"]
        try:
            loader.load_weights(bad)
        except err as e:
            if CKPT_ARRAY not in str(e) or what not in str(e):
                raise AssertionError(f"corrupt {plane}: {e}") from e
            # an IOError is an OSError, which the read boundary retries
            retries = loader.counters["retries:checkpoint_read"] - retries
            log(f"[checkpoint] a copy with a corrupt {plane} byte of "
                f"{CKPT_ARRAY}: {type(e).__name__} after {retries} "
                f"retries: {str(e)[:110]}...")
        else:
            raise AssertionError(f"a corrupt {plane} byte was restored")
    shutil.rmtree(CKPT_DIR)


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
    g12 = check_attn_g12(dev, flush)
    g12[0]["path"], g12[1]["path"] = "starcoder2-15b", "starcoder2-15b-paged"
    kernels = [check_quant(dev, flush), check_quant_kv(dev, flush),
               check_gemm(dev, flush),
               check_attn(dev, flush), *check_w4a4(dev, flush),
               *check_fwht(dev, flush), check_attn_paged(dev, flush),
               check_gemm_experts(dev, flush), *g12]
    check_moe_heads(dev, flush)
    del flush
    check_m_invariance(dev)
    # each kernel's launches: from the path run that drives it
    fixed = serve_path(dev, args.seed, "[serve]")
    paged = serve_path(dev, args.seed, "[serve-paged]",
                       params=fixed.pop("params"), kv_pool=2049,
                       kv_page_len=PAGE_LEN, prefill_chunk=512)
    gemma = paged.pop("params")
    decode_step_ab(dev, gemma, args.seed)
    if paged["streams"] != fixed["streams"]:
        raise AssertionError("paged chunked streams differ from the fixed "
                             "whole-prompt ones")
    log("[serve-paged] all six streams equal phase 3's token for token")
    checkpoint_round_trip(dev, args.seed, gemma, fixed["streams"])
    rows_a = lifecycle_dense(dev, args.seed, gemma, fixed["streams"], smi)
    recovery_phase(dev, args.seed, gemma, fixed["streams"], rows_a, smi)
    del gemma, rows_a
    torch.cuda.empty_cache()
    w4a4 = serve_path(dev, args.seed, "[serve-w4a4]", act_quant="mixfp4",
                      act_rht=True)
    lifecycle_fused_rung(dev, args.seed, w4a4.pop("params"), w4a4["streams"])
    torch.cuda.empty_cache()
    paths = {"w4a16": fixed["counts"], "w4a4-rht": w4a4["counts"],
             "paged-chunked": paged["counts"]}
    card_vs_cpu(dev, args.seed)
    paths["w4a4-2pass-rowscale"] = card_vs_cpu(dev, args.seed, w4a4=True)
    chunked_prefix_vs_whole(dev, args.seed)
    # the MoE family: Qwen1.5-MoE-A2.7B at full width and depth
    moe = "qwen2-moe-a2.7b"
    moe_fixed = serve_path(dev, args.seed, "[serve-moe]", arch=moe)
    moe_paged = serve_path(dev, args.seed, "[serve-moe-paged]", arch=moe,
                           params=moe_fixed.pop("params"), kv_pool=2049,
                           kv_page_len=PAGE_LEN)
    lifecycle_moe_poison(dev, args.seed, moe_paged.pop("params"),
                         moe_fixed["streams"])
    if moe_paged["streams"] != moe_fixed["streams"]:
        raise AssertionError("MoE pool streams differ from the fixed-slot "
                             "ones")
    log("[serve-moe-paged] all six streams equal phase 3m's token for "
        "token")
    paths["moe-w4a16"] = moe_fixed["counts"]
    del moe_fixed
    torch.cuda.empty_cache()
    card_vs_cpu(dev, args.seed, arch=moe)
    # the remaining dense configs at full width and depth, one at a time
    for arch, (tag, kv) in DENSE.items():
        served = serve_path(dev, args.seed, f"[serve-{tag}]", arch=arch,
                            new_tokens=16, kv_quant=kv)
        paths[arch] = served["counts"]
        del served
        torch.cuda.empty_cache()
    for arch, (tag, kv) in DENSE.items():
        counts = card_vs_cpu(dev, args.seed, arch=arch, kv_quant=kv,
                             paged=arch == "starcoder2-15b")
        if counts:
            paths[f"{arch}-paged"] = counts
    for entry in kernels:
        counter = entry.get("counter", entry["name"])
        path = entry.get("path") or next(name for name, c in paths.items()
                                         if c[counter])
        entry["path"], entry["launches"] = path, paths[path][counter]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
