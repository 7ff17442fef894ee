"""Decode-step studies of the PyTorch/CUDA port on one GPU.

Eight commands, each for one CUDA device:

``ab --parent DIR [--rounds R]``
    Parent against change in alternating turns (parent, change, change,
    parent, R times over), each turn a fresh process on the same card.
    DIR holds another checkout of the repo (``git archive <commit> | tar
    -x -C DIR``, inside a directory that ``.gitignore`` lists); the change
    is the checkout holding this script.  A turn measures, for gemma2-2b
    at full width with seeded random weights: the host time the GEMM
    wrappers take to enqueue one decode layer's 7 projections at M = 4
    (W4A16, and fused W4A4 + RHT), the card idle before each rep; and the
    decode step time at B = 4 over four 1024-token prompts of the
    fixed-slot W4A16 engine, the paged W4A16 engine with 512-token chunked
    prefill, and the fixed-slot W4A4 + RHT engine, and each engine's
    device launches per decode step (kernel, memset and copy rows of three
    steps traced with ``torch.profiler``).  Prints one JSON line per turn
    and a summary of medians by tree.

``trace-drops [--windows N]``
    Traces N windows of five W4A4 + RHT decode steps (the engine of
    ``chip_smoke.py`` phase 3b) with ``torch.profiler``, alternately with
    the profiler started cold at the window and after a warm-up step
    (``schedule(warmup=1, active=5)``, as ``chip_smoke.py`` traces), and
    compares every window's kernel rows with the wrappers' launch counts
    (a row missing from a trace is a record the profiler lost) and the
    windows' device row totals (every step runs the same kernels).

``attn-sweep``
    Device time per launch of the decode-attention kernel (fixed-slot,
    gemma2-2b heads, global layer) over batch sizes and lengths from 0
    to 8192 keys, from ``torch.profiler``'s kernel rows with the L2
    flushed before each call and without, beside the CTAs that hold keys
    and the byte bound: how the launch time scales with the splits and
    the CTAs.

``rowscale-sweep``
    Device time per launch of the RHT row-scale kernel (``fwht_row_scale``)
    over M (decode and prefill) and the K of gemma2-2b's projections, for
    each CTAs-per-row cluster size and thread count, from
    ``torch.profiler``'s kernel rows with the L2 flushed before each call,
    beside the plan ``kernels/tuning.py`` picks: the measurement that
    plan rests on.

``experts-sweep``
    Device time of one qwen2-moe decode layer's three expert launches
    (``mixfp4_gemm_w4a16_experts``, the weights of ``chip_smoke.py`` phase
    2m) for every plan of the expert decode kernel (``tuning.expert_plans``:
    column tile 64 or 128 x a ring of 2 to 4 slots) on (a) 64 experts of random rows at C = 5,
    (b) the served B = 4 dispatch (16 experts hold a row, C = 5), and (a)'s
    rows at C = 16 and 64, from ``torch.profiler``'s kernel rows with the L2
    flushed before each layer, beside the plan ``tuning.expert_plan``
    picks: the measurement that plan rests on.  Every plan's output must
    be bitwise the picked plan's.

``experts-ab --parent DIR [--rounds R]``
    Parent against change in alternating turns (parent, change, change,
    parent, R times over), each turn a fresh process: one qwen2-moe decode
    layer's three expert launches (``qtensor.qmm_experts``, the weights of
    ``chip_smoke.py`` phase 2m), card alone (``chip_smoke.bench`` with the
    host kept ahead, L2 flushed), on (a) 64 experts of random rows at C = 5
    and (b) the served B = 4 dispatch (16 experts hold a row).

``attn-ab --parent DIR [--rounds R]``
    Parent against change in alternating turns, as ``experts-ab``: the
    decode-attention kernel on ``chip_smoke.py`` phase 2's inputs (B = 4,
    8192 rows, gemma2-2b heads: g = 2, dh = 256, softcap 50), fixed-slot
    and paged, global and local (window 4096) layer, card alone.

``trace-clock [--windows N]``
    Traces N windows of one decode-M GEMM call each (W4A16, then fused
    W4A4 + RHT, alternately), every window after a warm-up call, in two
    arms: the first call right after the profiler starts recording, or
    after the host idles ``--pad`` seconds (as ``chip_smoke.py`` traces).  Per window: the device kernel rows against the two the
    call launches, and the times from the window's start to its first
    kernel and from its last kernel to the window's end, on the
    profiler's clock for the kernels and the host's for the window.

  python3 decode_study.py ab --parent build/parent --rounds 2
  python3 decode_study.py trace-drops --windows 24
  python3 decode_study.py trace-clock --windows 200
  python3 decode_study.py attn-sweep
  python3 decode_study.py rowscale-sweep
  python3 decode_study.py experts-sweep
  python3 decode_study.py experts-ab --parent build/parent --rounds 2
  python3 decode_study.py attn-ab --parent build/parent --rounds 3
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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# one decode layer's projections: wq, wk, wv, wo, w_gate, w_up, w_down
LAYER = [(2304, 2048), (2304, 1024), (2304, 1024), (2048, 2304),
         (2304, 9216), (2304, 9216), (9216, 2304)]
ENGINES = {                       # name -> ServeEngine options
    "w4a16": {},
    "w4a16_paged": {"kv_pool": 2049, "kv_page_len": 16, "prefill_chunk": 512},
    "w4a4_rht": {"act_quant": "mixfp4", "act_rht": True},
}


def log(msg: str):
    print(msg, flush=True)


def _import_tree(tree: Path):
    """Import ``repro_torch`` from ``tree``'s ``src`` and build its
    kernels there."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.kernels import build
    if Path(repro_torch.__file__).resolve().parents[2] != tree.resolve():
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not from {tree}")
    build.build_all()


def _engine(dev, seed: int, new_tokens: int, **kw):
    """A gemma2-2b engine at full width, B = 4, every slot holding a
    1024-token prompt, past its prefill and first decode steps."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = configs.config("gemma2-2b")
    engine = ServeEngine(cfg, build_model(cfg).init(seed, device=dev),
                         batch_size=4, max_len=8192, kv_quant="mixfp4",
                         device=dev, **kw)
    chunk_steps = (0 if engine.scheduler is None
                   else engine.batch_size * -(-1024 // engine.prefill_chunk))
    rng = np.random.RandomState(seed + 2)
    for i in range(engine.batch_size):
        if not engine.add_request(Request(
                uid=i, prompt=rng.randint(0, cfg.vocab, 1024).astype(np.int32),
                max_new_tokens=new_tokens + chunk_steps + 8)):
            raise AssertionError("requests were not admitted")
    for _ in range(3 + chunk_steps):
        engine.step()
    if engine.scheduler is not None and engine.scheduler.pending_jobs:
        raise AssertionError("prefill chunks left")
    torch.cuda.synchronize()
    return engine


def _wrapper_host_ms(dev, seed: int, reps: int = 50) -> dict:
    """Median host ms to enqueue one decode layer's 7 GEMM calls at M = 4,
    the card idle before each rep."""
    from repro_torch.core import qtensor, scaling
    from repro_torch.kernels import fwht
    from repro_torch.kernels import mixfp4_gemm as G
    from repro_torch.models.base import rht_signs_on_grid

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = {kn: qtensor.quantize(
        torch.randn(*kn, device=dev, generator=gen) / math.sqrt(kn[0]),
        qtensor.QuantSpec("mixfp4", qtensor.BlockLayout2D()))
        for kn in set(LAYER)}
    xs = {k: torch.randn(4, k, device=dev, generator=gen)
          for k in (2048, 2304, 9216)}
    sg = {k: rht_signs_on_grid(k, k, dev) for k in xs}
    rs = {k: scaling.row_scale(fwht.fwht_rows(x, sg[k]))
          for k, x in xs.items()}
    calls = {
        "w4a16": lambda: [G.mixfp4_gemm_w4a16(
            xs[k], w[(k, n)].payload, w[(k, n)].scales, w[(k, n)].scale32)
            for k, n in LAYER],
        "w4a4_rht": lambda: [G.mixfp4_gemm_w4a4_fused(
            xs[k], rs[k], w[(k, n)].payload, w[(k, n)].scales,
            w[(k, n)].scale32, per_row=True, rht_signs=sg[k])
            for k, n in LAYER],
    }
    out = {}
    for name, fn in calls.items():
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        out[name] = statistics.median(times)
    return out


def _device_rows(prof) -> list:
    """The device rows of a profile that are kernels, memsets or copies."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith("ProfilerStep")]


def _launches_per_step(engine, steps: int = 3) -> float:
    """Device launches (kernel, memset and copy rows) per decode step, from
    ``steps`` steps traced after a warm-up step, the host idle 50 ms before
    the first (``chip_smoke.py`` ``traced()``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        engine.step()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05)
        for i in range(steps):
            engine.step()
            torch.cuda.synchronize()
            if i < steps - 1:
                prof.step()
    return sum(ev.count for ev in _device_rows(prof)) / steps


def turn(tree: Path, seed: int, steps: int) -> dict:
    """One turn of ``ab``: wrapper host ms, decode step ms and device
    launches per decode step of ``tree``."""
    _import_tree(tree)
    dev = torch.device("cuda")
    res = {"tree": str(tree), "host_ms": _wrapper_host_ms(dev, seed),
           "step_ms": {}, "launches": {}}
    for name, kw in ENGINES.items():
        engine = _engine(dev, seed, steps + 4, **kw)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        res["step_ms"][name] = statistics.median(times)
        res["launches"][name] = _launches_per_step(engine)
        del engine
        torch.cuda.empty_cache()
    return res


def ab(parent: Path, rounds: int, seed: int, steps: int):
    trees = {"parent": parent.resolve(), "change": ROOT}
    results = {name: [] for name in trees}
    for name in ("parent", "change", "change", "parent") * rounds:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "turn",
             "--tree", str(trees[name]), "--seed", str(seed),
             "--steps", str(steps)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"{name} turn exited {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name].append(res)
        log(f"[ab] {name}: {json.dumps(res)}")
    summary = {}
    for name, runs in results.items():
        summary[name] = {
            f"{kind}.{key}": statistics.median(r[kind][key] for r in runs)
            for kind in ("host_ms", "step_ms", "launches")
            for key in runs[0][kind]}
    log(f"[ab] {rounds} rounds of (parent, change, change, parent), "
        f"{steps} decode steps per engine per turn; medians over turns: "
        f"{json.dumps(summary)}")


def trace_drops(windows: int, seed: int):
    """Count the device kernel rows of traced decode windows against the
    wrappers' launches, one line per window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    _import_tree(ROOT)
    from repro_torch.kernels import ops

    kinds = {"mixfp4_gemm_w4a4_fused": "w4a4_",
             "mixfp4_attn_decode": "attn_decode_kernel",
             "mixfp4_quant_kv": "quant_kv_kernel",
             "fwht_row_scale": "fwht_row_scale_kernel"}
    dev = torch.device("cuda")
    engine = _engine(dev, seed, 6 * windows + 8, **ENGINES["w4a4_rht"])
    steps = 5
    short = {"cold": [], "warm": []}
    rows_seen = {"cold": set(), "warm": set()}
    for w in range(windows):
        arm = "warm" if w % 2 else "cold"
        sched = (schedule(wait=0, warmup=1, active=steps, repeat=1)
                 if arm == "warm" else None)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            if arm == "warm":
                engine.step()
                prof.step()
            before = ops.launch_counts()
            for i in range(steps):
                engine.step()
                if arm == "warm" and i < steps - 1:
                    prof.step()
            torch.cuda.synchronize()
            after = ops.launch_counts()
        rows = _device_rows(prof)
        n_rows = sum(ev.count for ev in rows)
        lost = {k: after[k] - before[k]
                - sum(ev.count for ev in rows if sub in ev.key)
                for k, sub in kinds.items()}
        lost = {k: v for k, v in lost.items() if v}
        rows_seen[arm].add(n_rows)
        if lost:
            short[arm].append(w)
        log(f"[trace-drops] window {w} ({arm}): {n_rows} device rows; "
            f"kernel rows missing against the wrappers' launches: "
            f"{lost or 'none'}")
    log(f"[trace-drops] {windows} windows of {steps} W4A4 + RHT decode "
        f"steps, alternately cold and after a warm-up step: windows with a "
        f"row of the port's kernels missing: cold {short['cold']} of "
        f"{-(-windows // 2)}, warm {short['warm']} of {windows // 2}; "
        f"device rows per window: cold {sorted(rows_seen['cold'])}, warm "
        f"{sorted(rows_seen['warm'])}")


def trace_clock(windows: int, pad: float, seed: int):
    """One line per window: kernel rows, and the margins between the
    window's host-clock bounds and its kernels' profiler timestamps.  The
    windows alternate in pairs (one call of each GEMM) between no pad and
    the host idle ``pad`` seconds after the profiler starts recording, as
    ``chip_smoke.py`` ``traced()`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    _import_tree(ROOT)
    from repro_torch.core import qtensor, scaling
    from repro_torch.kernels import fwht
    from repro_torch.kernels import mixfp4_gemm as G
    from repro_torch.models.base import rht_signs_on_grid

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, n = 2304, 2048
    w = torch.randn(k, n, device=dev, generator=gen) / math.sqrt(k)
    qt = qtensor.quantize(w, qtensor.QuantSpec("mixfp4",
                                               qtensor.BlockLayout2D()))
    x = torch.randn(4, k, device=dev, generator=gen)
    sg = rht_signs_on_grid(k, k, dev)
    s_h = scaling.row_scale(fwht.fwht_rows(x, sg))
    calls = [lambda: G.mixfp4_gemm_w4a16(x, qt.payload, qt.scales,
                                         qt.scale32),
             lambda: G.mixfp4_gemm_w4a4_fused(
                 x, s_h, qt.payload, qt.scales, qt.scale32, per_row=True,
                 rht_signs=sg)]
    arms = [0.0, pad]
    short = {a: [] for a in arms}
    margins = {a: [] for a in arms}
    seen = {a: 0 for a in arms}
    for win in range(windows):
        fn = calls[win % 2]
        arm = arms[(win // 2) % len(arms)]
        seen[arm] += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            t_start = time.time_ns()
            prof.step()
            time.sleep(arm)
            fn()
            torch.cuda.synchronize()
            t_end = time.time_ns()
        evs = prof.profiler.kineto_results.events()
        kern = [e for e in evs if e.device_type() == DeviceType.CUDA
                and not e.is_user_annotation()
                and not e.name().startswith("ProfilerStep")]
        gemm = sum("w4a" in e.name() for e in kern)
        first = (min(e.start_ns() for e in kern) - t_start) / 1e3 \
            if kern else None
        last = (t_end - max(e.end_ns() for e in kern)) / 1e3 \
            if kern else None
        if len(kern) != 2 or gemm != 1:
            short[arm].append(win)
        if kern:
            margins[arm].append((first, last))
        log(f"[trace-clock] window {win} (pad {arm} s): {len(kern)} kernel "
            f"rows, {gemm} GEMM; window start to first kernel {first} us, "
            f"last kernel to window end {last} us")
    for arm in arms:
        m = margins[arm]
        log(f"[trace-clock] pad {arm} s: windows short of the 2 kernel "
            f"rows {short[arm]} of {seen[arm]}; "
            f"start margin min {min((a for a, _ in m), default=None)} us, "
            f"end margin min {min((b for _, b in m), default=None)} us")


# attn-sweep cases: (label, B, S, lengths); gemma2-2b heads (Hkv 4, H 8,
# dh 256), global layer, softcap 50
SWEEP = [("4 x 0 (no valid key)", 4, 8192, [0] * 4),
         ("1 x 1024", 1, 8192, [1024]),
         ("4 x 256", 4, 8192, [256] * 4),
         ("4 x 1024", 4, 8192, [1024] * 4),
         ("4 x 1024 at S=1024", 4, 1024, [1024] * 4),
         ("4 x 2048", 4, 8192, [2048] * 4),
         ("4 x 4096", 4, 8192, [4096] * 4),
         ("4 x 8192", 4, 8192, [8192] * 4),
         ("1 x 8192", 1, 8192, [8192]),
         ("phase 2", 4, 8192, [8192, 175, 2488, 710]),
         ("served", 4, 8192, [1190, 1200, 332, 4532]),
         ("16 x 1024", 16, 8192, [1024] * 16)]


def attn_sweep(seed: int, calls: int = 10):
    """Device time per launch of the fixed-slot decode-attention kernel
    over the SWEEP shapes, from ``torch.profiler``'s kernel rows, with the
    L2 flushed before each call (cold) and without (warm: the same cache
    rows again); one line per shape with its non-empty CTAs and byte
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _import_tree(ROOT)
    from repro_torch.kernels import mixfp4_attn as A
    from repro_torch.kernels import tuning
    from repro_torch.models.base import quantize_kv_rows

    dev = torch.device("cuda")
    hkv, h, dh = 4, 8, 256
    gen = torch.Generator(device=dev).manual_seed(seed)
    big = [a for _ in range(2) for a in quantize_kv_rows(torch.randn(
        16, 8192, hkv, dh, device=dev, generator=gen))]
    q = torch.randn(16, h, dh, device=dev, generator=gen)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for label, b, s, lens in SWEEP:
        cache = [a[:b, :s].contiguous() for a in big]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        fn = lambda: A.mixfp4_attn_decode(q[:b], *cache, lengths,
                                          softcap=50.0)
        fn()
        torch.cuda.synchronize()
        us = {}
        for arm in ("cold", "warm"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05)
                for _ in range(calls):
                    if arm == "cold":
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
            rows = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA
                    and "attn_decode_kernel" in ev.key]
            n = sum(ev.count for ev in rows)
            if n != calls:
                log(f"[attn-sweep] {label} {arm}: {n} of {calls} kernel "
                    "rows traced")
            us[arm] = sum(ev.self_device_time_total
                          for ev in rows) / max(n, 1)
        ctas = hkv * sum(len(tuning.attn_split_range(x, 0, s))
                         for x in lens)
        rows_read = sum(min(x, s) for x in lens)
        bound_us = (2 * rows_read * hkv * (dh // 2 + dh // 16)
                    + b * h * dh * 8) / 3.35e12 * 1e6
        log(f"[attn-sweep] {label}: B={b} S={s}: {ctas} non-empty CTAs of "
            f"{b * hkv * tuning.attn_splits(s).splits}; us per launch: "
            f"cold {us['cold']:.2f}, warm {us['warm']:.2f}; byte bound "
            f"{bound_us:.2f} us")


def rowscale_sweep(seed: int, calls: int = 10):
    """Device us per launch of the RHT row-scale kernel at M in (1, 4, 16,
    64, 4544) and K in (2048, 2304, 9216), for 1, 2, 4 and 8 CTAs per row
    and 64, 128 and 256 threads per CTA, L2 flushed before each call; one
    line per (M, K) with the fastest plan and the plan tuning picks."""
    from torch.profiler import ProfilerActivity, profile

    _import_tree(ROOT)
    from repro_torch.kernels import fwht, tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for m in (1, 4, 16, 64, 4544):
        for k in (2048, 2304, 9216):
            x = torch.randn(m, k, device=dev, generator=gen)
            signs = torch.where(torch.rand(k, device=dev, generator=gen)
                                < 0.5, -1.0, 1.0)
            us = {}
            for ctas in (1, 2, 4, 8):
                for threads in (64, 128, 256):
                    def fn():
                        fwht._row_scale_launch(x, signs, ctas, threads)
                    fn()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        time.sleep(0.05)
                        for _ in range(calls):
                            flush.zero_()
                            fn()
                        torch.cuda.synchronize()
                    rows = [ev for ev in _device_rows(prof)
                            if "row_scale_kernel" in ev.key]
                    n = sum(ev.count for ev in rows)
                    us[ctas, threads] = sum(
                        ev.self_device_time_total for ev in rows) / max(n, 1)
                    if n != calls:
                        log(f"[rowscale-sweep] M={m} K={k} {ctas}x{threads}: "
                            f"{n} of {calls} kernel rows traced")
            best = min(us, key=us.get)
            plan = tuning.row_scale_plan(m, k)
            log(f"[rowscale-sweep] M={m} K={k}: us per launch by (CTAs per "
                f"row, threads) " + ", ".join(
                    f"{c}x{t} {v:.2f}" for (c, t), v in us.items())
                + f"; fastest {best[0]}x{best[1]} {us[best]:.2f}; tuning "
                f"picks {plan.ctas}x{plan.threads} "
                f"{us.get((plan.ctas, plan.threads), float('nan')):.2f}")


def experts_sweep(seed: int, calls: int = 10):
    """Device us of one decode layer's three expert launches per plan of
    the expert decode kernel, on the inputs of the module docstring; one
    line per input with every plan's time, the fastest and tuning's."""
    from torch.profiler import ProfilerActivity, profile

    _import_tree(ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import mixfp4_gemm as G
    from repro_torch.kernels import tuning

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    stacks = cs.moe_stacks(dev, gen)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def rows(c):
        return {k: torch.randn(cs.MOE_EXPERTS, c, k, device=dev,
                               generator=gen).to(torch.bfloat16)
                for k in (2048, 1408)}

    inputs = {"(a) 64 experts of random rows, C=5": rows(5),
              "(b) the served B=4 dispatch, 16 experts, C=5": {
                  k: cs.served_rows(k, dev, seed + 21) for k in (2048, 1408)},
              "(a) C=16": rows(16), "(a) C=64": rows(64)}
    for label, xs in inputs.items():
        c = xs[2048].shape[1]
        picked = {k: tuning.expert_plan(c, k, n) for k, n in cs.MOE_LAYER}

        def layer(plans):
            return [G._experts_launch(xs[k], stacks[k, n].payload,
                                      stacks[k, n].scales,
                                      stacks[k, n].scale32, n, plans[k])
                    for k, n in cs.MOE_LAYER]

        want = layer(picked)
        us = {}
        for plan in tuning.expert_plans(c, 2048):
            plans = {k: plan for k, _ in cs.MOE_LAYER}
            got = layer(plans)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want)):
                raise AssertionError(f"{label}: plan {plan} is not bitwise "
                                     "the picked plan's")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05)
                for _ in range(calls):
                    flush.zero_()
                    layer(plans)
                torch.cuda.synchronize()
            found = [ev for ev in _device_rows(prof)
                     if "experts_decode_kernel" in ev.key]
            n = sum(ev.count for ev in found)
            us[tuple(plan)] = sum(ev.self_device_time_total
                                  for ev in found) / calls
            if n != 3 * calls:
                log(f"[experts-sweep] {label} {tuple(plan)}: {n} of "
                    f"{3 * calls} kernel rows traced")
        best = min(us, key=us.get)
        mine = sorted({tuple(p) for p in picked.values()})
        log(f"[experts-sweep] {label}: us per layer (3 launches) by (column "
            f"tile, threads, ring slots) " + ", ".join(
                f"{plan} {v:.2f}" for plan, v in us.items())
            + f"; fastest {best} {us[best]:.2f}; tuning picks {mine} "
            f"{us.get(mine[0], float('nan')) if len(mine) == 1 else 'mixed'}")


def experts_turn(tree: Path, seed: int) -> dict:
    """One turn of ``experts-ab``: the expert layer's card-alone ms on
    inputs (a) and (b) with ``tree``'s kernels.  The inputs are built here
    (``_dispatch_indices``, as the MoE layer dispatches), so both trees
    get the same bytes."""
    _import_tree(tree)
    import chip_smoke as cs
    from repro_torch.core import qtensor
    from repro_torch.models import moe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    stacks = cs.moe_stacks(dev, gen)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.RandomState(seed + 21)
    idx = torch.tensor(rng.permutation(cs.MOE_REAL)[:cs.MOE_SERVED_EXPERTS]
                       .reshape(4, cs.MOE_TOP_K), device=dev)
    tok_s, e_s, slot, keep, _ = moe._dispatch_indices(idx, cs.MOE_REAL, 4)
    inputs = {"a": {}, "b": {}}
    for k in (2048, 1408):
        inputs["a"][k] = torch.randn(cs.MOE_EXPERTS, 5, k, device=dev,
                                     generator=gen).to(torch.bfloat16)
        x = torch.tensor(rng.randn(4, k), dtype=torch.float32,
                         device=dev).to(torch.bfloat16)
        buf = torch.zeros((cs.MOE_EXPERTS, 5, k), dtype=torch.bfloat16,
                          device=dev)
        buf[e_s, slot] = torch.where(keep[:, None], x[tok_s], 0.0)
        inputs["b"][k] = buf
    out = {"tree": str(tree)}
    for name, xs in inputs.items():
        out[f"{name}_ms"] = cs.bench(
            lambda: [qtensor.qmm_experts(xs[k], stacks[k, n])
                     for k, n in cs.MOE_LAYER], 20, flush, keep_ahead=True)
    return out


def attn_turn(tree: Path, seed: int) -> dict:
    """One turn of ``attn-ab``: the decode-attention entries' card-alone ms
    on phase 2's inputs with ``tree``'s kernels."""
    _import_tree(tree)
    import chip_smoke as cs
    from repro_torch.kernels import mixfp4_attn as A

    dev = torch.device("cuda")
    q, fixed, lengths, slabs, bt = cs.paged_attn_inputs(dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    one = torch.ones((), device=dev)
    out = {"tree": str(tree)}
    for window in (0, 4096):
        kw = {"window": window, "k_scale32": one, "v_scale32": one,
              "softcap": 50.0}
        out[f"fixed_w{window}_ms"] = cs.bench(
            lambda: A.mixfp4_attn_decode(q, *fixed, lengths, **kw), 20,
            flush, keep_ahead=True)
        out[f"paged_w{window}_ms"] = cs.bench(
            lambda: A.mixfp4_attn_decode_paged(q, *slabs, bt, lengths, **kw),
            20, flush, keep_ahead=True)
    return out


def _turns(cmd: str, parent: Path, rounds: int, seed: int) -> list[dict]:
    """Alternating turns (parent, change, change, parent; ``rounds`` times)
    of the ``cmd`` command, each a fresh process."""
    turns = []
    for _ in range(rounds):
        for tree in (parent, ROOT, ROOT, parent):
            res = subprocess.run(
                [sys.executable, str(ROOT / "decode_study.py"), cmd,
                 "--tree", str(tree.resolve()), "--seed", str(seed)],
                capture_output=True, text=True, check=True)
            turn = json.loads(res.stdout.strip().splitlines()[-1])
            log(json.dumps(turn))
            turns.append(turn)
    return turns


def attn_ab(parent: Path, rounds: int, seed: int):
    """Alternating turns of :func:`attn_turn`, parent and change."""
    turns = _turns("attn-turn", parent, rounds, seed)
    for name, tree in (("parent", parent.resolve()), ("change", ROOT)):
        mine = [t for t in turns if Path(t["tree"]) == tree]
        log(f"[attn-ab] {name}: decode attention on phase 2's inputs, card "
            f"alone, median of {len(mine)} turns (ms): " + ", ".join(
                f"{key[:-3]} {statistics.median(t[key] for t in mine):.4f}"
                for key in mine[0] if key.endswith("_ms")))


def experts_ab(parent: Path, rounds: int, seed: int):
    """Alternating turns of :func:`experts_turn`, parent and change."""
    turns = _turns("experts-turn", parent, rounds, seed)
    for name, tree in (("parent", parent.resolve()), ("change", ROOT)):
        mine = [t for t in turns if Path(t["tree"]) == tree]
        log(f"[experts-ab] {name}: one layer's 3 expert launches, card "
            f"alone, median of {len(mine)} turns: (a) "
            f"{statistics.median(t['a_ms'] for t in mine):.4f} ms, (b) "
            f"{statistics.median(t['b_ms'] for t in mine):.4f} ms; turns "
            f"(a) {[round(t['a_ms'], 4) for t in mine]}, (b) "
            f"{[round(t['b_ms'], 4) for t in mine]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ab")
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", type=int, default=16)
    p = sub.add_parser("turn")
    p.add_argument("--tree", type=Path, required=True)
    p.add_argument("--steps", type=int, default=16)
    p = sub.add_parser("trace-drops")
    p.add_argument("--windows", type=int, default=24)
    sub.add_parser("attn-sweep")
    sub.add_parser("rowscale-sweep")
    sub.add_parser("experts-sweep")
    p = sub.add_parser("experts-ab")
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--rounds", type=int, default=2)
    p = sub.add_parser("experts-turn")
    p.add_argument("--tree", type=Path, required=True)
    p = sub.add_parser("attn-ab")
    p.add_argument("--parent", type=Path, required=True)
    p.add_argument("--rounds", type=int, default=3)
    p = sub.add_parser("attn-turn")
    p.add_argument("--tree", type=Path, required=True)
    p = sub.add_parser("trace-clock")
    p.add_argument("--windows", type=int, default=200)
    p.add_argument("--pad", type=float, default=0.05)
    for p in sub.choices.values():
        p.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_study.py needs a CUDA device")
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f"; " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    if args.cmd == "ab":
        ab(args.parent, args.rounds, args.seed, args.steps)
    elif args.cmd == "turn":
        print(json.dumps(turn(args.tree, args.seed, args.steps)))
    elif args.cmd == "attn-sweep":
        attn_sweep(args.seed)
    elif args.cmd == "rowscale-sweep":
        rowscale_sweep(args.seed)
    elif args.cmd == "experts-sweep":
        experts_sweep(args.seed)
    elif args.cmd == "experts-ab":
        experts_ab(args.parent, args.rounds, args.seed)
    elif args.cmd == "experts-turn":
        print(json.dumps(experts_turn(args.tree, args.seed)))
    elif args.cmd == "attn-ab":
        attn_ab(args.parent, args.rounds, args.seed)
    elif args.cmd == "attn-turn":
        print(json.dumps(attn_turn(args.tree, args.seed)))
    elif args.cmd == "trace-clock":
        trace_clock(args.windows, args.pad, args.seed)
    else:
        trace_drops(args.windows, args.seed)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
