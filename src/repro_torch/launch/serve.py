"""Serving entry point: build an arch from seeded random weights and serve
a few greedy requests through the continuous-batching engine (packed
MixFP4 weights, W4A16 or W4A4 kernels, optional packed KV cache).

Usage (on the GPU; ``--device cpu`` runs the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --kv-quant mixfp4 --requests 4 --new-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --kv-quant mixfp4 --act-quant mixfp4 --act-rht
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --device cpu --kv-quant mixfp4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quant", default="mixfp4", choices=["mixfp4", "nvfp4"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-quant", default=None, choices=["bf16", "mixfp4"],
                    help="hold the KV cache packed (mixfp4: 4.5 bits/value, "
                         "decode through the attention kernel); default bf16")
    ap.add_argument("--act-quant", default=None,
                    choices=["bf16", "mixfp4", "mixfp4-2pass",
                             "mixfp4-2pass-rowscale", "mixfp4-qdq"],
                    help="W4A4 serving: quantize the activations on the fly "
                         "and run every projection with both operands on "
                         "the wire format.  'mixfp4' fuses the per-row "
                         "quantizer into the GEMM (one launch per "
                         "projection); 'mixfp4-2pass-rowscale' is the "
                         "quantize_rows(per_row=True) -> GEMM composition "
                         "it is bitwise equal to; 'mixfp4-2pass' the legacy "
                         "per-tensor composition; 'mixfp4-qdq' its "
                         "dequantize-then-W4A16 oracle; default bf16 "
                         "(W4A16)")
    ap.add_argument("--act-rht", action="store_true",
                    help="grouped random Hadamard transform on both W4A4 "
                         "operands (weights rotated at pack time, "
                         "activations before the quantizer, the same "
                         "deterministic signs); requires --act-quant "
                         "mixfp4 or mixfp4-2pass-rowscale")
    ap.add_argument("--prefill-buckets", default="auto",
                    choices=["auto", "pow2-64", "off"])
    args = ap.parse_args(argv)
    if args.act_rht and args.act_quant not in ("mixfp4",
                                               "mixfp4-2pass-rowscale"):
        ap.error("--act-rht rotates both W4A4 operands and needs the "
                 "per-row scales; use --act-quant mixfp4 or "
                 "mixfp4-2pass-rowscale")

    device = resolve_device(args.device)
    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.config(args.arch))
    params = build_model(cfg).init(args.seed, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {n_params / 1e6:.1f}M params on {device}")
    engine = ServeEngine(cfg, params, batch_size=args.batch,
                         max_len=args.max_len, method=args.quant,
                         kv_quant=args.kv_quant, act_quant=args.act_quant,
                         act_rht=args.act_rht,
                         prefill_buckets=args.prefill_buckets, device=device)
    del params  # projections now live only as packed QTensors
    path = ("W4A16 kernel" if engine.act_quant == "bf16"
            else "W4A4 kernels")
    print(f"[serve] projection weights held as packed QTensors: "
          f"{engine.packed_bytes / 2**20:.1f} MiB "
          f"({engine.compression:.2f}x smaller than bf16), served through "
          f"qmm -> {path}")
    if engine.act_quant != "bf16":
        print(f"[serve] W4A4: activations quantized on the fly "
              f"(act_quant={engine.act_quant}, act_rht={engine.act_rht})")
    if engine.kv_quant == "mixfp4":
        print(f"[serve] packed MixFP4 KV cache: "
              f"{engine.kv_cache_bytes() / 2**20:.1f} MiB, decode reads it "
              f"through the attention kernel")

    rng = np.random.RandomState(args.seed)
    pending = [Request(uid=i, prompt=rng.randint(
        0, cfg.vocab, args.prompt_len).astype(np.int32),
        max_new_tokens=args.new_tokens) for i in range(args.requests)]
    ops.reset_launch_counts()
    t0, n_tok = time.perf_counter(), 0
    while pending or engine.has_work():
        while pending and engine.add_request(pending[0]):
            pending.pop(0)
        n_tok += len(engine.step())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests, {n_tok} tokens in {dt:.2f} s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, {engine.decode_steps} "
          f"decode steps)")
    print(f"[serve] kernel launches: {ops.launch_counts()}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
