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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --device cpu --kv-quant mixfp4 --kv-pool 9 --prefill-chunk 4
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-moe-a2.7b --kv-quant mixfp4
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --smoke --device cpu --kv-quant mixfp4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --save-weights build/ckpt/gemma2-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --device cpu --max-queue 2 --deadline-ms 1e6 \
      --inject-faults "0:decode=slow:5"

``--save-weights DIR`` writes the packed weights as a checkpoint in the
reference's format and exits without serving; ``ServeEngine.load_weights``
restores it (or a checkpoint the reference wrote).

Requests ride the engine's bounded admission queue (``--max-queue``;
``submit`` until backpressure, then ``step``), with optional default
deadlines (``--deadline-ms``, ``--ttft-budget-ms``) and a seeded fault
schedule (``--inject-faults``, which puts the engine on the injector's
virtual clock); the run ends with the lifecycle's terminal-state totals
and its robustness counters.

Each layer's projections are packed as soon as they are drawn (unless
``--act-rht``, whose rotation the engine applies to dense weights), so a
full-width MoE model never exists in f32 on the device.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import qtensor
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import QueueFullError, Request, ServeEngine
from repro_torch.serving.faults import parse_faults


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
    ap.add_argument("--kv-pool", type=int, default=0, metavar="PAGES",
                    help="serve the packed KV cache as a PAGES-page pool "
                         "with per-request block tables, copy-on-write "
                         "prefix caching and LRU eviction (serving.kvpool; "
                         "requires --kv-quant mixfp4). Page 0 is the trash "
                         "page, so usable pages are PAGES-1")
    ap.add_argument("--kv-page-len", type=int, default=16, metavar="ROWS",
                    help="rows per KV page (multiple of 16 — the MixFP4 "
                         "block — and must divide --max-len)")
    ap.add_argument("--prefill-buckets", default="auto",
                    choices=["auto", "pow2-64", "off"])
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="TOKENS",
                    help="chunked-prefill scheduling (serving.scheduler): "
                         "split each admission's prefill into TOKENS-token "
                         "chunks interleaved with decode steps, so long "
                         "prompts never stall the decode batch by more "
                         "than the chunk budget (bitwise-identical to "
                         "whole-prompt prefill and one prefill shape; "
                         "replaces --prefill-buckets)")
    ap.add_argument("--max-queue", type=int, default=64, metavar="N",
                    help="bounded admission queue: submissions beyond N "
                         "waiting requests are rejected with backpressure "
                         "(typed reason 'queue_full') instead of growing "
                         "an unbounded backlog")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="default per-request deadline: a request not "
                         "FINISHED within MS of submission lands EXPIRED "
                         "(typed reason 'deadline'), its slot and pool "
                         "pages released")
    ap.add_argument("--ttft-budget-ms", type=float, default=None,
                    metavar="MS",
                    help="default time-to-first-token budget: a request "
                         "with no first token within MS lands EXPIRED "
                         "(reason 'ttft_deadline')")
    ap.add_argument("--inject-faults", default=None, metavar="SEED:SPEC",
                    help="deterministic seeded fault injection at the "
                         "engine's host/device boundaries, e.g. "
                         "'7:decode=nan@3,pool_acquire=deny@p0.1' "
                         "(serving.faults.parse_faults; sites prefill/"
                         "decode/cow_copy/pool_acquire/checkpoint_read/"
                         "journal_write/process_crash, "
                         "kinds error/transient/nan/slow/dispatch/deny). "
                         "The engine then runs on the injector's virtual "
                         "clock")
    ap.add_argument("--save-weights", default=None, metavar="DIR",
                    help="write the packed weights as a checkpoint to DIR "
                         "(the reference's packed format; restore with "
                         "ServeEngine.load_weights(DIR)) and exit")
    args = ap.parse_args(argv)
    if args.act_rht and args.act_quant not in ("mixfp4",
                                               "mixfp4-2pass-rowscale"):
        ap.error("--act-rht rotates both W4A4 operands and needs the "
                 "per-row scales; use --act-quant mixfp4 or "
                 "mixfp4-2pass-rowscale")

    injector = (parse_faults(args.inject_faults)
                if args.inject_faults else None)
    device = resolve_device(args.device)
    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.config(args.arch))
    params = build_model(cfg).init(
        args.seed, device=device, pack=None if args.act_rht else args.quant)
    n_params = sum(math.prod(t.shape) * t.batch_size()
                   if isinstance(t, qtensor.QTensor) else t.numel()
                   for t in _leaves(params))
    print(f"[serve] {cfg.name}: {n_params / 1e6:.1f}M params on {device}")
    engine = ServeEngine(cfg, params, batch_size=args.batch,
                         max_len=args.max_len, method=args.quant,
                         kv_quant=args.kv_quant, act_quant=args.act_quant,
                         act_rht=args.act_rht,
                         prefill_buckets=args.prefill_buckets,
                         prefill_chunk=args.prefill_chunk or None,
                         kv_pool=args.kv_pool or None,
                         kv_page_len=args.kv_page_len, device=device,
                         max_queue=args.max_queue,
                         deadline_ms=args.deadline_ms,
                         ttft_budget_ms=args.ttft_budget_ms,
                         faults=injector)
    if injector is not None:
        print(f"[serve] fault injection armed: seed {injector.seed}, "
              f"{len(injector.rules)} rule(s); engine on the injector's "
              "virtual clock")
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
    if engine.prefill_chunk:
        print(f"[serve] chunked-prefill scheduler armed: admissions "
              f"prefill {engine.prefill_chunk} tokens/step interleaved "
              f"with decode")
    if args.save_weights:
        engine.save_weights(args.save_weights)
        print(f"[serve] packed QTensor weights checkpointed to "
              f"{args.save_weights}")
        return

    rng = np.random.RandomState(args.seed)
    # pooled runs share a page-sized "system prompt" across requests so the
    # pool report below shows prefix hits
    shared = (rng.randint(0, cfg.vocab, args.kv_page_len).astype(np.int32)
              if args.kv_pool else np.zeros((0,), np.int32))
    pending = [Request(uid=i, prompt=np.concatenate(
        [shared, rng.randint(0, cfg.vocab, args.prompt_len).astype(
            np.int32)]),
        max_new_tokens=args.new_tokens) for i in range(args.requests)]
    ops.reset_launch_counts()
    t0, n_tok = time.perf_counter(), 0
    # requests ride the bounded admission queue: submit until
    # backpressure, then step (step() itself pumps QUEUED requests into
    # free slots, expires deadlines, and crosses the fault boundaries)
    while pending or engine.has_work():
        while pending:
            try:
                engine.submit(pending[0])
            except QueueFullError:
                break
            pending.pop(0)
        n_tok += len(engine.step())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests, {n_tok} tokens in {dt:.2f} s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, {engine.decode_steps} "
          f"decode steps)")
    print(f"[serve] kernel launches: {ops.launch_counts()}")
    rep = engine.pool_report()
    if rep is not None:
        print(f"[serve] KV pool: {rep['pages_total']} pages x "
              f"{rep['page_len']} rows, peak concurrency "
              f"{engine.max_concurrent}; prefix hits {rep['prefix_hits']} "
              f"pages / {rep['prefix_hit_tokens']} tokens skipped, "
              f"{rep['cow_copies']} COW copies, {rep['evictions']} "
              f"evictions, {rep['alloc_failures']} admission deferrals; "
              f"final occupancy {rep['occupancy']:.2f} "
              f"({rep['pages_cached']} cached / {rep['pages_free']} free)")
    if engine.scheduler is not None:
        print(f"[serve] chunked prefill: {engine.prefill_dispatches} "
              f"prefill passes, at most "
              f"{engine.scheduler.max_prefill_tokens_per_step()} prompt "
              f"tokens in one step")
    rob = engine.robustness_report()
    print(f"[serve] lifecycle: {rob['request_states']} "
          f"(queue bound {rob['queue']['max_queue']}, deadline "
          f"{args.deadline_ms or 'off'} ms, ttft budget "
          f"{args.ttft_budget_ms or 'off'} ms)")
    notable = {k: v for k, v in rob["counters"].items()
               if k.split(":")[0] in ("failed", "expired", "cancelled",
                                      "rejected") or k.startswith(
                   ("retries", "degraded", "deferred", "injected"))}
    if notable:
        print(f"[serve] robustness counters: {notable}")
    if injector is not None:
        print(f"[serve] injector fired {len(injector.log)} event(s): "
              f"{injector.summary()['by_kind']}")


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
