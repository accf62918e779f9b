"""Compare checkouts of the PyTorch/CUDA port on one card: T5-3B's
bias-gradient kernels at B 4 x S 512 and a profiled T5-3B bucket-mode
training run.

Run it once per checkout, in turns (parent, change, change, parent),
within one command on the card: two commands may land on two cards.

    python3 scripts/torch_compare_t5.py ROOT TAG [--out DIR]

ROOT is a checkout whose ``chip_smoke.py`` and ``torchdistx_tpu_torch``
are the ones run; TAG names the run.  It prints ``COMPARE TAG {json}`` and
writes the same object to ``DIR/compare_TAG.json``:

- ``dgrad_ms``: dbias's and dtable's CUDA-event times from the checkout's
  ``chip_smoke.check_flash_bias`` at B 4 x S 512 (T5's scale, 20 calls);
- ``dtable``: dtable's device time per call, from calls queued behind a
  ``torch.cuda._sleep`` so that the wrapper's host time drops out, on the
  pre-pass's delta where the checkout's wrapper takes one and with the
  pre-pass (or the kernel that forms delta itself), and its kernels' time
  by ``torch.profiler``, encoder (full) and decoder (causal);
- ``t5_bucket``: the checkout's ``chip_smoke.train_t5`` in the bucket
  mode, 3 steps then 2 profiled: step ms, device ms a step by kernel class,
  and the repeated step's bit comparison where the checkout has one.

It needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import time


def queued_ms(torch, fn, iters, sleep_cycles=20_000_000):
    """Mean device ms per call: CUDA events around ``iters`` calls queued
    behind a sleep long enough for the host to enqueue them all (a copy of
    ``chip_smoke.queued_ms``, which an older checkout lacks)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(torch, fn, iters):
    """Device ms per call of each kernel ``fn`` launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.self_device_time_total}


def dtable_times(torch, fa, iters=50):
    """dtable at T5-3B's heads, B 4 x S 512, 32 buckets, scale 1.0."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, h, d = 4, 512, 32, 128

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = (rnd(b, s, h, d).float() * d ** -0.5).to(torch.bfloat16)
    k, v, do, table = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d), rnd(h, 32)
    takes_delta = "delta" in inspect.signature(fa.flash_bwd_dtable_cuda).parameters
    out = {}
    for name, causal in (("encoder", False), ("decoder", True)):
        cfg = (32, 128, not causal)
        o, lse = fa.flash_fwd_cuda(q, k, v, return_lse=True, causal=causal, scale=1.0,
                                   table=table, bucket_cfg=cfg)
        call = functools.partial(fa.flash_bwd_dtable_cuda, q, k, v, o, lse, do, table, cfg,
                                 causal=causal, scale=1.0)
        out[f"{name}_with_prepass_ms"] = queued_ms(torch, call, iters)
        if takes_delta:
            delta = fa.flash_bwd_delta_cuda(o, do)
            call = functools.partial(call, delta=delta)
            out[f"{name}_ms"] = queued_ms(torch, call, iters)
        out[f"{name}_kernels_ms"] = kernel_ms(torch, call, 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="the checkout to run")
    ap.add_argument("tag", help="the name of this run")
    ap.add_argument("--out", default="build/compare", help="directory of the JSON file")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("torch_compare_t5: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torchdistx_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rows, failures = cs.check_flash_bias(torch, torch.device("cuda"), cases=[(4, 512)],
                                         iters=20)
    dtable = dtable_times(torch, fa)
    train, f13 = cs.train_t5(torch, 0, True, steps=3, profile_steps=2)
    prof = train.get("profile", {})
    result = {
        "tag": args.tag, "root": root, "card": card.strip(), "failures": failures + f13,
        "dgrad_ms": {f"{r['mode']} {'causal' if r['causal'] else 'full'}": r["dgrad_ms"]
                     for r in rows if "dgrad_ms" in r},
        "dtable": dtable,
        "t5_bucket": {"step_ms": train["step_ms"],
                      "device_ms_per_step": prof.get("device_ms_per_step"),
                      "profiled_step_ms": prof.get("step_wall_ms"),
                      "by_class_ms": prof.get("by_class_ms"),
                      "repeat_step": train.get("repeat_step")},
        "seconds": time.perf_counter() - t0,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"compare_{args.tag}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print("COMPARE", args.tag, json.dumps(result))
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
