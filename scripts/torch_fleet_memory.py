"""What the serving fleet phase leaves on the card, and whether a training
run after it is slower.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_fleet_memory.py [--seed N]

It builds the port's kernels, trains llama_1b as ``chip_smoke.py``'s
phase 6 does (the process's first training run), reads the caching
allocator's allocated and reserved bytes, runs ``chip_smoke``'s phase 29
(``serve_fleet_phase``) on a full-width llama3_8b with random weights
from the seed, frees the model, reads the bytes again (before and after a
``gc.collect()``), then trains llama_1b twice more.  It prints one JSON
line per reading (``MEMORY {...}``, ``TRAIN {...}``: step ms and peak
bytes) and, last, the card's name and power limit.  It needs a CUDA
device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.ops import _build

    _build.build_all(["flash_fwd", "flash_bwd", "decode_attention", "fused_ce"])
    torch.backends.cuda.matmul.allow_tf32 = False

    def memory(when):
        torch.cuda.synchronize()
        print("MEMORY", json.dumps({"when": when,
                                    "allocated": torch.cuda.memory_allocated(),
                                    "reserved": torch.cuda.memory_reserved()}), flush=True)

    def train(when):
        summary, failures = cs.train(torch, args.seed)
        print("TRAIN", json.dumps({"when": when, "step_ms": summary["step_ms"],
                                   "peak_memory_bytes": summary["peak_memory_bytes"],
                                   "failures": failures}), flush=True)
        torch.cuda.empty_cache()

    train("first in the process")
    memory("before phase 29")
    tt.manual_seed(args.seed)
    model = tt.models.Llama.from_name("llama3_8b", dtype=torch.bfloat16, device="cuda")
    model.requires_grad_(False)
    with torch.no_grad():
        _, failures, _ = cs.serve_fleet_phase(torch, model, args.seed + 15)
    del model
    torch.cuda.empty_cache()
    memory("after phase 29")
    gc.collect()
    torch.cuda.empty_cache()
    memory("after phase 29 and gc.collect")
    train("after phase 29")
    train("after phase 29, again")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(smi.stdout.strip())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
