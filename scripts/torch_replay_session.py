"""Replay a ``tdx-session-v1`` black box with the PyTorch port.

Takes one recording written by a port ``ServeEngine(record=...)`` or
``ServeFleet(record=...)`` session (``torchdistx_tpu_torch/obs/
blackbox.py``), rebuilds the model and the engine or the fleet from the
recorded geometry, re-drives the exact submit / step / tick / signal
stream on the device named by ``--device`` (the card by default), and
prints the verdict:

- ``match``: every drain's digest is equal: the session reproduces.
- ``truncated_match``: the recording ends without a ``session_end`` (a
  killed run); its complete prefix replays equal, the cut is named.
- ``divergent``: the chains split; the verdict names the FIRST divergent
  drain (seq, tick, source), the counters that differ and the affected
  session request ids.
- ``geometry_mismatch``: the rebuilt engine does not match the recorded
  geometry (the fields named); nothing was re-driven.

The model: a ``model_spec`` event in the recording (``{"family": "llama"
| "gpt2", "name", "seed", "dtype", "overrides"}``) names it; ``--model
family:name``, ``--seed`` and ``--dtype`` override it.  The
weights are drawn from the seed (``torchdistx_tpu_torch.manual_seed``),
so the model is the recorded one only when the recording session built it
the same way.

Usage:
  python3 scripts/torch_replay_session.py SESSION.jsonl [--device cpu]
  python3 scripts/torch_replay_session.py SESSION.jsonl --strict
  python3 scripts/torch_replay_session.py SESSION.jsonl --validate-only

The full JSON verdict is the last line of standard output.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description="replay a tdx-session-v1 recording "
                                "with the PyTorch port and report the verdict")
    p.add_argument("recording", help="path to the session JSONL")
    p.add_argument("--device", default="cuda", help="where to replay (default: cuda)")
    p.add_argument("--model", default=None,
                   help="family:name, e.g. llama:tiny or gpt2:gpt2_large "
                   "(default: the recording's model_spec)")
    p.add_argument("--seed", type=int, default=None, help="weight seed override")
    p.add_argument("--dtype", default=None, help="model dtype override, e.g. bfloat16")
    p.add_argument("--validate-only", action="store_true",
                   help="schema and digest-chain integrity only; no re-execution")
    p.add_argument("--allow-truncated", action="store_true",
                   help="validation: a missing session_end is a note, not an error")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 unless the verdict is match or truncated_match")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the verdict to this path")
    return p.parse_args(argv)


def model_factory(events, args):
    """Build the recorded model from its ``model_spec`` and the overrides."""
    spec = dict(next((e for e in events if e.get("kind") == "model_spec"), None) or {})
    if args.model:
        spec["family"], _, spec["name"] = args.model.partition(":")
    if spec.get("name") is None:
        raise SystemExit("the recording has no model_spec event: pass --model "
                         "family:name (e.g. llama:tiny)")
    overrides = dict(spec.get("overrides") or {})
    seed = args.seed if args.seed is not None else int(spec.get("seed", 0))
    dtype_name = args.dtype or spec.get("dtype", "float32")

    def build():
        import torch

        import torchdistx_tpu_torch as tt
        from torchdistx_tpu_torch.models import GPT2, Llama

        cls = {"llama": Llama, "gpt2": GPT2}[spec.get("family", "llama")]
        tt.manual_seed(seed)
        model = cls.from_name(spec["name"], device=args.device,
                              dtype=getattr(torch, dtype_name), **overrides)
        return model.requires_grad_(False)

    return build


def describe(verdict) -> str:
    """One line: the verdict, and on a mismatch the first divergent drain."""
    v = verdict.get("verdict")
    if verdict.get("match"):
        return (f"REPLAY {str(v).upper()}: {verdict.get('drains_replayed')} drains equal "
                f"(chain {str(verdict.get('chain_replayed'))[:16]}...)")
    if v == "geometry_mismatch":
        return f"REPLAY GEOMETRY MISMATCH: fields {verdict.get('geometry_fields')}"
    d = verdict.get("first_divergence") or {}
    return (f"REPLAY DIVERGENT at drain seq={d.get('seq')} tick={d.get('tick')} "
            f"source={d.get('source')}: counters={d.get('counters')} "
            f"request_ids={d.get('rids')}")


def main(argv=None) -> int:
    args = _parse_args(argv)
    import torch

    from torchdistx_tpu_torch.obs.blackbox import (geometry_kwargs, load_session,
                                                   replay_session, validate_session_jsonl)

    errors = validate_session_jsonl(args.recording, allow_truncated=args.allow_truncated)
    for e in errors:
        print(f"INVALID: {e}")
    if args.validate_only or any("chain" in e or "unparseable" in e for e in errors):
        # a torn or truncated recording still replays its prefix; a broken
        # chain is not evidence of anything
        out = {"schema": "tdx-session-verdict-v1",
               "verdict": "valid" if not errors else "invalid", "errors": errors}
        print(json.dumps(out))
        return 1 if errors and (args.strict or not args.validate_only) else 0
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to replay on the CPU")
    events, _ = load_session(args.recording)
    build = model_factory(events, args)
    with torch.no_grad():
        if any(e.get("kind") == "fleet" for e in events):
            from torchdistx_tpu_torch.serve import ServeEngine

            model = build()  # one model shared by every rebuilt replica
            verdict = replay_session(events, engine_factory=lambda rec, geom: ServeEngine(
                model, record=rec, **geometry_kwargs(geom)))
        else:
            verdict = replay_session(events, model_factory=build)
    print(describe(verdict))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(verdict, f, indent=2)
    print(json.dumps(verdict))
    return 0 if verdict.get("match") or not args.strict else 1


if __name__ == "__main__":
    sys.exit(main())
