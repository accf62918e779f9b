"""The single-card training workloads: ``build_train_workload``, counterpart
of ``torchdistx_tpu/utils/benchmarks.py:build_train_workload``,
``build_t5_train_workload``, counterpart of ``scripts/bench_t5_train.py``,
and ``build_vision_train_workload`` for ResNet and ViT.

A Llama LM step (flash attention on the card, AnyPrecisionAdamW at lr
1e-4, or with ``optimizer="adamw_8bit"`` the 8-bit AdamW at lr 1e-4, bf16)
built the way the JAX one is: ``deferred_init`` of the model,
``materialize_module`` on the device, one fixed batch of tokens and labels
from ``np.random.RandomState(0)``, the plain ``cross_entropy`` loss, or
with ``fused_ce=True`` the fused LM-head loss on the hidden states
(``ops.fused_ce``, no (B, S, vocab) logits in device memory).  It takes
explicit arguments where the JAX function reads environment variables
(``name`` for ``TDX_BENCH_TRAIN_MODEL``, ``batch``, ``seq``, ``remat``), and
takes model overrides: ``build_train_workload("mistral_7b", batch=1,
seq=8192, n_layers=8)`` trains a windowed model through the window flash
kernels, and ``build_train_workload("llama2_7b", batch=1, seq=4096,
optimizer="adamw_8bit", remat=True, remat_policy="dots", fused_ce=True)``
trains BASELINE config 5 on one card.  ``flops_per_token`` keeps the JAX
formula, which counts every causal pair and so overcounts a windowed
model's attention.  The workload also reports the process's host RSS
before deferred init, its peak over deferred init and materialize, and
the growth (GB; sampled, see :class:`_PeakRss`).  ``zero2=True`` trains
the JAX workload's ZeRO-2 arm: ``ShardingPlan(mesh, dp_axis="dp",
zero2=True, min_shard_elems=1)`` on ``{"dp": world}`` (every rank of the
process group; a ``ValueError`` below two), the batch replicated, through
``GSPMDTrainStep``: parameters replicated, each rank updating its ``dp``
slice with its slice of the optimizer state.  The dict then also holds
``plan``, ``zero2_dp``, ``zero2_participating_bytes``,
``zero2_step_wire_bytes`` (``plan.step_wire_bytes``: the closed form a
step books into the comm audit) and ``optimizer_bytes()``, which returns
``(bytes of the whole state, bytes this rank holds)`` once a step has made
the state.  ``numerics=True`` builds the step with the numerics observatory
(``obs.numerics``: ``params/``, ``act/``, ``loss`` and ``grads/`` digests a
step, the JAX workload's ``TDX_NUMERICS`` taps plus the activations), which
the trainer harvests at every step (``log_every=1``) into
``workload["trainer"].numerics_book``.  ``cost_card=True`` has the trainer
take the counted cost card on its first step (``Trainer.cost_card``:
FLOPs counted, ``metrics["mfu_xla"]`` and ``["flop_attribution"]``).

:func:`warm_to_steady_state` warms any ``run(carry)`` up until a call sets
up nothing new, the JAX function's contract.

The T5 workload is the JAX script's step: ``deferred_init`` of
``T5.from_name(name, use_flash=True)``, ``materialize_module``,
AnyPrecisionAdamW at lr 1e-4, one fixed (src, tgt) batch from
``np.random.RandomState(seed)``, loss ``cross_entropy(model(src, tgt),
tgt)``, model FLOPs 6N per token (tokens = batch x seq), bf16 on the
card and f32 on the CPU (the script's choice), ``flash_bucket_bias``
choosing the bias mode.

The vision workload builds ``resnet18/50/101`` or a ``ViT`` the same way
(``deferred_init``, ``materialize_module``, AnyPrecisionAdamW at lr 1e-4)
and trains it in training mode (BatchNorm on batch statistics) on one
fixed batch of random images and labels from ``np.random.RandomState(seed)``
with the ``cross_entropy`` of the logits.  A "token" is an image:
``tokens_per_batch`` is the batch size and ``flops_per_token`` three times
one image's forward FLOPs (the convolutions' and matrix products'
multiply-adds, counted by ``torch.utils.flop_counter.FlopCounterMode``
over a one-image forward).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..optimizers import AnyPrecisionAdamW, adamw_8bit

__all__ = ["build_train_workload", "build_t5_train_workload", "build_vision_train_workload",
           "optimizer_bytes", "warm_to_steady_state"]

_RSS_INTERVAL_S = 0.005  # host RSS sampling period over deferred init


def build_train_workload(
    name: str = "llama_1b",
    *,
    batch: int = 2,
    seq: int = 2048,
    remat: bool = False,
    remat_policy: str = "full",
    device="cuda",
    seed: int = 0,
    optimizer: str = "anyprecision",
    fused_ce: bool = False,
    zero2: bool = False,
    numerics: bool = False,
    cost_card: bool = False,
    **model_overrides: Any,
) -> dict:
    """Returns ``{"run", "trainer", "step", "model", "optimizer", "batch",
    "name", "n_params", "batch_size", "seq", "tokens_per_batch",
    "flops_per_token", "remat", "remat_policy", "fused_ce",
    "deferred_init_s", "materialize_s", "host_rss_before_gb",
    "peak_host_rss_gb", "host_rss_delta_gb", "card_bytes_deferred",
    "card_bytes_materialized"}``;
    ``run(n_steps)`` takes ``n_steps`` more steps through ``Trainer.fit``
    and returns their losses as floats.  ``optimizer``: ``"anyprecision"``
    or ``"adamw_8bit"`` (the JAX labels)."""
    if optimizer not in _OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(_OPTIMIZERS)}, "
                         f"got {optimizer!r}")
    if remat_policy != "full" and not remat:
        raise ValueError("remat_policy has no effect without remat=True")

    from ..models.llama import Llama
    from ..nn import functional as F
    from ..ops.fused_ce import fused_linear_cross_entropy

    device = torch.device(device)
    model, init_s = _deferred_model(Llama.from_name, name, device, seed,
                                    max_seq_len=seq, remat=remat,
                                    remat_policy=remat_policy, **model_overrides)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq))).to(device)
    labels = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq))).to(device)

    if fused_ce:
        def loss_fn(m, b):
            toks, labs = b
            h = m(toks, return_hidden=True)
            return fused_linear_cross_entropy(h, m.lm_head.weight, labs)
    else:
        def loss_fn(m, b):
            toks, labs = b
            return F.cross_entropy(m(toks), labs)

    # model FLOPs per token: 6N for the forward and backward matmuls plus
    # the attention term 12 * L * dim * seq (PaLM appendix convention)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq
    extra, make_step = {}, None
    if zero2:
        extra, make_step = _zero2_arm(model, numerics)
    return _workload(model, loss_fn, (tokens, labels), name, batch, seq, n_params,
                     flops_per_token, init_s, optimizer, make_step=make_step,
                     cost_card=cost_card,
                     remat=remat, remat_policy=remat_policy, fused_ce=fused_ce,
                     zero2=zero2, numerics=numerics, **extra)


def warm_to_steady_state(run, carry, sync, max_calls: int = 5, watcher=None,
                         label: str = "warm_to_steady_state"):
    """Call ``run(carry) -> (carry, aux)`` until a call sets up nothing
    new, returning ``(carry, warm_times, converged)``, as the JAX function
    does.  ``sync(aux)`` must wait until the call's work is done (e.g. read
    a loss).  ``converged`` is False when ``max_calls`` ran out while calls
    still set things up: callers MUST surface it, since a timed window after
    such a warm-up may still hold a setup.

    "Sets up nothing new" is the port's "compiles nothing new": no new
    ``obs.recompile`` program (the engine's first dispatches and graph
    captures, counted by ``watcher``, or by a watcher installed for the
    warm-up, each call under ``recompile_scope(label)``) and no new CUDA
    graph capture (``serve.graph_loop.GraphLoop.captures_total``)."""
    from ..obs.recompile import RecompileWatcher
    from ..serve.graph_loop import GraphLoop

    own = watcher is None
    if own:
        watcher = RecompileWatcher()

    def setups():
        return watcher.total, GraphLoop.captures_total

    warm_times = []
    converged = False
    try:
        for _ in range(max_calls):
            before = setups()
            t0 = time.perf_counter()
            with watcher.scope(label):
                carry, aux = run(carry)
                sync(aux)
            warm_times.append(time.perf_counter() - t0)
            if setups() == before:
                converged = True
                break
    finally:
        if own:
            watcher.uninstall()
    return carry, warm_times, converged


def _zero2_arm(model, numerics: bool = False):
    """The ZeRO-2 plan over every rank and the step that realizes it."""
    from ..parallel import GSPMDTrainStep, ShardingPlan, create_mesh
    from ..parallel.multihost import process_count

    world = process_count()
    if world < 2:
        raise ValueError(f"zero2=True needs a multi-rank mesh (have {world} rank(s))")
    mesh = create_mesh({"dp": world})
    plan = ShardingPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
    extra = {"plan": f"zero2(dp={world})", "zero2_dp": world,
             "zero2_participating_bytes": plan.zero2_participating_bytes(model),
             "zero2_step_wire_bytes": plan.step_wire_bytes(model)}

    def make_step(opt, loss_fn):
        return (GSPMDTrainStep(model, opt, loss_fn, mesh, plan=plan, numerics=numerics),
                lambda: optimizer_bytes(opt))

    return extra, make_step


def optimizer_bytes(opt) -> tuple:
    """``(bytes of the whole state, bytes this rank holds)`` of a torch
    optimizer's state tensors: a tensor marked as a piece
    (``parallel.mesh.sharding_of``, or the slot of such a held tensor)
    counts its global shape in the first."""
    from ..parallel.mesh import sharding_of

    total = local = 0
    for held, slots in opt.state.items():
        found = sharding_of(held)
        for t in slots.values():
            if not isinstance(t, torch.Tensor):
                continue
            n = t.numel() * t.element_size()
            local += n
            if found is not None and t.shape == held.shape:
                n = int(np.prod(found[1])) * t.element_size()
            total += n
    return total, local


def build_t5_train_workload(
    name: str = "t5_3b",
    *,
    batch: int = 4,
    seq: int = 512,
    flash_bucket_bias: bool = False,
    device="cuda",
    seed: int = 0,
    **model_overrides: Any,
) -> dict:
    """``scripts/bench_t5_train.py``'s step on one card (encoder and
    decoder both ``seq`` long).  Returns what ``build_train_workload``
    returns; ``batch`` is the (src, tgt) pair."""
    from ..models.t5 import T5
    from ..nn import functional as F

    device = torch.device(device)
    model_overrides.setdefault("use_flash", True)
    # the JAX script's choice: bf16 on the accelerator, f32 on the CPU
    model_overrides.setdefault(
        "dtype", torch.bfloat16 if device.type == "cuda" else torch.float32)
    model, init_s = _deferred_model(T5.from_name, name, device, seed,
                                    flash_bucket_bias=flash_bucket_bias,
                                    **model_overrides)
    n_params = sum(p.numel() for p in model.parameters())
    vocab = model.cfg.vocab_size
    rs = np.random.RandomState(seed)
    src = torch.from_numpy(rs.randint(0, vocab, (batch, seq))).to(device)
    tgt = torch.from_numpy(rs.randint(0, vocab, (batch, seq))).to(device)

    def loss_fn(m, b):
        s, t = b
        return F.cross_entropy(m(s, t), t)

    return _workload(model, loss_fn, (src, tgt), name, batch, seq, n_params,
                     6 * n_params, init_s, "anyprecision", remat=False, fused_ce=False)


_RESNETS = ("resnet18", "resnet50", "resnet101")


def build_vision_train_workload(
    name: str = "resnet50",
    *,
    batch: int = 128,
    image_size: Optional[int] = None,
    num_classes: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    seed: int = 0,
) -> dict:
    """ResNet (``name`` in ``resnet18``, ``resnet50``, ``resnet101``) or ViT
    (a ``vit_configs`` name) trained on ``batch`` images of ``image_size``
    (default: the ViT config's, 224 for ResNet) in ``num_classes`` classes
    (default: the model's, 1000 for ResNet); ``dtype`` defaults to bf16 on
    the card and f32 on the CPU.  Returns what ``build_train_workload``
    returns (``seq`` is 1: a token is an image), with ``image_size``,
    ``num_classes`` and ``dtype``."""
    from ..models.vit import vit_configs
    from ..nn import functional as F

    if name not in _RESNETS and name not in vit_configs:
        raise ValueError(f"unknown vision model {name!r}")
    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, init_s = _deferred_model(_vision_model, name, device, seed, dtype=dtype,
                                    num_classes=num_classes, image_size=image_size)
    if name in _RESNETS:
        image_size, num_classes = image_size or 224, model.fc.out_features
    else:
        image_size, num_classes = model.cfg.image_size, model.cfg.num_classes
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(seed)
    images = torch.from_numpy(rs.randn(batch, 3, image_size, image_size).astype(np.float32))
    images = images.to(device=device, dtype=dtype)
    labels = torch.from_numpy(rs.randint(0, num_classes, batch)).to(device)

    def loss_fn(m, b):
        return F.cross_entropy(m(b[0]), b[1])

    flops_per_image = 3 * _forward_flops(model, images[:1])
    return _workload(model, loss_fn, (images, labels), name, batch, 1, n_params,
                     flops_per_image, init_s, "anyprecision", image_size=image_size,
                     num_classes=num_classes, dtype=dtype)


def _vision_model(name, *, device, dtype, num_classes=None, image_size=None):
    from ..models import resnet
    from ..models.vit import ViT

    if name in _RESNETS:
        return getattr(resnet, name)(num_classes=num_classes or 1000, dtype=dtype,
                                     device=device)
    overrides = {k: v for k, v in (("num_classes", num_classes), ("image_size", image_size))
                 if v is not None}
    return ViT.from_name(name, device=device, dtype=dtype, **overrides)


def _forward_flops(model, x) -> int:
    """FLOPs of one forward of ``model`` on ``x`` (2 per multiply-add of the
    convolutions and matrix products), the module left in its mode."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return counter.get_total_flops()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rss_now_gb() -> float:
    """This process's resident set now, GB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


class _PeakRss:
    """The resident set before the block and the largest one read every
    ``_RSS_INTERVAL_S`` on a thread while it runs (GB); a peak shorter than
    the interval can be missed.  Not ``ru_maxrss``: it survives ``exec``,
    so a process started with multiprocessing's spawn inherits its
    parent's peak there.  Not the kernel's ``VmHWM``: the sandboxed
    kernels the card runs under here give no ``VmHWM`` and refuse
    ``/proc/self/clear_refs``."""

    def __enter__(self) -> "_PeakRss":
        self._stop = threading.Event()
        self.before = self.peak = _rss_now_gb()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(_RSS_INTERVAL_S):
            self.peak = max(self.peak, _rss_now_gb())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_now_gb())


def _deferred_model(ctor, name, device, seed, **kwargs):
    """``deferred_init`` then ``materialize_module`` on ``device``: the
    host seconds of each (the card synchronized), the process's RSS before
    them, its peak over them (:class:`_PeakRss`) and the difference (GB),
    and the growth of the card's allocated bytes over deferred init and
    over both (0 on the CPU)."""
    from ..deferred_init import deferred_init, materialize_module
    from .rng import manual_seed

    def card_bytes():
        return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0

    manual_seed(seed)
    _sync(device)
    bytes0 = card_bytes()
    with _PeakRss() as rss:
        t0 = time.perf_counter()
        model = deferred_init(ctor, name, device=device, **kwargs)
        t1 = time.perf_counter()
        bytes1 = card_bytes()
        materialize_module(model)
        _sync(device)
        t2 = time.perf_counter()
    return model, {"deferred_init_s": t1 - t0, "materialize_s": t2 - t1,
                   "host_rss_before_gb": rss.before, "peak_host_rss_gb": rss.peak,
                   "host_rss_delta_gb": rss.peak - rss.before,
                   "card_bytes_deferred": bytes1 - bytes0,
                   "card_bytes_materialized": card_bytes() - bytes0}


# the JAX labels; both at the JAX workload's lr
_OPTIMIZERS = {
    "anyprecision": lambda params: AnyPrecisionAdamW(params, lr=1e-4),
    "adamw_8bit": lambda params: adamw_8bit(params, 1e-4),
}


def _workload(model, loss_fn, batch_data, name, batch, seq, n_params,
              flops_per_token, init_s, optimizer, make_step=None, cost_card=False, **flags):
    from ..trainer import Trainer, TrainStep

    opt = _OPTIMIZERS[optimizer](model.parameters())
    if make_step is None:
        step = TrainStep(model, opt, loss_fn, numerics=flags.get("numerics", False))
    else:
        step, flags["optimizer_bytes"] = make_step(opt, loss_fn)
    trainer = Trainer(step, tokens_per_batch=batch * seq, log_every=1,
                      log_fn=lambda m: None, flops_per_token=flops_per_token,
                      cost_card=cost_card)

    def run(n_steps: int) -> list:
        start = len(step.losses)
        trainer.fit(itertools.repeat(batch_data), trainer.global_step + n_steps)
        return [float(x) for x in step.losses[start:]]

    return {
        "run": run, "trainer": trainer, "step": step, "model": model,
        "optimizer": opt, "batch": batch_data, "name": name,
        "n_params": int(n_params), "batch_size": batch, "seq": seq,
        "tokens_per_batch": batch * seq, "flops_per_token": flops_per_token,
        **flags, **init_s,
    }
