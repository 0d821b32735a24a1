"""LM training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 6 --ckpt-dir /tmp/ck                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --smoke --device cpu                   # on the CPU

Real steps on one device: a synthetic token stream (``synthetic_batch``,
the reference's numpy stream), ``lm_loss`` with rematerialisation, the
optimizer (AdamW by default), a checkpoint every ``--ckpt-every`` steps
and auto-resume from the newest intact one; ``--compress`` sends the
gradient through top-k compression with error feedback before the
update. ``--smoke`` takes the reduced per-arch config. On the card each
GQA or local attention layer runs the flash kernel in its forward (twice
a step with remat: once more when the backward recomputes the layer) and
differentiates the plain attention.

The reference initialises from ``jax.random.PRNGKey(0)``, the port from a
torch generator seeded 0, so the two start from different weights;
``train_loop`` takes the parameters and optimizer state, so a caller can
start it from the reference's (``convert.lm_params_from_jax``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import DeviceSpec, resolve_device, to_tensor
from repro_torch.models.lm import init_params, lm_loss
from repro_torch.optim.compression import (
    ErrorFeedback, flatten_grads, unflatten_grads)
from repro_torch.optim.optimizers import (
    Optimizer, get_optimizer, tree_leaves, tree_map)


def synthetic_batch(cfg, batch: int, seq: int, step: int,
                    device: DeviceSpec = None) -> Dict[str, torch.Tensor]:
    """The reference's batch for ``step``: tokens (B, S[, K]) int32 and
    loss_mask (B, S) f32 of ones from numpy ``default_rng(step)``, and for
    a VLM (B, P, D) normal patch embeddings in the model's dtype."""
    rng = np.random.default_rng(step)
    if cfg.num_codebooks > 1:
        toks = rng.integers(0, cfg.vocab_size, (batch, seq, cfg.num_codebooks))
    else:
        toks = rng.integers(0, cfg.vocab_size, (batch, seq))
    out = {"tokens": to_tensor(toks.astype(np.int32), device),
           "loss_mask": to_tensor(np.ones((batch, seq), np.float32), device)}
    if cfg.vision_prefix_len:
        out["prefix_embeds"] = to_tensor(rng.normal(
            size=(batch, cfg.vision_prefix_len, cfg.d_model)), device).to(
                getattr(torch, cfg.dtype))
    return out


def grads_only(cfg, params, batch: Dict[str, torch.Tensor]
               ) -> Tuple[Any, torch.Tensor]:
    """(gradient tree, loss) of ``lm_loss`` with remat at ``params``; each
    gradient in its parameter's dtype."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm_loss(cfg, p, batch, remat=True)
    grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return tree_map(lambda _: next(grads), params), loss.detach()


def leaf_paths(tree: Any, prefix: Tuple = ()):
    """Each leaf's path (a tuple of keys and indices), in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    else:
        yield prefix


def _get(tree: Any, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: Any, path: Tuple, value: Any) -> None:
    _get(tree, path[:-1])[path[-1]] = value


def apply_grads(opt: Optimizer, params, opt_state, grads, lr: float):
    """``opt.update`` and ``p + u`` cast back to each parameter's dtype,
    as the reference's step computes them, one parameter at a time: every
    optimizer of ``repro_torch.optim`` updates each leaf from its own
    gradient and state and the shared step count. Like the reference's
    donated arguments, ``params``, ``opt_state`` and ``grads`` are
    consumed: their containers are updated in place (each old leaf freed
    as soon as its successor exists, so the step never holds two copies
    of the optimizer state) and the first two are returned."""
    keys = [k for k in opt_state if k != "step"]
    step = opt_state["step"]
    new_step = step + 1
    for path in list(leaf_paths(params)):
        p = _get(params, path)
        sub = {"step": step, **{k: _get(opt_state[k], path) for k in keys}}
        upd, new = opt.update(_get(grads, path), sub, p, lr)
        _put(grads, path, None)
        _put(params, path, (p + upd).to(p.dtype))
        for k in keys:
            _put(opt_state[k], path, new[k])
        new_step = new["step"]
    opt_state["step"] = new_step
    return params, opt_state


def train_step(cfg, opt: Optimizer, params, opt_state,
               batch: Dict[str, torch.Tensor], lr: float):
    """One step: (params, opt_state, loss); the inputs are consumed."""
    grads, loss = grads_only(cfg, params, batch)
    params, opt_state = apply_grads(opt, params, opt_state, grads, lr)
    return params, opt_state, loss


def train_loop(cfg, params, opt_state, args: argparse.Namespace,
               opt: Optimizer, log=print
               ) -> Tuple[Any, Any, Dict[int, float]]:
    """Steps ``[start, args.steps)`` from ``params`` and ``opt_state``
    (resumed from ``args.ckpt_dir``'s newest intact checkpoint when there
    is one), printing the reference's lines through ``log``. Returns
    (params, opt_state, {step: loss})."""
    dev = resolve_device(args.device)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None:
        resumed = ckpt.auto_resume({"params": params, "opt": opt_state}, dev)
        if resumed is not None:
            tree, manifest = resumed
            params, opt_state = tree["params"], tree["opt"]
            start_step = manifest["step"] + 1
            log(f"resumed from step {manifest['step']}")
    ef = ErrorFeedback(k_frac=0.01) if args.compress else None
    losses: Dict[int, torch.Tensor] = {}
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, step, dev)
        if ef is None:
            params, opt_state, loss = train_step(cfg, opt, params, opt_state,
                                                 batch, args.lr)
        else:
            grads, loss = grads_only(cfg, params, batch)
            flat, spec = flatten_grads(grads)
            del grads
            _, flat_c = ef.compress(flat)     # the payload a link would carry
            del flat
            params, opt_state = apply_grads(opt, params, opt_state,
                                            unflatten_grads(flat_c, spec),
                                            args.lr)
        losses[step] = loss
        if step % 5 == 0 or step == args.steps - 1:
            log(f"step {step:5d}  loss {float(loss):.4f}  "
                f"({time.time() - t0:.1f}s)")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save({"params": params, "opt": opt_state}, step)
    if ckpt is not None:
        ckpt.wait()
    return params, opt_state, {s: float(l) for s, l in losses.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", action="store_true",
                    help="top-k gradient compression w/ error feedback")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, the plain path")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model}")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = get_optimizer(args.optimizer)
    opt_state = opt.init(params)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"params: {n / 1e6:.1f}M")
    train_loop(cfg, params, opt_state, args, opt)
    print("done")


if __name__ == "__main__":
    main()
