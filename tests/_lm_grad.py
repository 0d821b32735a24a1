"""Gradient parity of the port's LM stack against the JAX package, with a
float64 witness.

At the reference's init (a stacked weight's std is repeat ** -0.5, about
0.7 on the SMOKE configs: ROADMAP Queue 3) attention logits reach the
hundreds, softmax saturates and the f32 gradients of the layers nearest
the input move by up to about 2e-3 of a leaf's largest entry when the
forward's f32 roundings change. Both packages compute the same gradient:
in float64 they agree to 1e-9 of each leaf's largest entry (in practice
1e-10 and below). So each comparison computes four gradients, each
package's in f32 and in f64, and holds them as follows:

* f64: the port's within ``F64_TOL`` of the reference's, every leaf;
* f32: every leaf by ``_f64.witness_ok``: the port's within ``GRAD_TOL``
  of the reference's, unless the witness shows that leaf ill-conditioned,
  i.e. the reference's own f32 lies farther than ``GRAD_TOL / WITNESS``
  from f64; then the port's f32 must lie no farther from f64 than
  ``WITNESS`` times the reference's does. The reference's distance is
  the largest over its f32 runs at the given inputs and at inputs
  ``nudged`` by one ulp (``N_NUDGED``, run only when a leaf is refused):
  at recurrentgemma's ``lam`` one sample of it ranges over 1.2e-4 to
  1.6e-3, the port's over 4.7e-4 to 1.3e-3.

Each figure is max |a - b| over a leaf divided by the leaf's largest |b|;
the printed figures are the largest over the leaves.
"""
import contextlib
import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _f64 import (GRAD_TOL, N_NUDGED, leaf_err,  # noqa: F401  (re-exported)
                  nudged, port_f64, witness_misses, witness_ok)
from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models.lm import model as jmodel
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import lm_loss
from repro_torch.optim import tree_map

F64_TOL = 1e-9


@contextlib.contextmanager
def jax_f64():
    """The reference in f64: x64 on, and its ``jnp.float32`` casts made
    ``float64`` while the block runs."""
    with jax.enable_x64(True), \
            unittest.mock.patch.object(jnp, "float32", jnp.float64):
        yield


def sorted_leaves(tree):
    """Leaves in ``jax.tree_util``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in sorted_leaves(t)]
    return [tree]


def rel_err(got, want) -> float:
    """The largest ``leaf_err`` over the leaves."""
    return max(leaf_err(a, b) for a, b in zip(got, want))


def check_witness(name, port32, jax32, port64, jax64, more=None) -> dict:
    """Hold four lists of gradient arrays to the rules above, leaf by
    leaf (``more`` as ``witness_misses`` takes it); returns the largest
    figures (printed with ``-s``)."""
    misses, fig = witness_misses(port32, jax32, jax64, more=more)
    fig["f64_gap"] = rel_err(port64, jax64)
    print(f"{name}: " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in fig.items()))
    assert fig["f64_gap"] <= F64_TOL, (name, fig)
    assert not misses, (f"{name}: leaves (index, (port_vs_ref, "
                        f"ref_f32_vs_f64, port_f32_vs_f64)) the witness "
                        f"refuses", misses)
    return fig


def check_trajectory(name, port32, ref32, f64_runs) -> dict:
    """The same rules over a run's losses (lists, one per step), step by
    step, as absolute differences: Adam's first steps move each parameter
    by about lr times the sign of its gradient, so the gradients' f32
    noise grows along a run, in both packages alike. ``f64_runs()`` gives
    the port's and the reference's f64 losses; it runs only when the f32
    runs part by more than ``GRAD_TOL``."""
    def dist(a, b):
        return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    gap = dist(port32, ref32)
    fig = dict(port_vs_ref=float(gap.max()))
    if fig["port_vs_ref"] <= GRAD_TOL:
        print(f"{name}: port_vs_ref {fig['port_vs_ref']:.2e}")
        return fig
    port64, ref64 = f64_runs()
    ref_gap, port_gap = dist(ref32, ref64), dist(port32, ref64)
    fig.update(ref_f32_vs_f64=float(ref_gap.max()),
               port_f32_vs_f64=float(port_gap.max()),
               f64_gap=float(dist(port64, ref64).max()))
    print(f"{name}: " + ", ".join(f"{k} {v:.2e}" for k, v in fig.items()))
    assert fig["f64_gap"] <= F64_TOL * max(abs(x) for x in ref64), \
        (name, fig)
    misses = [(step, g) for step, g in enumerate(zip(gap, ref_gap, port_gap))
              if not witness_ok(*g)]
    assert not misses, (f"{name}: steps the witness refuses", misses)
    return fig


def vjp_both(jfn, pfn, inputs, cot, f64: bool):
    """(output, input gradients) of ``jfn`` (JAX) and ``pfn`` (port) at the
    numpy ``inputs`` under cotangent ``cot``, in f32 or f64, as numpy."""
    dt = np.float64 if f64 else np.float32
    xs = [np.asarray(a, dt) for a in inputs]
    ctx = jax_f64() if f64 else contextlib.nullcontext()
    with ctx:
        out, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in xs])
        jg = [np.asarray(g) for g in vjp(jnp.asarray(np.asarray(cot, dt)))]
        jout = np.asarray(out)
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in xs]
    with (port_f64() if f64 else contextlib.nullcontext()):
        pout = pfn(*ts)
        pg = torch.autograd.grad(pout, ts, torch.from_numpy(
            np.asarray(cot, dt)))
    return (jout, jg), (pout.detach().numpy(), [g.numpy() for g in pg])


def batch_of(cfg, b, s, seed):
    """Tokens, a loss mask with the second half of row 0 zero, and for a
    VLM a (B, P, D) prefix, from numpy ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0.0
    out["loss_mask"] = mask
    if cfg.vision_prefix_len:
        out["prefix_embeds"] = (rng.normal(size=(
            b, cfg.vision_prefix_len, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    jcfg = jax_get_smoke(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.lm_loss(jcfg, p, b)))


def _cast(a, dt):
    a = np.asarray(a)
    return a.astype(dt) if a.dtype.kind == "f" else a


def ref_loss_and_grads(arch, jparams, batch, f64):
    """(loss, gradient leaves) of the reference, in f32 or in f64."""
    dt = np.float64 if f64 else np.float32
    with (jax_f64() if f64 else contextlib.nullcontext()):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(_cast(a, dt)),
                                    jparams)
        jb = {k: jnp.asarray(_cast(v, dt)) for k, v in batch.items()}
        jl, jg = _jax_value_and_grad(arch)(jp, jb)
        return float(jl), [np.asarray(g) for g in
                           jax.tree_util.tree_leaves(jg)]


def loss_and_grads(arch, jparams, batch, f64):
    """(loss, gradient leaves in JAX's order) of the reference and of the
    port, in f32 or in f64."""
    dt = np.float64 if f64 else np.float32

    def cast(a):
        return _cast(a, dt)
    ref = ref_loss_and_grads(arch, jparams, batch, f64)
    p = tree_map(lambda t: t.requires_grad_(), lm_params_from_jax(
        jax.tree_util.tree_map(cast, jparams), "cpu"))
    tb = {k: torch.from_numpy(cast(v)) for k, v in batch.items()}
    with (port_f64() if f64 else contextlib.nullcontext()):
        loss = lm_loss(get_smoke_config(arch), p, tb)
        grads = torch.autograd.grad(loss, sorted_leaves(p))
    return ref, (loss.item(), [g.numpy() for g in grads])


def check_arch(arch):
    """The SMOKE config's ``lm_loss`` (B=2, S=32, a mask with zeros) and
    every gradient leaf, port against reference, with the witness."""
    jcfg = jax_get_smoke(arch)
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = batch_of(jcfg, 2, 32, ARCH_IDS.index(arch))
    (jl, jg), (pl, pg) = loss_and_grads(arch, jparams, batch, False)
    (jl64, jg64), (pl64, pg64) = loss_and_grads(arch, jparams, batch, True)
    print(f"{arch}: loss port {pl:.7f} reference {jl:.7f}; f64 port "
          f"{pl64:.12f} reference {jl64:.12f}")
    np.testing.assert_allclose(pl, jl, atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(pl64, jl64, rtol=1e-12)
    assert len(pg) == len(jg) == len(jax.tree_util.tree_leaves(jparams))

    def more():
        for k in range(N_NUDGED):
            rng = np.random.default_rng(100 + k)
            jp = jax.tree_util.tree_map(lambda a: nudged(a, rng), jparams)
            yield (ref_loss_and_grads(arch, jp, batch, False)[1],
                   ref_loss_and_grads(arch, jp, batch, True)[1])
    check_witness(arch, pg, jg, pg64, jg64, more)
    # every leaf gets a gradient: the MTP subtree's too (deepseek-v3)
    assert all(np.abs(g).max() > 0 for g in pg)
