#!/usr/bin/env python3
"""How far each package's f32 gradient of ``lm_loss`` lies from float64,
leaf by leaf, at a SMOKE config's weights and at weights nudged by one ulp.

    PYTHONPATH=src python3 tests/witness_spread.py recurrentgemma-2b [runs]

Runs on the CPU, both packages (about 15 s for 6 runs). The weights are
the reference's ``init_params`` at ``PRNGKey(0)``; run k > 0 scales each
f32 entry by 1 or 1 +- 2^-23 at random (``tests/_f64.nudged``, numpy seed
100 + k), the batch is ``tests/_lm_grad.batch_of``'s (B=2, S=32). For
each leaf where the two f32 results part by more than 1e-4 of its largest
entry, or where the reference's f32 lies farther than 2.5e-5 from f64 in
some run, it prints the reference's and the port's distance from their
common f64 result in every run (max |a - b| over the leaf / its largest
|b|).

What it tells: whether one package's f32 is the less accurate at a leaf,
or whether a single sample of an ill-conditioned leaf's rounding noise
fell low in one package and high in the other (``tests/_lm_grad.py``'s
witness takes the largest over such runs for that reason).
"""
import sys

import jax
import numpy as np

from _f64 import GRAD_TOL, WITNESS, leaf_err, nudged
from _lm_grad import batch_of, loss_and_grads
from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models.lm import model as jmodel


def main(arch: str, runs: int = 6) -> None:
    jcfg = jax_get_smoke(arch)
    base = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(base)[0]]
    batch = batch_of(jcfg, 2, 32, ARCH_IDS.index(arch))
    ref, port, gap = [], [], []
    for k in range(runs):
        rng = np.random.default_rng(100 + k)
        jp = base if k == 0 else jax.tree_util.tree_map(
            lambda a: nudged(a, rng), base)
        (_, jg), (_, pg) = loss_and_grads(arch, jp, batch, False)
        (_, jg64), _ = loss_and_grads(arch, jp, batch, True)
        ref.append([leaf_err(a, b) for a, b in zip(jg, jg64)])
        port.append([leaf_err(a, b) for a, b in zip(pg, jg64)])
        gap.append([leaf_err(a, b) for a, b in zip(pg, jg)])
    ref, port, gap = (np.array(x) for x in (ref, port, gap))
    print(f"{arch}: {len(paths)} leaves, {runs} runs (run 0 at PRNGKey(0)'s "
          f"weights); distance from f64, reference | port")
    for i, path in enumerate(paths):
        if gap[0, i] <= GRAD_TOL and ref[:, i].max() <= GRAD_TOL / WITNESS:
            continue
        print(f"{i:3d} {path}: port vs reference {gap[0, i]:.2e}; "
              + " ".join(f"{x:.1e}" for x in ref[:, i]) + " | "
              + " ".join(f"{x:.1e}" for x in port[:, i])
              + f"; run 0 port / reference {port[0, i] / ref[0, i]:.2f}, "
              f"port / the reference's largest "
              f"{port[0, i] / ref[:, i].max():.2f}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 6)
