"""The port's data-parallel ``GNNTrainer.fit(mesh=...)`` against the
port's own ``grad_accum`` fit and the JAX package's, the fit cases of
``tests/test_data_parallel.py``.

On CPU meshes (``DataMesh(["cpu"] * w)`` and a 2×2 ``("pod", "data")``
mesh, the port's counterpart of the reference's emulated host devices) a
mesh fit is bitwise the port's ``grad_accum = world`` fit — the weighted
mean is ``GradAccumulator``'s sum and division, operation for operation —
history and parameters alike, with dropout on or off, and within ATOL =
RTOL = 1e-4 of the JAX package's ``grad_accum = world`` fit (f32 on the
CPU, sums in other orders; the reference holds that fit to its own mesh
fit within 1e-5). JAX parity runs at dropout 0: the port's dropout masks
cannot match JAX's bits. Every fit starts from the reference's initial
parameters, carried by ``params_from_jax``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.dist import data_parallel as jdp
from repro.graph.datasets import get_dataset as jax_get_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.train import GNNTrainer as JaxTrainer
from repro_torch.convert import params_from_jax
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.dist.data_parallel import DataMesh
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import tree_leaves
from repro_torch.train import GNNTrainer
from repro_torch.train import gnn_trainer as trainer_mod
from repro_torch.train.gnn_trainer import step_generator

ATOL = RTOL = 1e-4
# the reference's _pipe settings (tests/test_data_parallel.py:32-38)
PIPE = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32)
EPOCHS = 2


@pytest.fixture(scope="module")
def env():
    jds, ds = jax_get_dataset("tiny"), get_dataset("tiny")

    def port(**kw):
        p = IBMBPipeline(ds, IBMBConfig(**PIPE, **kw))
        return p.plan("train"), p.plan("val", for_inference=True)

    jp = JaxPipeline(jds, JaxConfig(**PIPE))
    e = dict(ds=ds, segment={"port": port(), "jax": (
                 jp.plan("train"), jp.plan("val", for_inference=True))},
             bcsr={"port": port(backend="bcsr", tune_blocks=(16, 32))},
             # every batch's auto decision pinned to bcsr at block_f 0
             # (the reference's _bcsr_pins)
             pinned={"port": port(backend="bcsr", autotune=True,
                                  auto_kappa=1e9, tune_block_fs=())},
             kw=dict(kind="gcn", in_dim=ds.feat_dim, hidden=32,
                     out_dim=ds.num_classes, num_layers=2))
    assert len(e["segment"]["port"][0]) % 4 != 0, "want a ragged tail"
    return e


def _cfg(env, dropout=0.3, **kw):
    return GNNConfig(**env["kw"], dropout=dropout, **kw)


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _jax_init(env):
    return jax.tree_util.tree_map(np.asarray, jax_init_gnn(
        JaxGNNConfig(**env["kw"], dropout=0.0),
        jax.random.fold_in(jax.random.PRNGKey(0), 0)))


@pytest.fixture(scope="module")
def jax_fits(env):
    """The JAX package's fits at dropout 0 on the segment plans: with
    grad_accum = w for w in 1, 2, 4, and on a 1-device mesh."""
    jtr, jva = env["segment"]["jax"]
    cfg = JaxGNNConfig(**env["kw"], dropout=0.0)
    out = {w: JaxTrainer(cfg, lr=1e-3, seed=0, grad_accum=w).fit(
        jtr, jva, env["ds"].num_classes, epochs=EPOCHS) for w in (1, 2, 4)}
    out["mesh1"] = JaxTrainer(cfg, lr=1e-3, seed=0).fit(
        jtr, jva, env["ds"].num_classes, epochs=EPOCHS,
        mesh=jdp.data_mesh(1))
    return out


def _port_fit(env, monkeypatch, plans="segment", dropout=0.0, mesh=None,
              **trainer_kw):
    """The port's fit from the reference's initial parameters."""
    init = _jax_init(env)
    monkeypatch.setattr(trainer_mod, "init_gnn",
                        lambda cfg, gen, device=None:
                        params_from_jax(init, device))
    tr, va = env[plans]["port"]
    return GNNTrainer(_cfg(env, dropout=dropout), lr=1e-3, seed=0,
                      device="cpu", **trainer_kw).fit(
        tr, va, env["ds"].num_classes, epochs=EPOCHS, mesh=mesh)


def _assert_bitwise(got, want):
    assert len(got.history) == len(want.history) == EPOCHS
    for g, w in zip(got.history, want.history):
        for k in ("epoch", "train_loss", "val_loss", "val_acc", "lr"):
            assert g[k] == w[k], (k, g, w)
    assert (got.best_epoch, got.best_val_acc) == \
        (want.best_epoch, want.best_val_acc)
    assert _same_params(got.params, want.params)


def _assert_close_to_jax(got, ref):
    for g, r in zip(got.history, ref.history):
        for k in ("train_loss", "val_loss", "val_acc", "lr"):
            _close(g[k], r[k])
    for lg, lr in zip(got.params["layers"], ref.params["layers"]):
        for k in lr:
            _close(lg[k], lr[k])


MESHES = {"w1": (DataMesh(["cpu"]), 1), "w2": (DataMesh(["cpu"] * 2), 2),
          "w4": (DataMesh(["cpu"] * 4), 4),
          "pod2x2": (DataMesh([["cpu"] * 2] * 2, ("pod", "data")), 4)}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_fit_is_grad_accum_bitwise_and_matches_jax(
        env, jax_fits, monkeypatch, name):
    mesh, world = MESHES[name]
    got = _port_fit(env, monkeypatch, mesh=mesh)
    want = _port_fit(env, monkeypatch, grad_accum=world)
    _assert_bitwise(got, want)
    _assert_close_to_jax(got, jax_fits[world])
    if world == 1:                           # the reference's own mesh fit
        _assert_close_to_jax(got, jax_fits["mesh1"])


@pytest.mark.parametrize("plans", ["segment", "bcsr"])
def test_mesh_fit_with_dropout_is_grad_accum_bitwise(env, monkeypatch,
                                                     plans):
    """Dropout on, a ragged tail: member j of super-step si draws the mask
    of global step si*world+j, as the grad_accum loop's step counter."""
    got = _port_fit(env, monkeypatch, plans=plans, dropout=0.3,
                    mesh=MESHES["w4"][0], backend=plans)
    want = _port_fit(env, monkeypatch, plans=plans, dropout=0.3,
                     grad_accum=4, backend=plans)
    _assert_bitwise(got, want)


def test_mesh_fit_generators_follow_the_step_counter(env, monkeypatch):
    seen = []

    def spy(seed, epoch, step, device):
        seen.append((epoch, step))
        return step_generator(seed, epoch, step, device)

    monkeypatch.setattr(trainer_mod, "step_generator", spy)
    _port_fit(env, monkeypatch, dropout=0.3, mesh=MESHES["w4"][0])
    n = len(env["segment"]["port"][0])
    per_epoch = -(-n // 4) * 4                # pads draw a generator too
    assert seen == [(ep, st) for ep in range(EPOCHS)
                    for st in range(per_epoch)]


def test_mesh_auto_is_forced_bcsr_bitwise(env, monkeypatch):
    """With every decision pinned to bcsr at block_f 0, backend='auto'
    through the mesh is bitwise the forced bcsr mesh run (the reference's
    test_mesh_auto_matches_forced_bcsr)."""
    tr = env["pinned"]["port"][0]
    assert tr.batch_backends() == ["bcsr"] * len(tr)
    mesh = MESHES["w4"][0]
    got = _port_fit(env, monkeypatch, plans="pinned", dropout=0.3,
                    mesh=mesh, backend="auto")
    want = _port_fit(env, monkeypatch, plans="pinned", dropout=0.3,
                     mesh=mesh, backend="bcsr")
    _assert_bitwise(got, want)
