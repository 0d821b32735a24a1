"""The port's GCN training against the JAX package's, on the ``tiny``
dataset (hidden 32, 2 layers), with the reference's parameters carried over
by ``params_from_jax``.

Both sides run f32 on the CPU: JAX aggregates bcsr batches with its
``impl="stream"`` path, the port with its plain streaming version, and
segment batches with XLA's scatter-add and ``index_add_``. The sums run in
other orders, so losses and gradients differ by a few ulps; the stated
tolerance is ATOL = RTOL = 1e-4 everywhere in this file, including the
3-epoch ``fit`` histories (Adam at lr 1e-3 does not amplify a few ulps past
it in three epochs of this size)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_get_dataset
from repro.graph.sampling import NeighborSampling as JaxNeighborSampling
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.gnn.models import masked_accuracy as jax_masked_accuracy
from repro.models.gnn.models import masked_xent as jax_masked_xent
from repro.train import gnn_trainer as jax_trainer_mod
from repro.train.gnn_trainer import GNNTrainer as JaxTrainer
from repro_torch.convert import params_from_jax
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import stage
from repro_torch.graph.datasets import get_dataset
from repro_torch.graph.sampling import NeighborSampling, make_batcher
from repro_torch.models.gnn import GNNConfig, gnn_apply
from repro_torch.models.gnn.models import masked_accuracy, masked_xent
from repro_torch.models.gnn.ops import dropout
from repro_torch.optim import tree_leaves
from repro_torch.train import GNNTrainer, NonFiniteGradError, step_rng
from repro_torch.train import gnn_trainer as trainer_mod

ATOL = RTOL = 1e-4

PLAN = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32, backend="bcsr", tune_blocks=(16, 32))


@pytest.fixture(scope="module")
def plans():
    jds, ds = jax_get_dataset("tiny"), get_dataset("tiny")
    jpipe, pipe = JaxPipeline(jds, JaxConfig(**PLAN)), \
        IBMBPipeline(ds, IBMBConfig(**PLAN))
    return dict(
        ds=ds, jds=jds,
        jax=(jpipe.plan("train"), jpipe.plan("val", for_inference=True)),
        port=(pipe.plan("train"), pipe.plan("val", for_inference=True)),
        kw=dict(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                num_layers=2, dropout=0.0))


def _jax_params(kw, key):
    return jax.tree_util.tree_map(np.asarray,
                                  jax_init_gnn(JaxGNNConfig(**kw), key))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("backend", ["segment", "bcsr"])
@pytest.mark.parametrize("bi", [0, 3])
def test_train_step_loss_and_grads_match_jax(plans, backend, bi):
    kw = plans["kw"]
    params = _jax_params(kw, jax.random.PRNGKey(bi))
    jtr, ttr = plans["jax"][0], plans["port"][0]
    # the reference's own loss_fn (gnn_trainer.py:144-147) under value_and_grad
    jl, jg = JaxTrainer(JaxGNNConfig(**kw), backend=backend)._steps_for(
        backend, 0)["grad"](params, jtr.cache[bi], jax.random.PRNGKey(1))
    tl, tg = GNNTrainer(GNNConfig(**kw), backend=backend, device="cpu") \
        ._steps_for(backend, 0)["grad"](params_from_jax(params, "cpu"),
                                        stage(ttr.cache[bi], "cpu"),
                                        torch.Generator())
    _close(tl, jl)
    for lj, lp in zip(jg["layers"], tg["layers"]):
        assert sorted(lj) == sorted(lp)
        for k in lj:
            _close(lp[k], lj[k])


def _fit_both(plans, backend, monkeypatch, epochs=3, train=None,
              jax_train=None, **trainer_kw):
    kw = plans["kw"]
    # the reference initialises from fold_in(PRNGKey(seed), 0); the port's
    # init is replaced by those same parameters, and nothing else
    params = _jax_params(kw, jax.random.fold_in(jax.random.PRNGKey(0), 0))
    monkeypatch.setattr(trainer_mod, "init_gnn",
                        lambda cfg, gen, device=None:
                        params_from_jax(params, device))
    jtr, jva = plans["jax"]
    ttr, tva = plans["port"]
    ref = JaxTrainer(JaxGNNConfig(**kw), backend=backend, **trainer_kw).fit(
        jax_train or jtr, jva, plans["ds"].num_classes, epochs=epochs,
        schedule_mode="tsp")
    port = GNNTrainer(GNNConfig(**kw), backend=backend, device="cpu",
                      **trainer_kw).fit(
        train or ttr, tva, plans["ds"].num_classes, epochs=epochs,
        schedule_mode="tsp")
    return ref, port


@pytest.mark.parametrize("backend", ["segment", "bcsr"])
def test_fit_history_matches_jax(plans, backend, monkeypatch):
    ref, port = _fit_both(plans, backend, monkeypatch)
    assert len(port.history) == len(ref.history) == 3
    for r, p in zip(ref.history, port.history):
        for key in ("train_loss", "val_loss", "val_acc", "lr"):
            _close(p[key], r[key])
    assert port.best_epoch == ref.best_epoch
    _close(port.best_val_acc, ref.best_val_acc)
    for lj, lp in zip(ref.params["layers"], port.params["layers"]):
        for k in lj:
            _close(lp[k], lj[k])


def test_fit_with_grad_accum_matches_jax(plans, monkeypatch):
    ref, port = _fit_both(plans, "bcsr", monkeypatch, epochs=2,
                          grad_accum=3)
    for r, p in zip(ref.history, port.history):
        for key in ("train_loss", "val_loss", "val_acc"):
            _close(p[key], r[key])


def test_fit_from_a_resampling_batcher_matches_jax(plans, monkeypatch):
    ns = dict(num_batches=4, fanouts=(3, 3), seed=0)
    port_b = NeighborSampling(plans["ds"], "train", **ns)
    jax_b = JaxNeighborSampling(plans["jds"], "train", **ns)
    pb, jb = port_b.epoch_batches(1), jax_b.epoch_batches(1)
    for p, j in zip(pb, jb):                      # numpy copies: identical
        for k, v in p.device_arrays().items():
            assert np.array_equal(v, j.device_arrays()[k])
    ref, port = _fit_both(plans, "segment", monkeypatch, epochs=2,
                          train=port_b, jax_train=jax_b)
    for r, p in zip(ref.history, port.history):
        for key in ("train_loss", "val_loss", "val_acc"):
            _close(p[key], r[key])


def test_bcsr_with_a_resampling_batcher_is_refused(plans):
    batcher = make_batcher("neighbor_sampling", plans["ds"], "train",
                           num_batches=2)
    with pytest.raises(ValueError, match="neighbor_sampling"):
        GNNTrainer(GNNConfig(**plans["kw"]), backend="bcsr",
                   device="cpu").fit(batcher, plans["port"][1],
                                     plans["ds"].num_classes, epochs=1)


def test_evaluate_matches_jax(plans):
    kw = plans["kw"]
    params = _jax_params(kw, jax.random.PRNGKey(5))
    want = JaxTrainer(JaxGNNConfig(**kw), backend="bcsr").evaluate(
        params, plans["jax"][1])
    got = GNNTrainer(GNNConfig(**kw), backend="bcsr", device="cpu").evaluate(
        params_from_jax(params, "cpu"), plans["port"][1])
    _close(got["loss"], want["loss"])
    _close(got["acc"], want["acc"])


def test_masked_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=12).astype(np.int32)
    mask = (rng.random(12) < 0.6).astype(np.float32)
    args = [torch.from_numpy(a) for a in (logits, labels, mask)]
    _close(masked_xent(*args), jax_masked_xent(logits, labels, mask))
    _close(masked_accuracy(*args), jax_masked_accuracy(logits, labels, mask))
    zero = torch.zeros(12)
    assert float(masked_xent(args[0], args[1], zero)) == 0.0


@pytest.mark.parametrize("policy", ["skip", "halt"])
def test_nonfinite_policy_matches_jax(plans, policy, monkeypatch):
    kw = plans["kw"]
    from repro.core.batches import BatchCache as JaxBatchCache
    from repro_torch.core.batches import BatchCache

    def poisoned(cache_cls, plan):
        fields = {k: np.array(v[:3]) for k, v in plan.cache.fields.items()}
        fields["features"][1, 0, 0] = np.nan      # batch 1 of 3
        return cache_cls.from_fields(fields)

    train_j = poisoned(JaxBatchCache, plans["jax"][0])
    train_p = poisoned(BatchCache, plans["port"][0])
    if policy == "halt":
        with pytest.raises(jax_trainer_mod.NonFiniteGradError):
            JaxTrainer(JaxGNNConfig(**kw), backend="segment",
                       nonfinite_policy="halt").fit(
                train_j, plans["jax"][1], plans["ds"].num_classes, epochs=1,
                schedule_mode="none")
        port = GNNTrainer(GNNConfig(**kw), backend="segment",
                          nonfinite_policy="halt", device="cpu")
        with pytest.raises(NonFiniteGradError):
            port.fit(train_p, plans["port"][1], plans["ds"].num_classes,
                     epochs=1, schedule_mode="none")
        assert port.snapshot()["faults"]["halts"] == 1
        return
    ref = JaxTrainer(JaxGNNConfig(**kw), backend="segment",
                     nonfinite_policy="skip")
    r = ref.fit(train_j, plans["jax"][1], plans["ds"].num_classes, epochs=2,
                schedule_mode="none")
    port = GNNTrainer(GNNConfig(**kw), backend="segment",
                      nonfinite_policy="skip", device="cpu")
    p = port.fit(train_p, plans["port"][1], plans["ds"].num_classes,
                 epochs=2, schedule_mode="none")
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot()["faults"] == {"nonfinite_steps": 2,
                                         "skipped_steps": 2, "halts": 0}
    assert all(np.isfinite(h["train_loss"]) for h in p.history)
    assert all(torch.isfinite(t).all() for t in tree_leaves(p.params))
    assert len(r.history) == len(p.history)


def test_unknown_nonfinite_policy_is_refused():
    with pytest.raises(ValueError, match="nonfinite_policy"):
        GNNTrainer(GNNConfig(), nonfinite_policy="retry", device="cpu")


# ---------------------------------------------------------------- dropout

def test_dropout_keeps_one_minus_rate_and_scales_the_kept():
    x = torch.ones((400, 250))
    y = dropout(x, 0.3, torch.Generator().manual_seed(0), False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert dropout(x, 0.3, None, True) is x
    assert dropout(x, 0.0, None, False) is x


def test_dropout_mask_is_a_function_of_epoch_and_step():
    x = torch.ones((64, 32))

    def mask(ep, step):
        g = trainer_mod.step_generator(0, ep, step, torch.device("cpu"))
        return dropout(x, 0.5, g, False) != 0

    assert torch.equal(mask(2, 3), mask(2, 3))         # same (epoch, step)
    assert not torch.equal(mask(0, 3), mask(1, 3))     # epochs differ
    assert not torch.equal(mask(1, 0), mask(1, 1))     # steps differ
    assert step_rng(0, 1, 2) == step_rng(0, 1, 2)
    assert len({step_rng(s, e, t) for s in range(2) for e in range(3)
                for t in range(3)}) == 18


def test_train_forward_drops_after_each_hidden_relu(plans):
    kw = dict(plans["kw"], dropout=0.5, num_layers=3)
    cfg = GNNConfig(**kw)
    params = params_from_jax(_jax_params(kw, jax.random.PRNGKey(0)), "cpu")
    batch = stage(plans["port"][0].cache[0], "cpu")
    plain = gnn_apply(cfg, params, batch)
    assert torch.equal(plain, gnn_apply(cfg, params, batch, train=True))
    g1 = torch.Generator().manual_seed(1)
    g2 = torch.Generator().manual_seed(1)
    a = gnn_apply(cfg, params, batch, generator=g1, train=True)
    b = gnn_apply(cfg, params, batch, generator=g2, train=True)
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    # two hidden layers each drew a mask: the generator moved twice as far
    # as one (N, hidden) draw
    g3 = torch.Generator().manual_seed(1)
    n = batch["features"].shape[0]
    torch.rand((n, kw["hidden"]), generator=g3)
    torch.rand((n, kw["hidden"]), generator=g3)
    assert torch.equal(g1.get_state(), g3.get_state())


# ------------------------------------------------------------ refusals

def test_trainer_defaults_to_cuda_and_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNNTrainer(GNNConfig())


def test_mesh_waits_for_the_data_parallel_slice(plans):
    trainer = GNNTrainer(GNNConfig(**plans["kw"]), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        trainer.fit(plans["port"][0], plans["port"][1],
                    plans["ds"].num_classes, epochs=1, mesh=object())
