"""The port's GraphSAGE and GAT against the JAX package's, on the ``tiny``
dataset: forward, one train step, 3-epoch ``fit`` histories, serving, and
the plain version of the SpMM's pattern mode that SAGE's bcsr mean runs.

Both sides run f32 on the CPU with the reference's parameters carried over
by ``params_from_jax``: JAX aggregates bcsr batches with its
``impl="stream"`` path, the port with its plain streaming version, and
segment batches with XLA's scatter-add/scatter-max and ``index_add_`` /
``scatter_reduce``. The sums run in other orders, so results differ by a
few ulps; the stated tolerance is ATOL = RTOL = 1e-4 throughout (Adam at
lr 1e-3 does not amplify a few ulps past it in three epochs of this size).
The degree SAGE divides by is a count and must match bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.configs import gnn_gat as jax_gat_cfg
from repro.configs import gnn_sage as jax_sage_cfg
from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_get_dataset
from repro.kernels.spmm import spmm_bcsr_sym as jax_spmm_bcsr_sym
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import gnn_apply as jax_gnn_apply
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.gnn import ops as jax_ops
from repro.models.gnn.models import output_logits as jax_output_logits
from repro.serve import GNNInferenceEngine as JaxEngine
from repro.train.gnn_trainer import GNNTrainer as JaxTrainer
from repro_torch.configs import gnn_gat, gnn_gcn, gnn_sage
from repro_torch.convert import params_from_jax
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import stage
from repro_torch.graph.datasets import get_dataset
from repro_torch.kernels import build
from repro_torch.kernels.spmm import (
    binary_tiles, csr_to_bcsr, spmm_bcsr, spmm_bcsr_sym)
from repro_torch.models.gnn import GNNConfig, gnn_apply, init_gnn, ops
from repro_torch.models.gnn.models import output_logits
from repro_torch.serve import GNNInferenceEngine
from repro_torch.train import GNNTrainer
from repro_torch.train import gnn_trainer as trainer_mod

ATOL = RTOL = 1e-4

PLAN = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32, backend="bcsr", tune_blocks=(16, 32))

# the SMOKE configs (2 layers, hidden 32, tiny's 16 features and 5 classes)
# and a 3-layer narrow config of each kind, at dropout 0
KINDS = {
    "sage-smoke": dict(kind="sage", hidden=32, num_layers=2),
    "sage-3layer": dict(kind="sage", hidden=24, num_layers=3),
    "gat-smoke": dict(kind="gat", hidden=32, num_layers=2, heads=4),
    "gat-3layer": dict(kind="gat", hidden=16, num_layers=3, heads=2),
}
CASES = [("sage-smoke", b) for b in ("segment", "bcsr", "dense")] + \
    [("sage-3layer", b) for b in ("segment", "bcsr", "dense")] + \
    [("gat-smoke", "segment"), ("gat-3layer", "segment")]


@pytest.fixture(scope="module")
def plans():
    jds, ds = jax_get_dataset("tiny"), get_dataset("tiny")
    jpipe, pipe = JaxPipeline(jds, JaxConfig(**PLAN)), \
        IBMBPipeline(ds, IBMBConfig(**PLAN))
    return dict(
        ds=ds,
        jax=(jpipe.plan("train"), jpipe.plan("val", for_inference=True),
             jpipe.plan("test", for_inference=True)),
        port=(pipe.plan("train"), pipe.plan("val", for_inference=True),
              pipe.plan("test", for_inference=True)))


def _kw(name, ds):
    return dict(KINDS[name], in_dim=ds.feat_dim, out_dim=ds.num_classes,
                dropout=0.0)


def _jax_params(kw, key):
    return jax.tree_util.tree_map(np.asarray,
                                  jax_init_gnn(JaxGNNConfig(**kw), key))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


# ----------------------------------------------------------------- configs

def test_configs_keep_the_reference_s_values():
    for port, ref in ((gnn_sage, jax_sage_cfg), (gnn_gat, jax_gat_cfg)):
        for name in ("CONFIG", "SMOKE"):
            assert vars(getattr(port, name)) == vars(getattr(ref, name))
    assert vars(gnn_gat.CONFIG_REDDIT) == vars(jax_gat_cfg.CONFIG_REDDIT)
    from repro.configs import gnn_gcn as jax_gcn_cfg
    for name in ("CONFIG", "CONFIG_REDDIT", "SMOKE"):
        assert vars(getattr(gnn_gcn, name)) == vars(getattr(jax_gcn_cfg,
                                                            name))
    assert isinstance(gnn_sage.CONFIG, GNNConfig)


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("name, backend", CASES)
@pytest.mark.parametrize("bi", [0, 2])
def test_gnn_apply_matches_jax(plans, name, backend, bi):
    kw = _kw(name, plans["ds"])
    params = _jax_params(kw, jax.random.PRNGKey(bi))
    batch = plans["jax"][2].cache[bi]
    want = jax_output_logits(jax_gnn_apply(
        JaxGNNConfig(backend=backend, **kw), params, batch), batch)
    tb = stage(plans["port"][2].cache[bi], "cpu")
    got = output_logits(gnn_apply(GNNConfig(backend=backend, **kw),
                                  params_from_jax(params, "cpu"), tb), tb)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_init_gnn_shapes_and_glorot_limits(plans, name):
    kw = _kw(name, plans["ds"])
    ref = _jax_params(kw, jax.random.PRNGKey(0))
    port = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0),
                    device="cpu")
    again = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0),
                     device="cpu")
    for lj, lp, la in zip(ref["layers"], port["layers"], again["layers"]):
        assert {k: tuple(v.shape) for k, v in lp.items()} == \
            {k: v.shape for k, v in lj.items()}
        for k, v in lp.items():
            assert torch.equal(v, la[k])
            if k in ("b", "ln_bias"):
                assert not v.any()
            elif k == "ln_scale":
                assert bool((v == 1).all())
            else:
                lim = np.sqrt(6.0 / (v.shape[0] + v.shape[-1]))
                assert 0 < float(v.abs().max()) <= lim


def test_gat_output_layer_averages_heads_and_hidden_layers_concatenate(
        plans):
    kw = dict(_kw("gat-3layer", plans["ds"]), heads=4, hidden=8)
    params = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0),
                      device="cpu")
    p = params["layers"]
    assert tuple(p[0]["a_src"].shape) == (4, 2) and p[0]["b"].shape[0] == 8
    assert tuple(p[-1]["a_src"].shape) == (4, kw["out_dim"])
    assert p[-1]["b"].shape[0] == kw["out_dim"]
    tb = stage(plans["port"][2].cache[0], "cpu")
    out = gnn_apply(GNNConfig(**kw), params, tb)
    assert tuple(out.shape) == (tb["features"].shape[0], kw["out_dim"])


def test_params_from_jax_carries_sage_and_gat_trees(plans):
    for name in ("sage-3layer", "gat-3layer"):
        ref = _jax_params(_kw(name, plans["ds"]), jax.random.PRNGKey(3))
        port = params_from_jax(ref, "cpu")
        for lj, lp in zip(ref["layers"], port["layers"]):
            assert sorted(lj) == sorted(lp)
            for k in lj:
                assert tuple(lp[k].shape) == lj[k].shape
                assert np.array_equal(lp[k].numpy(), lj[k])


def test_segment_softmax_matches_jax():
    rng = np.random.default_rng(0)
    n, e, h = 9, 40, 3
    seg = rng.integers(0, n - 2, e).astype(np.int32)   # two empty segments
    logits = rng.normal(size=(e, h)).astype(np.float32) * 4
    mask = (rng.random(e) < 0.7).astype(np.float32)
    want = np.asarray(jax_ops.segment_softmax(
        jnp.asarray(logits), jnp.asarray(seg), n, jnp.asarray(mask)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = ops.segment_softmax(lt, torch.from_numpy(seg), n,
                              torch.from_numpy(mask))
    _close(got.detach().numpy(), want)
    # per segment, the real edges' weights sum to 1 in every head
    sums = np.zeros((n, h), np.float32)
    np.add.at(sums, seg, got.detach().numpy())
    real = np.zeros(n, bool)
    real[seg[mask > 0]] = True
    _close(sums[real], np.ones((real.sum(), h)))
    # and the gradient of a weighted sum matches JAX's
    w = rng.normal(size=(e, h)).astype(np.float32)
    jg = jax.grad(lambda x: (jax_ops.segment_softmax(
        x, jnp.asarray(seg), n, jnp.asarray(mask)) * w).sum())(
            jnp.asarray(logits))
    (got * torch.from_numpy(w)).sum().backward()
    _close(lt.grad.numpy(), jg)


def test_mean_agg_matches_jax():
    rng = np.random.default_rng(1)
    n, e, f = 12, 50, 7
    h = rng.normal(size=(n, f)).astype(np.float32)
    src = rng.integers(0, n - 1, e).astype(np.int32)    # node n-1 has none
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = (rng.random(e) < 0.8).astype(np.float32)
    want = np.asarray(jax_ops.mean_agg(*(jnp.asarray(a) for a in
                                         (h, src, dst, mask))))
    got = ops.mean_agg(*(torch.from_numpy(a) for a in (h, src, dst, mask)))
    _close(got.numpy(), want)
    assert not got[n - 1].any()


# -------------------------------------------- the SpMM's pattern mode, plain

def _case(block, f, n=96, seed=0):
    a = sp.random(n, n, density=0.08, random_state=seed, format="csr",
                  dtype=np.float32)
    a = (a + a.T).tocsr()
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    x = np.random.default_rng(seed).normal(
        size=(bc.num_cols, f)).astype(np.float32)
    return a, bc, x


@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("f", [40, 128])
def test_pattern_plain_matches_jax_on_binary_tiles(block, f):
    """The plain pattern mode against the reference's formula: JAX
    ``spmm_bcsr_sym`` (``impl="stream"``) on ``(tile_vals != 0)`` tiles,
    forward and backward; the degree against ``bin_tiles.sum(axis=(1,
    3))`` bit for bit."""
    a, bc, x = _case(block, f, seed=block + f)
    bin_tiles = (bc.tile_vals != 0).astype(np.float32)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda xx: jax_spmm_bcsr_sym(
        jnp.asarray(bc.tile_cols), jnp.asarray(bin_tiles), xx, "stream",
        128), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    cols, vals = torch.from_numpy(bc.tile_cols), torch.from_numpy(
        bc.tile_vals)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = spmm_bcsr_sym(cols, vals, xt, pattern=True)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want)
    _close(xt.grad.numpy(), want_g)
    pat = (a != 0).astype(np.float32)
    _close(got.detach().numpy()[:a.shape[0]], pat @ x[:a.shape[0]])
    jdeg = np.asarray(jnp.asarray(bin_tiles).sum(axis=(1, 3)).reshape(-1))
    deg = ops.bcsr_degree(vals).numpy()
    assert deg.dtype == jdeg.dtype and deg.tobytes() == jdeg.tobytes()


@pytest.mark.parametrize("split", [0, 2])
def test_pattern_degree_on_real_batches_is_the_reference_s(plans, split):
    """Every bcsr batch of a tiny plan: the degree bit for bit, and the
    plain pattern product (both plain versions) within ATOL of the JAX
    stream path on the binary tiles, the batch's features as x."""
    fields = plans["port"][split].cache.fields
    for bi in range(len(plans["port"][split])):
        cols, vals = fields["tile_cols"][bi], fields["tile_vals"][bi]
        x = fields["features"][bi]
        bin_tiles = jnp.asarray(vals != 0, jnp.float32)
        want = np.asarray(jax_spmm_bcsr_sym(jnp.asarray(cols), bin_tiles,
                                            jnp.asarray(x), "stream", 128))
        jdeg = np.asarray(bin_tiles.sum(axis=(1, 3)).reshape(-1))
        tv = torch.from_numpy(vals)
        assert ops.bcsr_degree(tv).numpy().tobytes() == jdeg.tobytes()
        for impl in ("stream", "reference"):
            got = spmm_bcsr(torch.from_numpy(cols), tv, torch.from_numpy(x),
                            impl=impl, pattern=True)
            _close(got.numpy(), want)


def test_pattern_counts_a_nan_value_as_one():
    """``NaN != 0``: a NaN tile value is an entry of the pattern, counted
    once in the degree and taken as 1 in the product."""
    _a, bc, x = _case(16, 8, seed=7)
    vals = bc.tile_vals.copy()
    r, k, i, j = (int(v) for v in np.argwhere(vals != 0)[0])
    ones = vals.copy()
    vals[r, k, i, j], ones[r, k, i, j] = np.nan, 1.0
    cols = torch.from_numpy(bc.tile_cols)
    got = spmm_bcsr(cols, torch.from_numpy(vals), torch.from_numpy(x),
                    pattern=True)
    want = spmm_bcsr(cols, torch.from_numpy(ones), torch.from_numpy(x),
                     pattern=True)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert torch.equal(ops.bcsr_degree(torch.from_numpy(vals)),
                       ops.bcsr_degree(torch.from_numpy(ones)))
    assert torch.equal(binary_tiles(torch.from_numpy(vals), torch.float32),
                       binary_tiles(torch.from_numpy(ones), torch.float32))


def test_pattern_padding_slots_add_nothing_and_calls_repeat_bitwise():
    _a, bc, x = _case(16, 40, seed=9)
    padded = bc.with_pad_k(bc.tile_cols.shape[1] + 3)
    xt = torch.from_numpy(x)
    outs = [spmm_bcsr(torch.from_numpy(t.tile_cols),
                      torch.from_numpy(t.tile_vals), xt, pattern=True)
            for t in (bc, padded, padded)]
    _close(outs[1].numpy(), outs[0].numpy())
    assert torch.equal(outs[1].view(torch.int32), outs[2].view(torch.int32))
    assert torch.equal(ops.bcsr_degree(torch.from_numpy(bc.tile_vals)),
                       ops.bcsr_degree(torch.from_numpy(padded.tile_vals)))


def test_pattern_kernel_arithmetic_spreads_nan_only_to_readers():
    """The kernel's pattern arithmetic (the walk over nonzero entries in
    (k, j) order, each taken as 1: ``kernel_model`` on the binary tiles):
    a NaN row of x reaches exactly the rows whose entries read it, and the
    rest match the plain pattern product on x with that row zeroed."""
    from test_torch_spmm import kernel_model
    a, bc, x = _case(16, 8, seed=11)
    bc = bc.with_pad_k(bc.tile_cols.shape[1] + 2)
    n = a.shape[0]
    dense = a.toarray()
    p = int(np.flatnonzero(dense.any(axis=0))[0])
    readers = np.zeros(bc.num_rows, bool)
    readers[:n] = dense[:, p] != 0
    xn, xz = x.copy(), x.copy()
    xn[p], xz[p] = np.nan, 0.0
    cols, vals = torch.from_numpy(bc.tile_cols), torch.from_numpy(bc.tile_vals)
    got = kernel_model(cols, binary_tiles(vals, torch.float32),
                       torch.from_numpy(xn)).numpy()
    assert (np.isnan(got).all(axis=1) == readers).all()
    assert not np.isnan(got[~readers]).any()
    want = spmm_bcsr(cols, vals, torch.from_numpy(xz), pattern=True).numpy()
    _close(got[~readers], want[~readers])


def test_pattern_on_cpu_launches_nothing_and_refuses_the_unfused_kernel():
    _a, bc, x = _case(16, 8, seed=2)
    cols, vals = torch.from_numpy(bc.tile_cols), torch.from_numpy(
        bc.tile_vals)
    build.reset_launches()
    spmm_bcsr(cols, vals, torch.from_numpy(x), pattern=True)
    with pytest.raises(ValueError):               # CPU tensors
        spmm_bcsr(cols, vals, torch.from_numpy(x), impl="cuda",
                  pattern=True)
    with pytest.raises(ValueError, match="no pattern mode"):
        spmm_bcsr(cols, vals, torch.from_numpy(x), impl="cuda_unfused",
                  pattern=True)
    assert build.launches.get("spmm_bcsr_pattern", 0) == 0
    assert build.launches.get("spmm_bcsr", 0) == 0


def test_sage_bcsr_divides_by_the_degree_once_per_forward(plans,
                                                          monkeypatch):
    kw = _kw("sage-3layer", plans["ds"])
    params = params_from_jax(_jax_params(kw, jax.random.PRNGKey(0)), "cpu")
    tb = stage(plans["port"][2].cache[0], "cpu")
    calls = []
    real = ops.bcsr_degree
    monkeypatch.setattr(ops, "bcsr_degree",
                        lambda *a: calls.append(1) or real(*a))
    gnn_apply(GNNConfig(backend="bcsr", **kw), params, tb)
    assert len(calls) == 1


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("name, backend", [
    ("sage-3layer", "bcsr"), ("sage-3layer", "segment"),
    ("sage-smoke", "dense"), ("gat-3layer", "segment"),
    ("gat-smoke", "segment")])
@pytest.mark.parametrize("bi", [0, 3])
def test_train_step_loss_and_grads_match_jax(plans, name, backend, bi):
    kw = _kw(name, plans["ds"])
    params = _jax_params(kw, jax.random.PRNGKey(bi))
    # the reference's own loss_fn under value_and_grad
    jl, jg = JaxTrainer(JaxGNNConfig(**kw), backend=backend)._steps_for(
        backend, 0)["grad"](params, plans["jax"][0].cache[bi],
                            jax.random.PRNGKey(1))
    tl, tg = GNNTrainer(GNNConfig(**kw), backend=backend, device="cpu") \
        ._steps_for(backend, 0)["grad"](params_from_jax(params, "cpu"),
                                        stage(plans["port"][0].cache[bi],
                                              "cpu"),
                                        torch.Generator())
    _close(tl, jl)
    for lj, lp in zip(jg["layers"], tg["layers"]):
        assert sorted(lj) == sorted(lp)
        for k in lj:
            _close(lp[k], lj[k])


@pytest.mark.parametrize("name, backend", [("sage-3layer", "bcsr"),
                                           ("gat-3layer", "segment"),
                                           ("gat-smoke", "auto")])
def test_fit_history_matches_jax(plans, name, backend, monkeypatch):
    kw = _kw(name, plans["ds"])
    params = _jax_params(kw, jax.random.fold_in(jax.random.PRNGKey(0), 0))
    monkeypatch.setattr(trainer_mod, "init_gnn",
                        lambda cfg, gen, device=None:
                        params_from_jax(params, device))
    jtr, jva, _ = plans["jax"]
    ttr, tva, _ = plans["port"]
    n_cls = plans["ds"].num_classes
    ref = JaxTrainer(JaxGNNConfig(**kw), backend=backend).fit(
        jtr, jva, n_cls, epochs=3, schedule_mode="tsp")
    port = GNNTrainer(GNNConfig(**kw), backend=backend, device="cpu").fit(
        ttr, tva, n_cls, epochs=3, schedule_mode="tsp")
    assert len(port.history) == len(ref.history) == 3
    for r, p in zip(ref.history, port.history):
        for key in ("train_loss", "val_loss", "val_acc", "lr"):
            _close(p[key], r[key])
    assert port.best_epoch == ref.best_epoch
    for lj, lp in zip(ref.params["layers"], port.params["layers"]):
        for k in lj:
            _close(lp[k], lj[k])


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("name, backend", [("sage-3layer", "bcsr"),
                                           ("sage-smoke", "segment"),
                                           ("gat-3layer", "segment"),
                                           ("gat-smoke", "auto")])
def test_engine_query_matches_jax(plans, name, backend):
    kw = _kw(name, plans["ds"])
    params = _jax_params(kw, jax.random.PRNGKey(4))
    je = JaxEngine(plans["jax"][2], JaxGNNConfig(**kw), params,
                   backend=backend, cache_batches=2)
    te = GNNInferenceEngine(plans["port"][2], GNNConfig(**kw),
                            params_from_jax(params, "cpu"), backend=backend,
                            cache_batches=2, device="cpu")
    ids = plans["port"][2].routing.node_ids
    rng = np.random.default_rng(0)
    for q in [ids, ids[::-1], rng.choice(ids, 7, replace=False)]:
        _close(te.query(q), je.query(q))
    for k in ("requests", "nodes", "batch_runs", "lru_hits", "evictions"):
        assert te.stats[k] == je.stats[k]
    if backend == "auto" and kw["kind"] == "gat":     # no tiles: segment
        assert set(te._decisions) == {("segment", 0)}
