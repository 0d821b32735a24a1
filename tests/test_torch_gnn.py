"""The port's GCN forward against the JAX package's, on one tiny bcsr batch,
with the reference's parameters carried over by ``params_from_jax``."""
import jax
import numpy as np
import pytest
import torch

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import gnn_apply as jax_gnn_apply
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.gnn.models import output_logits as jax_output_logits
from repro_torch.convert import params_from_jax
from repro_torch.device import stage
from repro_torch.models.gnn import GNNConfig, gnn_apply, init_gnn
from repro_torch.models.gnn.models import output_logits

# f32 on both sides; the aggregation sums run in another order, and nothing
# on the CPU uses TF32
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    ds = get_dataset("tiny")
    plan = JaxPipeline(ds, JaxConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr", tune_blocks=(16, 32))).plan(
            "test", for_inference=True)
    kw = dict(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
              num_layers=2, dropout=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_gnn(JaxGNNConfig(**kw), jax.random.PRNGKey(0)))
    return plan.cache[0], kw, params


@pytest.mark.parametrize("order", ["transform_first", "agg_first"])
@pytest.mark.parametrize("backend", ["segment", "bcsr", "dense"])
def test_gnn_apply_matches_jax(setup, backend, order, monkeypatch):
    batch, kw, params = setup
    monkeypatch.setenv("REPRO_GCN_AGG_ORDER", order)
    want = jax_output_logits(
        jax_gnn_apply(JaxGNNConfig(backend=backend, **kw), params, batch),
        batch)
    tb = stage(batch, "cpu")
    got = output_logits(gnn_apply(GNNConfig(backend=backend, **kw),
                                  params_from_jax(params, "cpu"), tb), tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_params_from_jax_keeps_the_layout(setup):
    _batch, _kw, params = setup
    port = params_from_jax(params, "cpu")
    for lj, lp in zip(params["layers"], port["layers"]):
        assert sorted(lj) == sorted(lp)
        for k in lj:
            assert tuple(lp[k].shape) == lj[k].shape   # w is (d_in, d_out)
            assert np.array_equal(lp[k].numpy(), lj[k])
    h = np.random.default_rng(0).normal(
        size=(3, params["layers"][0]["w"].shape[0])).astype(np.float32)
    np.testing.assert_allclose(
        (torch.from_numpy(h) @ port["layers"][0]["w"]).numpy(),
        h @ params["layers"][0]["w"], atol=ATOL, rtol=RTOL)


def test_init_gnn_shapes_and_glorot_limits(setup):
    _batch, kw, params = setup
    port = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0),
                    device="cpu")
    again = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0),
                     device="cpu")
    for lj, lp, la in zip(params["layers"], port["layers"], again["layers"]):
        assert {k: tuple(v.shape) for k, v in lp.items()} == \
            {k: v.shape for k, v in lj.items()}
        d_in, d_out = lj["w"].shape
        lim = np.sqrt(6.0 / (d_in + d_out))
        assert float(lp["w"].abs().max()) <= lim
        assert torch.equal(lp["w"], la["w"])
        assert not lp["b"].any()


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_sage_and_gat_wait_for_their_slice(setup, kind):
    """Their slice has landed: both kinds initialise with the reference's
    layer keys and shapes and run a forward on a bcsr batch
    (``tests/test_torch_gnn_kinds.py`` holds them to JAX)."""
    batch, kw, _params = setup
    cfg = GNNConfig(**dict(kw, kind=kind, backend="bcsr"))
    ref = jax_init_gnn(JaxGNNConfig(**dict(kw, kind=kind)),
                       jax.random.PRNGKey(0))
    port = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    for lj, lp in zip(ref["layers"], port["layers"]):
        assert {k: tuple(v.shape) for k, v in lp.items()} == \
            {k: tuple(v.shape) for k, v in lj.items()}
    tb = stage(batch, "cpu")
    out = gnn_apply(cfg, port, tb)
    assert tuple(out.shape) == (tb["features"].shape[0], kw["out_dim"])
    assert bool(torch.isfinite(out).all())
