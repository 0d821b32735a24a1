"""The port's GNNInferenceEngine against the JAX engine on the same tiny
test plan: the same queries give the same logits and the same counters."""
import jax
import numpy as np
import pytest

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.serve import GNNInferenceEngine as JaxEngine
from repro.serve import GNNRequest as JaxRequest
from repro_torch.convert import params_from_jax
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.serve import GNNInferenceEngine, GNNRequest

# f32 on both sides; the aggregation sums run in another order, and nothing
# on the CPU uses TF32
ATOL = RTOL = 1e-4
COUNTERS = ("requests", "nodes", "batch_runs", "lru_hits", "evictions")


# the autotuner's default decides bcsr on this dense little graph; kappa 0
# makes it decide segment, which is what it decides on arxiv-like
@pytest.fixture(scope="module", params=[16.0, 0.0],
                ids=["kappa16-bcsr", "kappa0-segment"])
def setup(request):
    kw = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
              pad_multiple=32, backend="bcsr", tune_blocks=(16, 32),
              auto_kappa=request.param)
    ref = JaxPipeline(jax_dataset("tiny"), JaxConfig(**kw)).plan(
        "test", for_inference=True)
    port = IBMBPipeline(get_dataset("tiny"), IBMBConfig(**kw)).plan(
        "test", for_inference=True)
    assert set(port.batch_backends()) == \
        {"bcsr" if request.param else "segment"}
    ds = jax_dataset("tiny")
    mkw = dict(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
               num_layers=2, dropout=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_gnn(JaxGNNConfig(**mkw), jax.random.PRNGKey(0)))
    return ref, port, mkw, params


def _engines(setup, backend, cache_batches):
    ref, port, mkw, params = setup
    je = JaxEngine(ref, JaxGNNConfig(**mkw), params, backend=backend,
                   cache_batches=cache_batches)
    te = GNNInferenceEngine(port, GNNConfig(**mkw),
                            params_from_jax(params, "cpu"), backend=backend,
                            cache_batches=cache_batches, device="cpu")
    return je, te


def _same_counters(je, te):
    assert {k: te.stats[k] for k in COUNTERS} == \
        {k: je.stats[k] for k in COUNTERS}
    assert te.stats["versions"] == je.stats["versions"]


@pytest.mark.parametrize("backend", ["bcsr", "auto"])
@pytest.mark.parametrize("cache_batches", [0, 2])
def test_query_matches_jax(setup, backend, cache_batches):
    je, te = _engines(setup, backend, cache_batches)
    ids = setup[0].routing.node_ids
    rng = np.random.default_rng(0)
    for q in [ids, ids[::-1], rng.choice(ids, 7, replace=False), ids[:0]]:
        np.testing.assert_allclose(te.query(q), je.query(q), atol=ATOL,
                                   rtol=RTOL)
    _same_counters(je, te)


@pytest.mark.parametrize("backend", ["bcsr", "auto"])
def test_coalesced_run_matches_jax(setup, backend):
    je, te = _engines(setup, backend, 2)
    ids = setup[0].routing.node_ids
    rng = np.random.default_rng(1)
    burst = [rng.choice(ids, 5, replace=False) for _ in range(12)]
    burst += [ids[:0], np.array([10 ** 9])]          # empty, uncovered
    jr = [JaxRequest(node_ids=q) for q in burst]
    tr = [GNNRequest(node_ids=q) for q in burst]
    je.run(jr)
    out = te.run(tr)
    assert out["requests"] == len(burst)
    for a, b in zip(jr, tr):
        assert (b.done, b.error is None) == (a.done, a.error is None)
        if a.done:
            np.testing.assert_allclose(b.logits, a.logits, atol=ATOL,
                                       rtol=RTOL)
    _same_counters(je, te)
    assert te.stats["batch_runs"] <= len(setup[1])   # each batch once


def test_engine_refuses_mesh(setup):
    """Mesh serving is ported (tests/test_torch_data_parallel.py); a mesh
    without a data axis is refused with the reference's error."""
    from repro_torch.dist.data_parallel import DataMesh
    _ref, port, mkw, params = setup
    with pytest.raises(ValueError, match="has no data axis"):
        GNNInferenceEngine(port, GNNConfig(**mkw),
                           params_from_jax(params, "cpu"),
                           mesh=DataMesh(["cpu"], ("model",)))


def test_query_raises_on_uncovered_ids(setup):
    _je, te = _engines(setup, "bcsr", 0)
    with pytest.raises(KeyError):
        te.query([10 ** 9])
