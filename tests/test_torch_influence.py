"""The port's exact influence (``repro_torch.core.influence``) against the
JAX package's, and the reference's Theorem 1 check on the port.

The same randomly initialized 3-layer GCN (the reference's weights, carried
by ``params_from_jax``) runs a full-graph forward over the tiny dataset's
normalized adjacency with segment aggregation, as
``tests/test_influence.py:_full_graph_apply`` does. The port's Jacobian
(``torch.func.jacrev``) must give each node's influence within 1e-5 of
the largest influence of JAX's (``jax.jacobian``; f32 on the CPU, sums in
other orders), and PPR must rank nodes like the port's influence (mean
Spearman correlation above 0.5, the reference's threshold)."""
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.influence import exact_influence as jax_exact_influence
from repro.core.influence import expected_influence_rw as jax_expected
from repro.core.ppr import dense_ppr as jax_dense_ppr
from repro.graph.datasets import get_dataset as jax_get_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.gnn import ops as jax_ops
from repro_torch.convert import params_from_jax
from repro_torch.core.influence import (
    exact_influence, expected_influence_rw)
from repro_torch.core.ppr import dense_ppr
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import ops

REL = 1e-5
NODES = [3, 50, 111]


def _edges(ds):
    m = ds.norm_graph.to_scipy().tocoo()
    return (np.asarray(m.row, np.int32), np.asarray(m.col, np.int32),
            np.asarray(m.data, np.float32))


def _jax_apply(params, ds, num_layers):
    src, dst, w = _edges(ds)

    def apply_fn(feats):
        h = feats
        for l, p in enumerate(params["layers"]):
            h = jax_ops.weighted_agg(h @ p["w"], src, dst, w) + p["b"]
            if l < num_layers - 1:
                h = jax.nn.relu(h)
        return h

    return apply_fn


def _port_apply(params, ds, num_layers, device="cpu"):
    src, dst, w = (torch.as_tensor(a, device=device) for a in _edges(ds))

    def apply_fn(feats):
        h = feats
        for l, p in enumerate(params["layers"]):
            h = ops.weighted_agg(h @ p["w"], src, dst, w) + p["b"]
            if l < num_layers - 1:
                h = torch.relu(h)
        return h

    return apply_fn


def _spearman(a, b):
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


@pytest.fixture(scope="module")
def gcn():
    jds, ds = jax_get_dataset("tiny"), get_dataset("tiny")
    cfg = JaxGNNConfig(kind="gcn", in_dim=ds.feat_dim, hidden=32,
                       out_dim=ds.num_classes, num_layers=3, dropout=0.0)
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_init_gnn(cfg, jax.random.PRNGKey(0)))
    return dict(jds=jds, ds=ds, cfg=cfg, jparams=jparams,
                params=params_from_jax(jparams, "cpu"))


@pytest.mark.parametrize("u", NODES)
def test_exact_influence_matches_jax(gcn, u):
    ds, jds, n = gcn["ds"], gcn["jds"], gcn["cfg"].num_layers
    want = jax_exact_influence(_jax_apply(gcn["jparams"], jds, n),
                               jds.features, u)
    with warnings.catch_warnings():
        # a vmap without a batching rule warns and loops in Python
        warnings.simplefilter("error")
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        try:
            got = exact_influence(_port_apply(gcn["params"], ds, n),
                                  ds.features, u, device="cpu")
        finally:
            torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert got.shape == want.shape == (ds.num_nodes,)
    assert got.dtype == np.float32
    assert (got > 0).sum() >= 5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * float(np.abs(want).max()))
    np.testing.assert_array_equal(got > 0, want > 0)


def test_ppr_approximates_the_port_s_influence(gcn):
    """Theorem 1 (tests/test_influence.py:44-60) on the port."""
    ds, n = gcn["ds"], gcn["cfg"].num_layers
    ppr = dense_ppr(ds.graph, alpha=0.25)
    np.testing.assert_array_equal(ppr, jax_dense_ppr(gcn["jds"].graph,
                                                     alpha=0.25))
    apply_fn = _port_apply(gcn["params"], ds, n)
    cors = []
    for u in NODES:
        inf = exact_influence(apply_fn, ds.features, u, device="cpu")
        nz = inf > 0
        if nz.sum() < 5:
            continue
        cors.append(_spearman(inf[nz], ppr[u][nz]))
    assert len(cors) == len(NODES)
    assert np.mean(cors) > 0.5, f"PPR should rank like influence, got {cors}"


@pytest.mark.parametrize("layers,alpha", [(3, 0.0), (10, 0.2), (2, 0.5)])
def test_expected_influence_rw_equals_the_reference(layers, alpha):
    ds = get_dataset("tiny")
    a = ds.graph.to_scipy()
    deg = np.asarray(a.sum(1)).ravel()
    p = (sp.diags(1.0 / np.maximum(deg, 1)) @ a).toarray()
    got = expected_influence_rw(p, num_layers=layers, alpha=alpha)
    np.testing.assert_array_equal(got, jax_expected(p, layers, alpha))
    if alpha == 0:
        assert np.allclose(got, np.linalg.matrix_power(p, layers),
                           atol=1e-8)
    else:
        assert (got.sum(1) <= 1.0 + 1e-6).all()


def test_exact_influence_defaults_to_the_card():
    if torch.cuda.is_available():
        got = exact_influence(lambda x: x * 2.0, np.ones((3, 2)), 1)
        np.testing.assert_array_equal(got, [0.0, 4.0, 0.0])
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        exact_influence(lambda x: x, np.ones((3, 2)), 0)


def test_influence_is_not_an_eager_import_of_core():
    root = os.path.join(os.path.dirname(__file__), "..")
    probe = ("import sys, repro_torch.core; "
             "print('repro_torch.core.influence' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH="src"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
