"""``build_tiles``: a batch's block-CSR tiles made from its COO edges and
``tile_cols``, bit for bit the ``tile_vals`` that ``csr_to_bcsr`` gives for
the same edges, on every path that makes tiles (``build_batches`` at
blocks 32, 64 and 128, ``retile_batches``, a refreshed plan's rebuilt
batches, a chunked build with ``bcsr_pad_k``, a plan loaded from npz) and
on hand-made edge cases. Staging builds them on the card in place of the
copy only where ``device._tiles_match`` (the check ``page_lock`` runs) says
so; here that check runs on the CPU, against tiles that match and tiles
that were tampered with."""
import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch.core import GraphDelta, IBMBConfig, IBMBPipeline, Plan
from repro_torch.core.autotune import retile_batches, sweep_tile_blocks
from repro_torch.core.batches import build_batches
from repro_torch.graph.csr import coo_to_csr, gcn_preprocess
from repro_torch.graph.datasets import get_dataset
from repro_torch.kernels.spmm.ops import (TILE_SOURCES, build_tiles,
                                         csr_to_bcsr)
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.gnn.models import gnn_apply, init_gnn

CPU = torch.device("cpu")
PLAN = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32, backend="bcsr", tune_blocks=(16, 32))


def _tiny():
    """The tiny graph, normalised, with three output sets and their
    one-hop neighbours as auxiliary nodes."""
    ds = get_dataset("tiny")
    g = gcn_preprocess(ds.graph)
    outs = np.array_split(np.sort(ds.splits["test"]), 3)
    aux = [np.unique(np.concatenate([g.neighbors(int(u)) for u in o]))
           for o in outs]
    return ds, g, outs, aux


def _built(ds, g, outs, aux, **kw):
    return build_batches(g, ds.features, ds.labels, outs, aux, **kw)


def _dicts(batches):
    return [b.device_arrays() for b in batches]


def _cache_dicts(plan):
    return [plan.cache[i] for i in range(len(plan.cache))]


def _build_at(block):
    return lambda _tmp: _dicts(_built(*_tiny(), bcsr_block=block))


def _retiled(_tmp):
    batches = _built(*_tiny(), bcsr_block=32)
    _costs, kmax = sweep_tile_blocks(batches, [64])
    return _dicts(retile_batches(batches, 64, kmax[64]))


def _chunked(_tmp):
    ds, g, outs, aux = _tiny()
    whole = _built(ds, g, outs, aux, bcsr_block=32)
    pad_k = whole[0].tile_cols.shape[1] + 2
    caps = dict(max_nodes=whole[0].node_ids.shape[0],
                max_edges=whole[0].edge_src.shape[0],
                max_outputs=whole[0].output_idx.shape[0])
    return [d for lo, hi in ((0, 1), (1, 3))
            for d in _dicts(_built(ds, g, outs[lo:hi], aux[lo:hi],
                                   bcsr_block=32, bcsr_pad_k=pad_k,
                                   **caps))]


def _refreshed(_tmp):
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(**PLAN))
    plan = pipe.plan("test", for_inference=True)
    test = ds.splits["test"]
    u = int(test[0])
    v = next(int(t) for t in test[1:]
             if not np.isin(t, ds.graph.neighbors(u)))
    nb = ds.graph.neighbors(u)
    child, audit = pipe.refresh(plan, GraphDelta(
        edge_inserts=np.array([[u, v]]),
        edge_deletes=np.array([[u, int(nb[0])]])))
    assert len(audit.rebuilt)
    return _cache_dicts(child)


def _from_npz(tmp):
    plan = IBMBPipeline(get_dataset("tiny"), IBMBConfig(**PLAN)).plan(
        "test", for_inference=True)
    plan.save(str(tmp / "plan.npz"))
    return _cache_dicts(Plan.load(str(tmp / "plan.npz")))


def _coo(src, dst, w, n, block, pad_k=None, pad_edges=3):
    """One batch from COO edges as ``retile_batches`` makes its tiles,
    with ``pad_edges`` padded edges (node 0 to node 0, weight 0)."""
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    nz = w != 0
    sub = coo_to_csr(src[nz], dst[nz], n, weights=w[nz])
    bc = csr_to_bcsr(sub.indptr, sub.indices, sub.weights, n, n,
                     block=block, pad_k=pad_k)
    pad = np.zeros(pad_edges, np.int32)
    return dict(edge_src=np.concatenate([src, pad]),
                edge_dst=np.concatenate([dst, pad]),
                edge_weight=np.concatenate([w, pad.astype(np.float32)]),
                tile_cols=bc.tile_cols, tile_vals=bc.tile_vals)


def _hand(_tmp):
    rng = np.random.default_rng(3)
    return [
        # a -0.0 weight and an explicit +0.0, both dropped
        _coo([0, 1, 5, 9], [1, 0, 9, 5], [0.5, 0.5, -0.0, 0.0], 16, 8),
        # row tile 1 of 3 empty, row tile 2 with column tile 0 as its
        # first real tile
        _coo([0, 20, 21, 3], [3, 1, 18, 0], [1.0, 2.0, 3.0, 1.0], 24, 8),
        # K padded past the real tiles; a NaN and an Inf weight
        _coo([0, 0, 7, 15], [15, 7, 0, 0], [np.nan, 1.5, np.inf, 2.0], 16,
             4, pad_k=4),
        # the same entry twice (summed), and a row tile with every slot
        _coo([2, 2, 1, 1, 1, 1], [3, 3, 0, 4, 8, 12],
             [0.25, 0.5, 1.0, 1.0, 1.0, 1.0], 16, 4),
        # no edges at all
        _coo([], [], [], 8, 4, pad_k=2),
        # random weights at block 1 and at a block that does not divide
        _coo(rng.integers(0, 12, 40), rng.integers(0, 12, 40),
             rng.standard_normal(40), 12, 1),
        _coo(rng.integers(0, 30, 90), rng.integers(0, 30, 90),
             rng.standard_normal(90), 30, 7, pad_k=6),
    ]


CASES = {"build-b32": _build_at(32), "build-b64": _build_at(64),
         "build-b128": _build_at(128), "retile": _retiled,
         "refresh": _refreshed, "chunked-pad-k": _chunked,
         "npz": _from_npz, "hand-made": _hand}


def _build(batch):
    t = {k: torch.from_numpy(np.asarray(batch[k]))
         for k in TILE_SOURCES[1:]}
    return build_tiles(t["edge_src"], t["edge_dst"], t["edge_weight"],
                       t["tile_cols"], batch["tile_vals"].shape[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_built_tiles_are_the_converter_s_bit_for_bit(case, tmp_path):
    batches = CASES[case](tmp_path)
    assert batches
    for i, b in enumerate(batches):
        want = np.ascontiguousarray(b["tile_vals"])
        got = _build(b)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert tuple(got.shape) == want.shape, (case, i)
        assert got.numpy().view(np.int32).tobytes() == \
            want.view(np.int32).tobytes(), (case, i)
        assert devmod._tiles_match(b, CPU), (case, i)


def _tamper(batch, how):
    b = {k: np.array(v) for k, v in batch.items()}
    vals, cols = b["tile_vals"], b["tile_cols"]
    r, k = np.argwhere(np.abs(vals).sum(axis=(2, 3)) > 0)[0]
    if how == "value":
        i, j = np.argwhere(vals[r, k] != 0)[0]
        vals[r, k, i, j] = np.nextafter(vals[r, k, i, j], np.float32(9))
    elif how == "negative-zero":
        i, j = np.argwhere(vals[r, k] == 0)[0]
        vals[r, k, i, j] = -0.0
    elif how == "nan":
        i, j = np.argwhere(vals[r, k] != 0)[0]
        vals[r, k, i, j] = np.nan
    elif how == "column":
        cols[r, k] = (cols[r, k] + 1) % cols.shape[0]
    elif how == "edge-weight":
        e = int(np.argmax(b["edge_weight"] != 0))
        b["edge_weight"][e] *= 2
    return b


@pytest.mark.parametrize("how", ["value", "negative-zero", "nan",
                                 "column", "edge-weight"])
def test_the_check_rejects_tiles_that_disagree_with_the_edges(how):
    plan = IBMBPipeline(get_dataset("tiny"), IBMBConfig(**PLAN)).plan(
        "test", for_inference=True)
    batch = plan.cache[0]
    assert devmod._tiles_match(batch, CPU)
    bad = _tamper(batch, how)
    assert not devmod._tiles_match(bad, CPU)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_the_forward_on_built_tiles_is_the_forward_on_copied_ones(kind):
    ds = get_dataset("tiny")
    plan = IBMBPipeline(ds, IBMBConfig(**PLAN)).plan("test",
                                                     for_inference=True)
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=16, out_dim=ds.num_classes,
                    num_layers=2, kind=kind, backend="bcsr")
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    for i in range(len(plan.cache)):
        copied = {k: torch.from_numpy(np.array(v))
                  for k, v in plan.cache[i].items()}
        built = dict(copied, tile_vals=_build(plan.cache[i]))
        want = gnn_apply(cfg, params, copied)
        got = gnn_apply(cfg, params, built)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_entries_with_no_slot_or_outside_the_nodes_are_dropped():
    """Edges that the tiles do not hold (a node past R * B, a negative id,
    a column tile with no real slot in its row tile) are dropped, never
    written out of bounds, so a check of such tiles fails cleanly."""
    b = _coo([0, 3], [3, 0], [1.0, 2.0], 8, 4, pad_k=3)
    want = b["tile_vals"]
    extra = dict(b, edge_src=np.array([0, 3, 8, -1, 0, 4], np.int32),
                 edge_dst=np.array([3, 0, 0, 0, 9, 4], np.int32),
                 edge_weight=np.array([1, 2, 5, 5, 5, 5], np.float32))
    got = _build(extra)
    # row tile 1 (nodes 4-7) has no real slot for column tile 1
    assert tuple(got.shape) == (2, 3, 4, 4)
    assert got.numpy().tobytes() == want.tobytes()
