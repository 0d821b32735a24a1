"""The SpMM bound, the model operations and the per-layer readers, on
hand-built entries: padding, all-zero tiles and the program's block size
add nothing; the counts follow the entries; a trace that holds another
count of SpMM kernels than the window made reads nothing."""
import numpy as np
import pytest
import scipy.sparse as sp

from perfbench.harness import readers
from perfbench.harness import roofline as rf

MODEL = {"kind": "gcn", "in_dim": 8, "hidden": 16, "out_dim": 3,
         "num_layers": 3}

#: row, column of the nonzero entries of a 6-by-6 adjacency: rows 0, 1, 4
#: hold entries, columns 0, 2, 5
SRC = np.array([0, 0, 1, 4, 4])
DST = np.array([0, 5, 2, 0, 2])


def test_the_counts_of_hand_built_entries():
    t = rf.spmm_needs(SRC, DST)
    assert (t.nnz, t.rows, t.cols) == (5, 3, 3)
    f = 40
    assert rf.spmm_bytes(t, f, True) == 5 * 8 + 4 * 4 + (3 + 3) * f * 4
    assert rf.spmm_bytes(t, f, False) == 5 * 4 + 4 * 4 + (3 + 3) * f * 4
    assert rf.spmm_flops(t, f) == 2 * 5 * f
    assert rf.spmm_bound_s(t, f, True) == pytest.approx(
        rf.spmm_bytes(t, f, True) / rf.PEAK_HBM_BYTES)


def _tile_entries(bc, block):
    """(row, column) of every nonzero value the block-CSR tiles hold."""
    vals, cols = np.asarray(bc.tile_vals), np.asarray(bc.tile_cols)
    r, k, i, j = np.nonzero(vals)
    return r * block + i, cols[r, k] * block + j


@pytest.mark.parametrize("block,pad_k", [(16, None), (16, 9), (32, 5),
                                         (8, 12)])
def test_padding_zero_tiles_and_block_size_add_nothing(block, pad_k):
    """The port's own tiles at several block sizes and paddings need
    what the entries need, while the slots they store grow."""
    from repro_torch.kernels.spmm.ops import csr_to_bcsr
    n = 96
    a = sp.random(n, n, density=0.03, random_state=1, format="csr")
    a = (a + a.T).tocsr()
    a.sort_indices()
    r, c = a.nonzero()
    want = rf.spmm_needs(r, c)
    bc = csr_to_bcsr(a.indptr, a.indices, a.data.astype(np.float32), n, n,
                     block=block, pad_k=pad_k)
    assert rf.spmm_needs(*_tile_entries(bc, block)) == want
    slots = np.asarray(bc.tile_vals).size * 4
    assert rf.spmm_bytes(want, 40, True) < slots + 2 * n * 40 * 4


def test_calls_and_model_operations():
    assert rf.spmm_calls(MODEL, False) == [16, 16, 3]
    assert rf.spmm_calls(MODEL, True) == [16, 16, 3] * 2
    sage = dict(MODEL, kind="sage")
    assert rf.spmm_calls(sage, False) == [8, 16, 16]
    assert rf.spmm_calls(sage, True) == [8, 16, 16, 16, 16]
    t = rf.spmm_needs(SRC, DST)
    assert rf.batch_bound_s(t, MODEL, False) == pytest.approx(
        sum(rf.spmm_bound_s(t, f, True) for f in (16, 16, 3)))
    assert rf.batch_bound_s(t, sage, True) == pytest.approx(
        sum(rf.spmm_bound_s(t, f, False) for f in (8, 16, 16, 16, 16)))
    n, nnz = 10, 30
    dense = 2 * n * (8 * 16 + 16 * 16 + 16 * 3)
    assert rf.model_flops(MODEL, n, nnz, False) == dense + 2 * nnz * 35
    assert rf.model_flops(MODEL, n, nnz, True) == 3 * (dense + 2 * nnz * 35)
    assert rf.model_flops(sage, n, nnz, False) == 2 * dense + 2 * nnz * 40


def _ctx(traced_calls, made_calls=8):
    trace = {"window_s": 10.0, "busy_s": 8.0, "htod_s": 6.0, "spmm_s": 0.5,
             "spmm_calls": traced_calls}
    return {"trace": trace, "plan_timings": {"ppr": 1.0, "plan": 2.0},
            "spmm_calls": made_calls, "spmm_bound_s": 0.1,
            "model_flops": 6.7e12,
            "trace_complete": traced_calls == made_calls}


def test_readers_of_a_complete_trace():
    ctx = _ctx(8)
    assert readers.spmm_roofline(ctx) == pytest.approx(20.0)
    assert readers.stage_share(ctx) == pytest.approx(75.0)
    assert readers.idle_share(ctx) == pytest.approx(20.0)
    assert readers.mfu(ctx) == pytest.approx(1.0)
    assert readers.plan_build_s(ctx) == 3.0


@pytest.mark.parametrize("traced_calls", [7, 9, 16])
def test_an_incomplete_trace_reads_nothing(traced_calls):
    """Dropped events or extra launches: every metric of the trace is
    withheld, whatever the time per call says."""
    ctx = _ctx(traced_calls)
    for read in (readers.spmm_roofline, readers.stage_share,
                 readers.idle_share, readers.mfu):
        assert read(ctx) is None
    assert readers.plan_build_s(ctx) == 3.0


def test_window_costs_count_the_reference_s_batches():
    from _tiny import tiny_cell
    from perfbench.harness import data, plan_ref, runner
    cell = tiny_cell("gcn-arxiv.train")
    g = data.load_graph(cell.config["dataset"])
    batches = plan_ref.reference_batches(g, cell.config["ibmb"], "train",
                                         False)
    model = cell.config["model"]
    one = runner.window_costs(g, batches, model, True, 1)
    three = runner.window_costs(g, batches, model, True, 3)
    assert one["spmm_calls"] == 6 * len(batches)
    assert three["spmm_calls"] == 3 * one["spmm_calls"]
    assert three["spmm_bound_s"] == pytest.approx(3 * one["spmm_bound_s"])
    b = batches[0]
    src, dst, _ = plan_ref.induced_edges(g.n_indptr, g.n_indices,
                                         g.n_weights, b.nodes)
    assert len(src) > len(b.nodes)      # self loops and edges
    assert one["model_flops"] > rf.model_flops(model, len(b.nodes),
                                               len(src), True)


NO_SPMM_KIND = '''
def spmm_calls(model, train):
    return []


def forward_flops(model, real_nodes, nnz):
    return 2.0 * real_nodes * model["in_dim"] * model["out_dim"]
'''


def test_a_kind_without_spmm_calls_reads_a_complete_trace(tmp_path):
    """A kind that aggregates without the SpMM expects no ``spmm_bcsr*``
    kernel: a trace with none is complete, the SpMM's roofline reads
    nothing, the model's share of the peak and the idle share read."""
    from _tiny import tiny_cell
    from perfbench.harness import data, plan_ref, runner
    from perfbench.harness.cell import load_kind, load_reader
    kinds = tmp_path / "perfbench" / "kinds"
    kinds.mkdir(parents=True)
    (kinds / "no_spmm_kind.py").write_text(NO_SPMM_KIND)
    load_kind("no_spmm_kind", str(tmp_path))
    cell = tiny_cell("gcn-arxiv.train")
    model = dict(cell.config["model"], kind="no_spmm_kind")
    g = data.load_graph(cell.config["dataset"])
    batches = plan_ref.reference_batches(g, cell.config["ibmb"], "train",
                                         False)[:3]
    costs = runner.window_costs(g, batches, model, True, 2)
    assert costs["spmm_calls"] == 0 and costs["spmm_bound_s"] == 0
    assert costs["model_flops"] == 2 * 3 * sum(
        2.0 * len(b.nodes) * 32 * 10 for b in batches)
    trace = {"window_s": 10.0, "busy_s": 8.0, "htod_s": 6.0, "spmm_s": 0.0,
             "spmm_calls": 0}
    ctx = dict(costs, trace=trace, plan_timings={"plan": 1.0})
    assert runner.mark_complete(ctx) and ctx["trace_complete"]
    assert load_reader("spmm_roofline.train")(ctx) is None
    assert load_reader("mfu.train")(ctx) == pytest.approx(
        100.0 * costs["model_flops"] / (10.0 * rf.PEAK_F32_FLOPS))
    assert load_reader("idle_share.train")(ctx) == pytest.approx(20.0)
    assert not runner.mark_complete({"trace": None, "spmm_calls": 0})
