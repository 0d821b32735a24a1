"""The port on a CUDA card: the kernels against their plain versions (the
SpMM's pattern mode too), the loader's side-stream staging, short GCN and
SAGE fits, staging from a page-locked plan cache (bitwise, by DMA), a
world-2 mesh fit on one card against grad_accum, a GAT and
a SAGE step against the CPU, the async tier with a
resident and an out-of-core tenant against the synchronous engine, and
the LM's prefill and serving through the flash-attention kernel.

Every test is marked ``cuda`` and skips without a card. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
from repro_torch.kernels.spmm import (
    binary_tiles, csr_to_bcsr, spmm_bcsr, spmm_bcsr_ref, spmm_bcsr_sym)

# f32, TF32 off: kernel and plain version differ only in summation order
ATOL = RTOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("block", [1, 7, 16, 128])
@pytest.mark.parametrize("f", [40, 256])
def test_unfused_kernel_matches_plain_forward_and_backward(dev, block, f):
    n = 256
    a = sp.random(n, n, density=0.08, random_state=block, format="csr",
                  dtype=np.float32)
    a = (a + a.T).tocsr()
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    cols = torch.as_tensor(bc.tile_cols, device=dev)
    vals = torch.as_tensor(bc.tile_vals, device=dev)
    gen = torch.Generator(dev).manual_seed(block)
    xp = torch.randn((bc.num_cols, f), device=dev, generator=gen)
    g = torch.randn((bc.num_rows, f), device=dev, generator=gen)
    build.reset_launches()
    xt = xp.clone().requires_grad_(True)
    out = spmm_bcsr_sym(cols, vals, xt, impl="cuda_unfused")
    out.backward(g)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr_unfused"] == 2
    torch.testing.assert_close(out, spmm_bcsr_ref(cols, vals, xp),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(xt.grad, spmm_bcsr_ref(cols, vals, g),
                               atol=ATOL, rtol=RTOL)


def _spmm_case(block, f, dev, seed, n=256):
    """Random symmetric block-CSR on the card, with two more slots in every
    row tile: an all-zero tile at column tile 1 % C, and, in row tiles 0
    and 1, a nonzero tile at column tile C and -1, outside x, which the
    kernels skip. Returns the operands and the tiles the plain version
    must see (the outside slots zeroed and pointed at tile 0)."""
    a = sp.random(n, n, density=0.08, random_state=seed, format="csr",
                  dtype=np.float32)
    a = (a + a.T).tocsr()
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    k = bc.tile_cols.shape[1]
    bc = bc.with_pad_k(k + 2)
    cols, vals = bc.tile_cols.copy(), bc.tile_vals.copy()
    c = bc.num_cols // block
    cols[:, k] = 1 % c
    cols[0, k + 1], cols[1 % len(cols), k + 1] = c, -1
    vals[0, k + 1] = vals[1 % len(cols), k + 1] = 1.0
    seen_cols, seen_vals = cols.copy(), vals.copy()
    seen_cols[:2, k + 1], seen_vals[:2, k + 1] = 0, 0.0
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((bc.num_cols, f), device=dev, generator=gen)
    g = torch.randn((bc.num_rows, f), device=dev, generator=gen)
    return ([torch.as_tensor(t, device=dev) for t in (cols, vals)], x, g,
            [torch.as_tensor(t, device=dev) for t in (seen_cols, seen_vals)],
            a)


@pytest.mark.parametrize("impl", ["cuda", "cuda_unfused"])
@pytest.mark.parametrize("block", [1, 7, 16, 128])
@pytest.mark.parametrize("f", [40, 256, 300])
def test_spmm_kernels_match_plain_and_repeat_bitwise(dev, impl, block, f):
    """Forward and backward (spmm_bcsr_sym) against the plain version, with
    all-zero slots and column tiles outside x; F = 300 takes two feature
    blocks, B = 1 and 7 read the slabs without bulk copies; a second call
    gives the same bits."""
    (cols, vals), x, g, (sc, sv), _ = _spmm_case(block, f, dev, block + f)
    name = {"cuda": "spmm_bcsr", "cuda_unfused": "spmm_bcsr_unfused"}[impl]
    build.reset_launches()
    xt = x.clone().requires_grad_(True)
    out = spmm_bcsr_sym(cols, vals, xt, impl=impl)
    out.backward(g)
    again = spmm_bcsr(cols, vals, x, impl=impl)
    torch.cuda.synchronize()
    assert build.launches[name] == 3
    torch.testing.assert_close(out, spmm_bcsr_ref(sc, sv, x), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(xt.grad, spmm_bcsr_ref(sc, sv, g), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))


@pytest.mark.parametrize("impl", ["cuda", "cuda_unfused"])
@pytest.mark.parametrize("block", [7, 128])
def test_spmm_kernels_spread_nan_only_through_nonzero_entries(dev, impl,
                                                              block):
    """A NaN row of x reaches exactly the outputs of the rows whose nonzero
    entries read it; every other output matches the plain version on x
    with that row zeroed."""
    (cols, vals), x, _g, (sc, sv), a = _spmm_case(block, 40, dev, 5)
    p = int(np.flatnonzero(np.asarray(a.sum(axis=0)).ravel())[0])
    readers = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    readers[:a.shape[0]] = torch.as_tensor(a[:, p].toarray().ravel() != 0,
                                           device=dev)
    xn, xz = x.clone(), x.clone()
    xn[p], xz[p] = float("nan"), 0.0
    got = spmm_bcsr(cols, vals, xn, impl=impl)
    want = spmm_bcsr_ref(sc, sv, xz)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got).all(dim=1), readers)
    assert not bool(torch.isnan(got[~readers]).any())
    torch.testing.assert_close(got[~readers], want[~readers], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("policy", ["skip", "halt"])
def test_nonfinite_guard_trips_under_bcsr_as_under_segment_on_cpu(dev,
                                                                  policy):
    """A NaN feature in batch 1 of 3: on the card under ``backend="bcsr"``
    (the SpMM kernels multiply only nonzero entries) the trainer's guard
    halts, or skips the same steps, as the CPU's ``segment`` run does."""
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.core.batches import BatchCache
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import GNNTrainer, NonFiniteGradError
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr", tune_blocks=(16, 32)))
    train, val = pipe.plan("train"), pipe.plan("val", for_inference=True)
    fields = {k: np.array(v[:3]) for k, v in train.cache.fields.items()}
    fields["features"][1, 0, 0] = np.nan
    poisoned = BatchCache.from_fields(fields)
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                    num_layers=2, dropout=0.0)
    runs = {}
    for backend, where in (("bcsr", dev), ("segment", "cpu")):
        trainer = GNNTrainer(cfg, backend=backend, nonfinite_policy=policy,
                             device=where)
        build.reset_launches()
        if policy == "halt":
            with pytest.raises(NonFiniteGradError):
                trainer.fit(poisoned, val, ds.num_classes, epochs=1,
                            schedule_mode="none")
        else:
            res = trainer.fit(poisoned, val, ds.num_classes, epochs=2,
                              schedule_mode="none")
            assert all(np.isfinite(h["train_loss"]) for h in res.history)
        runs[backend] = (trainer.snapshot()["faults"],
                         build.launches.get("spmm_bcsr", 0))
    assert runs["bcsr"][0] == runs["segment"][0]
    assert runs["bcsr"][1] > 0 and runs["segment"][1] == 0
    if policy == "halt":
        assert runs["bcsr"][0]["halts"] == 1
    else:
        assert runs["bcsr"][0] == {"nonfinite_steps": 2, "skipped_steps": 2,
                                   "halts": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [37, 100, 128])
def test_gather_kernel_matches_plain_and_zero_fills_bad_ids(dev, dtype, f):
    gen = torch.Generator(dev).manual_seed(f)
    table = torch.randn((300, f), device=dev, generator=gen).to(dtype)
    idx = torch.randint(0, 300, (1000,), device=dev, generator=gen,
                        dtype=torch.int32)
    build.reset_launches()
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert build.launches["gather_rows"] == 1
    assert torch.equal(got, gather_rows_ref(table, idx))
    bad = idx.clone()
    bad[::7] = -1
    bad[3::7] = 300
    got = gather_rows(table, bad)
    ok = (bad >= 0) & (bad < 300)
    assert torch.equal(got[ok], gather_rows_ref(table, bad[ok]))
    assert not bool((got[~ok] != 0).any())


def test_loader_stages_on_a_side_stream(dev):
    from repro_torch.data import PrefetchLoader
    batches = [{"x": np.full((64, 32), i, np.float32)} for i in range(5)]
    out = [b["x"].sum().item() for b in PrefetchLoader(batches, device=dev)]
    assert out == [64 * 32 * i for i in range(5)]


def _same(staged, host):
    """Staged tensors bitwise the host arrays: same dtypes, shapes, bytes."""
    assert staged.keys() == host.keys()
    for k, v in host.items():
        got = staged[k].cpu().numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == np.ascontiguousarray(v).tobytes(), k


def test_a_page_locked_cache_stages_bitwise_by_dma(dev, monkeypatch):
    """The loader and the engine page-lock the plan's cache and stage it
    by DMA: every staged batch bitwise its host arrays, every staged byte
    counted as pinned, and the trace's copies ``Pinned -> Device``."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.serve.gnn_engine as engine_mod
    from repro_torch import obs
    from repro_torch.data import PrefetchLoader
    from repro_torch.device import page_locked
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.serve import GNNInferenceEngine
    ds, _train, plan = _tiny_plans()
    order = np.asarray(plan.schedule)
    obs.reset()
    obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            staged = list(PrefetchLoader(plan, device=dev))
            torch.cuda.synchronize()
        assert all(page_locked(v) for v in plan.cache.fields.values())
        for bi, got in zip(order, staged):
            _same(got, plan.cache[int(bi)])
        copies = [e.name for e in prof.events() if "Memcpy HtoD" in e.name]
        assert copies and set(copies) == {"Memcpy HtoD (Pinned -> Device)"}
        seen = []
        inner = engine_mod.stage
        monkeypatch.setattr(engine_mod, "stage", lambda host, d, span: (
            seen.append((host, inner(host, d, span))) or seen[-1][1]))
        cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32,
                        out_dim=ds.num_classes, num_layers=2, backend="bcsr")
        params = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
        eng = GNNInferenceEngine(plan, cfg, params, cache_batches=0)
        eng.query(plan.routing.node_ids)
        assert len(seen) == len(plan.cache)
        for host, got in seen:
            _same(got, host)
        for name in ("loader.stage", "engine.stage"):
            rows = [r["attrs"] for r in obs.records() if r["name"] == name]
            assert len(rows) == len(plan.cache), name
            assert all(0 < a["pinned_bytes"] == a["bytes"] for a in rows)
    finally:
        obs.disable()
        obs.reset()


def test_short_fit_launches_the_kernel_on_every_aggregation(dev):
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import GNNTrainer
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr", tune_blocks=(16, 32)))
    train, val = pipe.plan("train"), pipe.plan("val", for_inference=True)
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                    num_layers=2, dropout=0.3)
    build.reset_launches()
    res = GNNTrainer(cfg, backend="bcsr").fit(train, val, ds.num_classes,
                                              epochs=2)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr"] == \
        2 * (4 * len(train) + 2 * len(val))
    assert all(np.isfinite(h["train_loss"]) for h in res.history)


def test_world2_mesh_on_one_card_is_grad_accum_bitwise(dev):
    """A DataMesh that names the card twice: the mesh fit (dropout on, a
    ragged tail) is bitwise the single-device grad_accum=2 fit, and every
    member's SpMM runs the kernel — 6 launches per train member, pads
    included, 2 per eval member."""
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.dist.data_parallel import DataMesh
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.optim import tree_leaves
    from repro_torch.train import GNNTrainer
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr", tune_blocks=(16, 32)))
    train, val = pipe.plan("train"), pipe.plan("val", for_inference=True)
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                    num_layers=2, dropout=0.3)
    mesh = DataMesh([dev, dev])
    build.reset_launches()
    got = GNNTrainer(cfg, backend="bcsr").fit(train, val, ds.num_classes,
                                              epochs=2, mesh=mesh)
    torch.cuda.synchronize()
    members = -(-len(train) // 2) * 2
    assert build.launches["spmm_bcsr"] == \
        2 * (4 * members + 2 * -(-len(val) // 2) * 2)
    want = GNNTrainer(cfg, backend="bcsr", grad_accum=2).fit(
        train, val, ds.num_classes, epochs=2)
    for g, w in zip(got.history, want.history):
        for k in ("train_loss", "val_loss", "val_acc", "lr"):
            assert g[k] == w[k], (k, g, w)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.params),
                                                 tree_leaves(want.params)))


def test_async_tier_and_lazy_engine_on_the_card(dev, tmp_path):
    """A resident and an out-of-core tenant behind the threaded async tier
    answer bit for bit what the synchronous engine on the card answers,
    with no retry, reject or failure; the SpMM ran once per layer of every
    batch forward of every engine."""
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.ooc import OOCConfig
    from repro_torch.serve import (AsyncGNNEngine, AsyncServeConfig,
                                   GNNInferenceEngine)
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr"))
    plan = pipe.plan("test", for_inference=True)
    lazy = pipe.plan("test", for_inference=True, out_of_core=True,
                     store_dir=str(tmp_path / "store"),
                     ooc=OOCConfig(chunk_batches=1, resident_batches=1))
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                    num_layers=2, backend="bcsr")
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    engines = {"resident": GNNInferenceEngine(plan, cfg, params,
                                              cache_batches=0),
               "ooc": GNNInferenceEngine(lazy, cfg, params, cache_batches=0)}
    sync = GNNInferenceEngine(plan, cfg, params, cache_batches=0)
    rng = np.random.default_rng(0)
    ids = plan.routing.node_ids
    queries = [rng.choice(ids, 5, replace=False) for _ in range(24)]
    build.reset_launches()
    tier = AsyncGNNEngine(engines, AsyncServeConfig(window_us=200.0))
    futs = [tier.submit(("resident", "ooc")[i % 2], q)
            for i, q in enumerate(queries)]
    got = [f.result(timeout=120.0) for f in futs]
    tier.close()
    for q, g in zip(queries, got):
        assert g.tobytes() == sync.query(q).tobytes()
    torch.cuda.synchronize()
    snap = tier.snapshot()
    assert snap["completed"] == len(queries) and snap["failed"] == 0
    assert snap["rejected"] == 0 and snap["faults"]["retries"] == 0
    assert snap["tenants"]["ooc"]["ooc"]["resident"] <= 1
    runs = sum(e.stats["batch_runs"] for e in (*engines.values(), sync))
    assert build.launches["spmm_bcsr"] == cfg.num_layers * runs


# ------------------------------------------ the SpMM kernel's pattern mode
@pytest.mark.parametrize("block", [1, 7, 16, 128])
@pytest.mark.parametrize("f", [40, 256, 300])
def test_pattern_kernel_matches_plain_and_repeats_bitwise(dev, block, f):
    """``(A != 0) @ x`` forward and backward against the plain version on
    the binary tiles, with all-zero slots and column tiles outside x; a
    second call gives the same bits."""
    (cols, vals), x, g, (sc, sv), _ = _spmm_case(block, f, dev, 3 * block + f)
    bin_sv = binary_tiles(sv, torch.float32)
    build.reset_launches()
    xt = x.clone().requires_grad_(True)
    out = spmm_bcsr_sym(cols, vals, xt, pattern=True)
    out.backward(g)
    again = spmm_bcsr(cols, vals, x, pattern=True)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr_pattern"] == 3
    assert build.launches.get("spmm_bcsr", 0) == 0
    torch.testing.assert_close(out, spmm_bcsr_ref(sc, bin_sv, x), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(xt.grad, spmm_bcsr_ref(sc, bin_sv, g),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))


@pytest.mark.parametrize("block", [7, 128])
def test_pattern_kernel_nan_rules(dev, block):
    """A NaN value counts as 1; a NaN row of x reaches exactly the rows
    whose nonzero entries read it."""
    (cols, vals), x, _g, (sc, sv), a = _spmm_case(block, 40, dev, 9)
    nz = (vals != 0).nonzero()[0]
    nan_vals, one_vals = vals.clone(), vals.clone()
    nan_vals[tuple(nz)], one_vals[tuple(nz)] = float("nan"), 1.0
    got = spmm_bcsr(cols, nan_vals, x, pattern=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, spmm_bcsr(cols, one_vals, x, pattern=True))
    p = int(np.flatnonzero(np.asarray(a.sum(axis=0)).ravel())[0])
    readers = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    readers[:a.shape[0]] = torch.as_tensor(a[:, p].toarray().ravel() != 0,
                                           device=dev)
    xn, xz = x.clone(), x.clone()
    xn[p], xz[p] = float("nan"), 0.0
    got = spmm_bcsr(cols, vals, xn, pattern=True)
    want = spmm_bcsr_ref(sc, binary_tiles(sv, torch.float32), xz)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got).all(dim=1), readers)
    assert not bool(torch.isnan(got[~readers]).any())
    torch.testing.assert_close(got[~readers], want[~readers], atol=ATOL,
                               rtol=RTOL)


def _tiny_plans(backend="bcsr"):
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend=backend, tune_blocks=(16, 32)))
    return ds, pipe.plan("train"), pipe.plan("val", for_inference=True)


def test_short_sage_fit_launches_the_pattern_kernel_on_every_aggregation(
        dev):
    """Per train step: one launch per layer forward and one per layer
    backward but the first (raw features need no gradient); one per layer
    per evaluated val batch; the weighted kernel never."""
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import GNNTrainer
    ds, train, val = _tiny_plans()
    layers = 3
    cfg = GNNConfig(kind="sage", in_dim=ds.feat_dim, hidden=32,
                    out_dim=ds.num_classes, num_layers=layers, dropout=0.3)
    build.reset_launches()
    res = GNNTrainer(cfg, backend="bcsr").fit(train, val, ds.num_classes,
                                              epochs=2)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr_pattern"] == \
        2 * ((2 * layers - 1) * len(train) + layers * len(val))
    assert build.launches.get("spmm_bcsr", 0) == 0
    assert all(np.isfinite(h["train_loss"]) for h in res.history)


@pytest.mark.parametrize("kind, backend", [("gat", "bcsr"),
                                           ("sage", "bcsr")])
def test_gnn_kind_step_on_the_card_matches_cpu(dev, kind, backend):
    """One train step's loss and gradients, card against CPU, at dropout
    0, the batch staged from the page-locked cache; GAT runs the segment
    path whatever the backend and launches no SpMM."""
    from repro_torch.device import page_lock, page_locked, stage
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train import GNNTrainer
    ds, train, _val = _tiny_plans()
    cfg = GNNConfig(kind=kind, in_dim=ds.feat_dim, hidden=32,
                    out_dim=ds.num_classes, num_layers=3, heads=4,
                    dropout=0.0)
    card = GNNTrainer(cfg, backend=backend)
    params = card.init_params()
    page_lock(train.cache, dev)     # staged by DMA, as the loader stages it
    assert page_locked(train.cache[0]["tile_vals"])
    build.reset_launches()
    got_l, got_g = card._steps_for(backend, 0)["grad"](
        params, stage(train.cache[0], dev), None)
    torch.cuda.synchronize()
    launched = sum(build.launches.values())
    assert launched == (0 if kind == "gat" else 5)
    cpu = GNNTrainer(cfg, backend=backend, device="cpu")
    want_l, want_g = cpu._steps_for(backend, 0)["grad"](
        tree_map(lambda t: t.cpu(), params), stage(train.cache[0], "cpu"),
        None)
    torch.testing.assert_close(got_l.cpu(), want_l, atol=ATOL, rtol=RTOL)
    for a, b in zip(tree_leaves(got_g), tree_leaves(want_g)):
        torch.testing.assert_close(a.cpu(), b, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------- flash attention
def _bshd(gen, shape, dtype, dev):
    """(B, S, heads, D) viewed as (B, heads, S, D), as the LM passes it."""
    return torch.randn(shape, device=dev, generator=gen).to(dtype) \
        .transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 64),
                                           (True, 5000), (False, 5000)])
@pytest.mark.parametrize("s,d,g", [(200, 64, 4), (333, 128, 1),
                                   (64, 64, 8), (1, 64, 1), (63, 128, 2),
                                   (65, 64, 1), (127, 128, 4), (129, 64, 2),
                                   (4095, 64, 4), (4095, 128, 1)])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_kernel_matches_plain(dev, dtype, causal, window, s, d, g,
                                    layout):
    """Against the plain version on f32 copies of the same inputs: f32
    differs in summation order only; bf16 adds one rounding of each output
    (at most 2^-8 of its size), since the kernel accumulates in f32.
    Lengths on both sides of the 64- and 128-key tiles, a window longer
    than S, (B, S, heads, D) buffers as transposed views and contiguous
    (B, heads, S, D) tensors."""
    gen = torch.Generator(dev).manual_seed(s)
    if layout == "bshd":
        q = _bshd(gen, (2, s, 2 * g, d), dtype, dev)
        k, v = (_bshd(gen, (2, s, 2, d), dtype, dev) for _ in range(2))
    else:
        q = torch.randn((2, 2 * g, s, d), device=dev, generator=gen) \
            .to(dtype)
        k, v = (torch.randn((2, 2, s, d), device=dev, generator=gen)
                .to(dtype) for _ in range(2))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == 1
    assert got.stride() == q.stride() and got.dtype == dtype
    limit = ATOL + (2 ** -8 * want.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((got.float() - want).abs() <= limit).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 2048), (False, 64)])
@pytest.mark.parametrize("s,g", [(1, 1), (65, 10), (200, 4), (4095, 10)])
def test_flash_kernel_at_head_dim_256_matches_plain(dev, dtype, causal,
                                                    window, s, g):
    """The head-dim-256 instantiations (recurrentgemma's local layers: 10
    query heads over 1 kv head, window 2048), counted apart."""
    gen = torch.Generator(dev).manual_seed(s + g)
    q = _bshd(gen, (1, s, g, 256), dtype, dev)
    k, v = (_bshd(gen, (1, s, 1, 256), dtype, dev) for _ in range(2))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert build.launches["flash_attention_d256"] == 1
    assert build.launches.get("flash_attention", 0) == 0
    limit = ATOL + (2 ** -8 * want.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((got.float() - want).abs() <= limit).all())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-v2-lite-16b",
                                  "rwkv6-3b", "musicgen-large",
                                  "internvl2-1b"])
def test_new_archs_prefill_and_decode_on_the_card_match_cpu(dev, arch):
    """Each SMOKE config (at the kernel's head dims: recurrentgemma's at
    256, its full config's, musicgen's and internvl2's at 64) on the card
    against the CPU:
    prefill logits, then 4 decode steps. The weights are the first layers
    of a 16 times deeper stack: the reference's init draws std repeat **
    -0.5, and at a repeat of 1 or 2 the activations grow until f32 alone
    is further than 1e-4 from the exact logits."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import (
        decode_step, head_logits, init_cache, init_params, lm_forward)
    from repro_torch.models.lm.config import Stage
    from repro_torch.optim import tree_map
    cfg = get_smoke_config(arch)
    if arch == "recurrentgemma-2b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    elif arch in ("musicgen-large", "internvl2-1b"):
        cfg = dataclasses.replace(cfg, head_dim=64)
    deep = dataclasses.replace(cfg, stages=tuple(
        Stage(st.layers, 16 * st.repeat) for st in cfg.stages))
    params = init_params(deep, torch.Generator().manual_seed(2), dev)
    params["stages"] = [tree_map(lambda t, n=st.repeat: t[:n], sp)
                        for sp, st in zip(params["stages"], cfg.stages)]
    cpu = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(2)
    shape = (2, 64) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                       else ())
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape))
    prefix = None
    if cfg.vision_prefix_len:
        prefix = torch.as_tensor(rng.normal(size=(
            2, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32))
    build.reset_launches()
    with torch.no_grad():
        got = head_logits(cfg, params, lm_forward(
            cfg, params, toks.to(dev), None if prefix is None
            else prefix.to(dev))[:, -1])
        torch.cuda.synchronize()
        want = head_logits(cfg, cpu, lm_forward(cfg, cpu, toks, prefix)
                           [:, -1])
        torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)
        launches = {k: v for k, v in build.launches.items() if v}
        assert launches == ({"flash_attention_d256": 1}
                            if arch == "recurrentgemma-2b" else
                            {"flash_attention": cfg.num_layers}
                            if arch in ("musicgen-large", "internvl2-1b")
                            else {})
        caches = {d: init_cache(cfg, 2, 16, d) for d in (dev, "cpu")}
        for t in range(4):
            out = {d: decode_step(cfg, p, caches[d], toks[:, t:t + 1].to(d),
                                  t)[0] for d, p in ((dev, params),
                                                     ("cpu", cpu))}
            torch.testing.assert_close(out[dev].cpu(), out["cpu"],
                                       atol=ATOL, rtol=RTOL)


def _lm_cfg():
    """A narrow llama-like config with the kernel's head dim."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("llama3.2-1b"), d_model=256,
                               num_heads=4, num_kv_heads=2, head_dim=64)


def test_lm_prefill_launches_once_per_layer_and_matches_cpu(dev):
    from repro_torch.models.lm import head_logits, init_params, lm_forward
    from repro_torch.optim import tree_map
    cfg = _lm_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 77)), device=dev)
    build.reset_launches()
    with torch.no_grad():
        got = head_logits(cfg, params, lm_forward(cfg, params, toks)[:, -1])
        torch.cuda.synchronize()
        assert build.launches["flash_attention"] == cfg.num_layers
        cpu = tree_map(lambda t: t.cpu(), params)
        want = head_logits(cfg, cpu, lm_forward(cfg, cpu, toks.cpu())[:, -1])
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)


def test_serve_engine_on_the_card_matches_cpu_tokens(dev):
    from repro_torch.models.lm import init_params
    from repro_torch.optim import tree_map
    from repro_torch.serve import Request, ServeEngine
    cfg = _lm_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(1), dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
               for _ in range(5)]
    out = {}
    for where, p in (("cuda", params),
                     ("cpu", tree_map(lambda t: t.cpu(), params))):
        reqs = [Request(prompt=pr, max_new_tokens=4) for pr in prompts]
        stats = ServeEngine(cfg, p, num_slots=2, max_len=64,
                            device=where).run(reqs)
        assert stats["completed"] == 5
        out[where] = [r.out_tokens for r in reqs]
    assert out["cuda"] == out["cpu"]


def test_flash_kernel_refuses_bf16_strides_tma_cannot_read(dev):
    """bf16 reads through TMA: a sequence stride of 68 values (136 bytes)
    is refused with a clear error, never launched."""
    q = torch.zeros((1, 2, 16, 68), device=dev,
                    dtype=torch.bfloat16)[..., :64]
    k = v = torch.zeros((1, 2, 16, 64), device=dev, dtype=torch.bfloat16)
    build.reset_launches()
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, k, v)
    assert build.launches.get("flash_attention", 0) == 0
    assert flash_attention(q.contiguous(), k, v).shape == q.shape


def test_flash_kernel_refuses_grad(dev):
    q = torch.zeros((1, 2, 16, 64), device=dev, requires_grad=True)
    k = v = torch.zeros((1, 2, 16, 64), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


# ------------------------------------------------------------ LM training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_train_gradients_match_plain(dev, dtype, window, d):
    """``FlashAttentionTrain``: the kernel's forward (one launch) against
    ``plain_attention`` on the same inputs (f32 in summation order, bf16
    within one rounding of the output), and its backward, which
    differentiates ``plain_attention`` on the saved inputs, equal to the
    plain path's gradients."""
    from repro_torch.models.lm.attention import (
        FlashAttentionTrain, plain_attention)
    gen = torch.Generator(dev).manual_seed(d + window)
    g = 10 if d == 256 else 2
    q = torch.randn((2, 128, 2 * g, d), device=dev, generator=gen).to(dtype)
    k, v = (torch.randn((2, 128, 2, d), device=dev, generator=gen).to(dtype)
            for _ in range(2))
    cot = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    build.reset_launches()
    out = FlashAttentionTrain.apply(*ins, window, 1024)
    got = torch.autograd.grad(out, ins, cot)
    torch.cuda.synchronize()
    name = "flash_attention_d256" if d == 256 else "flash_attention"
    assert {k_: n for k_, n in build.launches.items() if n} == {name: 1}
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = plain_attention(*ref_ins, window)
    want = torch.autograd.grad(plain, ref_ins, cot)
    f32 = plain_attention(*(t.float() for t in (q, k, v)), window)
    limit = ATOL + (2 ** -8 * f32.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((out.float() - f32).abs() <= limit).all())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_lm_train_step_on_the_card_matches_cpu(dev):
    """``lm_loss`` and every gradient leaf of a narrow llama-like config
    (head dim 64, f32) with remat, card against CPU: two flash launches
    per layer (the forward and the backward's recompute). The weights are
    the first layers of a 16 times deeper stack, as above. Where card and
    CPU part by more than 1e-4 of a leaf's largest entry, the CPU's
    float64 gradient is the witness, leaf by leaf (``_f64.witness_ok``):
    the CPU's f32 must lie farther than 2.5e-5 from it (the largest over
    its runs at these and at nudged parameters) and the card's within 4x
    as far."""
    import dataclasses
    from _f64 import N_NUDGED, nudged, port_f64, witness_misses
    from repro_torch.launch.train import grads_only, synthetic_batch
    from repro_torch.models.lm import init_params
    from repro_torch.models.lm.config import Stage
    from repro_torch.optim import tree_leaves, tree_map
    cfg = _lm_cfg()
    deep = dataclasses.replace(cfg, stages=tuple(
        Stage(st.layers, 16 * st.repeat) for st in cfg.stages))
    params = init_params(deep, torch.Generator().manual_seed(3), dev)
    params["stages"] = [tree_map(lambda t, n=st.repeat: t[:n].clone(), sp)
                        for sp, st in zip(params["stages"], cfg.stages)]
    cpu = tree_map(lambda t: t.cpu(), params)
    build.reset_launches()
    grads, loss = grads_only(cfg, params,
                             synthetic_batch(cfg, 2, 64, 0, dev))
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == 2 * cfg.num_layers
    batch = synthetic_batch(cfg, 2, 64, 0, "cpu")
    want_g, want = grads_only(cfg, cpu, batch)
    with port_f64():
        g64, _ = grads_only(cfg, tree_map(lambda t: t.double(), cpu), batch)
    torch.testing.assert_close(loss.cpu(), want, atol=ATOL, rtol=RTOL)

    def more():
        for i in range(N_NUDGED):
            rng = np.random.default_rng(100 + i)
            moved = tree_map(lambda t: nudged(t, rng), cpu)
            r32, _ = grads_only(cfg, moved, batch)
            with port_f64():
                r64, _ = grads_only(cfg, tree_map(lambda t: t.double(),
                                                  moved), batch)
            yield tree_leaves(r32), tree_leaves(r64)
    misses, _ = witness_misses(tree_leaves(grads), tree_leaves(want_g),
                               tree_leaves(g64), tol=ATOL, more=more)
    assert not misses, misses
