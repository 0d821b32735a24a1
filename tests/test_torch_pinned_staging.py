"""Page-locking a plan's batch cache in place (``device.page_lock``) with
the CUDA runtime stood in by a fake that records its calls: each field is
registered once, a repeat is a no-op, a refusal leaves the pageable path,
what is not a resident in-memory cache on a CUDA device is never
registered, releasing the cache unregisters every field, and the staging
spans' ``pinned_bytes`` never exceed their ``bytes``. The lock then
checks each batch's tiles against the tiles built from its edges
(``stage.tile_check``, here on the CPU): a batch that matches is staged to
a card with its tiles built there (``stage_nbytes``' ``built_bytes``), a tampered one keeps
the copy, the checked fields turn read-only and releasing the cache
forgets its batches. The copies and the build themselves run on the card
(the ``cuda`` tests at the end, and ``tests/test_torch_cuda.py``)."""
import gc
import mmap

import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch import obs
from repro_torch.core import BatchCache, IBMBConfig, IBMBPipeline
from repro_torch.data import PrefetchLoader
from repro_torch.device import (copy_batch, page_lock, page_locked,
                                stage_nbytes)
from repro_torch.dist.data_parallel import stack_batches
from repro_torch.graph.datasets import get_dataset
from repro_torch.kernels.spmm.ops import TILE_SOURCES
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.gnn.models import init_gnn
from repro_torch.ooc import OOCConfig
from repro_torch.serve import GNNInferenceEngine, GNNRequest

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
PLAN = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32, backend="bcsr", tune_blocks=(16, 32))


class FakeCudart:
    """``torch.cuda.cudart()``'s registration calls, recorded; ``refuse``
    makes every registration fail as the driver would (a nonzero code)."""

    def __init__(self, refuse=False):
        self.refuse = refuse
        self.registered, self.unregistered = [], []
        self.errors_cleared = 0

    def cudaHostRegister(self, ptr, nbytes, flags):
        self.registered.append((ptr, nbytes, flags))
        return 2 if self.refuse else 0

    def cudaHostUnregister(self, ptr):
        self.unregistered.append(ptr)
        return 0

    def cudaGetLastError(self):
        self.errors_cleared += 1
        return 0


@pytest.fixture
def fake(monkeypatch):
    rt = FakeCudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: rt)
    # no card to compare on: the lock's check of the tiles runs on the CPU
    check = devmod._check_tiles
    monkeypatch.setattr(devmod, "_check_tiles",
                        lambda cache, _dev, keys: check(cache, CPU, keys))
    obs.disable()
    obs.reset()
    yield rt
    gc.collect()                 # release this test's caches under the fake
    obs.disable()
    obs.reset()
    assert devmod._ranges == {}
    assert devmod._check_counts == {} and devmod._checked == frozenset()


def _cache(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return BatchCache.from_fields({
        "x": rng.standard_normal((n, 40, 8)).astype(np.float32),
        "idx": rng.integers(0, 40, (n, 64)).astype(np.int32),
        "mask": rng.random((n, 40)) < 0.5})


def _addr(a):
    return a.__array_interface__["data"][0]


def _nbytes(batch):
    return sum(v.nbytes for v in batch.values())


def _pinned(batch, device):
    return stage_nbytes(batch, device)["pinned_bytes"]


def _built(batch, device):
    return stage_nbytes(batch, device)["built_bytes"]


def test_each_field_is_registered_once_and_a_repeat_is_a_no_op(fake):
    cache = _cache()
    assert page_lock(cache, CUDA) == cache.nbytes()
    assert sorted(fake.registered) == sorted(
        (_addr(a), a.nbytes, 1) for a in cache.fields.values())
    assert page_lock(cache, CUDA) == 0
    assert len(fake.registered) == len(cache.fields)
    tot = obs.totals()["stage.page_lock"]
    assert tot["count"] == 1 and tot["bytes"] == cache.nbytes()
    assert tot["seconds"] >= 0


def test_every_batch_of_a_registered_cache_is_page_locked(fake):
    cache = _cache()
    other = _cache(seed=1)
    page_lock(cache, CUDA)
    for i in range(len(cache)):
        b = cache[i]
        assert all(page_locked(v) for v in b.values())
        assert _pinned(b, CUDA) == _nbytes(b)
        assert _pinned(b, torch.device("cpu")) == 0
        assert _pinned(other[i], CUDA) == 0
    assert not page_locked(cache.fields["x"].copy())


def test_a_refusal_leaves_the_pageable_path(fake):
    fake.refuse = True
    cache = _cache()
    assert page_lock(cache, CUDA) == 0
    assert len(fake.registered) == len(cache.fields)
    assert fake.errors_cleared == len(cache.fields)
    assert not any(page_locked(v) for v in cache.fields.values())
    assert _pinned(cache[0], CUDA) == 0
    # once per cache: a refused cache is not tried again
    assert page_lock(cache, CUDA) == 0
    assert len(fake.registered) == len(cache.fields)
    del cache
    gc.collect()
    assert fake.unregistered == []


def _memmap_cache(tmp_path):
    fields = {}
    for k, v in _cache().fields.items():
        np.save(tmp_path / f"{k}.npy", v)
        fields[k] = np.load(tmp_path / f"{k}.npy", mmap_mode="r")
    return BatchCache.from_fields(fields)


def test_memmaps_are_never_registered(fake, tmp_path):
    assert page_lock(_memmap_cache(tmp_path), CUDA) == 0
    buf = mmap.mmap(-1, 4096)
    mapped = np.frombuffer(buf, np.float32).reshape(4, 256)
    mixed = BatchCache.from_fields({"m": mapped, "x": _cache().fields["x"]})
    assert page_lock(mixed, CUDA) == mixed.fields["x"].nbytes
    assert [r[0] for r in fake.registered] == [_addr(mixed.fields["x"])]
    del mixed, mapped
    gc.collect()
    buf.close()


def test_a_lazy_cache_and_the_cpu_are_never_registered(fake, tmp_path):
    ds = get_dataset("tiny")
    lazy = IBMBPipeline(ds, IBMBConfig(**PLAN)).plan(
        "test", for_inference=True, out_of_core=True,
        store_dir=str(tmp_path / "store"),
        ooc=OOCConfig(chunk_batches=1, resident_batches=1))
    assert page_lock(lazy.cache, CUDA) == 0
    assert page_lock(_cache(), torch.device("cpu")) == 0
    assert page_lock([dict(x=np.ones(3))], CUDA) == 0
    plan = IBMBPipeline(ds, IBMBConfig(**PLAN)).plan("test",
                                                     for_inference=True)
    list(PrefetchLoader(plan, device="cpu"))
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=16, out_dim=ds.num_classes,
                    num_layers=2)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    for p in (plan, lazy):
        eng = GNNInferenceEngine(p, cfg, params, backend="bcsr",
                                 device="cpu")
        eng.query(plan.routing.node_ids[:5])
    assert fake.registered == []
    assert obs.totals().get("stage.page_lock") is None


def test_releasing_the_cache_unregisters_every_field(fake):
    cache = _cache()
    page_lock(cache, CUDA)
    addrs = sorted(_addr(a) for a in cache.fields.values())
    del cache
    gc.collect()
    assert sorted(fake.unregistered) == addrs
    assert devmod._spans == ()


def test_caches_sharing_a_field_hold_it_until_both_are_released(fake):
    a = _cache()
    b = BatchCache.from_fields({"x": a.fields["x"],
                                "y": np.arange(12, dtype=np.int64)})
    page_lock(a, CUDA)
    assert page_lock(b, CUDA) == b.fields["y"].nbytes
    assert len(fake.registered) == len(a.fields) + 1
    x = _addr(a.fields["x"])
    del a
    gc.collect()
    assert x not in fake.unregistered and page_locked(b.fields["x"])
    del b
    gc.collect()
    assert fake.unregistered.count(x) == 1


def test_a_range_inside_a_registered_one_is_not_registered_again(fake):
    a = _cache()
    page_lock(a, CUDA)
    view = BatchCache.from_fields({"x": a.fields["x"][1:3]})
    assert page_lock(view, CUDA) == 0
    assert len(fake.registered) == len(a.fields)
    assert page_locked(view[0]["x"])


def test_the_loader_and_the_engine_lock_the_cache_they_stage(monkeypatch):
    """Who calls ``page_lock``: the loader on its cache (a Plan's, or the
    cache handed in) and the engine on its plan's cache at construction
    and on a swap, each with its resolved device."""
    import repro_torch.data.loader as loader_mod
    import repro_torch.serve.gnn_engine as engine_mod
    calls = []
    spy = lambda cache, device: calls.append((cache, device)) or 0
    monkeypatch.setattr(loader_mod, "page_lock", spy)
    monkeypatch.setattr(engine_mod, "page_lock", spy)
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(**PLAN))
    plan = pipe.plan("test", for_inference=True)
    cpu = torch.device("cpu")
    PrefetchLoader(plan, device="cpu")
    PrefetchLoader(plan.cache, device="cpu")
    assert calls == [(plan.cache, cpu), (plan.cache, cpu)]
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=16, out_dim=ds.num_classes,
                    num_layers=2)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls.clear()
    eng = GNNInferenceEngine(plan, cfg, params, backend="bcsr", device="cpu")
    swapped = pipe.plan("test", for_inference=True)
    eng.swap(swapped)
    assert calls == [(plan.cache, cpu), (swapped.cache, cpu)]


def test_staging_spans_count_pinned_bytes_within_bytes(fake):
    ds = get_dataset("tiny")
    plan = IBMBPipeline(ds, IBMBConfig(**PLAN)).plan("test",
                                                     for_inference=True)
    page_lock(plan.cache, CUDA)       # registered, but staged to the CPU
    obs.enable()
    n = len(list(PrefetchLoader(plan, device="cpu")))
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=16, out_dim=ds.num_classes,
                    num_layers=2)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = GNNInferenceEngine(plan, cfg, params, backend="bcsr",
                             cache_batches=0, device="cpu")
    ids = np.asarray(plan.routing.node_ids)
    eng.run([GNNRequest(ids[i:i + 9]) for i in range(0, len(ids), 9)])
    rows = obs.records()
    for name, count in (("loader.stage", n),
                        ("engine.stage", len(plan.cache))):
        got = [r["attrs"] for r in rows if r["name"] == name]
        assert len(got) == count, name
        for a in got:
            assert 0 == a["pinned_bytes"] <= a["bytes"], (name, a)
    del eng, plan


def test_copy_batch_counts_what_it_copies_on_its_span(fake):
    cache = _plan().cache
    page_lock(cache, CUDA)             # checked, but staged to the CPU
    b = cache[0]
    with obs.span("stage.probe") as s:
        got = copy_batch(b, "cpu", span=s)
    assert s.counts == stage_nbytes(b, CPU) == dict(
        bytes=_nbytes(b), pinned_bytes=0, built_bytes=0)
    assert stage_nbytes(b, CUDA) == dict(
        bytes=_nbytes(b) - b["tile_vals"].nbytes,
        pinned_bytes=_nbytes(b) - b["tile_vals"].nbytes,
        built_bytes=b["tile_vals"].nbytes)
    for k, v in b.items():
        assert got[k].numpy().tobytes() == v.tobytes()


def test_copy_batch_issues_the_largest_copy_first(monkeypatch):
    """Copies go out largest first, the staged dict keeps the batch's
    order, and the tensors are the host arrays."""
    issued = []
    inner = devmod.to_tensor

    def spy(a, device=None):
        issued.append(a.nbytes)
        return inner(a, device)

    monkeypatch.setattr(devmod, "to_tensor", spy)
    batch = _cache()[1]
    got = devmod.copy_batch(batch, "cpu")
    assert list(got) == list(batch)
    assert issued == sorted((v.nbytes for v in batch.values()), reverse=True)
    for k, v in batch.items():
        assert got[k].numpy().tobytes() == v.tobytes()


# ------------------------------------------------- tiles built from edges
def _plan():
    return IBMBPipeline(get_dataset("tiny"), IBMBConfig(**PLAN)).plan(
        "test", for_inference=True)


def _tampered(cache, bi=1):
    """A copy of ``cache`` with one entry of batch ``bi``'s tiles moved."""
    fields = {k: np.array(v) for k, v in cache.fields.items()}
    vals = fields["tile_vals"][bi]
    r, k, i, j = np.argwhere(vals != 0)[0]
    vals[r, k, i, j] *= 2
    return BatchCache.from_fields(fields)


def test_the_lock_checks_every_batch_s_tiles_and_stages_them_built(fake):
    plan = _plan()
    cache = plan.cache
    assert page_lock(cache, CUDA) == cache.nbytes()
    tot = obs.totals()
    assert tot["stage.page_lock"]["bytes"] == cache.nbytes()
    check = tot["stage.tile_check"]
    tiles = cache.fields["tile_vals"]
    assert (check["count"], check["checked"], check["mismatched"],
            check["bytes"]) == (1, len(cache), 0, tiles.nbytes)
    for i in range(len(cache)):
        b = cache[i]
        built = _built(b, CUDA)
        assert built == b["tile_vals"].nbytes > 0
        assert stage_nbytes(b, CUDA)["bytes"] == _nbytes(b) - built
        assert _pinned(b, CUDA) == _nbytes(b) - built
        assert _built(b, CPU) == 0
        assert _pinned(b, CPU) == 0
    # what is not a checked view of the cache copies its tiles
    assert _built(stack_batches(cache, np.array([0, 1])), CUDA) == 0
    assert _built({k: v.copy() for k, v in cache[0].items()},
                        CUDA) == 0
    assert _built({k: v[:2] for k, v in cache.fields.items()},
                        CUDA) == 0
    got = copy_batch(cache[0], "cpu")
    assert got["tile_vals"].numpy().tobytes() == cache[0][
        "tile_vals"].tobytes()


def test_a_tampered_batch_keeps_the_copy(fake):
    cache = _tampered(_plan().cache, bi=1)
    page_lock(cache, CUDA)
    check = obs.totals()["stage.tile_check"]
    assert (check["checked"], check["mismatched"]) == (len(cache), 1)
    built = [_built(cache[i], CUDA) for i in range(len(cache))]
    assert built[1] == 0 and all(b > 0 for i, b in enumerate(built)
                                 if i != 1)
    b = cache[1]
    assert _pinned(b, CUDA) == _nbytes(b)


def test_releasing_the_cache_forgets_its_checked_batches(fake):
    cache = _plan().cache
    page_lock(cache, CUDA)
    assert len(devmod._checked) == len(cache)
    del cache
    gc.collect()
    assert devmod._checked == frozenset() and devmod._check_counts == {}


def test_caches_sharing_checked_batches_check_them_once(fake):
    a = _plan().cache
    b = BatchCache.from_fields(dict(a.fields))
    page_lock(a, CUDA)
    page_lock(b, CUDA)
    assert obs.totals()["stage.tile_check"]["checked"] == len(a)
    assert set(devmod._check_counts.values()) == {2}
    del a
    gc.collect()
    assert all(_built(b[i], CUDA) > 0 for i in range(len(b)))
    del b


@pytest.mark.parametrize("field", TILE_SOURCES)
def test_a_checked_cache_s_tile_and_edge_fields_are_read_only(fake, field):
    cache = _plan().cache
    page_lock(cache, CUDA)
    with pytest.raises(ValueError, match="read-only"):
        cache.fields[field][0].flat[0] = 0
    cache.fields["features"][0, 0, 0] += 0      # the rest stay writeable


def test_a_check_out_of_card_memory_skips_the_rest_with_a_warning(
        fake, monkeypatch):
    cache = _plan().cache
    match = devmod._tiles_match
    calls = []

    def short_of_memory(batch, device):
        calls.append(device)
        if len(calls) > 1:
            raise torch.cuda.OutOfMemoryError("no room to compare")
        return match(batch, device)

    monkeypatch.setattr(devmod, "_tiles_match", short_of_memory)
    with pytest.warns(RuntimeWarning, match="out of card memory"):
        page_lock(cache, CUDA)
    assert len(calls) == 2 < len(cache)
    check = obs.totals()["stage.tile_check"]
    assert (check["checked"], check["mismatched"], check["skipped"]) == \
        (1, 0, len(cache) - 1)
    built = [_built(cache[i], CUDA) for i in range(len(cache))]
    assert built[0] > 0 and not any(built[1:])


def test_a_cache_without_tiles_is_not_checked(fake):
    plan = IBMBPipeline(get_dataset("tiny"), IBMBConfig(
        **dict(PLAN, backend="segment"))).plan("test", for_inference=True)
    assert "tile_vals" not in plan.cache.fields
    page_lock(plan.cache, CUDA)
    assert "stage.tile_check" not in obs.totals()
    assert _built(plan.cache[0], CUDA) == 0


# ------------------------------------------------------------- on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    obs.reset()
    obs.enable()
    yield CUDA
    obs.disable()
    obs.reset()


def _same(staged, host):
    assert staged.keys() == host.keys()
    for k, v in host.items():
        got = staged[k].cpu().numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == np.ascontiguousarray(v).tobytes(), k


def _stage_rows(name):
    return [r["attrs"] for r in obs.records() if r["name"] == name]


@pytest.mark.cuda
def test_built_tiles_stage_bitwise_today_s_copy_on_the_card(dev,
                                                           monkeypatch):
    """Through the loader and the engine a checked cache stages every
    field bitwise its host array, its tiles built; ``bytes`` are the
    copies, all page-locked, and ``built_bytes`` the tiles."""
    import repro_torch.serve.gnn_engine as engine_mod
    ds = get_dataset("tiny")
    plan = _plan()
    staged = list(PrefetchLoader(plan, device=dev))
    torch.cuda.synchronize()
    for bi, got in zip(np.asarray(plan.schedule), staged):
        _same(got, plan.cache[int(bi)])
    seen = []
    inner = engine_mod.stage
    monkeypatch.setattr(engine_mod, "stage", lambda host, d, span: (
        seen.append((host, inner(host, d, span))) or seen[-1][1]))
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                    num_layers=2, backend="bcsr")
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    eng = GNNInferenceEngine(plan, cfg, params, cache_batches=0)
    eng.query(plan.routing.node_ids)
    assert len(seen) == len(plan.cache)
    for host, got in seen:
        _same(got, host)
    tiles = plan.cache.fields["tile_vals"][0].nbytes
    for name in ("loader.stage", "engine.stage"):
        rows = _stage_rows(name)
        assert len(rows) == len(plan.cache), name
        for a in rows:
            assert a["built_bytes"] == tiles, (name, a)
            assert 0 < a["pinned_bytes"] == a["bytes"], (name, a)
        assert sum(a["bytes"] + a["built_bytes"] for a in rows) == \
            plan.cache.nbytes()
    assert obs.totals()["stage.tile_check"]["mismatched"] == 0


@pytest.mark.cuda
def test_a_tampered_tile_is_copied_and_the_rest_built_on_the_card(dev):
    cache = _tampered(_plan().cache, bi=1)
    staged = list(PrefetchLoader(cache, device=dev))
    torch.cuda.synchronize()
    for i, got in enumerate(staged):
        _same(got, cache[i])
    built = {a["batch"]: a["built_bytes"] for a in _stage_rows(
        "loader.stage")}
    assert built[1] == 0 and all(built[i] > 0 for i in built if i != 1)
    assert obs.totals()["stage.tile_check"]["mismatched"] == 1


@pytest.mark.cuda
def test_releasing_a_checked_cache_clears_its_batches_on_the_card(dev):
    cache = _plan().cache
    before = set(devmod._checked)
    page_lock(cache, dev)
    assert len(devmod._checked - before) == len(cache)
    with pytest.raises(ValueError, match="read-only"):
        cache.fields["edge_weight"][0, 0] = 1.0
    del cache
    gc.collect()
    assert devmod._checked == before
