"""Page-locking a plan's batch cache in place (``device.page_lock``) with
the CUDA runtime stood in by a fake that records its calls: each field is
registered once, a repeat is a no-op, a refusal leaves the pageable path,
what is not a resident in-memory cache on a CUDA device is never
registered, releasing the cache unregisters every field, and the staging
spans' ``pinned_bytes`` never exceed their ``bytes``. The copies
themselves run on the card (``tests/test_torch_cuda.py``)."""
import gc
import mmap

import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch import obs
from repro_torch.core import BatchCache, IBMBConfig, IBMBPipeline
from repro_torch.data import PrefetchLoader
from repro_torch.device import (host_nbytes, page_lock, page_locked,
                                pinned_nbytes)
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.gnn.models import init_gnn
from repro_torch.ooc import OOCConfig
from repro_torch.serve import GNNInferenceEngine, GNNRequest

CUDA = torch.device("cuda")
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
    obs.disable()
    obs.reset()
    yield rt
    gc.collect()                 # release this test's caches under the fake
    obs.disable()
    obs.reset()
    assert devmod._ranges == {}


def _cache(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return BatchCache.from_fields({
        "x": rng.standard_normal((n, 40, 8)).astype(np.float32),
        "idx": rng.integers(0, 40, (n, 64)).astype(np.int32),
        "mask": rng.random((n, 40)) < 0.5})


def _addr(a):
    return a.__array_interface__["data"][0]


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
        assert pinned_nbytes(b, CUDA) == host_nbytes(b)
        assert pinned_nbytes(b, torch.device("cpu")) == 0
        assert pinned_nbytes(other[i], CUDA) == 0
    assert not page_locked(cache.fields["x"].copy())


def test_a_refusal_leaves_the_pageable_path(fake):
    fake.refuse = True
    cache = _cache()
    assert page_lock(cache, CUDA) == 0
    assert len(fake.registered) == len(cache.fields)
    assert fake.errors_cleared == len(cache.fields)
    assert not any(page_locked(v) for v in cache.fields.values())
    assert pinned_nbytes(cache[0], CUDA) == 0
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
