"""The port's out-of-core plans (``repro_torch.ooc``) against the JAX
package's ``repro.ooc``.

Streaming is host numpy on both sides, so a streamed plan must equal the
port's resident plan and the reference's streamed plan bit for bit, on the
segment and the bcsr backend, and each package must open the other's
``PlanStore``. Serving from a lazy plan on the CPU must give the resident
engine's logits bit for bit, and the JAX lazy engine's within ATOL = RTOL
= 1e-4 (f32, the port's other parity tests' tolerance). The lazy cache's
counters, the ``batch_io`` retry rules, shard routing and the store's
corruption and truncation errors must be the reference's."""
import os

import jax
import numpy as np
import pytest

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.core.plan import PlanFormatError as JaxPlanFormatError
from repro.faults import FaultInjector as JaxFaultInjector
from repro.faults import corrupt_file
from repro.graph.datasets import get_dataset as jax_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.ooc import PlanStore as JaxPlanStore
from repro.ooc import ShardRouter as JaxShardRouter
from repro.ooc import build_shards as jax_build_shards
from repro.ooc import write_store as jax_write_store
from repro.serve import GNNInferenceEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import IBMBConfig, IBMBPipeline, PlanFormatError
from repro_torch.faults import FaultInjector
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.ooc import (LazyBatchCache, OOCConfig, PlanStore,
                             PlanStoreWriter, ShardRouter, build_shards,
                             load_manifest, write_store)
from repro_torch.serve import GNNInferenceEngine

ATOL = RTOL = 1e-4
PIPE_KW = dict(variant="node", k_per_output=8, max_outputs_per_batch=64,
               pad_multiple=32)
OOC = dict(chunk_batches=2, resident_batches=4)


def _pipes(backend):
    kw = dict(PIPE_KW, backend=backend)
    return (JaxPipeline(jax_dataset("tiny"), JaxConfig(**kw)),
            IBMBPipeline(get_dataset("tiny"), IBMBConfig(**kw)))


@pytest.fixture(scope="module", params=["segment", "bcsr"])
def built(request, tmp_path_factory):
    """Per backend: the port's resident and streamed train plans, the
    reference's streamed plan, and both store directories."""
    backend = request.param
    root = tmp_path_factory.mktemp(f"torch_ooc_{backend}")
    ref_pipe, port_pipe = _pipes(backend)
    resident = port_pipe.plan("train")
    port = _pipes(backend)[1].plan("train", out_of_core=True,
                                  store_dir=str(root / "port"),
                                  ooc=OOCConfig(**OOC))
    from repro.ooc import OOCConfig as JaxOOCConfig
    ref = ref_pipe.plan("train", out_of_core=True,
                        store_dir=str(root / "ref"), ooc=JaxOOCConfig(**OOC))
    return dict(backend=backend, resident=resident, port=port, ref=ref,
                port_dir=str(root / "port"), ref_dir=str(root / "ref"))


def _model(backend):
    ds = jax_dataset("tiny")
    kw = dict(kind="gcn", in_dim=ds.feat_dim, hidden=32,
              out_dim=ds.num_classes, num_layers=2, backend=backend)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_gnn(JaxGNNConfig(**kw), jax.random.PRNGKey(0)))
    return JaxGNNConfig(**kw), GNNConfig(**kw), params


def _assert_same_lazy_plan(a, b):
    """Fingerprint, schedule, routing, membership, decisions and every
    batch field of two plans, bit for bit."""
    assert a.fingerprint == b.fingerprint
    for f in ("node_ids", "batch", "row"):
        assert np.array_equal(getattr(a.routing, f), getattr(b.routing, f))
    for f in ("schedule", "node_ids", "batch_backend", "batch_block_f"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert len(a.cache) == len(b.cache)
    assert a.cache.meta == b.cache.meta
    assert sorted(a.cache.fields) == sorted(b.cache.fields)
    for k, v in b.cache.fields.items():
        got = np.asarray(a.cache.fields[k])
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == np.asarray(v).tobytes(), k
    for i in range(len(b.cache)):
        x, y = a.cache[i], b.cache[i]
        assert sorted(x) == sorted(y)
        assert all(x[k].tobytes() == y[k].tobytes() for k in y), i


# ------------------------------------------------------- streamed == resident
def test_stream_requires_store_dir():
    with pytest.raises(ValueError, match="store_dir"):
        _pipes("segment")[1].plan("train", out_of_core=True)


def test_stream_equals_resident(built):
    port, res = built["port"], built["resident"]
    assert isinstance(port.cache, LazyBatchCache)
    _assert_same_lazy_plan(port, res)
    assert port.meta["out_of_core"] is True
    for f in ("roots", "indices", "values"):
        assert np.array_equal(getattr(port.ppr, f), getattr(res.ppr, f))


def test_stream_equals_reference_stream(built):
    port, ref = built["port"], built["ref"]
    _assert_same_lazy_plan(port, ref)
    assert port.meta == ref.meta
    hp, hr = (PlanStore.open(built["port_dir"]).header,
              JaxPlanStore.open(built["ref_dir"]).header)
    # wall-clock timings are the only field allowed to differ
    assert {k: v for k, v in hp.items() if k != "timings"} == \
        {k: v for k, v in hr.items() if k != "timings"}
    with np.load(os.path.join(built["port_dir"], "index.npz")) as a, \
            np.load(os.path.join(built["ref_dir"], "index.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in b.files)
    for f in sorted(os.listdir(os.path.join(built["ref_dir"], "fields"))):
        with open(os.path.join(built["port_dir"], "fields", f), "rb") as x, \
                open(os.path.join(built["ref_dir"], "fields", f), "rb") as y:
            assert x.read() == y.read(), f


def test_each_package_opens_the_other_s_store(built):
    port_in_ref = JaxPlanStore.open(built["port_dir"]).as_plan(2)
    ref_in_port = PlanStore.open(built["ref_dir"]).as_plan(2)
    _assert_same_lazy_plan(ref_in_port, built["resident"])
    _assert_same_lazy_plan(port_in_ref, built["resident"])


# ------------------------------------------------------------- lazy serving
def test_lazy_engine_logits(built):
    """The lazy plan serves the resident engine's logits bit for bit on
    the CPU, and the JAX lazy engine's within ATOL."""
    backend = built["backend"]
    jcfg, tcfg, params = _model(backend)
    q = np.random.default_rng(0).permutation(
        jax_dataset("tiny").splits["train"])
    tparams = params_from_jax(params, "cpu")
    want = GNNInferenceEngine(built["resident"], tcfg, tparams,
                              device="cpu").query(q)
    lazy = GNNInferenceEngine(PlanStore.open(built["port_dir"]).as_plan(2),
                              tcfg, tparams, device="cpu")
    got = lazy.query(q)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    jlazy = JaxEngine(JaxPlanStore.open(built["ref_dir"]).as_plan(2), jcfg,
                      params)
    np.testing.assert_allclose(got, jlazy.query(q), atol=ATOL, rtol=RTOL)
    assert lazy.ooc_stats() == jlazy.ooc_stats()
    assert lazy.ooc_stats()["resident"] <= 2
    assert GNNInferenceEngine(built["resident"], tcfg, tparams,
                              device="cpu").ooc_stats() is None


def test_lazy_cache_snapshot_matches_reference(built):
    """The same access sequence through both packages' LRU: the same
    loads, hits, evictions, resident bytes and store I/O counters."""
    caches = [PlanStore.open(built["port_dir"]).as_plan(2).cache,
              JaxPlanStore.open(built["ref_dir"]).as_plan(2).cache]
    n = len(caches[0])
    seq = [0, 1, 0, n - 1, 1, 0, 0] + list(range(n))
    for cache in caches:
        for i in seq:
            cache[i]
        cache.stack([0, 1])
    a, b = (c.snapshot() for c in caches)
    assert a == b
    assert a["resident"] <= 2 and a["budget"] == 2
    assert caches[0].nbytes() == caches[1].nbytes()
    assert caches[0].resident_nbytes() == caches[1].resident_nbytes()


def test_eviction_under_budget(built):
    cache = PlanStore.open(built["port_dir"]).as_plan(
        resident_batches=2).cache
    for i in range(len(cache)):
        cache[i]
    snap = cache.snapshot()
    assert snap["loads"] == len(cache)
    assert snap["evictions"] == len(cache) - 2 and snap["resident"] == 2
    cache[len(cache) - 1]                        # hot: a hit
    assert cache.snapshot()["hits"] == 1
    cache[0]                                     # cold: read again
    assert cache.snapshot()["loads"] == len(cache) + 1


# ------------------------------------------------------ batch_io semantics
@pytest.mark.parametrize("script, rates, retries", [
    ({"batch_io": [0]}, None, 2),                # absorbed by a retry
    ({"batch_io": [0, 1]}, None, 2),             # absorbed by two
    (None, {"batch_io": 1.0}, 2),                # retries exhausted
    ({"batch_io": [0]}, None, 0),                # no retries allowed
])
def test_batch_io_retries_match_reference(built, tmp_path, script, rates,
                                          retries):
    out = []
    for store_cls, inj in ((PlanStore, FaultInjector),
                           (JaxPlanStore, JaxFaultInjector)):
        store = store_cls.open(built["port_dir"], io_retries=retries,
                               faults=inj(seed=7, script=script,
                                          rates=rates))
        try:
            got = store.read_batch(0)
            res = ("ok", [got[k].tobytes() for k in sorted(got)])
        except OSError as e:
            res = ("OSError", str(e))
        out.append((res, store.stats.snapshot(), store.faults.snapshot()))
    assert out[0] == out[1]
    if out[0][0][0] == "ok":
        want = built["resident"].cache[0]
        assert out[0][0][1] == [want[k].tobytes() for k in sorted(want)]


def test_checksum_mismatch_is_never_retried(built, tmp_path):
    """Flipped bytes inside batch 1 fail that batch's checksum at once (no
    retry, though retries are allowed); every other batch serves."""
    errors = []
    for name, writer, store_cls, error in (
            ("port", write_store, PlanStore, PlanFormatError),
            ("ref", jax_write_store, JaxPlanStore, JaxPlanFormatError)):
        d = str(tmp_path / name)
        writer(d, built["resident"], chunk_batches=2)
        spec = next(s for s in PlanStore.open(d).specs
                    if s.name == "features")
        corrupt_file(os.path.join(d, "fields", "features.bin"),
                     offset=spec.rowbytes + 3, nbytes=4)
        store = store_cls.open(d, io_retries=2)
        store.read_batch(0)
        with pytest.raises(error, match="checksum mismatch") as e:
            store.read_batch(1)
        errors.append((e.value.args[0].replace(d, "<dir>"),
                       store.stats.snapshot()))
        for i in range(2, len(store)):
            store.read_batch(i)
    assert errors[0] == errors[1]
    assert errors[0][1] == {"reads": 2, "io_retries": 0, "crc_failures": 1}


# ------------------------------------------------- store errors, both sides
def _store_error(store_cls, d):
    try:
        store_cls.open(d)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__, str(e).replace(d, "<dir>")
    return None


def _damaged(tmp_path, built, how):
    d = str(tmp_path / how)
    write_store(d, built["resident"], chunk_batches=2)
    if how == "uncommitted":
        os.remove(os.path.join(d, "header.json"))
    elif how == "truncated":
        fpath = os.path.join(d, "fields", "features.bin")
        with open(fpath, "r+b") as f:
            f.truncate(os.path.getsize(fpath) - 7)
    elif how == "index":
        corrupt_file(os.path.join(d, "index.npz"), seed=1, nbytes=16)
    elif how == "header":
        with open(os.path.join(d, "header.json"), "r+b") as f:
            f.truncate(20)
    elif how == "version":
        import json
        hp = os.path.join(d, "header.json")
        with open(hp) as f:
            h = json.load(f)
        h["store_version"] = 99
        with open(hp, "w") as f:
            json.dump(h, f)
    return d


@pytest.mark.parametrize("how", ["uncommitted", "truncated", "index",
                                 "header", "version"])
def test_store_open_errors_match_reference(built, tmp_path, how):
    d = _damaged(tmp_path, built, how)
    got, want = _store_error(PlanStore, d), _store_error(JaxPlanStore, d)
    assert got is not None and got == want
    assert got[0] == ("FileNotFoundError" if how == "uncommitted"
                      else "PlanFormatError")


def test_store_refuses_uncommitted_build(built, tmp_path):
    d = str(tmp_path / "halfbuilt")
    w = PlanStoreWriter(d)
    fields = built["resident"].cache.fields
    w.append({k: v[:1] for k, v in fields.items()}, np.zeros((1, 3),
                                                               np.int64))
    w.abort()
    with pytest.raises(FileNotFoundError, match="no finalized PlanStore"):
        PlanStore.open(d)
    with pytest.raises(ValueError, match="refusing to overwrite"):
        PlanStoreWriter(built["port_dir"])


# ---------------------------------------------------------------- sharding
@pytest.fixture(scope="module")
def sharded(built, tmp_path_factory):
    backend = built["backend"]
    root = tmp_path_factory.mktemp(f"torch_shards_{backend}")
    jroot, troot = str(root / "ref"), str(root / "port")
    from repro.ooc import OOCConfig as JaxOOCConfig
    jman = jax_build_shards(_pipes(backend)[0], "train", 3, jroot,
                            ooc=JaxOOCConfig(chunk_batches=2))
    tman = build_shards(_pipes(backend)[1], "train", 3, troot,
                        ooc=OOCConfig(chunk_batches=2))
    return backend, jroot, troot, jman, tman


def test_shard_manifest_matches_reference(sharded):
    _backend, jroot, troot, jman, tman = sharded
    drop = ("build_seconds",)
    assert {k: v for k, v in tman.items() if k not in drop} == \
        {k: v for k, v in jman.items() if k not in drop}
    assert load_manifest(troot)["chain"] == jman["chain"]
    with np.load(os.path.join(troot, "owners.npz")) as a, \
            np.load(os.path.join(jroot, "owners.npz")) as b:
        assert all(np.array_equal(a[k], b[k]) for k in ("node_ids", "shard"))
    assert not os.path.exists(os.path.join(troot, "owners.npz.tmp"))


def test_shard_router_answers(sharded, built):
    """Queries spanning the shards: the port's router answers the port's
    resident engine bit for bit and the JAX router within ATOL; each
    package's router serves the other's shard build."""
    backend, jroot, troot, _jman, _tman = sharded
    jcfg, tcfg, params = _model(backend)
    tparams = params_from_jax(params, "cpu")
    q = np.random.default_rng(1).permutation(
        jax_dataset("tiny").splits["train"])
    router = ShardRouter.load(troot, tcfg, tparams, device="cpu")
    assert router.shards_hit(q) >= 2
    want = GNNInferenceEngine(built["resident"], tcfg, tparams,
                              device="cpu").query(q)
    got = router.query(q)
    assert got.tobytes() == want.tobytes()
    jrouter = JaxShardRouter.load(jroot, jcfg, params)
    np.testing.assert_allclose(got, jrouter.query(q), atol=ATOL, rtol=RTOL)
    snap, jsnap = router.snapshot(), jrouter.snapshot()
    assert {k: v for k, v in snap.items() if k != "per_shard"} == \
        {k: v for k, v in jsnap.items() if k != "per_shard"}
    assert {i: s["cache"] for i, s in snap["per_shard"].items()} == \
        {i: s["cache"] for i, s in jsnap["per_shard"].items()}
    cross = ShardRouter.load(jroot, tcfg, tparams, device="cpu").query(q)
    assert cross.tobytes() == got.tobytes()
    np.testing.assert_allclose(
        JaxShardRouter.load(troot, jcfg, params).query(q), got, atol=ATOL,
        rtol=RTOL)


def test_shard_partial_load_and_chain(sharded):
    backend, jroot, troot, _jman, tman = sharded
    _jcfg, tcfg, params = _model(backend)
    router = ShardRouter.load(troot, tcfg, params_from_jax(params, "cpu"),
                              shards=[1], device="cpu")
    q = np.asarray(jax_dataset("tiny").splits["train"], np.int64)
    assert len(router.query(q[router.owner(q) == 1]))
    with pytest.raises(KeyError, match="did not load"):
        router.query(q)
    with pytest.raises(KeyError, match="not covered by any shard"):
        router.owner(np.array([10 ** 9]))
    import json
    mpath = os.path.join(troot, "manifest.json")
    with open(mpath) as f:
        doc = json.load(f)
    doc["shards"][1]["fingerprint"] = "0" * 16
    with open(mpath, "w") as f:
        json.dump(doc, f)
    try:
        with pytest.raises(PlanFormatError, match="chain"):
            load_manifest(troot)
    finally:
        with open(mpath, "w") as f:
            json.dump(tman, f)
