"""Out-of-core plans (DESIGN.md §13): mmap-backed batch storage
(``store``), streaming chunked preprocessing (``stream``), and sharded
multi-host serving (``shard``). The port's copy of ``repro.ooc``: the
on-disk formats are the reference's, so either package opens the other's
stores and shard builds. Entry points:

    plan  = pipe.plan(split, out_of_core=True, store_dir=d)   # stream build
    store = PlanStore.open(d); plan = store.as_plan(resident_batches=8)
    build_shards(pipe, split, num_shards, root)
    router = ShardRouter.load(root, model_cfg, params, shards=[i])
"""
from repro_torch.ooc.store import (FieldSpec, LazyBatchCache, PlanStore,
                             PlanStoreWriter, write_store)
from repro_torch.ooc.stream import OOCConfig, stream_plan
from repro_torch.ooc.shard import (PlanShard, ShardRouter, build_shards,
                             load_manifest, shard_name)

__all__ = [
    "FieldSpec", "LazyBatchCache", "PlanStore", "PlanStoreWriter",
    "write_store", "OOCConfig", "stream_plan", "PlanShard", "ShardRouter",
    "build_shards", "load_manifest", "shard_name",
]
