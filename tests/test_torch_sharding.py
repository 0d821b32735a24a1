"""The port's logical-axis sharding (``repro_torch.dist``) against the
reference's (``repro.dist``): every spec function on every leaf of all ten
full configs on both production meshes, ``spec_for``'s arbitration and
``fit_spec``'s cases; ``annotate`` and ``placements`` on a fake (2, 2)
DeviceMesh.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names`` (``src/repro/dist/sharding.py:26-72``), so both
packages take one stand-in mesh in-process, with no devices. The fake
process group of the placement tests is destroyed when they end."""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.dist import logical as ref_logical
from repro.dist import sharding as ref_sharding
from repro.models.lm import abstract_cache, abstract_params
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro_torch import dist as port_dist
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import logical as port_logical
from repro_torch.dist import sharding as port_sharding
from repro_torch.models.lm import cache_shapes, param_shapes
from repro_torch.models.lm.model import _map_leaves
from repro_torch.optim.optimizers import get_optimizer

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def stand_in(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


def _names(path):
    return tuple(port_sharding._key_name(k) for k in path)


def _ref_specs(tree, fn):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_names(path): tuple(fn(path, leaf)) for path, leaf in leaves}


def _port_specs(tree, fn):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)) and not isinstance(
                t, torch.Tensor):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[_names(path)] = fn(path, t)
    walk(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _meta_params(arch):
    cfg = get_config(arch)
    dt = getattr(torch, cfg.dtype)
    return _map_leaves(param_shapes(cfg), lambda _n, s: torch.empty(
        s, dtype=dt, device="meta"))


def test_the_port_has_the_reference_s_archs():
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_param_spec_equals_the_reference_s_on_every_leaf(arch, mesh_kind):
    mesh = stand_in(*MESHES[mesh_kind])
    want = _ref_specs(abstract_params(ref_get_config(arch)),
                      lambda p, l: ref_sharding.param_spec(mesh, p, l))
    got = _port_specs(_meta_params(arch),
                      lambda p, l: port_sharding.param_spec(mesh, p, l))
    assert got == want
    assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_opt_spec_equals_the_reference_s_on_every_leaf(arch, mesh_kind,
                                                      opt_name):
    mesh = stand_in(*MESHES[mesh_kind])
    ref_opt = ref_get_optimizer(opt_name)
    ref_state = jax.eval_shape(ref_opt.init,
                               abstract_params(ref_get_config(arch)))
    want = _ref_specs(ref_state,
                      lambda p, l: ref_sharding.opt_spec(mesh, p, l, {}))
    state = get_optimizer(opt_name).init(_meta_params(arch))
    got = _port_specs(state,
                      lambda p, l: port_sharding.opt_spec(mesh, p, l, {}))
    assert got == want


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_cache_spec_equals_the_reference_s_on_every_leaf(arch, mesh_kind):
    mesh = stand_in(*MESHES[mesh_kind])
    b, s = 128, 32_768                     # the decode_32k cell
    want = _ref_specs(abstract_cache(ref_get_config(arch), b, s),
                      lambda p, l: ref_sharding.cache_spec(mesh, p, l))
    shapes = cache_shapes(get_config(arch), b, s)
    leaves = _map_leaves(shapes, lambda _n, sh: types.SimpleNamespace(
        shape=tuple(sh), ndim=len(sh)))
    got = _port_specs(leaves,
                      lambda p, l: port_sharding.cache_spec(mesh, p, l))
    assert got == want


BATCH_SHAPES = [("tokens", (256, 4096)), ("tokens", (32, 32_768)),
                ("tokens", (128, 1)), ("tokens", (128, 1, 4)),
                ("tokens", (1, 1)), ("tokens", (1, 524_288)),
                ("loss_mask", (256, 4096)), ("prefix_embeds", (256, 256, 896)),
                ("pos", ()), ("tokens", (3, 5))]


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("name,shape", BATCH_SHAPES)
def test_batch_spec_equals_the_reference_s(name, shape, mesh_kind):
    mesh = stand_in(*MESHES[mesh_kind])
    assert port_sharding.batch_spec(mesh, name, shape) == \
        tuple(ref_sharding.batch_spec(mesh, name, shape))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_logical_rules_for_equals_the_reference_s(arch, mesh_kind):
    mesh = stand_in(*MESHES[mesh_kind])
    assert port_sharding.logical_rules_for(get_config(arch), mesh) == \
        ref_sharding.logical_rules_for(ref_get_config(arch), mesh)


# the reference's tests/test_sharding.py:25-60, as cases run on both
# packages, plus cases where the fallback drops an axis
ONE = stand_in((1, 1), ("data", "model"))
PROD = stand_in(*MESHES["single"])
POD = stand_in(*MESHES["multi"])
FIT_CASES = [
    (ONE, (16, 32), ("data", "model"), ("data", "model")),
    (ONE, (4, 16, 32), ("data", "model"), (None, "data", "model")),
    (PROD, (8, 2048), ("model", "data"), (None, "data")),
    (PROD, (2048, 8), ("data", "model"), ("data", None)),
    (PROD, (64, 2048, 1408), ("model", "data", None),
     ("model", "data", None)),
    (POD, (256, 4096), (("pod", "data"), "model"),
     (("pod", "data"), "model")),
    (POD, (16, 4096), (("pod", "data"), "model"), (None, "model")),
    (PROD, (16, 4096), (("pod", "data"), None), (None, None)),
    (PROD, (32,), ("data", "model"), ("model",)),
    (PROD, (), (), ()),
]


@pytest.mark.parametrize("case", range(len(FIT_CASES)))
def test_fit_spec_cases_match_the_reference(case):
    mesh, shape, axes, want = FIT_CASES[case]
    got = port_sharding.fit_spec(mesh, shape, axes)
    assert got == want
    assert got == tuple(ref_sharding.fit_spec(mesh, shape, axes))


SPEC_FOR_CASES = [
    ({"seq": "model", "heads": "model", "batch": "data"},
     ("batch", "seq", "heads", None), ("data", None, "model", None)),
    ({"seq": "model", "heads": "model", "batch": "data"},
     ("batch", "seq", None), ("data", "model", None)),
    ({"seq": "model", "mlp": "model", "batch": ("pod", "data")},
     ("batch", "seq", "mlp"), (("pod", "data"), None, "model")),
    # ties go to the leftmost dimension
    ({"heads": "model", "kv_heads": "model"}, ("kv_heads", "heads"),
     ("model", None)),
    ({"batch": ("pod", "data"), "seq": "data"}, ("seq", "batch"),
     (None, ("pod", "data"))),
    ({"batch": ("pod", "data"), "other": ("data", "model")},
     ("batch", "other"), (("pod", "data"), "model")),
    ({}, ("batch", None), (None, None)),
]


@pytest.mark.parametrize("case", range(len(SPEC_FOR_CASES)))
def test_spec_for_arbitration_matches_the_reference(case):
    rules, axes, want = SPEC_FOR_CASES[case]
    assert port_logical.spec_for(axes, rules) == want
    assert tuple(ref_logical.spec_for(axes, rules)) == want
    with port_logical.logical_rules(rules):
        assert port_logical.spec_for(axes) == want


def test_spec_for_outside_a_context_is_all_none():
    assert port_logical.current_rules() is None
    assert port_logical.spec_for(("batch", "seq")) == (None, None)
    assert tuple(ref_logical.spec_for(("batch", "seq"))) == (None, None)


def test_param_spec_names_as_the_reference_s_test():
    mesh = ONE
    leaf = types.SimpleNamespace(shape=(128, 256), ndim=2)
    assert port_sharding.param_spec(mesh, ("mixer", "wq"), leaf) == \
        ("data", "model")
    leaf_o = types.SimpleNamespace(shape=(256, 128), ndim=2)
    assert port_sharding.param_spec(mesh, ("mixer", "wo"), leaf_o) == \
        ("model", "data")
    norm = types.SimpleNamespace(shape=(128,), ndim=1)
    assert port_sharding.param_spec(mesh, ("norm1", "scale"), norm) == \
        (None,)
    assert tuple(P(None)) == (None,)


def test_spec_functions_take_a_data_mesh():
    from repro_torch.dist.data_parallel import DataMesh
    mesh = DataMesh([["cpu"] * 4] * 2, ("data", "model"))
    leaf = types.SimpleNamespace(shape=(8, 12), ndim=2)
    assert port_sharding.param_spec(mesh, ("wq",), leaf) == ("data", "model")
    assert port_sharding.batch_spec(mesh, "tokens", (5, 8)) == \
        (None, "model")
    assert port_sharding.data_axes(mesh) == ("data",)


# ------------------------------------------------------------------ annotate
def test_annotate_is_the_identity_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert port_dist.annotate(x, "batch", "seq", "embed") is x
    with port_logical.logical_rules({"batch": "data"}):
        # rules but no mesh: still the same object
        assert port_dist.annotate(x, "batch", "seq", "embed") is x
    mesh = stand_in((2, 2), ("data", "model"))
    with port_logical.logical_rules({"batch": "data"}, mesh):
        # a plain tensor has no sharding to constrain
        assert port_dist.annotate(x, "batch", "seq", "embed") is x


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2) DeviceMesh on a fake process group of world 4 (this
    process is rank 0); destroyed when the module's tests end."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,axes", [
    ((4, 6, 8, 2), ("batch", "seq", "heads", None)),
    ((4, 6, 3, 2), ("batch", "seq", "kv_heads", None)),
    ((4, 6, 8), ("batch", "seq", "embed")),
    ((4, 6, 8), ("batch", None, "embed")),
    ((3, 5, 8), ("batch", "seq", "mlp")),
    ((8, 4, 6), ("expert", None, None)),
])
def test_annotate_gives_the_placements_fit_spec_says(fake_mesh, shape, axes):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_mesh
    rules = port_sharding.logical_rules_for(get_config("llama3.2-1b"), mesh)
    x = distribute_tensor(torch.randn(shape), mesh,
                          (Replicate(), Replicate()))
    spec = port_sharding.fit_spec(mesh, shape,
                                  port_logical.spec_for(axes, rules))
    want = port_sharding.placements(mesh, spec)
    with port_logical.logical_rules(rules, mesh):
        got = port_dist.annotate(x, *axes)
    if all(e is None for e in spec):
        assert got is x
    else:
        assert tuple(got.placements) == want
        assert tuple(got.shape) == shape
    # every entry of the spec shards its dimension, the rest replicate
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        for a in port_logical._as_tuple(entry):
            assert want[names.index(a)] == Shard(dim)


def test_annotate_leaves_an_all_none_spec_alone(fake_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = distribute_tensor(torch.randn(3, 5), fake_mesh,
                          (Replicate(), Replicate()))
    with port_logical.logical_rules({"batch": "data"}, fake_mesh):
        assert port_dist.annotate(x, None, None) is x
        assert port_dist.annotate(x, "batch", None) is x   # 3 % 2 != 0


def test_placements_split_a_tuple_major_to_minor(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    assert port_sharding.placements(fake_mesh, (("data", "model"), None)) == \
        (Shard(0), Shard(0))
    assert port_sharding.placements(fake_mesh, (None, "model")) == \
        (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        port_sharding.placements(fake_mesh, (("model", "data"),))
    one = stand_in((1, 2), ("data", "model"))
    # an axis of size 1 shards nothing
    assert port_sharding.placements(one, ("data", "model")) == \
        (Replicate(), Shard(1))


def test_distribute_tree_places_a_parameter_tree(fake_mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_params
    cfg = get_smoke_config("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed = port_sharding.distribute_tree(fake_mesh, params,
                                           port_sharding.param_spec)
    wq = placed["stages"][0]["layer0"]["mixer"]["wq"]
    want = port_sharding.placements(fake_mesh, port_sharding.param_spec(
        fake_mesh, ("stages", 0, "layer0", "mixer", "wq"), wq))
    assert tuple(wq.placements) == want
    r, d, f = params["stages"][0]["layer0"]["mixer"]["wq"].shape
    assert tuple(wq.to_local().shape) == (r, d // 2, f // 2)
    # each rank keeps its own shard: rank 0's is the leading block
    torch.testing.assert_close(
        wq.to_local(), params["stages"][0]["layer0"]["mixer"]["wq"][
            :, :d // 2, :f // 2], atol=0, rtol=0)


def test_splittable_replicates_only_what_the_split_needs(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.randn(4, 6, 8), fake_mesh,
                          (Shard(0), Shard(2)))
    assert port_dist.splittable(x, -1, 4) is x          # 4 % 2 == 0
    y = port_dist.splittable(x, -1, 3)                   # 3 % 2 != 0
    assert tuple(y.placements) == (Shard(0), Replicate())
    plain = torch.randn(4, 6)
    assert port_dist.splittable(plain, 1, 3) is plain


@pytest.mark.parametrize("h,kv,m", [(8, 2, 4), (8, 2, 2), (32, 8, 16),
                                    (12, 4, 2), (6, 2, 3)])
def test_kv_for_heads_reads_each_query_head_s_own_kv_head(h, kv, m):
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.lm.attention import kv_for_heads
    gen = torch.Generator().manual_seed(h * 100 + kv * 10 + m)
    q = torch.randn(2, 5, h, 4, generator=gen)
    k = torch.randn(2, 5, kv, 4, generator=gen)
    v = torch.randn(2, 5, kv, 4, generator=gen)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    hl = h // m
    for j in range(m):
        ql = q[:, :, j * hl:(j + 1) * hl]
        kl, vl = kv_for_heads(k, v, j * hl, hl, h // kv)
        got = attention_ref(ql.transpose(1, 2), kl.transpose(1, 2),
                            vl.transpose(1, 2)).transpose(1, 2)
        torch.testing.assert_close(got, want[:, :, j * hl:(j + 1) * hl],
                                   atol=0, rtol=0)
