"""The expert-parallel MoE (``moe_forward(..., dispatch="shmap")``, the
reference's ``_moe_forward_shmap``) on the deepseek-v2-lite SMOKE config
over CPU ``DataMesh``es of (1, 4) and (2, 2) ("data", "model").

The reference's shard_map runs on 4 emulated XLA CPU devices in a
subprocess (the test process keeps one JAX device). Where no assignment
drops the two agree within 1e-4; with drops the reference's
``_local_dispatch`` sends every dropped assignment to (expert 0, slot 0)
(ROADMAP Queue 3), and the port, which writes nothing for a drop, equals
the plain routed experts at each member's capacity."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import logical_rules
from repro_torch.dist.data_parallel import DataMesh
from repro_torch.models.lm import moe

ATOL = 1e-4
ARCH = "deepseek-v2-lite-16b"
MESHES = ((1, 4), (2, 2))
NO_DROP_CF, DROP_CF = 11.0, 0.5
B, S = 4, 64

_SUBPROC = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.dist.logical import logical_rules
from repro.dist.sharding import logical_rules_for
from repro.models.lm.moe import _moe_forward_shmap

data = np.load(sys.argv[1])
args = json.loads(sys.argv[2])
out = {}
for shape in args["meshes"]:
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    for cf in args["cfs"]:
        cfg = dataclasses.replace(get_smoke_config(args["arch"]),
                                  moe_capacity_factor=cf, dtype="float32")
        p = {k[2:]: jnp.asarray(data[k]) for k in data.files
             if k.startswith("p_")}
        with logical_rules(logical_rules_for(cfg, mesh), mesh=mesh):
            y = _moe_forward_shmap(cfg, p, jnp.asarray(data["x"]))
        out[f"{shape[0]}x{shape[1]}_{cf}"] = np.asarray(y)
np.savez(sys.argv[3], **out)
"""


def _root():
    return os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(params, x, the reference's shmap outputs by (mesh, capacity
    factor)) at numpy seed 3."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(3)
    p = {k: (rng.normal(size=s) * s[-2] ** -0.5).astype(np.float32)
         if len(s) >= 2 else rng.normal(size=s).astype(np.float32)
         for k, s in moe.moe_params_shape(cfg).items()}
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    d = tmp_path_factory.mktemp("moe_ep")
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    np.savez(src, x=x, **{f"p_{k}": v for k, v in p.items()})
    args = {"meshes": [list(m) for m in MESHES], "cfs": [NO_DROP_CF, DROP_CF],
            "arch": ARCH}
    res = subprocess.run([sys.executable, "-c", _SUBPROC, src,
                          json.dumps(args), dst], cwd=_root(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = dict(np.load(dst))
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), ref)


def _cfg(cf):
    return dataclasses.replace(get_smoke_config(ARCH),
                               moe_capacity_factor=cf, dtype="float32")


def _mesh(shape):
    return DataMesh([["cpu"] * shape[1]] * shape[0], ("data", "model"))


@pytest.mark.parametrize("shape", MESHES)
def test_shmap_matches_the_reference_s_shard_map_with_no_drops(case, shape):
    p, x, ref = case
    stats = {}
    got = moe.moe_forward(_cfg(NO_DROP_CF), p, x, dispatch="shmap",
                          mesh=_mesh(shape), stats=stats)
    assert sum(m["dropped"] for m in stats["members"]) == 0
    want = torch.from_numpy(ref[f"{shape[0]}x{shape[1]}_{NO_DROP_CF}"])
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    print(f"{shape}: shmap against the reference's shard_map: max err "
          f"{err:.3e} (max |out| {scale:.3g})")
    assert err <= ATOL * max(1.0, scale)
    # and against the plain path (one dispatch, the einsum's function)
    torch.testing.assert_close(got, moe.moe_forward(_cfg(NO_DROP_CF), p, x),
                               atol=ATOL * max(1.0, scale), rtol=0)


def _members(shape):
    ndp, ep = shape
    return [(i, j) for i in range(ndp) for j in range(ep)]


@pytest.mark.parametrize("shape", MESHES)
def test_shmap_drops_write_nothing_where_the_reference_writes_slot_0(
        case, shape):
    """With drops: the port equals the plain routed experts at each
    member's capacity; the reference differs only at the token that holds
    (expert 0, slot 0) of a member with drops, whose expert-0 input its
    dropped assignments overwrite with zeros."""
    p, x, ref = case
    cfg = _cfg(DROP_CF)
    stats = {}
    got = moe.moe_forward(cfg, p, x, dispatch="shmap", mesh=_mesh(shape),
                          stats=stats)
    cap = stats["capacity"]
    ndp, ep = shape
    bl, sl = B // ndp, S // ep
    d = x.shape[-1]
    want = torch.zeros_like(x)
    fault_rows = set()
    for (i, j), rec in zip(_members(shape), stats["members"]):
        rows, cols = slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl)
        xt = x[rows, cols].reshape(-1, d)
        want[rows, cols] = moe.routed(cfg, p, xt, cap).reshape(bl, sl, d)
        r = moe.route(cfg, p, xt, cap)
        assert rec["dropped"] == int((~r.keep).sum())
        if rec["dropped"]:
            first = int(r.token[(r.expert == 0) & (r.slot == 0)][0])
            fault_rows.add((i * bl + first // sl, j * sl + first % sl))
    want = want + moe._shared_out(cfg, p, x.reshape(-1, d)).reshape(x.shape)
    scale = want.abs().max().item()
    assert sum(m["dropped"] for m in stats["members"]) > 0
    torch.testing.assert_close(got, want, atol=ATOL * max(1.0, scale),
                               rtol=0)
    theirs = torch.from_numpy(ref[f"{shape[0]}x{shape[1]}_{DROP_CF}"])
    bad = (theirs - got).abs().amax(dim=-1) > 1e-3
    off = {tuple(int(v) for v in idx) for idx in bad.nonzero()}
    print(f"{shape}: the reference's shard_map differs above 1e-3 at "
          f"tokens {sorted(off)}; (expert 0, slot 0) of members with drops "
          f"holds {sorted(fault_rows)}")
    assert off and off <= fault_rows


def test_shmap_exchanges_2ecd_values_per_member(case):
    p, x, _ = case
    cfg = _cfg(NO_DROP_CF)
    stats = {}
    moe.moe_forward(cfg, p, x, dispatch="shmap", mesh=_mesh((1, 4)),
                    stats=stats)
    e, d = cfg.moe_num_experts, cfg.d_model
    assert stats["ep"] == 4 and len(stats["members"]) == 4
    for rec in stats["members"]:
        assert rec["send_bytes"] == rec["back_bytes"] == \
            e * stats["capacity"] * d * x.element_size()
    # the capacity of a member's S / ep tokens, not of all of x
    assert stats["capacity"] == moe.moe_capacity(cfg, B * (S // 4))


def test_shmap_takes_the_mesh_of_the_active_rules(case):
    p, x, _ = case
    cfg = _cfg(NO_DROP_CF)
    mesh = _mesh((2, 2))
    stats = {}
    with logical_rules({"batch": "data"}, mesh):
        got = moe.moe_forward(cfg, p, x, dispatch="shmap", stats=stats)
    assert stats["ep"] == 2
    torch.testing.assert_close(
        got, moe.moe_forward(cfg, p, x, dispatch="shmap", mesh=mesh),
        atol=0, rtol=0)


@pytest.mark.parametrize("mesh", [None, "no-model", "indivisible"])
def test_shmap_falls_back_to_the_plain_path(case, mesh):
    p, x, _ = case
    cfg = _cfg(NO_DROP_CF)
    m = {None: None, "no-model": DataMesh(["cpu"] * 2, ("data",)),
         "indivisible": DataMesh([["cpu"] * 3], ("data", "model"))}[mesh]
    stats = {}
    got = moe.moe_forward(cfg, p, x, dispatch="shmap", mesh=m, stats=stats)
    assert stats == {}                      # no exchange ran
    torch.testing.assert_close(got, moe.moe_forward(cfg, p, x), atol=0,
                               rtol=0)


def test_shmap_sequence_replicated_when_model_does_not_divide_it(case):
    p, x, _ = case
    cfg = _cfg(NO_DROP_CF)
    stats = {}
    x3 = x[:, :63]                          # 63 % 2 != 0
    got = moe.moe_forward(cfg, p, x3, dispatch="shmap",
                          mesh=_mesh((2, 2)), stats=stats)
    assert stats["capacity"] == moe.moe_capacity(cfg, (B // 2) * 63)
    torch.testing.assert_close(got, moe.moe_forward(cfg, p, x3),
                               atol=ATOL, rtol=0)


def test_unknown_dispatch_raises(case):
    p, x, _ = case
    with pytest.raises(ValueError):
        moe.moe_forward(_cfg(NO_DROP_CF), p, x, dispatch="sort")
