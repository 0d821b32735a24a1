"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

The cases of the reference's ``tests/test_checkpoint.py`` (round trip,
latest and resume with retention, an async save that does not block, a
half-written checkpoint ignored, random trees) and of the checkpoint half
of ``tests/test_faults.py`` (corrupt fallback, an empty dir, async and
blocking save errors) run on the port. Then the two packages read each
other's checkpoints bit for bit: a GCN's parameters with an Adam state,
and the bf16 parameters of the llama3.2-1b SMOKE config, stored as the
reference stores them (bits as ``V2`` members, manifest dtype bfloat16).
Restores are exact, so every comparison here is bitwise."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.lm import model as jmodel
from repro.optim import adam as jax_adam
from repro_torch.checkpoint import (
    Checkpointer, CheckpointCorruptError, CheckpointError, all_steps,
    latest_step, load_pytree, save_pytree)
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.faults import FaultInjector, corrupt_file
from repro_torch.optim import adam, tree_leaves, tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.as_tensor(
                       rng.normal(size=(8, 4)).astype(np.float32)),
                   "layers": [{"b": torch.arange(3.0)},
                              {"b": torch.arange(3.0) * 2}]},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.dtype, tuple(t.shape), t.numpy().tobytes()


def _assert_same_tree(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert _bits(a) == _bits(b)


# ------------------------------------------------- the reference's cases
def test_roundtrip(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path), 5, extra={"lr": 0.1})
    out, manifest = load_pytree(tree, str(tmp_path), 5)
    assert manifest["step"] == 5 and manifest["extra"]["lr"] == 0.1
    assert manifest["hosts"] == 1
    assert manifest["keys"] == ["params/layers/0/b", "params/layers/1/b",
                                "params/w", "step"]
    _assert_same_tree(out, tree)


def test_latest_and_resume(tmp_path):
    c = Checkpointer(str(tmp_path), keep=2)
    assert c.auto_resume(_tree()) is None
    for s in (1, 3, 9):
        c.save(_tree(s), s, blocking=True)
    assert latest_step(str(tmp_path)) == 9
    assert all_steps(str(tmp_path)) == [9, 3]
    out, manifest = c.auto_resume(_tree())
    assert manifest["step"] == 9
    _assert_same_tree(out, _tree(9))
    steps = sorted(fn for fn in os.listdir(tmp_path) if fn.startswith("step-"))
    assert len(steps) == 2


def test_async_save_does_not_block(tmp_path):
    c = Checkpointer(str(tmp_path))
    big = {"w": torch.ones((512, 512))}
    c.save(big, 1)                               # async
    c.wait()
    out, _m = c.restore(big)
    assert torch.equal(out["w"], torch.ones((512, 512)))


def test_half_written_checkpoint_is_ignored(tmp_path):
    c = Checkpointer(str(tmp_path))
    c.save(_tree(), 4, blocking=True)
    os.makedirs(tmp_path / "step-00000009")      # crash mid-write: no manifest
    assert latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("seed, depth", [(0, 1), (1, 2), (7, 3), (42, 2),
                                         (1000, 3)])
def test_roundtrip_random_trees(tmp_path, seed, depth):
    rng = np.random.default_rng(seed)

    def rand_tree(d):
        if d == 0:
            shape = tuple(rng.integers(1, 5, size=rng.integers(1, 3)))
            return torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        return {f"k{i}": rand_tree(d - 1) for i in range(rng.integers(1, 3))}

    tree = rand_tree(depth)
    save_pytree(tree, str(tmp_path), 0)
    out, _ = load_pytree(tree, str(tmp_path), 0)
    _assert_same_tree(out, tree)


def test_corrupt_checkpoint_falls_back_to_newest_intact(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(_tree(1), 1, blocking=True)
    ck.save(_tree(2), 2, blocking=True)
    corrupt_file(str(tmp_path / "step-00000002" / "shard-0.npz"), seed=2,
                 nbytes=8)
    with pytest.raises(CheckpointCorruptError):
        ck.restore(_tree(), step=2)
    out, manifest = ck.auto_resume(_tree())      # newest INTACT wins
    assert manifest["step"] == 1
    _assert_same_tree(out, _tree(1))
    corrupt_file(str(tmp_path / "step-00000001" / "shard-0.npz"), seed=3,
                 nbytes=8)
    with pytest.raises(CheckpointCorruptError, match="all 2 checkpoints"):
        ck.auto_resume(_tree())


def test_unreadable_manifest_is_corrupt(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_tree(1), 1, blocking=True)
    with open(tmp_path / "step-00000001" / "manifest.json", "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruptError, match="unreadable manifest"):
        ck.restore(_tree(), step=1)


def test_auto_resume_empty_dir_returns_none(tmp_path):
    assert Checkpointer(str(tmp_path)).auto_resume(_tree()) is None
    with pytest.raises(FileNotFoundError):
        load_pytree(_tree(), str(tmp_path))


def test_async_save_error_reraised_not_swallowed(tmp_path):
    ck = Checkpointer(str(tmp_path),
                      faults=FaultInjector(script={"ckpt_io": [0]}))
    ck.save(_tree(1), 1)                         # async — error captured
    with pytest.raises(CheckpointError, match="async checkpoint save"):
        ck.wait()
    ck.save(_tree(2), 2, blocking=True)          # the error was one-shot
    assert latest_step(str(tmp_path)) == 2


def test_async_save_error_reraised_by_the_next_save(tmp_path):
    ck = Checkpointer(str(tmp_path),
                      faults=FaultInjector(script={"ckpt_io": [0]}))
    ck.save(_tree(1), 1)
    with pytest.raises(CheckpointError, match="OSError"):
        ck.save(_tree(2), 2)
    ck.wait()
    assert all_steps(str(tmp_path)) == []


def test_blocking_save_error_raises_immediately(tmp_path):
    ck = Checkpointer(str(tmp_path),
                      faults=FaultInjector(script={"ckpt_io": [0]}))
    with pytest.raises(CheckpointError):
        ck.save(_tree(1), 1, blocking=True)
    assert latest_step(str(tmp_path)) is None    # no half-written debris
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------ the port's rules
def test_cpu_snapshot_is_not_aliased(tmp_path):
    """The save copies each CPU leaf before it returns: an in-place update
    right after an async save does not reach the written bytes."""
    tree = _tree(3)
    want = tree_map(lambda t: t.clone(), tree)
    ck = Checkpointer(str(tmp_path))
    ck.save(tree, 1)                             # async
    for t in tree_leaves(tree):
        t.add_(1)                                # the next optimizer step
    ck.wait()
    out, _m = ck.restore(want)
    _assert_same_tree(out, want)


def test_restore_takes_the_template_device_and_dtype(tmp_path):
    save_pytree({"a": torch.arange(4, dtype=torch.float32),
                 "b": np.arange(3, dtype=np.int64)}, str(tmp_path), 1)
    out, _m = load_pytree({"a": torch.zeros(4, dtype=torch.float64),
                           "b": np.zeros(3, np.int32)}, str(tmp_path), 1,
                          device="cpu")
    assert out["a"].dtype == torch.float64 and out["b"].dtype == torch.int32
    assert out["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert out["b"].tolist() == [0, 1, 2]


def test_numpy_template_restores_on_the_card_or_raises(tmp_path):
    """A numpy template's leaves land on ``cuda`` unless the caller names
    another device: without a card that raises, it never falls back."""
    save_pytree({"a": np.ones(2, np.float32)}, str(tmp_path), 1)
    if torch.cuda.is_available():
        out, _m = load_pytree({"a": np.zeros(2, np.float32)}, str(tmp_path))
        assert out["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pytree({"a": np.zeros(2, np.float32)}, str(tmp_path))


# ------------------------------------------- across the two packages
def _gcn_with_adam():
    """A GCN's parameters and an Adam state one step in, from JAX."""
    cfg = JaxGNNConfig(kind="gcn", in_dim=16, hidden=32, out_dim=5,
                       num_layers=3)
    params = jax_init_gnn(cfg, jax.random.PRNGKey(0))
    opt = jax_adam()
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p) * 0.1, params)
    _upd, state = opt.update(grads, opt.init(params), params, 1e-3)
    return {"params": params, "opt": state}


def _port_template(jtree):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jtree["params"]), "cpu")
    return {"params": params, "opt": adam().init(params)}


def _by_path(tree, prefix=()):
    """A port tree's leaves by key path."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _by_path(tree[key], prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _by_path(t, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): tree}


def _jax_by_path(jtree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): torch.from_numpy(np.array(a))
            for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _gcn_with_adam()
    jax_save(jtree, str(tmp_path), 3, extra={"epoch": 2})
    out, manifest = load_pytree(_port_template(jtree), str(tmp_path), 3)
    assert manifest["extra"] == {"epoch": 2}
    got, want = _by_path(out), _jax_by_path(jtree)
    assert sorted(got) == sorted(want)
    assert all(_bits(got[k]) == _bits(want[k]) for k in want)
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["opt"]["step"]) == 1


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _gcn_with_adam()
    host = jax.tree_util.tree_map(np.asarray, jtree)
    port = {"params": params_from_jax(host["params"], "cpu"),
            "opt": {"step": torch.tensor(int(host["opt"]["step"]),
                                         dtype=torch.int32),
                    "m": params_from_jax(host["opt"]["m"], "cpu"),
                    "v": params_from_jax(host["opt"]["v"], "cpu")}}
    save_pytree(port, str(tmp_path), 4)
    out, manifest = jax_load(jtree, str(tmp_path), 4)
    assert manifest["keys"] == sorted(
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0])
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _smoke_lm_bf16():
    jcfg = dataclasses.replace(jax_get_smoke("llama3.2-1b"), dtype="bfloat16")
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))


def test_bf16_jax_checkpoint_restores_in_the_port(tmp_path):
    jp = _smoke_lm_bf16()
    jax_save(jp, str(tmp_path), 1)
    template = lm_params_from_jax(jax.tree_util.tree_map(np.zeros_like, jp),
                                  "cpu")
    out, manifest = load_pytree(template, str(tmp_path), 1)
    want = lm_params_from_jax(jp, "cpu")
    assert {t.dtype for t in tree_leaves(out)} == {torch.bfloat16}
    _assert_same_tree(out, want)
    assert set(manifest["dtypes"].values()) == {"bfloat16"}


def test_bf16_port_checkpoint_is_the_reference_s_format(tmp_path):
    """The port writes bf16 leaves exactly as JAX does (the same npz
    members, ``V2`` bits, manifest dtypes and checksums) and reads them
    back bit for bit."""
    jp = _smoke_lm_bf16()
    params = lm_params_from_jax(jp, "cpu")
    jax_save(jp, str(tmp_path / "jax"), 1)
    save_pytree(params, str(tmp_path / "port"), 1)
    man = {}
    for side in ("jax", "port"):
        ck = tmp_path / side / "step-00000001"
        with open(ck / "manifest.json") as f:
            m = json.load(f)
        with np.load(ck / "shard-0.npz") as z:
            members = {k: (z[k].dtype.str, z[k].tobytes()) for k in z.files}
        man[side] = ({k: m[k] for k in ("keys", "shapes", "dtypes",
                                        "checksums", "hosts")}, members)
    assert man["port"] == man["jax"]
    out, _m = load_pytree(params, str(tmp_path / "port"), 1)
    _assert_same_tree(out, params)


def test_reference_cannot_restore_its_own_bf16(tmp_path):
    """The reference's ``load_pytree`` casts a ``V2`` member to bfloat16
    and fails (ROADMAP.md, Queue 3): the port reads the same files."""
    jp = {"w": jnp.arange(4, dtype=jnp.bfloat16)}
    jax_save(jp, str(tmp_path), 1)
    with pytest.raises(ValueError, match="No cast function"):
        jax_load(jp, str(tmp_path), 1)
    out, _m = load_pytree({"w": torch.zeros(4, dtype=torch.bfloat16)},
                          str(tmp_path), 1)
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
