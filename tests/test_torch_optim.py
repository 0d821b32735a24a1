"""The port's optimizers, schedule and accumulator against the JAX package's,
on identical gradients and state made from a seed with numpy.

Kept apart from gradient parity on purpose: near-zero gradient entries can
flip the sign of Adam's first step under a few ulps of summation order, so
comparing updates of gradients computed separately would need a loose
tolerance. Fed the same gradients, every comparison stays tight."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim.accumulate import GradAccumulator as JaxAccumulator
from repro.optim.schedules import ReduceLROnPlateau as JaxPlateau
from repro_torch.optim import (
    GradAccumulator, ReduceLROnPlateau, apply_updates, get_optimizer,
    tree_leaves, tree_map)

# f32 on both sides, the same formulas in the same order; what is left is
# how each library rounds pow/sqrt/mean
ATOL = RTOL = 1e-6

NAMES = ["sgd", "adam", "adamw", "adagrad", "adafactor"]


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"layers": [{"w": f(6, 5), "b": f(5), "ln_scale": f(5)},
                       {"w": f(5, 3), "b": f(3)}]}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _assert_trees_close(port, ref):
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    port_leaves, port_def = jax.tree_util.tree_flatten(
        port, is_leaf=torch.is_tensor)
    assert ref_def == port_def
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_update_and_state_match_jax_over_three_steps(name, weight_decay):
    params = _tree(0)
    ref, port = (jopt.get_optimizer(name, weight_decay=weight_decay),
                 get_optimizer(name, weight_decay=weight_decay))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = ref.init(jp), port.init(tp)
    _assert_trees_close(ts, js)
    for step in range(3):
        grads = _tree(10 + step, scale=0.1)
        ju, js = ref.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                            jp, jnp.float32(1e-2))
        tu, ts = port.update(_to_torch(grads), ts, tp, 1e-2)
        _assert_trees_close(tu, ju)
        _assert_trees_close(ts, js)
        jp, tp = jopt.apply_updates(jp, ju), apply_updates(tp, tu)
        _assert_trees_close(tp, jp)
    assert int(ts["step"]) == 3


def test_state_carries_across_packages():
    """A reference Adam state, converted leaf by leaf, continues in the
    port exactly as it would have continued in the reference."""
    params, grads = _tree(1), _tree(2, scale=0.1)
    ref, port = jopt.adam(), get_optimizer("adam")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, js = ref.update(jax.tree_util.tree_map(jnp.asarray, grads),
                       ref.init(jp), jp, jnp.float32(1e-3))
    ju, js2 = ref.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
                         jnp.float32(1e-3))
    tu, ts2 = port.update(_to_torch(grads), _to_torch(js), _to_torch(params),
                          1e-3)
    _assert_trees_close(tu, ju)
    _assert_trees_close(ts2, js2)


def test_adafactor_state_is_factored_like_the_reference():
    params = _tree(3)
    ts = get_optimizer("adafactor").init(_to_torch(params))
    js = jopt.adafactor().init(jax.tree_util.tree_map(jnp.asarray, params))
    assert tuple(ts["slots"]["layers"][0]["w"]["vr"].shape) == (6,)
    assert tuple(ts["slots"]["layers"][0]["w"]["vc"].shape) == (5,)
    assert sorted(ts["slots"]["layers"][0]["b"]) == ["v"]
    _assert_trees_close(ts, js)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb")


def test_tree_map_walks_the_first_tree_and_keeps_its_structure():
    t = {"a": [torch.ones(2), (torch.zeros(1), torch.ones(1))]}
    doubled = tree_map(lambda x: 2 * x, t)
    assert isinstance(doubled["a"][1], tuple)
    assert [float(x.sum()) for x in tree_leaves(doubled)] == [4.0, 0.0, 2.0]
    # a leaf of the first tree meets a whole subtree of the second
    paired = tree_map(lambda x, s: sorted(s), {"w": torch.ones(1)},
                      {"w": {"vr": 0, "vc": 1}})
    assert paired == {"w": ["vc", "vr"]}


def test_plateau_schedule_matches_jax():
    ref, port = JaxPlateau(lr=1e-2, patience=2, cooldown=1), \
        ReduceLROnPlateau(lr=1e-2, patience=2, cooldown=1)
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.98, 0.99, 1.2, 0.5, 0.6, 0.7,
               0.8, 0.9, 1.0, 1.1]
    for m in metrics:
        assert port.step(m) == ref.step(m)
        assert (port.best, port.bad_epochs, port.cooldown_left) == \
            (ref.best, ref.bad_epochs, ref.cooldown_left)
    assert port.lr < 1e-2


@pytest.mark.parametrize("every", [1, 2, 3])
def test_grad_accumulator_matches_jax(every):
    ref, port = JaxAccumulator(every), GradAccumulator(every)
    for i in range(5):
        g = _tree(20 + i)
        want = ref.add(jax.tree_util.tree_map(jnp.asarray, g))
        got = port.add(_to_torch(g))
        assert (want is None) == (got is None)
        if want is not None:
            _assert_trees_close(got, want)
    want, got = ref.flush(), port.flush()
    assert (want is None) == (got is None)
    if want is not None:
        _assert_trees_close(got, want)
