"""The kink rule of ``tests/_kinks.py``, which ``chip_smoke.py``'s card-vs-CPU
train steps use: the trace sees every ReLU and GAT LeakyReLU input in call
order, a forced side changes only what flows through it, and the rule
excuses an element only where the flipped kinks explain it. The "card" here
is a second CPU step with a chosen pre-activation forced across 0."""
import dataclasses

import pytest
import torch

import _kinks
from repro_torch.configs import gnn_gat
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.device import stage
from repro_torch.graph.datasets import get_dataset
from repro_torch.optim import tree_leaves
from repro_torch.train import GNNTrainer

ATOL = RTOL = 1e-4
# tighter than ATOL, so that one flipped kink on the tiny graph shows
TIGHT = 1e-7


@pytest.fixture(scope="module")
def gat_step():
    ds = get_dataset("tiny")
    plan = IBMBPipeline(ds, IBMBConfig(variant="node",
                                       max_outputs_per_batch=64,
                                       pad_multiple=32)).plan("train")
    cfg = dataclasses.replace(gnn_gat.CONFIG, in_dim=ds.feat_dim,
                              out_dim=ds.num_classes, dropout=0.0)
    trainer = GNNTrainer(cfg, backend="segment", device="cpu")
    params = trainer.init_params()
    grad = trainer._steps_for("segment", 0)["grad"]
    batch = stage(plan.cache[0], "cpu")

    def step(sides=None):
        with _kinks.kink_trace(sides) as tr:
            loss, g = grad(params, batch, None)
        return loss, tree_leaves(g), tr.inputs
    return step, _kinks.leaf_names(params)


def _nearest_zero(x):
    """The index of the nonzero entry of ``x`` nearest 0 (a padded node's
    row is all 0, and no gradient flows through it)."""
    a = x.abs().masked_fill(x == 0, float("inf"))
    return tuple(int(i) for i in torch.nonzero(a == a.min())[0])


def test_the_trace_sees_every_kink_in_call_order(gat_step):
    step, _ = gat_step
    _, _, inputs = step()
    # 3 layers: attention LeakyReLU per layer, ReLU after the two hidden
    n_edges = inputs[0].shape[0]
    assert [tuple(x.shape) for x in inputs] == [
        (n_edges, 4), (inputs[1].shape[0], 128), (n_edges, 4),
        (inputs[1].shape[0], 128), (n_edges, 4)]


def test_the_own_sides_change_nothing(gat_step):
    step, _ = gat_step
    loss, g, inputs = step()
    loss2, g2, _ = step(_kinks.sides_of(inputs))
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(g, g2))


@pytest.mark.parametrize("call", [0, 1, 2])
def test_a_flipped_kink_is_excused_only_where_it_explains(call, gat_step,
                                                         monkeypatch):
    step, names = gat_step
    # at the tight tolerance a flip reaches most of a small leaf; the share
    # rule has its own test
    monkeypatch.setattr(_kinks, "MAX_SHARE", 1.0)
    _, want, inputs = step()
    sides = _kinks.sides_of(inputs)
    idx = _nearest_zero(inputs[call])
    sides[call][idx] = ~sides[call][idx]
    _, card, _ = step(sides)                    # the "card": one side flipped
    # the two devices' inputs of that call a few ulps either side of 0
    near = 2 * _kinks.F32_EPS * float(inputs[call].abs().max())
    cpu_inputs = [x.clone() for x in inputs]
    cpu_inputs[call][idx] = -near if sides[call][idx] else near
    card_inputs = [x.clone() for x in cpu_inputs]
    card_inputs[call][idx] = -cpu_inputs[call][idx]
    flips = _kinks.flips(card_inputs, cpu_inputs)
    assert [(c, i) for c, i, *_ in flips] == [(call, idx)]
    assert _kinks.flip_problems(flips) == []
    _, forced, _ = step(_kinks.sides_of(card_inputs))
    excused, worst, problems = _kinks.kink_witness(card, want, forced, TIGHT,
                                                   TIGHT, names)
    assert problems == []
    n_bad = sum(int((~torch.isclose(a, b, atol=TIGHT, rtol=TIGHT)).sum())
                for a, b in zip(card, want))
    assert excused == n_bad > 0
    # an element moved elsewhere is not explained, and the rule says so
    card[0] = card[0].clone()
    card[0].view(-1)[0] += 1.0
    _, _, problems = _kinks.kink_witness(card, want, forced, TIGHT, TIGHT,
                                         names)
    assert any(p.startswith(f"{names[0]}: 1 of ") and "not explained" in p
               for p in problems)


def test_nothing_flipped_excuses_nothing(gat_step):
    step, names = gat_step
    _, want, _ = step()
    card = [t.clone() for t in want]
    card[2].view(-1)[3] += 1e-3
    excused, _, problems = _kinks.kink_witness(card, want, None, ATOL, RTOL,
                                               names)
    assert excused == 0
    assert problems == [f"{names[2]}: 1 elements outside the tolerance and "
                        f"no pre-activation flipped"]


def test_more_than_the_share_is_refused():
    want = [torch.zeros(10, 10)]
    card = [torch.zeros(10, 10)]
    card[0][:, 0] = 1.0                          # 10% of the leaf
    excused, worst, problems = _kinks.kink_witness(card, want, card, ATOL,
                                                   RTOL, ["w"])
    assert excused == 10 and worst == 1.0
    assert problems == ["w: 10 of 100 elements excused, more than 1 (1% of "
                        "the leaf, at least 1, for each of 1 flips)"]
    # one element a flip even where 1% of the leaf is less than one
    card[0][1:, 0] = 0.0
    assert _kinks.kink_witness(card, want, card, ATOL, RTOL, ["w"])[2] == []
    card[0][1, 0] = 1.0
    assert _kinks.kink_witness(card, want, card, ATOL, RTOL, ["w"],
                               n_flips=2)[2] == []
    assert len(_kinks.kink_witness(card, want, card, ATOL, RTOL,
                                   ["w"])[2]) == 1


def test_a_flip_far_from_zero_is_no_kink():
    cpu = [torch.tensor([[1.0, -3e-7]])]
    card = [torch.tensor([[1.0, 3e-7]])]        # 2.5 ulps of 1: a kink
    assert _kinks.flip_problems(_kinks.flips(card, cpu)) == []
    card = [torch.tensor([[1.0, 1e-3]])]
    (c, idx, a, b, u), = _kinks.flips(card, cpu)
    assert (c, idx) == (0, (0, 1)) and u > _kinks.KINK_ULPS
    assert len(_kinks.flip_problems([(c, idx, a, b, u)])) == 1
