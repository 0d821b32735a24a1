"""The port builds the same Plan as the JAX package, bit for bit, and the
two packages read each other's saved plans."""
import dataclasses

import numpy as np
import pytest

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.core.plan import Plan as JaxPlan
from repro.graph.datasets import get_dataset as jax_dataset
from repro_torch.core import IBMBConfig, IBMBPipeline, Plan, check_routing
from repro_torch.graph.datasets import get_dataset

# segment, and bcsr with the tile-size sweep the autotuner can retile to
CONFIGS = {
    "segment": dict(backend="segment"),
    "bcsr-tuned": dict(backend="bcsr", tune_blocks=(16, 32)),
}
_BASE = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
             pad_multiple=32)


def _plans(name, split="test", for_inference=True):
    kw = dict(_BASE, **CONFIGS[name])
    ref = JaxPipeline(jax_dataset("tiny"), JaxConfig(**kw)).plan(
        split, for_inference=for_inference)
    port = IBMBPipeline(get_dataset("tiny"), IBMBConfig(**kw)).plan(
        split, for_inference=for_inference)
    return ref, port


def _assert_same_plan(ref, port):
    assert port.fingerprint == ref.fingerprint
    assert sorted(port.cache.fields) == sorted(ref.cache.fields)
    for k, v in ref.cache.fields.items():
        got = port.cache.fields[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k
    assert port.cache.meta == ref.cache.meta
    for f in ("node_ids", "batch", "row"):
        assert np.array_equal(getattr(port.routing, f),
                              getattr(ref.routing, f)), f
    assert np.array_equal(port.schedule, ref.schedule)
    assert np.array_equal(port.node_ids, ref.node_ids)
    assert np.array_equal(port.batch_backend, ref.batch_backend)
    assert np.array_equal(port.batch_block_f, ref.batch_block_f)
    assert port.meta == ref.meta
    assert (port.version, port.parent) == (ref.version, ref.parent)
    for f in ("roots", "indices", "values"):
        assert np.array_equal(getattr(port.ppr, f), getattr(ref.ppr, f)), f


def test_config_fields_and_defaults_match():
    assert dataclasses.asdict(IBMBConfig()) == dataclasses.asdict(
        JaxConfig())


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("split, for_inference",
                         [("test", True), ("train", False)])
def test_plan_bitwise_equal(name, split, for_inference):
    ref, port = _plans(name, split, for_inference)
    _assert_same_plan(ref, port)
    check_routing(port)


def test_bcsr_plan_is_retiled_and_decided():
    _ref, port = _plans("bcsr-tuned")
    assert port.cache.fields["tile_vals"].shape[-1] in (16, 32)
    assert set(port.batch_backends()) <= {"bcsr", "segment"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_saved_plans_load_across_packages(name, tmp_path):
    ref, port = _plans(name)
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "ref.npz"))
    _assert_same_plan(JaxPlan.load(str(tmp_path / "port.npz"),
                                   expect_fingerprint=ref.fingerprint), port)
    _assert_same_plan(ref, Plan.load(str(tmp_path / "ref.npz"),
                                     expect_fingerprint=port.fingerprint))


def test_load_plan_refuses_other_config(tmp_path):
    ref, _port = _plans("segment")
    ref.save(str(tmp_path / "ref.npz"))
    other = IBMBPipeline(get_dataset("tiny"),
                         IBMBConfig(**dict(_BASE, **CONFIGS["bcsr-tuned"])))
    from repro_torch.core import PlanFormatError
    with pytest.raises(PlanFormatError):
        other.load_plan(str(tmp_path / "ref.npz"), "test",
                        for_inference=True)
