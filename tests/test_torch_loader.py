"""The port's PrefetchLoader: order, its up-front order check, shutdown on
early exit, worker errors surfacing in the consumer, and its refusals.
It stages on the CPU here (``device="cpu"``); the side-stream staging on a
card runs in ``chip_smoke.py``'s train phase."""
import gc
import threading

import numpy as np
import pytest
import torch

from repro.data.loader import PrefetchLoader as JaxLoader
from repro_torch.data import PrefetchLoader, stage_batch
from repro_torch.faults import FaultInjector, InjectedFault


def _batches(n=6):
    return [{"x": np.full((3, 2), i, np.float32),
             "idx": np.arange(4, dtype=np.int32) + i} for i in range(n)]


def test_yields_tensors_in_order():
    order = np.array([3, 0, 5, 1])
    got = [int(b["x"][0, 0]) for b in
           PrefetchLoader(_batches(), order, device="cpu")]
    assert got == [3, 0, 5, 1]
    ref = [int(np.asarray(b["x"])[0, 0]) for b in JaxLoader(_batches(),
                                                            order)]
    assert got == ref


def test_staged_batches_are_tensors_on_the_device():
    b = next(iter(PrefetchLoader(_batches(2), device="cpu")))
    assert all(torch.is_tensor(v) and v.device.type == "cpu"
               for v in b.values())
    assert b["idx"].dtype == torch.int32


@pytest.mark.parametrize("order", [[0, 6], [-1, 2]], ids=["past-end",
                                                          "negative"])
def test_order_outside_the_container_is_refused_up_front(order):
    with pytest.raises(IndexError, match="different"):
        PrefetchLoader(_batches(), np.array(order), device="cpu")
    with pytest.raises(IndexError, match="different"):
        JaxLoader(_batches(), np.array(order))


def test_early_break_joins_the_worker():
    loader = PrefetchLoader(_batches(50), device="cpu")
    for i, _ in enumerate(loader):
        if i == 2:
            break
    loader._worker.join(timeout=5.0)
    assert not loader._worker.is_alive()


def test_abandoned_iterator_joins_the_worker_on_gc():
    loader = PrefetchLoader(_batches(50), device="cpu")
    it = iter(loader)
    next(it)
    del it
    gc.collect()
    loader._worker.join(timeout=5.0)
    assert not loader._worker.is_alive()


def test_worker_exception_surfaces_in_the_consumer():
    class Boom(list):
        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("disk on fire")
            return super().__getitem__(i)

    loader = PrefetchLoader(Boom(_batches()), device="cpu")
    seen = []
    with pytest.raises(RuntimeError, match="disk on fire"):
        for b in loader:
            seen.append(int(b["x"][0, 0]))
    assert seen == [0, 1]
    assert isinstance(loader.failed, RuntimeError)
    loader._worker.join(timeout=5.0)
    assert not loader._worker.is_alive()


def test_injected_loader_fault_surfaces_like_the_reference():
    got, want = [], []
    with pytest.raises(InjectedFault):
        for b in PrefetchLoader(_batches(), device="cpu",
                                faults=FaultInjector(script={"loader": [3]})):
            got.append(int(b["x"][0, 0]))
    import repro.faults as jf
    with pytest.raises(jf.InjectedFault):
        for b in JaxLoader(_batches(),
                           faults=jf.FaultInjector(script={"loader": [3]})):
            want.append(int(np.asarray(b["x"])[0, 0]))
    assert got == want == [0, 1, 2]


def test_reusable_after_early_exit():
    loader = PrefetchLoader(_batches(5), device="cpu")
    for _ in loader:
        break
    assert [int(b["x"][0, 0]) for b in loader] == [0, 1, 2, 3, 4]
    assert threading.active_count() < 50


def test_group_waits_for_the_data_parallel_slice():
    """The data-parallel slice has landed: ``group=`` stages super-steps
    (the reference's semantics; tests/test_torch_data_parallel.py holds
    them to the reference's loader)."""
    steps = list(PrefetchLoader(_batches(5), group=2, device="cpu"))
    assert [s[0]["x"][:, 0, 0].tolist() for s in steps] == \
        [[0.0, 1.0], [2.0, 3.0], [4.0, 4.0]]
    assert [s[1].tolist() for s in steps] == [[1, 1], [1, 1], [1, 0]]


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(_batches())


def test_cpu_staging_records_no_event():
    batch, done = stage_batch(_batches(1)[0], torch.device("cpu"))
    assert done is None and batch["x"].shape == (3, 2)
