"""The port on a CUDA card: the kernels this slice added against their
plain versions, the loader's side-stream staging and a short fit.

Every test is marked ``cuda`` and skips without a card. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
from repro_torch.kernels.spmm import csr_to_bcsr, spmm_bcsr_ref, spmm_bcsr_sym

# f32, TF32 off: kernel and plain version differ only in summation order
ATOL = RTOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("block", [1, 7, 16, 128])
@pytest.mark.parametrize("f", [40, 256])
def test_unfused_kernel_matches_plain_forward_and_backward(dev, block, f):
    n = 256
    a = sp.random(n, n, density=0.08, random_state=block, format="csr",
                  dtype=np.float32)
    a = (a + a.T).tocsr()
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    cols = torch.as_tensor(bc.tile_cols, device=dev)
    vals = torch.as_tensor(bc.tile_vals, device=dev)
    gen = torch.Generator(dev).manual_seed(block)
    xp = torch.randn((bc.num_cols, f), device=dev, generator=gen)
    g = torch.randn((bc.num_rows, f), device=dev, generator=gen)
    build.reset_launches()
    xt = xp.clone().requires_grad_(True)
    out = spmm_bcsr_sym(cols, vals, xt, impl="cuda_unfused")
    out.backward(g)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr_unfused"] == 2
    torch.testing.assert_close(out, spmm_bcsr_ref(cols, vals, xp),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(xt.grad, spmm_bcsr_ref(cols, vals, g),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [37, 100, 128])
def test_gather_kernel_matches_plain_and_zero_fills_bad_ids(dev, dtype, f):
    gen = torch.Generator(dev).manual_seed(f)
    table = torch.randn((300, f), device=dev, generator=gen).to(dtype)
    idx = torch.randint(0, 300, (1000,), device=dev, generator=gen,
                        dtype=torch.int32)
    build.reset_launches()
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert build.launches["gather_rows"] == 1
    assert torch.equal(got, gather_rows_ref(table, idx))
    bad = idx.clone()
    bad[::7] = -1
    bad[3::7] = 300
    got = gather_rows(table, bad)
    ok = (bad >= 0) & (bad < 300)
    assert torch.equal(got[ok], gather_rows_ref(table, bad[ok]))
    assert not bool((got[~ok] != 0).any())


def test_loader_stages_on_a_side_stream(dev):
    from repro_torch.data import PrefetchLoader
    batches = [{"x": np.full((64, 32), i, np.float32)} for i in range(5)]
    out = [b["x"].sum().item() for b in PrefetchLoader(batches, device=dev)]
    assert out == [64 * 32 * i for i in range(5)]


def test_short_fit_launches_the_kernel_on_every_aggregation(dev):
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train import GNNTrainer
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr", tune_blocks=(16, 32)))
    train, val = pipe.plan("train"), pipe.plan("val", for_inference=True)
    cfg = GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                    num_layers=2, dropout=0.3)
    build.reset_launches()
    res = GNNTrainer(cfg, backend="bcsr").fit(train, val, ds.num_classes,
                                              epochs=2)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr"] == \
        2 * (4 * len(train) + 2 * len(val))
    assert all(np.isfinite(h["train_loss"]) for h in res.history)
