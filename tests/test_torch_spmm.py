"""The port's block-CSR SpMM against the JAX package's.

The plain versions run here on the CPU; the JAX side runs its reference
and its fused Pallas kernel in interpret mode, as the JAX tests do. The
CUDA kernel runs only on a card: ``test_cuda_kernel_matches_plain`` is
marked ``cuda`` and skips without one (``chip_smoke.py`` holds the kernel
against the plain version at the main path's shapes)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.kernels.spmm import csr_to_bcsr as jax_csr_to_bcsr
from repro.kernels.spmm import spmm_bcsr as jax_spmm_bcsr
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build
from repro_torch.kernels.spmm import (
    csr_to_bcsr, spmm_bcsr, spmm_bcsr_ref, spmm_bcsr_stream, spmm_bcsr_sym)
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.serve import GNNInferenceEngine

# f32 on both sides; the sums run in another order (einsum/bmm against
# XLA's dot), and nothing on the CPU uses TF32
ATOL = RTOL = 1e-4


def _case(block, f, n=96, seed=0):
    a = sp.random(n, n, density=0.08, random_state=seed, format="csr",
                  dtype=np.float32)
    a = (a + a.T).tocsr()
    x = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("f", [40, 64, 128])
def test_plain_versions_match_jax(block, f):
    a, x = _case(block, f, seed=block + f)
    n = a.shape[0]
    ref = jax_csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    assert bc.tile_cols.tobytes() == ref.tile_cols.tobytes()
    assert bc.tile_vals.tobytes() == ref.tile_vals.tobytes()
    xp = np.zeros((bc.num_cols, f), np.float32)
    xp[:n] = x
    want = {impl: np.asarray(jax_spmm_bcsr(ref.tile_cols, ref.tile_vals, xp,
                                           impl=impl, block_f=128))
            for impl in ("reference", "fused_interpret")}
    cols, vals = torch.from_numpy(bc.tile_cols), torch.from_numpy(bc.tile_vals)
    for fn in (spmm_bcsr_ref, spmm_bcsr_stream):
        got = fn(cols, vals, torch.from_numpy(xp)).numpy()
        for w in want.values():
            np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(want["reference"][:n], a @ x, atol=ATOL,
                               rtol=RTOL)


def test_sym_backward_is_transpose():
    a, x = _case(16, 16, seed=3)
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=16)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm_bcsr_sym(torch.from_numpy(bc.tile_cols),
                        torch.from_numpy(bc.tile_vals), xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), a.T @ g, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), a @ x, atol=ATOL,
                               rtol=RTOL)


def test_cpu_tensors_take_plain_path_and_launch_nothing():
    a, x = _case(16, 40, seed=5)
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=16)
    build.reset_launches()
    got = spmm_bcsr(torch.from_numpy(bc.tile_cols),
                    torch.from_numpy(bc.tile_vals), torch.from_numpy(x))
    assert build.launches.get("spmm_bcsr", 0) == 0
    np.testing.assert_allclose(got.numpy(), a @ x, atol=ATOL, rtol=RTOL)


def _tiny_bcsr():
    bc = csr_to_bcsr(np.array([0, 1, 1]), np.array([1]),
                     np.array([1.0], np.float32), 2, 2, block=2)
    return (torch.from_numpy(bc.tile_cols), torch.from_numpy(bc.tile_vals),
            torch.ones((2, 3)))


@pytest.mark.parametrize("mutate, exc", [
    (lambda c, v, x: (c, v, x), ValueError),               # CPU tensors
    (lambda c, v, x: (c.long(), v, x), TypeError),
    (lambda c, v, x: (c, v.double(), x), TypeError),
    (lambda c, v, x: (c, v, x.double()), TypeError),
    (lambda c, v, x: (c, v, x[:1]), ValueError),           # rows % B
    (lambda c, v, x: (c, v[..., :1], x), ValueError),      # B != B
    (lambda c, v, x: (c, torch.zeros(1, 1, 129, 129), torch.zeros(129, 3)),
     ValueError),                                          # B > 128
], ids=["cpu", "cols-int64", "vals-f64", "x-f64", "x-rows", "tile-shape",
        "block-129"])
def test_cuda_impl_refuses_what_the_kernel_does_not_take(mutate, exc):
    build.reset_launches()
    with pytest.raises(exc):
        spmm_bcsr(*mutate(*_tiny_bcsr()), impl="cuda")
    assert build.launches.get("spmm_bcsr", 0) == 0


@pytest.mark.parametrize("entry", ["spmm_bcsr", "init_gnn", "params",
                                   "engine"])
def test_entry_points_refuse_cpu_without_device_argument(entry,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols, vals, _x = _tiny_bcsr()
    cfg = GNNConfig(in_dim=3, hidden=4, out_dim=2, num_layers=2)
    calls = {
        "spmm_bcsr": lambda: spmm_bcsr(cols.numpy(), vals.numpy(),
                                       np.ones((2, 3), np.float32)),
        "init_gnn": lambda: init_gnn(cfg, torch.Generator()),
        "params": lambda: params_from_jax({"layers": []}),
        "engine": lambda: GNNInferenceEngine(None, cfg, {"layers": []}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 7, 16, 128])
@pytest.mark.parametrize("f", [40, 256])
def test_cuda_kernel_matches_plain(block, f):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    a, x = _case(block, f, n=256, seed=block)
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    dev = torch.device("cuda")
    cols = torch.as_tensor(bc.tile_cols, device=dev)
    vals = torch.as_tensor(bc.tile_vals, device=dev)
    xp = torch.zeros((bc.num_cols, f), device=dev)
    xp[:n] = torch.as_tensor(x, device=dev)
    build.reset_launches()
    got = spmm_bcsr(cols, vals, xp)
    torch.cuda.synchronize()
    assert build.launches["spmm_bcsr"] == 1
    torch.testing.assert_close(got, spmm_bcsr_ref(cols, vals, xp),
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- unfused
# The port's impl="cuda_unfused" is the counterpart of the reference's
# impl="pallas" (spmm_bcsr_pallas), which runs here in interpret mode.

@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("f", [40, 128])
def test_plain_versions_match_jax_unfused_interpret(block, f):
    a, x = _case(block, f, seed=2 * block + f)
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    xp = np.zeros((bc.num_cols, f), np.float32)
    xp[:n] = x
    want = np.asarray(jax_spmm_bcsr(bc.tile_cols, bc.tile_vals, xp,
                                    impl="interpret", block_f=128))
    cols, vals = torch.from_numpy(bc.tile_cols), torch.from_numpy(bc.tile_vals)
    for impl in ("stream", "reference"):
        got = spmm_bcsr(cols, vals, torch.from_numpy(xp), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_sym_backward_matches_jax_interpret():
    import jax
    from repro.kernels.spmm import spmm_bcsr_sym as jax_spmm_bcsr_sym
    a, x = _case(16, 32, seed=7)
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=16)
    g = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: (jax_spmm_bcsr_sym(
        bc.tile_cols, bc.tile_vals, v, "interpret", 32) * g).sum())(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    spmm_bcsr_sym(torch.from_numpy(bc.tile_cols),
                  torch.from_numpy(bc.tile_vals), xt).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # the backward is the forward on the cotangent (A symmetric)
    fwd_on_g = spmm_bcsr(bc.tile_cols, bc.tile_vals, g, device="cpu")
    np.testing.assert_allclose(xt.grad.numpy(), fwd_on_g.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mutate, exc", [
    (lambda c, v, x: (c, v, x), ValueError),               # CPU tensors
    (lambda c, v, x: (c.long(), v, x), TypeError),
    (lambda c, v, x: (c, v, x.double()), TypeError),
    (lambda c, v, x: (c, v, x[:1]), ValueError),           # rows % B
    (lambda c, v, x: (c, torch.zeros(1, 1, 129, 129), torch.zeros(129, 3)),
     ValueError),                                          # B > 128
], ids=["cpu", "cols-int64", "x-f64", "x-rows", "block-129"])
def test_cuda_unfused_impl_refuses_what_the_kernel_does_not_take(mutate,
                                                                 exc):
    build.reset_launches()
    with pytest.raises(exc):
        spmm_bcsr(*mutate(*_tiny_bcsr()), impl="cuda_unfused")
    with pytest.raises(exc):
        c, v, x = mutate(*_tiny_bcsr())
        spmm_bcsr_sym(c, v, x.requires_grad_(x.is_floating_point()),
                      impl="cuda_unfused")
    assert build.launches.get("spmm_bcsr_unfused", 0) == 0


@pytest.mark.parametrize("r, k, b, f, sms", [
    (79, 67, 128, 256, 132), (79, 67, 128, 40, 132), (52, 44, 128, 40, 132),
    (52, 44, 128, 256, 132), (1, 1, 16, 8, 132), (3, 5, 16, 40, 132),
    (1, 67, 128, 40, 132), (2, 90, 128, 300, 132), (500, 90, 128, 256, 132),
    (79, 0, 128, 40, 132)])
def test_k_splits_cover_two_waves_without_empty_splits(r, k, b, f, sms):
    """The unfused kernel's K split: bound by the bytes of tile_vals, it
    takes the S whose bytes (values plus 2·(S−1) partials) over the share
    of SMs its blocks keep busy are least, among the splits with no empty
    range; S = 1 wherever the blocks cover the SMs (the main path's
    shapes, arxiv-like train and test batch 0 at F 40 and 256)."""
    from repro_torch.kernels.spmm.ops import k_splits
    s, per = k_splits(r, k, b, f, sms)
    assert s >= 1 and s * per >= k
    if not k:
        assert (s, per) == (1, 0)
        return
    assert (s - 1) * per < k                         # no empty split
    base = r * -(-b // 8) * -(-f // 256)

    def cost(t):
        return (r * k * b * b * 4 + 2 * (t - 1) * r * b * f * 4) / \
            min(1.0, base * t / sms)

    # every split with no empty range, per slots each
    achievable = {-(-k // p) for p in range(1, k + 1)}
    assert cost(s) <= min(cost(t) for t in achievable)
    if base >= sms:
        assert s == 1


# -------------------------------------------------- the kernels' arithmetic
# Both CUDA kernels (csrc/spmm_tile.cuh) multiply only the nonzero entries
# of each tile and sum them per output in (k, j) order: slot by slot, and
# within a slot by ascending column. This plain model of that arithmetic
# runs here and is held against the JAX package's reference.

def kernel_model(tile_cols, tile_vals, x):
    """out = A @ x summing, per output, only the nonzero entries in (k, j)
    order; column tiles outside [0, C) are skipped."""
    r, k, b, _ = tile_vals.shape
    c = x.shape[0] // b
    xt = x.reshape(c, b, -1)
    acc = torch.zeros((r, b, x.shape[1]), dtype=x.dtype)
    for s in range(k):
        col = tile_cols[:, s].long()
        live = (col >= 0) & (col < c)
        xs = xt[col.clamp(0, c - 1)]                 # (R, B, F)
        for j in range(b):
            v = tile_vals[:, s, :, j]                 # (R, B): column j
            nz = ((v != 0) & live[:, None])[..., None]
            acc = torch.where(nz, acc + v[..., None] * xs[:, None, j], acc)
    return acc.reshape(r * b, -1)


@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("f", [40, 128])
def test_kernel_model_matches_jax_reference(block, f):
    from repro.kernels.spmm.ref import spmm_bcsr_ref as jax_spmm_bcsr_ref
    a, x = _case(block, f, seed=3 * block + f)
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=block)
    xp = np.zeros((bc.num_cols, f), np.float32)
    xp[:n] = x
    want = np.asarray(jax_spmm_bcsr_ref(bc.tile_cols, bc.tile_vals, xp,
                                         bc.tile_cols.shape[0]))
    got = kernel_model(torch.from_numpy(bc.tile_cols),
                       torch.from_numpy(bc.tile_vals), torch.from_numpy(xp))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def tiny_plans():
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset
    pipe = IBMBPipeline(get_dataset("tiny"), IBMBConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32, backend="bcsr", tune_blocks=(16, 32)))
    return {"train": pipe.plan("train"),
            "test": pipe.plan("test", for_inference=True)}


@pytest.mark.parametrize("split", ["train", "test"])
def test_kernel_model_matches_jax_reference_on_real_batches(tiny_plans,
                                                            split):
    """Every bcsr batch of the tiny dataset's plans, its features as x."""
    from repro.kernels.spmm.ref import spmm_bcsr_ref as jax_spmm_bcsr_ref
    fields = tiny_plans[split].cache.fields
    for bi in range(len(tiny_plans[split])):
        cols, vals = fields["tile_cols"][bi], fields["tile_vals"][bi]
        x = fields["features"][bi]
        assert np.count_nonzero(vals) > 0
        want = np.asarray(jax_spmm_bcsr_ref(cols, vals, x, cols.shape[0]))
        got = kernel_model(torch.from_numpy(cols), torch.from_numpy(vals),
                           torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("where", ["read by an entry", "under padding"])
def test_kernel_model_spreads_nan_only_through_nonzero_entries(where):
    """A NaN row of x reaches exactly the output rows whose nonzero entries
    read it; every other output equals the dense result with that row
    zeroed. The dense plain version also spreads it through the zeros of
    every tile, and padding slots (column tile 0), that cover the row."""
    a, x = _case(16, 8, seed=11)
    a = a.tolil()
    a[0, :] = 0                    # x row 0 (column tile 0) is read by no
    a[:, 0] = 0                    # entry; padding slots point at tile 0
    a = a.tocsr()
    a.eliminate_zeros()
    n = a.shape[0]
    bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=16) \
        .with_pad_k(8)
    dense = a.toarray()
    xp = np.zeros((bc.num_cols, 8), np.float32)
    xp[:n] = x
    p = int(np.flatnonzero(dense.any(axis=0))[0]) \
        if where == "read by an entry" else 0
    readers = np.zeros(bc.num_rows, bool)
    readers[:n] = dense[:, p] != 0
    xn, xz = xp.copy(), xp.copy()
    xn[p], xz[p] = np.nan, 0.0
    cols, vals = torch.from_numpy(bc.tile_cols), torch.from_numpy(bc.tile_vals)
    got = kernel_model(cols, vals, torch.from_numpy(xn)).numpy()
    assert (np.isnan(got).all(axis=1) == readers).all()
    assert not np.isnan(got[~readers]).any()
    want = spmm_bcsr_ref(cols, vals, torch.from_numpy(xz)).numpy()
    np.testing.assert_allclose(got[~readers], want[~readers], atol=ATOL,
                               rtol=RTOL)
    dense_nan = np.isnan(spmm_bcsr_ref(cols, vals, torch.from_numpy(xn))
                         .numpy()).any(axis=1)
    assert dense_nan.sum() > readers.sum()
