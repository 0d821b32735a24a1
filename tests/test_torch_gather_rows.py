"""The port's row gather against the JAX package's Pallas kernel, which runs
here in interpret mode as ``tests/test_kernels.py`` runs it. The CUDA kernel
runs only on a card: its tests are in ``tests/test_torch_cuda.py``, and
``chip_smoke.py`` holds it against the plain version at the main path's
shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_rows import gather_rows as jax_gather_rows
from repro_torch.kernels import build
from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
from repro_torch.kernels.gather_rows.ops import unit_bytes


def _case(n, f, m, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=m).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [128, 256])
def test_matches_jax_interpret(dtype, f):
    table, idx = _case(64, f, 37, seed=f)
    want = np.asarray(jax_gather_rows(
        jnp.asarray(table, dtype=getattr(jnp, dtype)), jnp.asarray(idx),
        impl="interpret", block_f=128).astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    build.reset_launches()
    got = gather_rows(tt, torch.from_numpy(idx))
    assert build.launches.get("gather_rows", 0) == 0    # plain path on CPU
    assert got.dtype == tt.dtype
    # a copy: bit-identical to the reference in either type
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_plain_version_raises_on_out_of_range_index():
    table, _ = _case(8, 4, 1, seed=0)
    with pytest.raises(IndexError):
        gather_rows_ref(torch.from_numpy(table), torch.tensor([8],
                                                              dtype=torch.int32))


@pytest.mark.parametrize("row_bytes, addrs, want", [
    (400, (0, 256), 16),       # f32, F=100: 16-byte vectors
    (200, (0, 256), 8),        # bf16, F=100
    (148, (0, 256), 4),        # f32, F=37
    (74, (0, 256), 2),         # bf16, F=37
    (512, (0, 8), 8),          # an 8-byte-aligned pointer caps the unit
    (3, (0, 0), 1),
])
def test_unit_bytes_is_the_widest_that_divides_row_and_addresses(
        row_bytes, addrs, want):
    assert unit_bytes(row_bytes, *addrs) == want


@pytest.mark.parametrize("mutate, exc", [
    (lambda t, i: (t, i), ValueError),                      # CPU tensors
    (lambda t, i: (t.double(), i), TypeError),
    (lambda t, i: (t, i.long()), TypeError),
    (lambda t, i: (t[0], i), ValueError),                   # table 1-D
], ids=["cpu", "table-f64", "idx-int64", "table-1d"])
def test_cuda_impl_refuses_what_the_kernel_does_not_take(mutate, exc):
    table, idx = _case(8, 4, 3, seed=1)
    build.reset_launches()
    with pytest.raises(exc):
        gather_rows(*mutate(torch.from_numpy(table), torch.from_numpy(idx)),
                    impl="cuda")
    assert build.launches.get("gather_rows", 0) == 0


def test_unknown_impl_raises():
    table, idx = _case(8, 4, 3, seed=2)
    with pytest.raises(ValueError, match="unknown impl"):
        gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                    impl="pallas")
