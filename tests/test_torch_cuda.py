"""The port on a CUDA card: the kernels against their plain versions, the
loader's side-stream staging, a short fit, and the LM's prefill and
serving through the flash-attention kernel.

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
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
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


# ---------------------------------------------------------- flash attention
def _bshd(gen, shape, dtype, dev):
    """(B, S, heads, D) viewed as (B, heads, S, D), as the LM passes it."""
    return torch.randn(shape, device=dev, generator=gen).to(dtype) \
        .transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 64),
                                           (True, 5000), (False, 5000)])
@pytest.mark.parametrize("s,d,g", [(200, 64, 4), (333, 128, 1),
                                   (64, 64, 8), (1, 64, 1), (63, 128, 2),
                                   (65, 64, 1), (127, 128, 4), (129, 64, 2),
                                   (4095, 64, 4), (4095, 128, 1)])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_kernel_matches_plain(dev, dtype, causal, window, s, d, g,
                                    layout):
    """Against the plain version on f32 copies of the same inputs: f32
    differs in summation order only; bf16 adds one rounding of each output
    (at most 2^-8 of its size), since the kernel accumulates in f32.
    Lengths on both sides of the 64- and 128-key tiles, a window longer
    than S, (B, S, heads, D) buffers as transposed views and contiguous
    (B, heads, S, D) tensors."""
    gen = torch.Generator(dev).manual_seed(s)
    if layout == "bshd":
        q = _bshd(gen, (2, s, 2 * g, d), dtype, dev)
        k, v = (_bshd(gen, (2, s, 2, d), dtype, dev) for _ in range(2))
    else:
        q = torch.randn((2, 2 * g, s, d), device=dev, generator=gen) \
            .to(dtype)
        k, v = (torch.randn((2, 2, s, d), device=dev, generator=gen)
                .to(dtype) for _ in range(2))
    build.reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == 1
    assert got.stride() == q.stride() and got.dtype == dtype
    limit = ATOL + (2 ** -8 * want.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((got.float() - want).abs() <= limit).all())


def _lm_cfg():
    """A narrow llama-like config with the kernel's head dim."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("llama3.2-1b"), d_model=256,
                               num_heads=4, num_kv_heads=2, head_dim=64)


def test_lm_prefill_launches_once_per_layer_and_matches_cpu(dev):
    from repro_torch.models.lm import head_logits, init_params, lm_forward
    from repro_torch.optim import tree_map
    cfg = _lm_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 77)), device=dev)
    build.reset_launches()
    with torch.no_grad():
        got = head_logits(cfg, params, lm_forward(cfg, params, toks)[:, -1])
        torch.cuda.synchronize()
        assert build.launches["flash_attention"] == cfg.num_layers
        cpu = tree_map(lambda t: t.cpu(), params)
        want = head_logits(cfg, cpu, lm_forward(cfg, cpu, toks.cpu())[:, -1])
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)


def test_serve_engine_on_the_card_matches_cpu_tokens(dev):
    from repro_torch.models.lm import init_params
    from repro_torch.optim import tree_map
    from repro_torch.serve import Request, ServeEngine
    cfg = _lm_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(1), dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
               for _ in range(5)]
    out = {}
    for where, p in (("cuda", params),
                     ("cpu", tree_map(lambda t: t.cpu(), params))):
        reqs = [Request(prompt=pr, max_new_tokens=4) for pr in prompts]
        stats = ServeEngine(cfg, p, num_slots=2, max_len=64,
                            device=where).run(reqs)
        assert stats["completed"] == 5
        out[where] = [r.out_tokens for r in reqs]
    assert out["cuda"] == out["cpu"]


def test_flash_kernel_refuses_bf16_strides_tma_cannot_read(dev):
    """bf16 reads through TMA: a sequence stride of 68 values (136 bytes)
    is refused with a clear error, never launched."""
    q = torch.zeros((1, 2, 16, 68), device=dev,
                    dtype=torch.bfloat16)[..., :64]
    k = v = torch.zeros((1, 2, 16, 64), device=dev, dtype=torch.bfloat16)
    build.reset_launches()
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, k, v)
    assert build.launches.get("flash_attention", 0) == 0
    assert flash_attention(q.contiguous(), k, v).shape == q.shape


def test_flash_kernel_refuses_grad(dev):
    q = torch.zeros((1, 2, 16, 64), device=dev, requires_grad=True)
    k = v = torch.zeros((1, 2, 16, 64), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
