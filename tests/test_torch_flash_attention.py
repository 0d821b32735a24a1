"""The port's plain attention (``attention_ref``, ``chunked_attention``)
against the JAX package's: ``flash_attention(impl="reference")``, the Pallas
kernel in interpret mode, and the XLA ``chunked_attention``. Inputs come
from numpy seeds; f32 on both sides. The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here a plain-torch model of the bf16 kernel's
arithmetic is held against the JAX reference."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.lm.attention import chunked_attention as jax_chunked
from repro.models.lm.attention import pick_chunk as jax_pick_chunk
from repro_torch.kernels.flash_attention import (
    attention_ref, chunked_attention, flash_attention, pick_chunk)

# f32 everywhere: the two packages differ in summation order only. The
# reference's own interpret-vs-reference test holds 2e-5.
ATOL = 2e-5


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 64), (2, 4, 256, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 64])
def test_attention_ref_matches_jax_reference_and_interpret(b, h, s, d,
                                                           causal, window):
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, (b, h, s, d)) for _ in range(3))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal, window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, causal=causal, window=window,
                    impl="reference")
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
    interp = jax_flash(jq, jk, jv, causal=causal, window=window,
                       impl="interpret", block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.asarray(interp), atol=ATOL)


@pytest.mark.parametrize("s", [128, 200, 255])
@pytest.mark.parametrize("kv,g", [(2, 1), (2, 4), (1, 8)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0), (False, 48)])
def test_gqa_attention_ref_maps_head_h_to_kv_head_h_over_g(s, kv, g, causal,
                                                           window):
    """GQA in the port's plain version equals the reference's attention on
    K/V expanded to H heads (query head h reads kv head h // G), odd S
    included."""
    rng = np.random.default_rng(s + g)
    d = 32
    q = _normal(rng, (2, kv * g, s, d))
    k, v = (_normal(rng, (2, kv, s, d)) for _ in range(2))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal, window=window).numpy()
    ke, ve = (jnp.repeat(jnp.asarray(a), g, axis=1) for a in (k, v))
    want = jax_flash(jnp.asarray(q), ke, ve, causal=causal, window=window,
                     impl="reference")
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("s,chunk", [(256, 64), (200, 64), (4095 // 15, 64),
                                     (96, 1024)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_attention_matches_jax(s, chunk, causal, window, softcap):
    rng = np.random.default_rng(5)
    b, h, kv, d = 2, 8, 2, 32
    q = _normal(rng, (b, s, h, d))
    k, v = (_normal(rng, (b, s, kv, d)) for _ in range(2))
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window, chunk_k=chunk,
                            softcap=softcap).numpy()
    want = jax_chunked(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                       window=window, chunk_k=chunk, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_chunked_attention_equals_attention_ref_in_the_kernels_layout():
    """The two plain versions compute one function: (B, S, H, D) through
    the chunked scan equals (B, H, S, D) views through attention_ref."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_normal(rng, (1, 200, 8, 64)))
    k, v = (torch.from_numpy(_normal(rng, (1, 200, 2, 64)))
            for _ in range(2))
    got = chunked_attention(q, k, v, causal=True, chunk_k=64)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,target", [(4096, 1024), (4095, 1024),
                                      (4352, 1024), (7, 4), (1, 8),
                                      (97, 16)])
def test_pick_chunk_matches_jax(s, target):
    assert pick_chunk(s, target) == jax_pick_chunk(s, target)


def test_bf16_plain_version_accumulates_in_f32():
    """bf16 inputs: the plain version computes in f32 and rounds once, so
    it is the f32 result rounded to bf16 (the kernel's contract)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 2, 128, 64)))
               .to(torch.bfloat16) for _ in range(3))
    got = attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    want = attention_ref(q.float(), k.float(), v.float())
    assert torch.equal(got, want.to(torch.bfloat16))


def test_wrapper_dispatch_on_the_cpu():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 4, 64, 64)))
               for _ in range(3))
    assert torch.equal(flash_attention(q, k, v),
                       attention_ref(q, k, v))
    assert torch.equal(flash_attention(q, k, v, causal=False, window=16,
                                       impl="reference"),
                       attention_ref(q, k, v, causal=False, window=16))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_takes_head_dim_256(dtype):
    """D = 256 (recurrentgemma's local layers) passes every check of the
    wrapper but the device's: a CPU tensor is refused as such."""
    q = torch.zeros((1, 10, 16, 256), dtype=dtype)
    k = v = torch.zeros((1, 1, 16, 256), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k, v, window=8, impl="cuda")


@pytest.mark.parametrize("bad,match", [
    (dict(d=32), "head dims"), (dict(d=192), "head dims"),
    (dict(kv=3), "do not fit"),
    (dict(dtype=torch.float16), "takes one of"),
    (dict(grad=True), "no backward")])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    d, kv = bad.get("d", 64), bad.get("kv", 2)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros((1, 4, 16, d), dtype=dtype,
                    requires_grad=bad.get("grad", False))
    k = v = torch.zeros((1, kv, 16, d), dtype=dtype)
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        flash_attention(q, k, v, impl="cuda")


# ------------------------------------------- the bf16 kernel's arithmetic
# The bf16 path is held elementwise to one bf16 rounding of the f32 result
# (chip_smoke.py, tests/test_torch_cuda.py): |got - want| <= 1e-4 +
# 2^-8·|want|.
BF16_ATOL, BF16_REL = 1e-4, 2 ** -8


def _kernel_model(q, k, v, causal, window, split_p=True):
    """What ``flash_fwd_wgmma`` computes, in plain torch on the CPU: bf16
    q (B, H, S, D) and k, v (B, KV, S, D); per block of 128 query rows (64
    at D = 256) the K/V tiles (128 keys, 64 at D = 128 and 256) that the
    TPU kernel's block skip leaves; f32
    scores scaled by D^-0.5·log2(e) into the log2 domain, -1e30 where
    masked; an online softmax with exp2; P·V as P_hi·V + P_lo·V with P_hi
    = bf16(P), P_lo = bf16(P - P_hi) (``split_p=False``: P rounded once
    to bf16); the row sum from the f32 P; one rounding of the output."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, dim=1) for t in (k, v))
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    bq, bk = 64 if d == 256 else 128, 128 if d == 64 else 64
    nk = -(-s // bk)
    out = torch.empty((b, h, s, d), dtype=torch.float32)
    for q0 in range(0, s, bq):
        rows = torch.arange(q0, min(q0 + bq, s))
        t_end = min(nk, (q0 + bq - 1) // bk + 1) if causal else nk
        x = q0 - window - bk + 1
        t_begin = x // bk + 1 if window > 0 and x >= 0 else 0
        m = torch.full((b, h, rows.numel()), -1e30)
        l = torch.zeros((b, h, rows.numel()))
        acc = torch.zeros((b, h, rows.numel(), d))
        for t in range(t_begin, t_end):
            cols = torch.arange(t * bk, min(t * bk + bk, s))
            sc = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2) * c
            ok = torch.ones((rows.numel(), cols.numel()), dtype=torch.bool)
            if causal:
                ok &= cols[None, :] <= rows[:, None]
            if window > 0:
                ok &= cols[None, :] > rows[:, None] - window
            sc = torch.where(ok, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vf[:, :, cols]
            if split_p:
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, cols]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(torch.bfloat16)


def _bf16_case(seed, s, d, g, kv=2):
    """bf16-exact f32 numpy inputs: q (1, kv·g, S, D), k and v (1, kv, S,
    D), normal as in chip_smoke.py."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (1, kv * g, s, d))
    k, v = (_normal(rng, (1, kv, s, d)) for _ in range(2))
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                 for a in (q, k, v))


def _worst_over_limit(q, k, v, causal, window, split_p=True):
    """The model against JAX's ``flash_attention(impl="reference")`` on
    the same (bf16-exact) inputs, K/V expanded to H heads: the largest
    |error| / (1e-4 + 2^-8·|want|)."""
    g = q.shape[1] // k.shape[1]
    got = _kernel_model(*(torch.from_numpy(a).to(torch.bfloat16)
                          for a in (q, k, v)), causal, window, split_p)
    ke, ve = (jnp.repeat(jnp.asarray(a), g, axis=1) for a in (k, v))
    want = np.asarray(jax_flash(jnp.asarray(q), ke, ve, causal=causal,
                                window=window, impl="reference"))
    err = np.abs(got.float().numpy() - want)
    assert np.isfinite(err).all()
    return float((err / (BF16_ATOL + BF16_REL * np.abs(want))).max())


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 65, 200, 1024])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 64)])
def test_bf16_kernel_arithmetic_is_within_one_rounding(causal, window, s, d,
                                                       g):
    """The bf16 kernel's arithmetic (split P, exp2 with the folded scale,
    the -1e30 sentinel, the block skip, the kernel's tiles) stays within one
    bf16 rounding of the f32 reference, the limit the card holds it to."""
    q, k, v = _bf16_case(s + d + g, s, d, g)
    assert _worst_over_limit(q, k, v, causal, window) <= 1.0


@pytest.mark.parametrize("g", [1, 10])
@pytest.mark.parametrize("s", [65, 200, 1024])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 512), (False, 64)])
def test_bf16_kernel_arithmetic_at_head_dim_256_is_within_one_rounding(
        causal, window, s, g):
    """The head-dim-256 instantiation (blocks of 64 query rows, K/V tiles
    of 64 keys), with recurrentgemma's 10 query heads over one kv head."""
    q, k, v = _bf16_case(s + g, s, 256, g, kv=1)
    assert _worst_over_limit(q, k, v, causal, window) <= 1.0


def test_rounding_p_once_to_bf16_breaks_the_limit():
    """Why the kernel splits P: rounded once to bf16, as a plain bf16
    P·V product would take it, P misses the one-rounding limit several
    times over on the same inputs that the split keeps within it."""
    q, k, v = _bf16_case(7, 1024, 64, 4)
    assert _worst_over_limit(q, k, v, True, 0) <= 1.0
    assert _worst_over_limit(q, k, v, True, 0, split_p=False) > 2.0


@pytest.mark.parametrize("bad", ["stride", "offset"])
def test_bf16_wrapper_refuses_strides_tma_cannot_read(bad):
    """bf16 goes through TMA, which wants a 16-byte-aligned start and
    strides that are multiples of 16 bytes: anything else is refused
    before the kernel (and before the device check); f32 is not bound by
    it."""
    if bad == "stride":       # rows of 68 values: 136 bytes apart
        base = torch.zeros((1, 4, 16, 68))
        q = base.to(torch.bfloat16)[..., :64]
        q32 = base[..., :64]
    else:                     # starts one value (2 bytes) in
        base = torch.zeros(1 + 4 * 16 * 64)
        q = base.to(torch.bfloat16)[1:].view(1, 4, 16, 64)
        q32 = base[1:].view(1, 4, 16, 64)
    k = v = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q32, k.float(), v.float(), impl="cuda")
