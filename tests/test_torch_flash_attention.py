"""The port's plain attention (``attention_ref``, ``chunked_attention``)
against the JAX package's: ``flash_attention(impl="reference")``, the Pallas
kernel in interpret mode, and the XLA ``chunked_attention``. Inputs come
from numpy seeds; f32 on both sides. The CUDA kernel itself is held against
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
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


@pytest.mark.parametrize("bad,match", [
    (dict(d=32), "head dims"), (dict(kv=3), "do not fit"),
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
