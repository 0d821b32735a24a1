"""The port's LM layer types and frontends against the JAX package: the
local (sliding-window) mixer, MLA, MoE, RG-LRU and RWKV6 module by module,
then every SMOKE config's prefill logits and 16 decode steps, the
parameter and cache trees of all ten architectures, their parameter
counts, the init rules of the new leaves, and the three faults of the
reference that the port reproduces (ROADMAP Queue 3). Inputs come from
numpy seeds and weights are carried by ``lm_params_from_jax``; f32 on the
CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models.lm import attention as jattn
from repro.models.lm import model as jmodel
from repro.models.lm import moe as jmoe
from repro.models.lm import rglru as jrglru
from repro.models.lm import rwkv as jrwkv
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import (
    cache_shapes, decode_step, head_logits, init_cache, init_params,
    lm_forward, param_shapes)
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import moe
from repro_torch.models.lm import rglru
from repro_torch.models.lm import rwkv

# f32 on both sides; the packages differ in summation order only
ATOL = RTOL = 1e-4
# the archs the dense-GQA tests of test_torch_lm.py do not cover
NEW_ARCHS = [a for a in ARCH_IDS if a not in ("llama3.2-1b", "qwen2-1.5b")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=ATOL, rtol=RTOL)


def _layer(jparams, stage, name, sub="mixer"):
    """Layer 0 of a stacked stage's ``layer{name}`` subtree, as numpy
    (JAX side) and as the port's tensors."""
    jp = {k: np.asarray(v)[0] for k, v in
          jparams["stages"][stage][name][sub].items()}
    return jp, {k: _t(v) for k, v in jp.items()}


def _jit(fn, cfg, **kw):
    """A reference decode function, compiled once for its config."""
    return jax.jit(lambda *a: fn(cfg, *a, **kw))


def _x(cfg, b=2, s=24, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, cfg.d_model)) * scale).astype(np.float32)


# the matrices applied as x @ w (fan-in on their second-to-last axis)
_MATMULS = {"wq", "wk", "wv", "wo", "wkv_a", "wk_b", "wv_b", "wq_a", "wq_b",
            "router", "we_in", "we_gate", "we_out", "sh_in", "sh_gate",
            "sh_out", "w_main", "w_gate", "w_out", "wa", "wi", "lora_a",
            "lora_b", "wa_w", "wb_w", "wr", "wg", "ck", "cv", "cr", "w_in",
            "proj"}


def _fan_in_scaled(tree):
    """The reference's init with every layer matrix scaled by fan_in ** -0.5
    (its init draws std repeat ** -0.5, 1 for a SMOKE stage of one layer,
    whose outputs reach the hundreds, where 1e-4 is below f32's own
    resolution)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * np.float32(a.shape[-2] ** -0.5)
        if str(path[-1].key) in _MATMULS and "stages" in str(path[0])
        else a, tree)


@pytest.fixture(scope="module")
def jparams():
    """The reference's init of each SMOKE config (layer matrices at std
    fan_in ** -0.5), one per arch and config change."""
    cache = {}

    def get(arch, **replace):
        key = (arch, tuple(sorted(replace.items())))
        if key not in cache:
            jcfg = dataclasses.replace(jax_get_smoke(arch), **replace)
            cache[key] = (jcfg, _fan_in_scaled(_np(jmodel.init_params(
                jcfg, jax.random.PRNGKey(0)))))
        return cache[key]
    return get


# ------------------------------------------------------------- local mixer
@pytest.mark.parametrize("s", [24, 32, 128])
def test_sliding_window_attention_matches_jax(s):
    """S < W and S = W (the degenerate plain-causal case) and S = 4·W (the
    neighbour-chunk pairing), GQA 4 over 1 kv head."""
    rng = np.random.default_rng(s)
    w, h, kv, d = 32, 4, 1, 16
    q = rng.normal(size=(2, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, kv, d)).astype(np.float32)
            for _ in range(2))
    got = attn.sliding_window_attention(_t(q), _t(k), _t(v), w)
    want = jattn.sliding_window_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), w)
    _close(got, want)


def test_sliding_window_refuses_what_the_reference_refuses():
    """S > W must be a multiple of W (the reference asserts it)."""
    q = torch.zeros((1, 40, 2, 8))
    with pytest.raises(ValueError, match="multiple of the window"):
        attn.sliding_window_attention(q, q[:, :, :1], q[:, :, :1], 32)
    with pytest.raises(AssertionError):
        jattn.sliding_window_attention(jnp.zeros((1, 40, 2, 8)),
                                       jnp.zeros((1, 40, 1, 8)),
                                       jnp.zeros((1, 40, 1, 8)), 32)


@pytest.mark.parametrize("s", [16, 64])
def test_local_mixer_forward_and_decode_match_jax(jparams, s):
    """recurrentgemma's local layer (layer 2 of its superblock): prefill on
    both sides of the window, then 40 decode steps through the ring
    cache."""
    jcfg, jp = jparams("recurrentgemma-2b")
    cfg = get_smoke_config("recurrentgemma-2b")
    jmix, mix = _layer(jp, 0, "layer2")
    x = _x(cfg, s=s, seed=s)
    pos = np.arange(s)
    got = attn.gqa_forward(cfg, mix, _t(x), _t(pos), window=cfg.window)
    want = jattn.gqa_forward(jcfg, jmix, jnp.asarray(x), jnp.asarray(pos),
                             window=jcfg.window)
    _close(got, want)
    shape = attn.gqa_cache_shape(cfg, 2, 64, window=cfg.window)
    cache = {k: torch.zeros(v) for k, v in shape.items()}
    jcache = {k: jnp.zeros(v) for k, v in shape.items()}
    jstep = _jit(jattn.gqa_decode, jcfg, window=jcfg.window)
    for t in range(40):
        xt = _x(cfg, s=1, seed=100 + t)
        out, _ = attn.gqa_decode(cfg, mix, _t(xt), cache, t,
                                 window=cfg.window)
        jout, jcache = jstep(jmix, jnp.asarray(xt), jcache, jnp.int32(t))
        _close(out, jout)


def test_local_layer_softcap_asymmetry_is_the_reference_s(jparams):
    """Reference fault (ROADMAP Queue 3): a local layer's prefill applies
    no logit softcap and its decode does. With a softcap of 1.0 the two
    compute different functions; the port matches the reference in
    each."""
    jcfg, jp = jparams("recurrentgemma-2b", logit_softcap=1.0)
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              logit_softcap=1.0)
    jmix, mix = _layer(jp, 0, "layer2")
    s = 12
    x = _x(cfg, s=s, seed=9, scale=3.0)
    pos = np.arange(s)
    pre = attn.gqa_forward(cfg, mix, _t(x), _t(pos), window=cfg.window)
    _close(pre, jattn.gqa_forward(jcfg, jmix, jnp.asarray(x),
                                  jnp.asarray(pos), window=jcfg.window))
    shape = attn.gqa_cache_shape(cfg, 2, s, window=cfg.window)
    cache = {k: torch.zeros(v) for k, v in shape.items()}
    jcache = {k: jnp.zeros(v) for k, v in shape.items()}
    jstep = _jit(jattn.gqa_decode, jcfg, window=jcfg.window)
    for t in range(s):
        out, _ = attn.gqa_decode(cfg, mix, _t(x[:, t:t + 1]), cache, t,
                                 window=cfg.window)
        jout, jcache = jstep(jmix, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.int32(t))
        _close(out, jout)
    gap = (out[:, 0] - pre[:, -1]).abs().max().item()
    assert gap > 100 * ATOL, gap
    # with the softcap at 0 the two agree
    cfg0 = dataclasses.replace(cfg, logit_softcap=0.0)
    cache = {k: torch.zeros(v) for k, v in shape.items()}
    for t in range(s):
        out0, _ = attn.gqa_decode(cfg0, mix, _t(x[:, t:t + 1]), cache, t,
                                  window=cfg.window)
    _close(out0[:, 0], pre[:, -1].numpy())


# --------------------------------------------------------------------- MLA
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_mla_forward_and_decode_match_jax(jparams, arch):
    """MLA without (v2-lite) and with (v3) a q LoRA rank: the chunked
    prefill at chunk 8 over S = 24, and 12 absorbed decode steps."""
    jcfg, jp = jparams(arch)
    cfg = get_smoke_config(arch)
    assert bool(cfg.q_lora_rank) == (arch == "deepseek-v3-671b")
    jmix, mix = _layer(jp, 0, "layer0")
    x = _x(cfg, seed=3)
    pos = np.arange(x.shape[1])
    got = attn.mla_forward(cfg, mix, _t(x), _t(pos), chunk_k=8)
    want = jattn.mla_forward(jcfg, jmix, jnp.asarray(x), jnp.asarray(pos),
                             chunk_k=8)
    _close(got, want)
    shape = attn.mla_cache_shape(cfg, 2, 16)
    assert shape == jattn.mla_cache_shape(jcfg, 2, 16)
    cache = {k: torch.zeros(v) for k, v in shape.items()}
    jcache = {k: jnp.zeros(v) for k, v in shape.items()}
    jstep = _jit(jattn.mla_decode, jcfg)
    for t in range(12):
        out, _ = attn.mla_decode(cfg, mix, _t(x[:, t:t + 1]), cache, t)
        jout, jcache = jstep(jmix, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.int32(t))
        _close(out, jout)
    _close(cache["c_kv"], jcache["c_kv"])
    _close(cache["k_rope"], jcache["k_rope"])
    # the last decode step and the prefill see the same 12 positions
    _close(out[:, 0], np.asarray(jattn.mla_forward(
        jcfg, jmix, jnp.asarray(x[:, :12]), jnp.arange(12)))[:, -1])


# --------------------------------------------------------------------- MoE
def _moe_case(jparams, cf, arch="deepseek-v2-lite-16b", t=64):
    jcfg, jp = jparams(arch, moe_capacity_factor=cf)
    cfg = dataclasses.replace(get_smoke_config(arch), moe_capacity_factor=cf)
    jffn, ffn = _layer(jp, 1, "layer0", "ffn")
    x = _x(cfg, b=2, s=t // 2, seed=int(cf * 10))
    return cfg, jcfg, ffn, jffn, x


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
def test_moe_forward_equals_the_einsum_dispatch(jparams, cf, arch):
    """With drops (capacity factor 0.5), at the config's 1.25 and with no
    drops: the port equals the reference's einsum dispatch (its default)."""
    cfg, jcfg, ffn, jffn, x = _moe_case(jparams, cf, arch)
    r = moe.route(cfg, ffn, _t(x).reshape(-1, cfg.d_model))
    assert r.capacity == jmoe.moe_capacity(jcfg, x.shape[0] * x.shape[1])
    if cf == 0.5:
        assert not bool(r.keep.all())      # some assignments are dropped
    if cf == 8.0:
        assert bool(r.keep.all())
    got = moe.moe_forward(cfg, ffn, _t(x))
    _close(got, jmoe._moe_forward_einsum(jcfg, jffn, jnp.asarray(x)))


def test_moe_sort_dispatch_fault_is_the_reference_s(jparams):
    """Reference fault (ROADMAP Queue 3): under drops the reference's
    ``_moe_forward_sort`` sends every dropped assignment to (expert 0,
    slot 0) with value 0, which erases the first token routed to expert
    0's contribution from that expert; with no drops it equals the einsum
    dispatch. The port equals the einsum dispatch in both cases."""
    cfg, jcfg, ffn, jffn, x = _moe_case(jparams, 0.5)
    want = np.asarray(jmoe._moe_forward_einsum(jcfg, jffn, jnp.asarray(x)))
    sort = np.asarray(jmoe._moe_forward_sort(jcfg, jffn, jnp.asarray(x)))
    diff = np.abs(sort - want).reshape(-1, cfg.d_model).max(axis=1)
    r = moe.route(cfg, ffn, _t(x).reshape(-1, cfg.d_model))
    first_e0 = int(r.token[r.expert == 0][0])
    assert diff[first_e0] > 1e-3
    assert np.flatnonzero(diff > ATOL).tolist() == [first_e0]
    _close(moe.moe_forward(cfg, ffn, _t(x)), want)
    cfg, jcfg, ffn, jffn, x = _moe_case(jparams, 8.0)
    np.testing.assert_allclose(
        np.asarray(jmoe._moe_forward_sort(jcfg, jffn, jnp.asarray(x))),
        np.asarray(jmoe._moe_forward_einsum(jcfg, jffn, jnp.asarray(x))),
        atol=ATOL, rtol=RTOL)


def test_moe_router_stats_match_jax(jparams):
    cfg, jcfg, ffn, jffn, x = _moe_case(jparams, 1.25)
    got = moe.moe_router_stats(cfg, ffn, _t(x))
    want = jmoe.moe_router_stats(jcfg, jffn, jnp.asarray(x))
    for key in ("expert_fraction", "mean_prob"):
        _close(got[key], want[key])


# ------------------------------------------------------------------ RG-LRU
def test_rglru_forward_and_decode_match_jax(jparams):
    """The conv, the gates and the log-depth scan over S = 37 (not a power
    of two), then 20 decode steps carrying h and the conv state."""
    jcfg, jp = jparams("recurrentgemma-2b")
    cfg = get_smoke_config("recurrentgemma-2b")
    jmix, mix = _layer(jp, 0, "layer0")
    x = _x(cfg, s=37, seed=4)
    _close(rglru.rglru_forward(cfg, mix, _t(x)),
           jrglru.rglru_forward(jcfg, jmix, jnp.asarray(x)))
    shape = rglru.rglru_cache_shape(cfg, 2)
    assert shape == jrglru.rglru_cache_shape(jcfg, 2)
    cache = {k: torch.zeros(v) for k, v in shape.items()}
    jcache = {k: jnp.zeros(v) for k, v in shape.items()}
    jstep = _jit(jrglru.rglru_decode, jcfg)
    for t in range(20):
        out, _ = rglru.rglru_decode(cfg, mix, _t(x[:, t:t + 1]), cache, t)
        jout, jcache = jstep(jmix, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.int32(t))
        _close(out, jout)
    _close(cache["h"], jcache["h"])
    _close(cache["conv"], jcache["conv"])


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 300, 8)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 300, 8)).astype(np.float32))
    h, want = torch.zeros(2, 8), []
    for t in range(300):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, 1).numpy())


# -------------------------------------------------------------------- RWKV6
@pytest.mark.parametrize("factored", [False, True])
def test_wkv_chunk_matches_jax(factored):
    rng = np.random.default_rng(6)
    b, h, c, dk = 2, 3, 16, 8
    r, k, v = (rng.normal(size=(b, h, c, dk)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1.6, (b, h, c, dk))).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    st = rng.normal(size=(b, h, dk, dk)).astype(np.float32)
    got = rwkv._wkv_chunk(*map(_t, (r, k, v, logw, u, st)),
                          factored=factored)
    want = jrwkv._wkv_chunk(*map(jnp.asarray, (r, k, v, logw, u, st)),
                            factored=factored)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("chunk", [64, 16, 1])
@pytest.mark.parametrize("factored", [False, True])
def test_rwkv_time_mix_matches_jax(jparams, monkeypatch, chunk, factored):
    """Chunk 64 (the default), 16 and 1 (decode's), the factored math on
    and off (the reference reads it from REPRO_RWKV_FACTORED and applies
    it to chunks of at most 16), from a zero and from a carried state."""
    jcfg, jp = jparams("rwkv6-3b")
    cfg = get_smoke_config("rwkv6-3b")
    jmix, mix = _layer(jp, 0, "layer0")
    monkeypatch.setenv("REPRO_RWKV_FACTORED", "1" if factored else "0")
    x = _x(cfg, s=32, seed=chunk)
    got, st = rwkv.rwkv_time_mix(cfg, mix, _t(x), chunk=chunk,
                                 factored=factored)
    want, jst = jrwkv.rwkv_time_mix(jcfg, jmix, jnp.asarray(x), chunk=chunk)
    _close(got, want)
    _close(st["wkv"], jst["wkv"])
    _close(st["shift_t"], jst["shift_t"])
    x2 = _x(cfg, s=16, seed=chunk + 1)
    got, _ = rwkv.rwkv_time_mix(cfg, mix, _t(x2), chunk=chunk,
                                factored=factored, state=st)
    want, _ = jrwkv.rwkv_time_mix(jcfg, jmix, jnp.asarray(x2), chunk=chunk,
                                  state=jst)
    _close(got, want)


def test_rwkv_channel_mix_matches_jax(jparams):
    jcfg, jp = jparams("rwkv6-3b")
    cfg = get_smoke_config("rwkv6-3b")
    jmix, mix = _layer(jp, 0, "layer0")
    x = _x(cfg, seed=8)
    last = _x(cfg, s=1, seed=9)[:, 0]
    for state, jstate in ((None, None), (_t(last), jnp.asarray(last))):
        got, shift = rwkv.rwkv_channel_mix(cfg, mix, _t(x), state=state)
        want, jshift = jrwkv.rwkv_channel_mix(jcfg, jmix, jnp.asarray(x),
                                              state=jstate)
        _close(got, want)
        _close(shift, jshift)
    assert rwkv.rwkv_cache_shape(cfg, 3) == jrwkv.rwkv_cache_shape(jcfg, 3)


# ------------------------------------------------------------ whole models
def _tokens(cfg, shape, seed):
    shape = shape + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _prefix(cfg, b, seed):
    if not cfg.vision_prefix_len:
        return None
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.vision_prefix_len, cfg.d_model)) * 0.02).astype(
            np.float32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_logits_match_jax(jparams, arch):
    """Every SMOKE config not covered by test_torch_lm.py: the final hidden
    states and all logits of a prefill (with the 4-codebook tokens of
    musicgen and the patch-embedding prefix of internvl2)."""
    jcfg, jp = jparams(arch)
    cfg, p = get_smoke_config(arch), lm_params_from_jax(jp, "cpu")
    b, s = 2, 32
    toks, prefix = _tokens(cfg, (b, s), 1), _prefix(cfg, b, 2)
    h = lm_forward(cfg, p, _t(toks),
                   prefix_embeds=None if prefix is None else _t(prefix))
    jh = jmodel.lm_forward(jcfg, jp, jnp.asarray(toks), remat=False,
                           prefix_embeds=None if prefix is None
                           else jnp.asarray(prefix))
    assert h.shape == (b, s + cfg.vision_prefix_len, cfg.d_model)
    _close(h, jh)
    _close(head_logits(cfg, p, h), jmodel.head_logits(jcfg, jp, jh))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_sixteen_decode_steps_match_jax(jparams, arch):
    """16 decode steps of every SMOKE config not covered by
    test_torch_lm.py against JAX's, step by step, and the final caches
    (ring KV, MLA's compressed cache, recurrent f32 states)."""
    jcfg, jp = jparams(arch)
    cfg, p = get_smoke_config(arch), lm_params_from_jax(jp, "cpu")
    b, s = 2, 16
    toks = _tokens(cfg, (b, s), 3)
    cache = init_cache(cfg, b, 24, "cpu")
    jcache = jmodel.init_cache(jcfg, b, 24)
    jstep = _jit(jmodel.decode_step, jcfg)
    for t in range(s):
        logits, new = decode_step(cfg, p, cache, _t(toks[:, t:t + 1]), t)
        assert new is cache                 # written in place
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        _close(logits, jlogits)
    got = jax.tree_util.tree_flatten_with_path(cache)[0]
    want = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        _close(g, w)


# ------------------------------------------------------------------- trees
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_trees_match_the_reference(arch):
    """Parameter and cache shape trees leaf for leaf, full and SMOKE; the
    SMOKE cache's dtypes too."""
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke(arch))):
        assert param_shapes(port) == jmodel.param_shapes(ref)
        assert cache_shapes(port, 2, 64) == jmodel.cache_shapes(ref, 2, 64)
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)),
        jmodel.abstract_cache(jax_get_smoke(arch), 3, 20))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
        init_cache(get_smoke_config(arch), 3, 20, "cpu"))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_of_every_full_config_match_the_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()


def test_active_param_count_fault_is_the_reference_s():
    """Reference fault (ROADMAP Queue 3): ``active_param_count`` looks for
    "experts" in the key path, but the expert leaves are ``we_in``,
    ``we_gate`` and ``we_out``, so a MoE model reports its full count. The
    port's copy reports the same."""
    cfg, ref = get_config("deepseek-v2-lite-16b"), \
        jax_get_config("deepseek-v2-lite-16b")
    assert ref.active_param_count() == ref.param_count() == 15_706_484_224
    assert cfg.active_param_count() == cfg.param_count() == 15_706_484_224


# -------------------------------------------------------- weights and init
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_lm_params_from_jax_carries_every_new_leaf_bit_for_bit(arch, dtype):
    """MLA (with a q LoRA), MoE and MTP (deepseek-v3), RG-LRU and the
    local mixer (recurrentgemma), RWKV6 with its empty ``ffn`` dicts."""
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype=dtype)
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(6)))
    p = lm_params_from_jax(jp, "cpu")
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(jp)[0])
    got_paths, got = zip(*jax.tree_util.tree_flatten_with_path(p)[0])
    assert got_paths == paths
    names = {str(path[-1].key) for path in paths}
    if arch == "rwkv6-3b":
        assert p["stages"][0]["layer0"]["ffn"] == {}
        assert {"u", "mu", "lora_b", "ln_x_scale", "cmix_mu_k"} <= names
    elif arch == "deepseek-v3-671b":
        assert {"wq_a", "q_norm", "wkv_a", "kv_norm", "we_in", "router",
                "sh_out", "proj"} <= names
    else:
        assert {"lam", "conv_w", "wa", "wq"} <= names
    for a, t in zip(leaves, got):
        assert t.dtype == getattr(torch, dtype)
        assert tuple(t.shape) == a.shape
        bits = np.int16 if dtype == "bfloat16" else np.int32
        assert np.array_equal(t.view(getattr(torch, bits.__name__)).numpy(),
                              a.view(bits))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "recurrentgemma-2b",
                                  "rwkv6-3b", "musicgen-large"])
def test_init_params_follows_the_reference_rules_for_new_leaves(arch):
    """The port's init against the reference's: the same tree of shapes
    (lam of shape (repeat,), as the reference makes it), ones, zeros and
    the linspace exactly, uniform × 0.5 for mu and u, dense_init's std
    elsewhere."""
    cfg = get_smoke_config(arch)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = _np(jmodel.init_params(jax_get_smoke(arch), jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == \
        jax.tree_util.tree_map(lambda a: a.shape, jp)
    for (path, t), (_, a) in zip(jax.tree_util.tree_flatten_with_path(p)[0],
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        name = str(path[-1].key)
        if name in ("lam", "ln_x_scale", "ln_x_bias", "conv_b", "ba", "bi",
                    "mu_base", "w_base", "cmix_mu_k", "cmix_mu_r", "scale",
                    "bias") or "norm" in name:
            assert np.array_equal(t.numpy(), a), path
        elif name in ("mu", "u"):
            assert 0 <= t.min() and t.max() < 0.5 and t.std() > 0.1
        else:
            assert abs(t.std().item() - t.shape[0] ** -0.5) < \
                0.2 * t.shape[0] ** -0.5, path
    if arch == "recurrentgemma-2b":
        lam = p["stages"][0]["layer0"]["mixer"]["lam"]
        assert lam.shape == (cfg.stages[0].repeat,)
    if arch == "deepseek-v3-671b":
        assert set(p["mtp"]) == {"proj", "norm_h", "norm_e", "layer"}
