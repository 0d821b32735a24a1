"""The port's LM stack against the JAX package: configs, norms and rope, the
GQA mixer, one layer, the whole prefill and 16 decode steps, on the f32
SMOKE configs of llama3.2-1b and qwen2-1.5b (qkv bias, head_dim 16), with
the reference's parameters carried over by ``lm_params_from_jax``. Inputs
come from numpy seeds; everything runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models.lm import attention as jattn
from repro.models.lm import blocks as jblocks
from repro.models.lm import common as jcommon
from repro.models.lm import model as jmodel
from repro.models.lm.config import dense_stages as jax_dense_stages
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.shapes import SHAPES, shape_applies
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import (
    cache_shapes, decode_step, embed_tokens, head_logits, init_cache,
    init_params, lm_forward, param_shapes)
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import blocks
from repro_torch.models.lm import common
from repro_torch.models.lm.config import dense_stages

# f32 on both sides; the packages differ in summation order only
ATOL = RTOL = 1e-4
ARCHS = ("llama3.2-1b", "qwen2-1.5b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(port cfg, JAX cfg, port params, JAX params) from one JAX init."""
    jcfg = jax_get_smoke(request.param)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return (get_smoke_config(request.param), jcfg,
            lm_params_from_jax(_np(jparams), "cpu"), jparams)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_copies_of_the_reference(arch):
    assert list_archs() == list(ARCH_IDS)
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.num_layers == ref.num_layers
        assert port.is_subquadratic == ref.is_subquadratic
        for shape in SHAPES.values():
            assert shape_applies(port, shape) == shape_applies(ref, shape)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-1.5b",
                                  "command-r-plus-104b", "granite-34b",
                                  "internvl2-1b"])
def test_param_counts_match_the_reference_without_jax(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()


def test_llama_full_config_size():
    cfg = get_config("llama3.2-1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (16, 2048, 32, 8, 64, 8192, 128256)
    assert cfg.param_count() == 1_235_814_400        # 2.47 GB in bf16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multicodebook_embedding_matches_jax(dtype):
    """MusicGen's (B, S, K) tokens: the sum of the K codebooks' embeddings
    plus the sinusoidal positions, in the reference's order of additions
    (in bf16 within one bf16 ulp, as the norms above)."""
    jcfg = dataclasses.replace(jax_get_smoke("musicgen-large"), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("musicgen-large"),
                              dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(7))
    p = lm_params_from_jax(_np(jp), "cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 9, cfg.num_codebooks))
    got = embed_tokens(cfg, p, torch.from_numpy(toks))
    want = np.asarray(jmodel.embed_tokens(jcfg, jp, jnp.asarray(toks)),
                      dtype=np.float32)
    assert got.shape == (2, 9, cfg.d_model)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else \
        dict(atol=0.0, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_vlm_prefix_goes_before_the_text():
    """InternVL's patch embeddings are put before the text embeddings and
    take positions 0..P-1: the text's hidden states depend on the prefix,
    and the prefix's do not depend on the text."""
    jcfg = jax_get_smoke("internvl2-1b")
    cfg = get_smoke_config("internvl2-1b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(8))
    p = lm_params_from_jax(_np(jp), "cpu")
    rng = np.random.default_rng(8)
    prefix = rng.normal(size=(2, cfg.vision_prefix_len, cfg.d_model)) \
        .astype(np.float32) * 0.02
    toks = rng.integers(0, cfg.vocab_size, (2, 8))
    h = lm_forward(cfg, p, torch.from_numpy(toks),
                   prefix_embeds=torch.from_numpy(prefix))
    _close(h, jmodel.lm_forward(jcfg, jp, jnp.asarray(toks), remat=False,
                                prefix_embeds=jnp.asarray(prefix)))
    other = lm_forward(cfg, p, torch.from_numpy(toks[::-1].copy()),
                       prefix_embeds=torch.from_numpy(prefix))
    p_len = cfg.vision_prefix_len
    assert torch.equal(h[:, :p_len], other[:, :p_len])
    alone = lm_forward(cfg, p, torch.from_numpy(toks))
    assert not torch.allclose(h[:, p_len:], alone, atol=1e-3)


# ----------------------------------------------------------------- common
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_and_activations_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(3, 10)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts, tb = (torch.from_numpy(a).to(tx.dtype) for a in (scale, bias))
    jx = jnp.asarray(x).astype(dtype)
    js, jb = (jnp.asarray(a).astype(dtype) for a in (scale, bias))
    # bf16: both sides round at the same places, so they agree to within
    # one bf16 ulp of the largest value
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else \
        dict(atol=0.0, rtol=2 ** -7)
    pairs = [
        (common.rms_norm(tx, ts), jcommon.rms_norm(jx, js)),
        (common.layer_norm(tx, ts, tb), jcommon.layer_norm(jx, js, jb)),
        (common.apply_rope(tx, torch.from_numpy(pos), 10_000.0),
         jcommon.apply_rope(jx, jnp.asarray(pos), 10_000.0)),
    ]
    for got, want in pairs:
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, dtype=np.float32), **tol)
    for act in ("silu", "gelu"):
        cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), act=act)
        np.testing.assert_allclose(
            common.activation(cfg, torch.from_numpy(x)).numpy(),
            np.asarray(jcommon.activation(cfg, jnp.asarray(x))),
            atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        common.sinusoidal_embed(torch.from_numpy(pos), 32).numpy(),
        np.asarray(jcommon.sinusoidal_embed(jnp.asarray(pos), 32)),
        atol=ATOL, rtol=RTOL)


# ------------------------------------------------------- mixer, layer, model
def _x(cfg, b=2, s=24, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def test_gqa_forward_matches_jax(model):
    cfg, jcfg, p, jp = model
    x = _x(cfg)
    pos = np.arange(x.shape[1])
    mix = {k: v[0] for k, v in p["stages"][0]["layer0"]["mixer"].items()}
    got = attn.gqa_forward(cfg, mix, torch.from_numpy(x),
                           torch.from_numpy(pos))
    jmix = {k: v[0] for k, v in jp["stages"][0]["layer0"]["mixer"].items()}
    want = jattn.gqa_forward(jcfg, jmix, jnp.asarray(x), jnp.asarray(pos),
                             chunk_k=8)
    _close(got, want)


def test_layer_forward_matches_jax(model):
    """One layer, on weights of std d_in ** -0.5 drawn with numpy (the
    reference's init gives std repeat ** -0.5, whose outputs reach the
    hundreds, where 1e-4 is below f32's own resolution)."""
    cfg, jcfg, _, jp = model
    rng = np.random.default_rng(2)
    jlayer = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape[1:]) * (
            a.shape[1] ** -0.5 if a.ndim == 3 else 0.1) +
            (a.ndim == 2)).astype(np.float32), _np(jp["stages"][0]["layer0"]))
    x = _x(cfg, seed=2)
    pos = np.arange(x.shape[1])
    spec = cfg.stages[0].layers[0]
    got = blocks.layer_forward(cfg, spec, lm_params_from_jax(jlayer, "cpu"),
                               torch.from_numpy(x), torch.from_numpy(pos))
    want = jblocks.layer_forward(jcfg, spec, jlayer, jnp.asarray(x),
                                 jnp.asarray(pos))
    _close(got, want)


@pytest.mark.parametrize("arch,stage,name", [
    ("recurrentgemma-2b", 0, "layer0"), ("recurrentgemma-2b", 0, "layer2"),
    ("deepseek-v2-lite-16b", 0, "layer0"),
    ("deepseek-v2-lite-16b", 1, "layer0"), ("rwkv6-3b", 0, "layer0")])
def test_every_new_layer_spec_forward_and_decode_match_jax(arch, stage,
                                                            name):
    """``layer_forward`` and 6 ``layer_decode`` steps of each new (mixer,
    ffn) pair, (rglru, dense), (local, dense), (mla, dense), (mla, moe) and
    (rwkv6, rwkv_cmix), on the reference's init with its matrices scaled
    to std fan_in ** -0.5 (the decay and mixing leaves kept)."""
    jcfg, cfg = jax_get_smoke(arch), get_smoke_config(arch)
    spec = cfg.stages[stage].layers[int(name[-1])]
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(9)))
    jlayer = jax.tree_util.tree_map_with_path(
        lambda path, a: a[0] * np.float32(
            a.shape[-2] ** -0.5 if a.ndim >= 3 and str(path[-1].key) not in
            ("mu", "conv_w", "u") else 1.0),
        jp["stages"][stage][name])
    layer = lm_params_from_jax(jlayer, "cpu")
    x = _x(cfg, s=16, seed=9)
    pos = np.arange(x.shape[1])
    _close(blocks.layer_forward(cfg, spec, layer, torch.from_numpy(x),
                                torch.from_numpy(pos)),
           jblocks.layer_forward(jcfg, spec, jlayer, jnp.asarray(x),
                                 jnp.asarray(pos)))
    shapes = blocks.layer_cache_shape(cfg, spec, 2, 8)
    assert shapes == jblocks.layer_cache_shape(jcfg, spec, 2, 8)
    cache = {k: torch.zeros(s, dtype=blocks._cache_dtype(cfg, k))
             for k, s in shapes.items()}
    jcache = {k: jnp.zeros(s, jblocks._cache_dtype(jcfg, k))
              for k, s in shapes.items()}
    step = jax.jit(lambda c, xt, t: jblocks.layer_decode(
        jcfg, spec, jlayer, xt, c, t))
    for t in range(6):
        out, same = blocks.layer_decode(cfg, spec, layer, torch.from_numpy(
            x[:, t:t + 1]), cache, t)
        assert same is cache
        jout, jcache = step(jcache, jnp.asarray(x[:, t:t + 1]), jnp.int32(t))
        _close(out, jout)
    for k in shapes:
        _close(cache[k], jcache[k])


@pytest.mark.parametrize("s", [16, 33])
def test_prefill_logits_match_jax(model, s):
    cfg, jcfg, p, jp = model
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s))
    h = lm_forward(cfg, p, torch.from_numpy(toks))
    jh = jmodel.lm_forward(jcfg, jp, jnp.asarray(toks), remat=False)
    _close(h, jh)
    _close(head_logits(cfg, p, h[:, -1]),
           jmodel.head_logits(jcfg, jp, jh[:, -1]))


def test_sixteen_decode_steps_match_jax_and_the_prefill(model):
    cfg, jcfg, p, jp = model
    b, s = 2, 16
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s))
    cache = init_cache(cfg, b, 32, "cpu")
    jcache = jmodel.init_cache(jcfg, b, 32)
    for t in range(s):
        logits, new = decode_step(cfg, p, cache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        assert new is cache                 # written in place
        jlogits, jcache = jmodel.decode_step(
            jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        _close(logits, jlogits)
    for got, want in zip(jax.tree_util.tree_leaves(cache),
                         jax.tree_util.tree_leaves(jcache)):
        _close(got, want)
    full = head_logits(cfg, p, lm_forward(cfg, p, torch.from_numpy(toks))
                       [:, -1])
    err = (logits[:, 0] - full).abs().max().item()
    assert err / full.abs().max().item() < 2e-2


def _decode_drift(toks, prefill, decode):
    """max |decode logits - prefill logits| / max |prefill logits| at the
    last position, after len(toks) teacher-forced decode steps."""
    full = np.asarray(prefill(toks), dtype=np.float32)
    for t in range(toks.shape[1]):
        logits = decode(toks[:, t:t + 1], t)
    return float(np.abs(np.asarray(logits, dtype=np.float32)[:, 0] -
                        full).max() / np.abs(full).max())


def test_bf16_decode_drift_is_the_reference_s():
    """In bf16, 16 layers drawn by the reference's init (std repeat ** -0.5
    = 0.25, as in the full llama3.2-1b) make teacher-forced decode drift
    from the prefill in the JAX package itself, to about its own 2e-2
    criterion. On the same parameters and tokens the port drifts by as much
    on average, and no more. ``-s`` prints the figures."""
    jcfg = dataclasses.replace(jax_get_smoke("llama3.2-1b"),
                               stages=jax_dense_stages(16), dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              stages=dense_stages(16), dtype="bfloat16")
    b, s = 2, 64
    jstep = jax.jit(lambda p_, c, t, pos: jmodel.decode_step(jcfg, p_, c, t,
                                                             pos))
    figures = []
    for seed in range(4):
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
        p = lm_params_from_jax(_np(jp), "cpu")
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (b, s))
        jcache = [jmodel.init_cache(jcfg, b, 2 * s)]
        cache = init_cache(cfg, b, 2 * s, "cpu")

        def jdecode(tok, t):
            logits, jcache[0] = jstep(jp, jcache[0], jnp.asarray(tok),
                                      jnp.int32(t))
            return logits.astype(jnp.float32)

        with torch.no_grad():
            figures.append((
                _decode_drift(toks, lambda x: jmodel.head_logits(
                    jcfg, jp, jmodel.lm_forward(jcfg, jp, jnp.asarray(x),
                                                remat=False)[:, -1]).astype(
                    jnp.float32), jdecode),
                _decode_drift(toks, lambda x: head_logits(
                    cfg, p, lm_forward(cfg, p, torch.from_numpy(x))[:, -1])
                    .float(), lambda tok, t: decode_step(
                        cfg, p, cache, torch.from_numpy(tok), t)[0].float())))
    print("bf16 decode vs prefill, err / max |logit| (JAX, port): " +
          ", ".join(f"({j:.3e}, {t:.3e})" for j, t in figures))
    jax_mean, port_mean = np.mean(figures, axis=0)
    assert jax_mean > 1e-2 and 0.5 < port_mean / jax_mean < 2


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_decode_ring_slots_match_jax(window):
    """The decode mixer's slot arithmetic, including the ring buffer the
    local mixer will use: 12 steps through a cache of 5 (window) or 8."""
    jcfg = jax_get_smoke("qwen2-1.5b")
    cfg = get_smoke_config("qwen2-1.5b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    jmix = {k: v[0] for k, v in jp["stages"][0]["layer0"]["mixer"].items()}
    mix = lm_params_from_jax(_np(jmix), "cpu")
    shape = attn.gqa_cache_shape(cfg, 2, 8, window=window)
    assert shape == jattn.gqa_cache_shape(jcfg, 2, 8, window=window)
    cache = {k: torch.zeros(s) for k, s in shape.items()}
    jcache = {k: jnp.zeros(s) for k, s in shape.items()}
    rng = np.random.default_rng(5)
    for pos in range(12):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        out, cache = attn.gqa_decode(cfg, mix, torch.from_numpy(x), cache,
                                     pos, window=window)
        jout, jcache = jattn.gqa_decode(jcfg, jmix, jnp.asarray(x), jcache,
                                        jnp.int32(pos), window=window)
        _close(out, jout)
        _close(cache["k"], jcache["k"])


def test_cache_tree_matches_the_reference():
    cfg = get_smoke_config("llama3.2-1b")
    jcfg = jax_get_smoke("llama3.2-1b")
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), jmodel.abstract_cache(jcfg, 3, 20))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
        init_cache(cfg, 3, 20, "cpu"))
    assert got == want
    assert cache_shapes(cfg, 3, 20) == jmodel.cache_shapes(jcfg, 3, 20)


# -------------------------------------------------------- weights and init
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_from_jax_keeps_tree_layout_and_bits(dtype):
    jcfg = dataclasses.replace(jax_get_smoke("qwen2-1.5b"), dtype=dtype)
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(6)))
    p = lm_params_from_jax(jp, "cpu")
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(jp)[0])
    got_paths, got = zip(*jax.tree_util.tree_flatten_with_path(p)[0])
    assert got_paths == paths
    for a, t in zip(leaves, got):
        assert t.dtype == getattr(torch, dtype)
        assert tuple(t.shape) == a.shape
        if dtype == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)


def test_init_params_follows_the_reference_rules():
    cfg = get_smoke_config("qwen2-1.5b")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert shapes == param_shapes(cfg) == \
        jmodel.param_shapes(jax_get_smoke("qwen2-1.5b"))
    layer = p["stages"][0]["layer0"]
    repeat = cfg.stages[0].repeat
    for t in (layer["norm1"]["scale"], layer["norm2"]["scale"],
              p["final_norm"]["scale"]):
        assert torch.equal(t, torch.ones_like(t))
    for name in ("bq", "bk", "bv"):
        assert not layer["mixer"][name].any()
    # dense_init: std = shape[0] ** -0.5, the stacked repeat axis for layer
    # weights (2 here), the vocab for the embedding table
    for t in (layer["mixer"]["wq"], layer["ffn"]["w_in"]):
        assert abs(t.std().item() - repeat ** -0.5) < 0.02
        assert abs(t.mean().item()) < 0.01
    table = p["embed"]["table"]
    assert abs(table.std().item() - cfg.vocab_size ** -0.5) < 0.003
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(again)))
    # the model's dtype
    bf = init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                     torch.Generator().manual_seed(0), "cpu")
    assert {t.dtype for t in jax.tree_util.tree_leaves(bf)} == \
        {torch.bfloat16}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
