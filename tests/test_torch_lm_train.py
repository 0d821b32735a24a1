"""LM training in the port against the JAX package, on the CPU: module by
module gradients at the SMOKE model's own activations (embed, norm, rope,
a GQA mixer, a layer, two layers, the head, the loss), ``chunked_xent``
at chunks that do and do not divide S - 1 with a partly zero mask and
with multi-codebook labels, ``remat`` bitwise equal to no remat, one
AdamW step from the same gradients, MoE gradients with and without
dropped assignments, and ``FlashAttentionTrain``'s backward (the kernel
stood in by the plain version). Every gradient is held with the float64
witness of ``_lm_grad``. Weights are carried by ``lm_params_from_jax``
from the reference's init; inputs come from numpy seeds."""
import dataclasses
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_grad import (batch_of, check_witness, rel_err, sorted_leaves,
                      vjp_both)
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models.lm import attention as jattn
from repro.models.lm import blocks as jblocks
from repro.models.lm import common as jcommon
from repro.models.lm import model as jmodel
from repro.models.lm import moe as jmoe
from repro.optim.optimizers import get_optimizer as jax_get_optimizer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention.ref import pick_chunk
from repro_torch.launch.train import apply_grads
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import blocks
from repro_torch.models.lm import common
from repro_torch.models.lm import model
from repro_torch.models.lm import moe
from repro_torch.models.lm import lm_loss
from repro_torch.optim import get_optimizer, tree_leaves, tree_map

ATOL = RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- module by module, llama
@pytest.fixture(scope="module")
def llama():
    """The SMOKE llama3.2-1b's reference weights and its activations on a
    seeded batch: h0 (embeddings), h1 and h2 (after each layer), hf (after
    the final norm), q (layer 0's projected query, before rope)."""
    jcfg = jax_get_smoke("llama3.2-1b")
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 32))
    pos = jnp.arange(32)
    layer = [jax.tree_util.tree_map(lambda a, r=r: a[r],
                                    jp["stages"][0]["layer0"])
             for r in range(2)]
    h0 = jmodel.embed_tokens(jcfg, jp, jnp.asarray(toks))
    h1 = jblocks.layer_forward(jcfg, jcfg.stages[0].layers[0], layer[0], h0,
                               pos)
    h2 = jblocks.layer_forward(jcfg, jcfg.stages[0].layers[0], layer[1], h1,
                               pos)
    hf = jcommon.apply_norm(jcfg, h2, jp["final_norm"])
    x0 = jcommon.apply_norm(jcfg, h0, layer[0]["norm1"])
    q = (x0 @ layer[0]["mixer"]["wq"]).reshape(2, 32, jcfg.num_heads,
                                                jcfg.resolved_head_dim)
    acts = {k: np.asarray(v) for k, v in dict(
        h0=h0, h1=h1, h2=h2, hf=hf, x0=x0, q=q).items()}
    return jcfg, get_smoke_config("llama3.2-1b"), jp, layer, toks, acts


def _module_case(name, jfn, pfn, inputs, seed):
    """The vjp of ``jfn`` and ``pfn`` at ``inputs`` under a seeded normal
    cotangent: outputs within 1e-4 of their largest entry (the two-layer
    output reaches the thousands), gradients held by the witness."""
    shape = jax.eval_shape(jfn, *[jax.ShapeDtypeStruct(np.shape(a),
                                                       jnp.float32)
                                  for a in inputs]).shape
    cot = np.random.default_rng(seed).normal(size=shape)
    (jo, jg), (po, pg) = vjp_both(jfn, pfn, inputs, cot, False)
    assert rel_err([po], [jo]) <= ATOL, name
    (_, jg64), (_, pg64) = vjp_both(jfn, pfn, inputs, cot, True)
    return check_witness(name, pg, jg, pg64, jg64)


def test_module_gradients_at_the_model_s_activations(llama):
    """Each module's vjp at the activations it meets in the SMOKE model,
    port against reference, with the f64 witness: the embedding, rms_norm
    at layer 1's input (|h| in the thousands), rope on layer 0's query, the
    GQA mixer, a whole layer, two layers, the tied head and the loss."""
    jcfg, cfg, jp, layer, toks, acts = llama
    spec = jcfg.stages[0].layers[0]
    pos_j, pos_t = jnp.arange(32), torch.arange(32)
    jtoks, ttoks = jnp.asarray(toks), torch.from_numpy(toks)
    mix = layer[0]["mixer"]
    mix_keys = sorted(mix)
    lay_keys = ("norm1", "mixer", "norm2", "ffn")

    def lay_leaves(p):
        return [p[k][kk] for k in lay_keys for kk in sorted(p[k])]

    def lay_tree(leaves):
        it = iter(leaves)
        return {k: {kk: next(it) for kk in sorted(layer[0][k])}
                for k in lay_keys}
    n_lay = len(lay_leaves(layer[0]))
    cases = {
        "embed": (lambda t: jmodel.embed_tokens(
            jcfg, {"embed": {"table": t}}, jtoks),
            lambda t: model.embed_tokens(cfg, {"embed": {"table": t}},
                                         ttoks),
            [jp["embed"]["table"]]),
        "rms_norm": (lambda x, s: jcommon.rms_norm(x, s, jcfg.norm_eps),
                     lambda x, s: common.rms_norm(x, s, cfg.norm_eps),
                     [acts["h1"], layer[1]["norm1"]["scale"]]),
        "rope": (lambda q: jcommon.apply_rope(q, pos_j, jcfg.rope_theta),
                 lambda q: common.apply_rope(q, pos_t, cfg.rope_theta),
                 [acts["q"]]),
        "gqa": (lambda x, *w: jattn.gqa_forward(
            jcfg, dict(zip(mix_keys, w)), x, pos_j),
            lambda x, *w: attn.gqa_forward(cfg, dict(zip(mix_keys, w)), x,
                                           pos_t),
            [acts["x0"]] + [mix[k] for k in mix_keys]),
        "layer": (lambda x, *w: jblocks.layer_forward(
            jcfg, spec, lay_tree(w), x, pos_j),
            lambda x, *w: blocks.layer_forward(cfg, spec, lay_tree(w), x,
                                               pos_t),
            [acts["h0"]] + lay_leaves(layer[0])),
        "two_layers": (
            lambda x, *w: jblocks.layer_forward(
                jcfg, spec, lay_tree(w[n_lay:]), jblocks.layer_forward(
                    jcfg, spec, lay_tree(w[:n_lay]), x, pos_j), pos_j),
            lambda x, *w: blocks.layer_forward(
                cfg, spec, lay_tree(w[n_lay:]), blocks.layer_forward(
                    cfg, spec, lay_tree(w[:n_lay]), x, pos_t), pos_t),
            [acts["h0"]] + lay_leaves(layer[0]) + lay_leaves(layer[1])),
        "head": (lambda h, t: jmodel.head_logits(
            jcfg, {"embed": {"table": t}}, h),
            lambda h, t: model.head_logits(cfg, {"embed": {"table": t}}, h),
            [acts["hf"], jp["embed"]["table"]]),
    }
    figs = {}
    for i, (name, (jfn, pfn, inputs)) in enumerate(cases.items()):
        figs[name] = _module_case(name, jfn, pfn, inputs, 10 + i)
    # the loss: a scalar, so its cotangent is 1
    labels, mask = toks[:, 1:], np.ones((2, 31), np.float32)

    def jloss(h, t):
        return jmodel.chunked_xent(jcfg, {"embed": {"table": t}}, h,
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   chunk=8)

    def ploss(h, t):
        return model.chunked_xent(cfg, {"embed": {"table": t}}, h,
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask), chunk=8)
    inputs = [acts["hf"][:, :-1], jp["embed"]["table"]]
    (jo, jg), (po, pg) = vjp_both(jloss, ploss, inputs, 1.0, False)
    np.testing.assert_allclose(po, jo, atol=ATOL, rtol=RTOL)
    (_, jg64), (_, pg64) = vjp_both(jloss, ploss, inputs, 1.0, True)
    figs["loss"] = check_witness("loss", pg, jg, pg64, jg64)
    # every module alone is within 1e-4 in f32; only the composition of
    # two layers (layer 1 meets layer 0's output, |h| in the thousands,
    # and saturates its softmax) parts, by as much in the reference
    for name, fig in figs.items():
        if name != "two_layers":
            assert fig["port_vs_ref"] <= ATOL, (name, fig)


# --------------------------------------------------------------- chunked_xent
def test_pick_chunk_is_the_reference_s():
    assert pick_chunk(255, 512) == 255
    assert pick_chunk(4095, 512) == 455
    assert pick_chunk(4352, 512) == 272


@pytest.mark.parametrize("arch,chunk", [("llama3.2-1b", 5),
                                        ("llama3.2-1b", 4),
                                        ("llama3.2-1b", 512),
                                        ("musicgen-large", 5),
                                        ("musicgen-large", 7)])
def test_chunked_xent_matches_the_reference(arch, chunk):
    """Chunks that divide S - 1 = 15 (5, and 512 -> one chunk of 15) and
    that do not (4 -> 3, 7 -> 5), a mask with zeros, and a 4-codebook
    model's (B, S, K) labels summed over codebooks: the loss and its
    gradients with respect to h and the head (and the table a tied head
    reads), with the witness; ``xent_remat`` bitwise the same."""
    jcfg, cfg = jax_get_smoke(arch), get_smoke_config(arch)
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(chunk)
    h = rng.normal(size=(2, 15, cfg.d_model)).astype(np.float32)
    lshape = (2, 15, cfg.num_codebooks) if cfg.num_codebooks > 1 \
        else (2, 15)
    labels = rng.integers(0, cfg.vocab_size, lshape)
    mask = (rng.random((2, 15)) > 0.3).astype(np.float32)
    key = ("head", "w") if "head" in jp else ("embed", "table")

    def jfn(hh, w):
        return jmodel.chunked_xent(jcfg, {key[0]: {key[1]: w}}, hh,
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   chunk=chunk)

    def pfn(hh, w, remat=False):
        return model.chunked_xent(cfg, {key[0]: {key[1]: w}}, hh,
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask), chunk=chunk,
                                  remat=remat)
    inputs = [h, jp[key[0]][key[1]]]
    (jo, jg), (po, pg) = vjp_both(jfn, pfn, inputs, 1.0, False)
    np.testing.assert_allclose(po, jo, atol=ATOL, rtol=RTOL)
    (_, jg64), (_, pg64) = vjp_both(jfn, pfn, inputs, 1.0, True)
    check_witness(f"{arch} chunk {chunk}", pg, jg, pg64, jg64)
    assert rel_err(pg, jg) <= ATOL
    # the reference's REPRO_XENT_REMAT=1 is the port's remat=True
    _, (po_r, pg_r) = vjp_both(jfn, lambda a, b: pfn(a, b, remat=True),
                               inputs, 1.0, False)
    assert np.array_equal(po_r, po)
    assert all(np.array_equal(a, b) for a, b in zip(pg_r, pg))


def _loss_grads(cfg, params, batch, **kw):
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm_loss(cfg, p, batch, **kw)
    return loss, torch.autograd.grad(loss, tree_leaves(p))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b",
                                  "deepseek-v3-671b"])
def test_remat_is_bitwise_no_remat(arch):
    """Checkpointing each repeat recomputes the same f32 operations: the
    loss and every gradient leaf are bitwise those without remat; under
    ``torch.no_grad()`` the forward is bitwise too."""
    cfg = get_smoke_config(arch)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 2, 16, 5).items()}
    l1, g1 = _loss_grads(cfg, params, b, remat=True)
    l0, g0 = _loss_grads(cfg, params, b, remat=False)
    assert torch.equal(l1, l0)
    assert len(g1) == len(g0) == len(tree_leaves(params))
    assert all(torch.equal(a, c) for a, c in zip(g1, g0))
    with torch.no_grad():
        assert torch.equal(lm_loss(cfg, params, b), l0.detach())


# ------------------------------------------------------------------- AdamW
def test_one_adamw_step_from_the_same_gradients_matches_the_reference():
    """The reference's step (``opt.update`` of the whole tree, then ``(p +
    u).astype(p.dtype)``) against the port's ``apply_grads`` (one leaf at a
    time, containers updated in place), from the reference's gradients of
    the SMOKE llama3.2-1b in f32 and in bf16: parameters and Adam state."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_get_smoke("llama3.2-1b"), dtype=dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
        b = batch_of(jcfg, 2, 16, 6)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jgrads = jax.jit(jax.grad(lambda p: jmodel.lm_loss(jcfg, p, jb)))(
            jp)
        jopt = jax_get_optimizer("adamw")
        st = jopt.init(jp)

        @jax.jit
        def ref_step(grads, st, jp):
            upd, st = jopt.update(grads, st, jp, jnp.float32(3e-4))
            return jax.tree_util.tree_map(
                lambda p, u: (p + u).astype(p.dtype), jp, upd), st
        for _ in range(2):
            jp_new, st_new = ref_step(jgrads, st, jp)
            opt = get_optimizer("adamw")
            params = lm_params_from_jax(_np(jp), "cpu")
            state = {"step": torch.tensor(int(st["step"]), dtype=torch.int32),
                     "m": lm_params_from_jax(_np(st["m"]), "cpu"),
                     "v": lm_params_from_jax(_np(st["v"]), "cpu")}
            grads = lm_params_from_jax(_np(jgrads), "cpu")
            params, state = apply_grads(opt, params, state, grads, 3e-4)
            assert all(g is None for g in tree_leaves(grads))
            assert int(state["step"]) == int(st_new["step"])
            for got, want in ((params, jp_new), (state["m"], st_new["m"]),
                              (state["v"], st_new["v"])):
                got, want = sorted_leaves(got), jax.tree_util.tree_leaves(
                    want)
                assert [g.dtype for g in got] == [
                    lm_params_from_jax(np.asarray(w), "cpu").dtype
                    for w in want]
                # bf16 parameters: one bf16 rounding of f32 sums that agree
                # to about 1e-7
                tol = 1e-6 if dtype == "float32" else 2 ** -7
                for g, w in zip(got, want):
                    np.testing.assert_allclose(
                        g.float().numpy(), np.asarray(w, np.float32),
                        atol=tol, rtol=tol)
            jp, st = jp_new, st_new


# --------------------------------------------------------------------- MoE
@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True),
                                                   (16.0, False)])
def test_moe_gradient_with_and_without_drops(capacity_factor, drops):
    """deepseek-v2-lite's MoE FFN at the SMOKE config's widths: the vjp of
    the port's sort-built dispatch against the reference's einsum, with the
    capacity binding (assignments dropped) and not."""
    jcfg = dataclasses.replace(jax_get_smoke("deepseek-v2-lite-16b"),
                               moe_capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"),
                              moe_capacity_factor=capacity_factor)
    jp = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(3)))
    st = [i for i, s in enumerate(jcfg.stages)
          if s.layers[0].ffn == "moe"][0]
    ffn = {k: v[0] for k, v in jp["stages"][st]["layer0"]["ffn"].items()}
    keys = sorted(ffn)
    x = np.random.default_rng(4).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    r = moe.route(cfg, {k: _t(v) for k, v in ffn.items()},
                  _t(x).reshape(-1, cfg.d_model))
    assert bool((~r.keep).any()) == drops
    check_witness(f"moe cf {capacity_factor}", *_moe_vjps(
        lambda xx, *w: jmoe.moe_forward(jcfg, dict(zip(keys, w)), xx),
        lambda xx, *w: moe.moe_forward(cfg, dict(zip(keys, w)), xx),
        [x] + [ffn[k] for k in keys],
        np.random.default_rng(5).normal(size=x.shape)))


def _moe_vjps(jfn, pfn, inputs, cot):
    """port f32, reference f32, port f64, reference f64 input gradients;
    the outputs (in the thousands at this init) within 1e-4 of their
    largest entry."""
    (jo, jg), (po, pg) = vjp_both(jfn, pfn, inputs, cot, False)
    assert rel_err([po], [jo]) <= ATOL
    (_, jg64), (_, pg64) = vjp_both(jfn, pfn, inputs, cot, True)
    return pg, jg, pg64, jg64


# ------------------------------------------------------ FlashAttentionTrain
@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_train_backward_is_the_plain_one(window):
    """``FlashAttentionTrain`` with the kernel stood in by the plain
    ``attention_ref`` (the CPU has no kernel): the forward is the kernel's
    output, and the backward the gradient of ``plain_attention`` (the
    reference's ``chunked_attention`` / ``sliding_window_attention``) on
    the saved inputs; ``flash_attention(impl="cuda")`` itself still
    refuses inputs that need a gradient."""
    from repro_torch.kernels.flash_attention import attention_ref
    rng = np.random.default_rng(window)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 16, h, 16)).astype(
        np.float32)).requires_grad_() for h in (4, 2, 2))
    calls = []

    def kernel(q_, k_, v_, causal=True, window=0, impl=None):
        calls.append(impl)
        return attention_ref(q_, k_, v_, causal=causal, window=window)
    with unittest.mock.patch.object(attn, "flash_attention", kernel):
        out = attn.FlashAttentionTrain.apply(q, k, v, window, 1024)
    assert calls == ["cuda"]
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), cot)
    plain = attn.plain_attention(q, k, v, window)
    want = torch.autograd.grad(plain, (q, k, v), cot)
    torch.testing.assert_close(out, plain, atol=ATOL, rtol=RTOL)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
