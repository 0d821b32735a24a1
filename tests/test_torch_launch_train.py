"""The port's LM training launcher (``repro_torch.launch.train``) and gradient
compression (``repro_torch.optim.compression``) against the JAX package,
on the CPU: ``synthetic_batch``; 6 steps of SMOKE llama3.2-1b and of
SMOKE rwkv6-3b from the reference's weights, losses against the
reference's loop (``ref_losses``, the jitted step of
``repro.launch.train.main``, itself held to ``main``'s printed lines),
with the float64 witness of ``_lm_grad``;
a checkpoint the reference's ``main`` wrote at step 3 resumed by the
port; ``--compress`` for 3 steps; ``main``'s printed lines; and every
function of ``compression.py``, leaf order and ties included."""
import argparse
import contextlib
import io
import re
import sys
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_grad import check_trajectory, jax_f64, port_f64, sorted_leaves
from repro.configs import get_smoke_config as jax_get_smoke
from repro.launch import train as jtrain
from repro.models.lm import model as jmodel
from repro.optim import compression as jcomp
from repro.optim.optimizers import get_optimizer as jax_get_optimizer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import train
from repro_torch.optim import compression as comp
from repro_torch.optim import get_optimizer, tree_map

# f32 on both sides; the first step's loss agrees to about 1e-6, later
# ones are held with the witness (``_lm_grad.check_trajectory``)
ATOL = RTOL = 1e-4
B, S = 2, 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _args(**kw):
    base = dict(steps=6, batch=B, seq=S, lr=3e-4, optimizer="adamw",
                ckpt_dir=None, ckpt_every=10, compress=False, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def ref_losses(arch, steps, compress=False, f64=False):
    """The reference's loop: ``main``'s jitted step (or its
    ``grads_only``/``ErrorFeedback``/``apply_grads`` path) from
    ``PRNGKey(0)``, in f32 or (the witness) in f64; ([loss per step], the
    initial parameters)."""
    cfg = jax_get_smoke(arch)
    init = _np(jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    dt = np.float64 if f64 else np.float32

    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(dt) if a.dtype.kind == "f" else a)
    out = []
    with (jax_f64() if f64 else contextlib.nullcontext()):
        params = jax.tree_util.tree_map(cast, init)
        opt = jax_get_optimizer("adamw")
        st = opt.init(params)
        lr = jnp.asarray(3e-4, dt)

        @jax.jit
        def grads_only(p, b):
            return jax.value_and_grad(
                lambda q: jmodel.lm_loss(cfg, q, b, remat=True))(p)

        @jax.jit
        def apply(p, s, g):
            upd, s = opt.update(g, s, p, lr)
            return jax.tree_util.tree_map(
                lambda a, u: (a + u).astype(a.dtype), p, upd), s
        ef = jcomp.ErrorFeedback(k_frac=0.01) if compress else None
        for step in range(steps):
            b = {k: cast(v) for k, v in jtrain.synthetic_batch(
                cfg, B, S, step).items()}
            loss, grads = grads_only(params, b)
            if ef is not None:
                flat, spec = jcomp.flatten_grads(grads)
                _, flat_c = ef.compress(flat)
                grads = jcomp.unflatten_grads(flat_c, spec)
            params, st = apply(params, st, grads)
            out.append(float(loss))
    return out, init


def port_losses(arch, init, steps, f64=False, **kw):
    """The port's ``train_loop`` from the reference's initial parameters,
    in f32 or (the witness) in f64; [loss per step]."""
    dt = torch.float64 if f64 else torch.float32
    params = tree_map(lambda t: t.to(dt), lm_params_from_jax(init, "cpu"))
    opt = get_optimizer("adamw")
    with (port_f64() if f64 else contextlib.nullcontext()):
        _, state, got = train.train_loop(
            get_smoke_config(arch), params, opt.init(params),
            _args(steps=steps, **kw), opt, log=lambda _: None)
    assert sorted(got) == list(range(steps))
    assert int(state["step"]) == steps
    return [got[s] for s in range(steps)]


@pytest.fixture(scope="module")
def llama_ref():
    return ref_losses("llama3.2-1b", 6)


def _run_main(mod, argv):
    """``mod.main`` with ``argv``, its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if mod is jtrain:
            with unittest.mock.patch.object(sys, "argv", ["train"] + argv):
                mod.main()
        else:
            mod.main(argv)
    return buf.getvalue().splitlines()


def _step_losses(lines):
    return {int(m.group(1)): float(m.group(2)) for m in
            (re.match(r"step +(\d+)  loss (\S+)  \(", ln) for ln in lines)
            if m}


# ----------------------------------------------------------- synthetic_batch
@pytest.mark.parametrize("arch,smoke", [("llama3.2-1b", True),
                                        ("musicgen-large", True),
                                        ("internvl2-1b", True),
                                        ("internvl2-1b", False)])
def test_synthetic_batch_is_the_reference_s(arch, smoke):
    """Tokens, mask and a VLM's prefix, bit for bit (the full internvl2
    config's prefix in bf16)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    for step in (0, 7):
        got = train.synthetic_batch(cfg, 2, 16, step, "cpu")
        want = jtrain.synthetic_batch(cfg, 2, 16, step)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = lm_params_from_jax(np.asarray(w), "cpu")
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


# ---------------------------------------------------------------- the loop
def test_reference_loop_is_main_s(llama_ref):
    """``ref_losses`` is the reference's launcher: its losses printed as
    ``main`` prints them equal ``main``'s lines (steps 0 and 5)."""
    losses, _ = llama_ref
    lines = _run_main(jtrain, ["--arch", "llama3.2-1b", "--smoke",
                               "--steps", "6", "--batch", str(B), "--seq",
                               str(S)])
    printed = _step_losses(lines)
    assert sorted(printed) == [0, 5]
    for step, loss in printed.items():
        assert f"{losses[step]:.4f}" == f"{loss:.4f}"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-3b"])
def test_six_steps_match_the_reference_loop(arch, llama_ref):
    """6 steps from the reference's weights: the losses within 1e-4, held
    with the float64 witness of ``_lm_grad`` (rwkv6's f32 runs part from
    the f64 run by about 1e-2 at step 5, the reference's farther than the
    port's); the lines ``train_loop`` prints."""
    want, init = llama_ref if arch == "llama3.2-1b" else \
        ref_losses(arch, 6)
    got = port_losses(arch, init, 6)
    check_trajectory(arch, got, want, lambda: (
        port_losses(arch, init, 6, f64=True),
        ref_losses(arch, 6, f64=True)[0]))
    cfg = get_smoke_config(arch)
    logs = []
    params = lm_params_from_jax(init, "cpu")
    opt = get_optimizer("adamw")
    _, _, again = train.train_loop(cfg, params, opt.init(params), _args(),
                                   opt, log=logs.append)
    assert [again[s] for s in range(6)] == got
    assert [ln.split("  (")[0] for ln in logs] == [
        f"step {s:5d}  loss {got[s]:.4f}" for s in (0, 5)]


def test_resume_from_a_checkpoint_the_reference_wrote(tmp_path, llama_ref):
    """The reference's ``main`` stops after step 3 with a checkpoint; the
    port's loop, started from other weights, resumes from it (params and
    Adam state) and its steps 4 and 5 match the reference's uninterrupted
    run."""
    want, _ = llama_ref
    ck = str(tmp_path / "ck")
    _run_main(jtrain, ["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
                       "--batch", str(B), "--seq", str(S), "--ckpt-dir", ck,
                       "--ckpt-every", "4"])
    cfg = get_smoke_config("llama3.2-1b")
    params = train.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    opt = get_optimizer("adamw")
    logs = []
    _, state, got = train.train_loop(cfg, params, opt.init(params),
                                     _args(ckpt_dir=ck), opt,
                                     log=logs.append)
    assert logs[0] == "resumed from step 3"
    assert sorted(got) == [4, 5] and int(state["step"]) == 6
    np.testing.assert_allclose([got[4], got[5]], want[4:6],
                               atol=ATOL, rtol=RTOL)


def test_compress_three_steps_match_the_reference():
    """``--compress``: the gradient through ``flatten_grads``, 1% top-k
    with error feedback and ``unflatten_grads`` before AdamW, 3 steps,
    with the witness."""
    want, init = ref_losses("llama3.2-1b", 3, compress=True)
    got = port_losses("llama3.2-1b", init, 3, compress=True)
    check_trajectory("llama3.2-1b --compress", got, want, lambda: (
        port_losses("llama3.2-1b", init, 3, f64=True, compress=True),
        ref_losses("llama3.2-1b", 3, compress=True, f64=True)[0]))


def test_main_prints_the_reference_s_lines(tmp_path):
    """``main(["--smoke", "--device", "cpu", ...])``: the reference's
    lines in the reference's order (the losses differ: the packages
    initialise from different generators), a checkpoint every
    ``--ckpt-every`` steps and, run again, the resume line."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--steps", "6", "--batch",
            str(B), "--seq", "32", "--ckpt-every", "3", "--ckpt-dir"]
    got = _run_main(train, argv + [str(tmp_path / "port"), "--device",
                                   "cpu"])
    want = _run_main(jtrain, argv + [str(tmp_path / "ref")])

    def shape(lines):
        return [re.sub(r"loss \S+  \(\S+s\)", "loss L  (Ts)", ln)
                for ln in lines]
    assert shape(got) == shape(want)
    assert got[0].startswith("arch=llama3.2-1b-smoke layers=")
    assert got[1] == want[1]                 # params: ...M
    assert got[-1] == "done"
    again = _run_main(train, argv[:3] + ["--steps", "8"] + argv[5:] + [
        str(tmp_path / "port"), "--device", "cpu"])
    assert again[2] == "resumed from step 5"
    assert list(_step_losses(again)) == [7]


# -------------------------------------------------------------- compression
def _jax_order_tree(rng):
    """A tree whose dicts are built in non-sorted key order."""
    return {"zeta": rng.normal(size=(3, 2)).astype(np.float32),
            "alpha": [rng.normal(size=(4,)).astype(np.float32),
                      {"y": rng.normal(size=(2, 2)).astype(np.float32),
                       "b": rng.normal(size=(1,)).astype(np.float32)}],
            "mid": rng.normal(size=(5,)).astype(np.float32)}


def test_flatten_grads_lays_leaves_out_in_jax_s_order():
    tree = _jax_order_tree(np.random.default_rng(0))
    flat, spec = comp.flatten_grads(lm_params_from_jax(tree, "cpu"))
    jflat, jspec = jcomp.flatten_grads(tree)
    assert torch.equal(flat, torch.from_numpy(np.asarray(jflat)))
    back = comp.unflatten_grads(flat * 2, spec)
    assert list(back) == list(tree)            # the port's own key order
    assert list(back["alpha"][1]) == ["y", "b"]
    jback = jcomp.unflatten_grads(jflat * 2, jspec)
    for got, want in zip(sorted_leaves(back),
                         jax.tree_util.tree_leaves(jback)):
        assert torch.equal(got, torch.from_numpy(np.asarray(want)))
    # the LM's own gradient tree: the same vector as the reference's
    jp = _np(jmodel.init_params(jax_get_smoke("deepseek-v3-671b"),
                                jax.random.PRNGKey(0)))
    assert torch.equal(comp.flatten_grads(lm_params_from_jax(jp, "cpu"))[0],
                       torch.from_numpy(np.asarray(
                           jcomp.flatten_grads(jp)[0])))


def _payload_equal(got, want):
    assert got.size == want.size
    assert got.indices.dtype == torch.int32
    assert got.indices.tolist() == np.asarray(want.indices).tolist()
    assert torch.equal(got.values, torch.from_numpy(np.asarray(
        want.values)))


@pytest.mark.parametrize("k", [1, 5, 17, 64])
def test_topk_matches_lax_top_k_with_ties(k):
    """Magnitudes drawn from few values, both signs, so k cuts through
    ties: the same indices in the same order as ``lax.top_k``
    (descending magnitude, ties by ascending index) and the same
    decompressed vector."""
    rng = np.random.default_rng(k)
    x = (rng.integers(1, 5, 64) * rng.choice([-1.0, 1.0], 64)).astype(
        np.float32)
    got = comp.topk_compress(torch.from_numpy(x), k)
    want = jcomp.topk_compress(jnp.asarray(x), k)
    _payload_equal(got, want)
    assert torch.equal(comp.topk_decompress(got), torch.from_numpy(
        np.asarray(jcomp.topk_decompress(want))))


def test_topk_tie_rule_is_lower_index_first():
    x = torch.tensor([1.0, -3.0, 3.0, 2.0, -3.0, 3.0])
    p = comp.topk_compress(x, 3)
    assert p.indices.tolist() == [1, 2, 4]
    assert p.values.tolist() == [-3.0, 3.0, -3.0]
    assert comp.topk_compress(x, 99).indices.tolist() == [1, 2, 4, 5, 3, 0]


def test_error_feedback_matches_the_reference_over_rounds():
    """Three rounds on a gradient-like vector (0.1% of entries large):
    payloads, decompressed vectors and residuals equal."""
    rng = np.random.default_rng(3)
    got_ef, want_ef = comp.ErrorFeedback(0.01), jcomp.ErrorFeedback(0.01)
    for _ in range(3):
        g = rng.normal(size=4000).astype(np.float32)
        g[rng.integers(0, 4000, 4)] *= 100
        p, sent = got_ef.compress(torch.from_numpy(g))
        jp, jsent = want_ef.compress(jnp.asarray(g))
        _payload_equal(p, jp)
        assert torch.equal(sent, torch.from_numpy(np.asarray(jsent)))
        assert torch.equal(got_ef._residual,
                           torch.from_numpy(np.asarray(want_ef._residual)))


def test_int8_quantization_rounds_half_to_even_like_the_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, -127.0, 64.5],
                 np.float32)
    q, scale = comp.quantize_int8(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert float(scale) == 1.0 == float(jscale)
    assert q.dtype == torch.int8
    assert q.tolist() == np.asarray(jq).tolist() == \
        [127, 0, 2, 2, 0, -2, 3, -127, 64]
    y = np.random.default_rng(4).normal(size=(7, 9)).astype(np.float32)
    q, scale = comp.quantize_int8(torch.from_numpy(y))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(y))
    assert q.tolist() == np.asarray(jq).tolist()
    assert torch.equal(comp.dequantize_int8(q, scale), torch.from_numpy(
        np.asarray(jcomp.dequantize_int8(jq, jscale))))


def test_launcher_runs_on_the_card_unless_asked_for_the_cpu():
    ap = train.parser()
    assert ap.parse_args(["--arch", "llama3.2-1b"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
