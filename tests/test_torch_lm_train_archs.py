"""``lm_loss`` and its gradient, port against the JAX package, on the
SMOKE configs with a recurrent or MoE layer, on the CPU: the loss within
1e-4 and every gradient leaf held with the float64 witness of
``_lm_grad`` (the reference's init makes these gradients ill-conditioned
in f32; in f64 the two packages agree to 1e-9). deepseek-v3 adds its MTP
term. Weights are the reference's init, carried by ``lm_params_from_jax``;
the dense configs are in ``test_torch_lm_train_dense.py``."""
import pytest

from _lm_grad import check_arch

ARCHS = ("recurrentgemma-2b", "rwkv6-3b", "deepseek-v2-lite-16b",
         "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_leaf_match_the_reference(arch):
    check_arch(arch)
