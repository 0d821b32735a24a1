"""``lm_loss`` and its gradient, port against the JAX package, on the
SMOKE configs of attention-only models, on the CPU (as
``test_torch_lm_train_archs.py``): internvl2 with its patch-embedding
prefix, musicgen with 4-codebook labels."""
import pytest

from _lm_grad import check_arch

ARCHS = ("llama3.2-1b", "qwen2-1.5b", "command-r-plus-104b", "granite-34b",
         "internvl2-1b", "musicgen-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_leaf_match_the_reference(arch):
    check_arch(arch)
