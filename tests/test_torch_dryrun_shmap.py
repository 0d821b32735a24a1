"""The dry-run cells whose layers run inside ``local_map``, on a fake (4, 4)
("data", "model") process group at B=8, S=64:

* rwkv6-3b's SMOKE prefill, train and decode: its time mix splits 5·16
  LoRA columns into 5 and 4 heads of 32 over a "model" axis of 4, so the
  LoRA output is gathered before its split (``splittable``), and each
  rank runs the chunks of its own (batch, heads) (``_wkv_parallel``);
* deepseek-v2-lite-16b under ``moe_dispatch="shmap"``: ``_ep_member`` on
  every rank inside ``local_map``, its two exchanges functional
  all-to-alls over the "model" axis, which the counter records.

Also rwkv6-3b's and musicgen-large's train step on a (2, 8) mesh whose
"model" axis divides neither their heads nor their codebooks. The fake
process group (world 16, this process rank 0) lives for this module's
tests only."""
import pytest

from test_torch_dryrun_archs import DP, KINDS, MOE_ARCHS, RWKV_ARCH, TP, \
    check_cell, mesh, mesh_2x8, run_smoke_cell, \
    strided_shards_made  # noqa: F401  (mesh, mesh_2x8 are fixtures)


@pytest.mark.parametrize("kind", KINDS)
def test_rwkv6_cell_runs_on_a_fake_4x4_mesh(mesh, kind):
    check_cell(run_smoke_cell(mesh, RWKV_ARCH, kind), DP * TP)


@pytest.mark.parametrize("kind", KINDS)
def test_shmap_moe_cell_exchanges_tokens(mesh, kind):
    arch = MOE_ARCHS[0]
    cell = run_smoke_cell(mesh, arch, kind, moe_dispatch="shmap")
    check_cell(cell, DP * TP)
    assert cell["hlo"]["collectives"]["all-to-all"] > 0
    if kind == "prefill":
        # each rank routes its own tokens: no (T, E, C) dispatch einsum
        einsum = run_smoke_cell(mesh, arch, kind)
        assert einsum["hlo"]["collectives"]["all-to-all"] == 0
        assert cell["hlo"]["dot_flops"] < einsum["hlo"]["dot_flops"]


@pytest.mark.parametrize("arch", [RWKV_ARCH, "musicgen-large"])
def test_train_step_on_heads_the_model_axis_does_not_divide(
        mesh_2x8, monkeypatch, arch):
    """rwkv6-3b's merged heads and musicgen-large's (K·V) logits split
    over a "model" axis that divides neither the heads nor the codebooks
    (production: 40 heads over 16): each split is made splittable first,
    forward and backward, and no strided shard is made."""
    made = strided_shards_made(monkeypatch)
    check_cell(run_smoke_cell(mesh_2x8, arch, "train"), DP * TP)
    assert made == []
