"""The dry run of the two MoE archs (deepseek-v2-lite-16b, deepseek-v3-671b)
on a fake (4, 4) ("data", "model") process group at B=8, S=64, under the
default einsum dispatch: on DTensors the MoE layer builds the reference's
one-hot formulation (``moe.routed_einsum``), whose dispatch and combine
the counter sees as the reference's HLO has them, split over the
experts' "model" shards; and deepseek-v3's train step on a (2, 8) mesh
whose "model" axis does not divide its heads. The fake process group
(world 16, this process rank 0) lives for this module's tests only."""
import pytest

from test_torch_dryrun_archs import DP, KINDS, MOE_ARCHS, TP, check_cell, \
    mesh, mesh_2x8, run_smoke_cell, \
    strided_shards_made  # noqa: F401  (mesh, mesh_2x8 are fixtures)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_einsum_moe_cell_runs_on_a_fake_4x4_mesh(mesh, arch, kind):
    cell = run_smoke_cell(mesh, arch, kind)
    check_cell(cell, DP * TP)
    # the einsum dispatch moves no token across ranks by all-to-all
    assert cell["hlo"]["collectives"]["all-to-all"] == 0


def test_mla_train_step_on_heads_the_model_axis_does_not_divide(
        mesh_2x8, monkeypatch):
    """deepseek-v3's q LoRA, MLA's up-projections and its merged heads
    split over a "model" axis that does not divide its 4 SMOKE heads:
    made splittable first, forward and backward; no strided shard."""
    made = strided_shards_made(monkeypatch)
    check_cell(run_smoke_cell(mesh_2x8, MOE_ARCHS[1], "train"), DP * TP)
    assert made == []
