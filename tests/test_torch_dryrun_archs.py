"""The port's dry run (``repro_torch.launch.dryrun.run_cell``) on the
SMOKE cells of the ten LM archs, on a fake (4, 4) ("data", "model")
process group at B=8, S=64: each (arch, kind) cell runs with no error and
reports a sharded step (collectives, memory, a roofline). This file holds
the seven archs of attention and RG-LRU layers; the two MoE archs' cells
are in ``test_torch_dryrun_moe.py``, rwkv6-3b's and the expert-parallel
exchange's in ``test_torch_dryrun_shmap.py``, and deepseek-v2-lite's and
rwkv6's (2, 2) prefills beside the reference's ``analyze_hlo`` in
``test_torch_dryrun_ref_archs.py`` (each file within about 40 s). Cells on a (2, 8) mesh, whose "model"
axis divides none of the SMOKE heads, make no strided shard
(``strided_shards_made``).

The fake process group (world 16, this process rank 0) lives for this
module's tests only."""
import pytest

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun

B, S = 8, 64
DP = TP = 4
MOE_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
RWKV_ARCH = "rwkv6-3b"
ARCHS = [a for a in ARCH_IDS if not a.startswith("gnn-")
         and a not in MOE_ARCHS and a != RWKV_ARCH]
KINDS = ("prefill", "train", "decode")


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    dryrun.fake_group(DP * TP)
    try:
        yield make_test_mesh((DP, TP))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_2x8(mesh):
    """(2, 8) on the same fake group of 16 ranks: a "model" axis that
    divides d_model but not the SMOKE configs' 4 heads or 4 codebooks, as
    16 does not divide rwkv6-3b's 40 heads at production size."""
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh((2, 8))


def strided_shards_made(monkeypatch):
    """A list that grows by one each time DTensor makes a strided shard:
    a merge of sharded dimensions that torch 2.11 (the card machine's)
    refuses and this torch accepts."""
    from torch.distributed.tensor.placement_types import _StridedShard
    made = []
    init = _StridedShard.__init__

    def counted(self, *a, **kw):
        made.append(type(self).__name__)
        init(self, *a, **kw)
    monkeypatch.setattr(_StridedShard, "__init__", counted)
    return made


def run_smoke_cell(mesh, arch, kind, **kw):
    return dryrun.run_cell(arch, kind, "test", verbose=False, mesh=mesh,
                           cfg=get_smoke_config(arch),
                           shape=ShapeSpec(kind, S, B, kind), **kw)


def check_cell(cell, chips):
    assert "error" not in cell
    assert cell["chips"] == chips
    h, m, r = cell["hlo"], cell["memory"], cell["roofline"]
    assert h["flops"] > 0 and h["dot_flops"] > 0
    assert h["collective_bytes"] > 0
    assert 0 < m["argument_bytes"] < m["peak_bytes"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_the_sweep_covers_every_lm_arch():
    lm = [a for a in ARCH_IDS if not a.startswith("gnn-")]
    assert len(lm) == 10
    assert sorted(ARCHS + list(MOE_ARCHS) + [RWKV_ARCH]) == sorted(lm)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_runs_on_a_fake_4x4_mesh(mesh, arch, kind):
    check_cell(run_smoke_cell(mesh, arch, kind), DP * TP)
