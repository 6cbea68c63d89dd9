"""PyTorch port: the analytic cost model, the shape cells and the
roofline held to the JAX package on the CPU.

``cell_costs`` (FLOPs, HBM bytes, collective bytes and model FLOPs of a
cell, per device) is arithmetic on the config: the port's must equal the
JAX package's exactly, for every architecture x applicable shape x mesh
x a grid of knobs.  ``applicable_shapes`` and the shape cells equal the
JAX package's, and ``roofline_terms`` fed the JAX module's own peaks
equals its ``roofline_terms`` exactly."""
import itertools

import pytest

from repro.configs.base import SHAPES_BY_NAME as J_SHAPES
from repro.configs.base import applicable_shapes as j_applicable_shapes
from repro.configs.registry import ARCHS as J_ARCHS
from repro.distributed import hlo_analysis as jha
from repro.distributed.costmodel import MeshDims as JMeshDims
from repro.distributed.costmodel import cell_costs as j_cell_costs
from repro_torch.configs.base import SHAPES_BY_NAME, applicable_shapes
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.costmodel import MeshDims, cell_costs
from repro_torch.distributed.trace_analysis import roofline_terms
from repro_torch.launch.dryrun import model_flops_global

MESHES = ((1, 1, 1), (256, 16, 16), (512, 32, 16), (4, 2, 2))
TRAIN_GRID = list(itertools.product(("none", "dots", "full"), (1, 4),
                                    (16.0, 12.0), (0, 64), (False, True)))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_applicable_shapes_match_jax(arch):
    """The same cells for every architecture: no decode for the encoder,
    long_500k only for ssm and hybrid."""
    got = [(s.name, s.seq_len, s.global_batch, s.kind)
           for s in applicable_shapes(ARCHS[arch])]
    want = [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in j_applicable_shapes(J_ARCHS[arch])]
    assert got == want
    assert sorted(SHAPES_BY_NAME) == sorted(J_SHAPES)
    kinds = {s[3] for s in got}
    assert ("decode" in kinds) == (ARCHS[arch].family != "encoder")


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_cell_costs_match_jax_exactly(arch):
    """Every applicable shape on four meshes: training over remat x
    microbatches x optimizer bytes x ssm_chunk x attention skipping,
    serving under fsdp and tp_only; every number equal (==, no
    tolerance), and the dry run's model FLOPs its ``model_flops_global``."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    n = 0
    for shape in applicable_shapes(cfg):
        jshape = J_SHAPES[shape.name]
        for dims in MESHES:
            md, jmd = MeshDims(*dims), JMeshDims(*dims)
            if shape.kind == "train":
                cases = [dict(remat=r, microbatches=m, opt_bytes_per_param=o,
                              ssm_chunk=c, attn_skip=a)
                         for r, m, o, c, a in TRAIN_GRID]
            else:
                cases = [dict(serve_params=p) for p in ("fsdp", "tp_only")]
            for kw in cases:
                got = cell_costs(cfg, shape, md, **kw)
                want = j_cell_costs(jcfg, jshape, jmd, **kw)
                assert got == want, (shape.name, dims, kw)
                assert got["model_flops_global"] == model_flops_global(
                    cfg, shape)
                n += 1
    assert n >= len(MESHES) * (len(TRAIN_GRID) + 2)


@pytest.mark.parametrize("flops,nbytes,coll,model", [
    (1e15, 1e12, 1e10, 6e14), (3e12, 8e11, 0.0, 1e12),
    (1e9, 1e9, 5e11, 0.0), (0.0, 0.0, 0.0, 0.0)])
def test_roofline_terms_match_jax_given_its_peaks(flops, nbytes, coll, model):
    """The port's ``roofline_terms`` with the JAX module's PEAK_FLOPS,
    HBM_BW and ICI_BW is the JAX ``roofline_terms``, field for field."""
    got = roofline_terms(flops, nbytes, coll, model,
                         peak_flops=jha.PEAK_FLOPS, hbm_bw=jha.HBM_BW,
                         link_bw=jha.ICI_BW).to_dict()
    want = jha.roofline_terms(flops, nbytes, coll, model).to_dict()
    assert got == want


def test_roofline_takes_the_collective_seconds_when_given():
    """The dry run's collective term is reckoned group by group; the
    other terms stay the H100 spec sheet's."""
    r = roofline_terms(989e12, 3.35e12, 1e9, 989e12, coll_seconds=2.5)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 2.5)
    assert r.bottleneck == "collective" and r.roofline_fraction == 0.4
