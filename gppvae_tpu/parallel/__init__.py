"""Scale-out layer: device mesh, shardings, sharded-N GP math.

The reference is single-process single-GPU (SURVEY.md §2.2: no distributed
backend at all); this layer is the scaling story (SURVEY.md §5):
a 1-D `data` mesh over the chips, the dataset/latent/feature matrices
row-sharded over it, and the GP's R-sized reductions (Gram UᵀU, UᵀZ)
psum'ed over the interconnect — XLA's SPMD partitioner inserts the collectives from
sharding annotations (the scaling-book recipe: pick a mesh, annotate, let
XLA do the rest). Validated without hardware on a virtual CPU mesh
(SURVEY.md §4.5) and by __graft_entry__.dryrun_multichip.
"""

from gppvae_tpu.parallel.spmd_audit import (
    assert_wire_structure,
    audit_fused_wire,
    audit_lowered,
    parse_collectives,
)
from gppvae_tpu.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    replicated,
    row_sharding,
    shard_params_model_axis,
    shard_rows,
    trim_to_multiple,
)

__all__ = [
    "assert_wire_structure",
    "audit_fused_wire",
    "audit_lowered",
    "parse_collectives",
    "make_mesh",
    "make_mesh_2d",
    "replicated",
    "row_sharding",
    "shard_params_model_axis",
    "shard_rows",
    "trim_to_multiple",
]
