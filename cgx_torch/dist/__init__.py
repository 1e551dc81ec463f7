"""Distributed layer: row partitioning, halo exchange, row-sharded CG.

Counterpart of :mod:`cgx.dist`: a 1-D process mesh over matrix rows
(:class:`RowMesh`; NCCL on the cards, gloo on the CPU), the ring halo
exchange of a partitioned operator's off-block columns (or an all-gather
for unbanded sparsity), the port's CG loops with their dots summed over
the ranks, the one-level additive-Schwarz IC(0), the 2-D process grid, and
the fused engines K3 and K5 across ranks (ghost x-planes, fp64 sums
reduced between the kernels), the WBELL engine on row-group shards (K7 and
K8 over each shard's row layout, :mod:`cgx_torch.dist.wbell`) and the df64
refinement across ranks over it (the sharded df64 true residual,
:mod:`cgx_torch.dist.hp`).

Every rank runs the same program (``torchrun`` on cards, :func:`run_spmd`
on the CPU).  The collectives each rank calls are counted in
:mod:`cgx_torch.dist.halo`.
"""
from cgx_torch.dist.partition import (Partition, LocalPartition,
                                      partition_csr, partition_dia,
                                      pad_vector, unpad_vector)
from cgx_torch.dist.halo import halo_exchange, local_matvec
from cgx_torch.dist.launch import (RowMesh, initialize, is_multihost,
                                   global_row_mesh, make_row_mesh, run_spmd)
from cgx_torch.dist.solve import AXIS, dist_cg_solve, gather_rows
from cgx_torch.dist.schwarz import IC0SweepBlocks, ic0_sweep_blocks
from cgx_torch.dist.grid2d import (Partition2D, partition_csr_2d,
                                   make_grid_mesh, dist_cg_solve_2d)
from cgx_torch.dist.fused import (dist_fused_cg, dist_fused_cg_multi,
                                  dist_fused_supported)
from cgx_torch.dist.wbell import (WBellPartition, partition_wbell,
                                  dist_wbell_cg_solve,
                                  dist_wbell_cg_solve_internal,
                                  dist_wbell_cg_solve_multi)
from cgx_torch.dist.hp import (partition_df64_ell, make_dist_ir_df64_solver,
                               dist_ir_df64_solve,
                               make_dist_ir_df64_solver_multi,
                               dist_ir_df64_solve_multi)

__all__ = [
    "Partition", "LocalPartition", "partition_csr", "partition_dia",
    "pad_vector", "unpad_vector", "halo_exchange", "local_matvec", "AXIS",
    "dist_cg_solve", "make_row_mesh", "gather_rows", "RowMesh",
    "initialize", "is_multihost", "global_row_mesh", "run_spmd",
    "IC0SweepBlocks", "ic0_sweep_blocks", "Partition2D", "partition_csr_2d",
    "make_grid_mesh", "dist_cg_solve_2d", "dist_fused_cg",
    "dist_fused_cg_multi", "dist_fused_supported", "WBellPartition",
    "partition_wbell", "dist_wbell_cg_solve", "dist_wbell_cg_solve_internal",
    "dist_wbell_cg_solve_multi", "partition_df64_ell",
    "make_dist_ir_df64_solver", "dist_ir_df64_solve",
    "make_dist_ir_df64_solver_multi", "dist_ir_df64_solve_multi",
]
