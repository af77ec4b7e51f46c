"""Solver core of the port: GMRES(m), the block multi-RHS solver and
s-step GMRES, their row-sharded forms on torch.distributed, Arnoldi
schemes, Givens QR, operators (dense, ELL, banded, sliced ELL,
matrix-free), the preconditioners (and the operators' Gershgorin bounds),
stencils, graphs and the paper's offload strategies."""
from repro_torch.core.gmres import (BREAKDOWN, HEALTHY, NAN_INF, STAGNATED,
                                    STATUS_NAMES, Diagnostics, GmresResult,
                                    classify_residuals, gmres, gmres_batched,
                                    gmres_batched_cycle)
from repro_torch.core.operators import (BandedOperator, DenseOperator,
                                        FunctionOperator, SlicedEllOperator,
                                        SparseOperator, as_operator,
                                        random_diagdom, with_dtype)
from repro_torch.core import preconditioners
from repro_torch.core.sstep import gmres_sstep
from repro_torch.core.distributed import (gmres_sharded, gmres_sstep_sharded,
                                          local_operator, make_sharded_solver)

__all__ = ["gmres", "gmres_batched", "gmres_batched_cycle", "gmres_sstep",
           "gmres_sharded", "gmres_sstep_sharded", "make_sharded_solver",
           "local_operator",
           "GmresResult", "Diagnostics", "classify_residuals", "HEALTHY", "NAN_INF",
           "STAGNATED", "BREAKDOWN", "STATUS_NAMES", "DenseOperator",
           "SparseOperator", "BandedOperator", "SlicedEllOperator",
           "FunctionOperator", "as_operator", "with_dtype", "random_diagdom",
           "preconditioners"]
