"""Solver core of the port: GMRES(m), Arnoldi schemes, Givens QR,
operators and the paper's offload strategies."""
from repro_torch.core.gmres import (BREAKDOWN, HEALTHY, NAN_INF, STAGNATED,
                                    STATUS_NAMES, Diagnostics, GmresResult,
                                    classify_residuals, gmres)
from repro_torch.core.operators import (DenseOperator, FunctionOperator,
                                        as_operator, random_diagdom)

__all__ = ["gmres", "GmresResult", "Diagnostics", "classify_residuals",
           "HEALTHY", "NAN_INF", "STAGNATED", "BREAKDOWN", "STATUS_NAMES",
           "DenseOperator", "FunctionOperator", "as_operator",
           "random_diagdom"]
