"""Hand-written Hopper kernels of the port, each beside its plain version.

The solver's: ``matvec`` (GEMV / block GEMM), ``cgs2`` (fused Gram-Schmidt
pass; the pipelined step's single-reduce payload and update),
``arnoldi_fused`` (whole Arnoldi step), ``spmv`` (ELL, sliced ELL,
banded), ``block_gs`` (s-step block passes, split and single-reduce;
per-lane CGS2), ``matrix_powers`` (the s-step cycle's powers; the fused
Chebyshev apply), ``trisolve`` (ILU(0) setup and triangular sweeps).
The model stack's: ``attention`` (online-softmax attention with GQA and
a sliding window), ``ssd`` (the Mamba2 SSD chunked scan), ``gated_norm``
(the SiLU gate fused with RMSNorm).
Sources are in ``repro_torch/csrc``; ``_build`` compiles them with
``nvcc`` at the first launch.  Importing these modules builds nothing.
"""
