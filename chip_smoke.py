"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --in-turn DIR [GROUP ...]   # the redesigned
        # kernel-table rows and their cells, the tree at DIR (e.g. `git
        # archive` of the parent commit, unpacked) against this one in
        # turn (measure_cells); GROUP: redesign1 (rows 7 and 20), gemv
        # (rows 4 and 6), redesign3 (rows 1 and 19), redesign4 (row 13
        # and the ILU(0) setup), redesign5 (rows 2 and 9: the streamed
        # cgs2 / gs_project and block_gs_pass, each wrapper's host cost,
        # the dense and banded cgs2_fused and banded s-step solves),
        # redesign6 (rows 17 and 5: ell_powers beside banded_powers, the
        # payload beside row 4, rows 15 and 18, the ELL s-step and banded
        # pipelined solves), redesign7 (rows 14 and 18: banded_powers and
        # ell_powers at s = 2 / 5 / 8, the Chebyshev apply at orders 2 / 4
        # / 8, SHA-256 held to the parent's, row 15, the banded s-step and
        # Chebyshev(4) solves), redesign8 (row 21: ssd_scan with zamba2's
        # decays at S = 512 and 2,048, f32 and bf16, within the kernel's
        # bar of the parent's output; a 12-layer full-width zamba2-7b
        # prefill), redesign9 (rows 12 and 10: block_gs_project_gram and
        # block_gs_project at n = 2^20, k_start 0 / 12 / 25, f32 and bf16,
        # Q the parent's bits, rows 9 and 11 the parent's SHA-256, one and
        # two blocks an SM, the banded pipelined s-step and one-rank
        # sharded s-step solves); default all nine;
        # redesign3_sweep (the launch shapes of rows 1 and 19) only when
        # named

Phases, one JSON line each (``"phase": ...``):

1. build      compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process
              per source, in parallel); nvcc version; card and power limit;
              ``ptxas -v``'s registers, stack frame, spills and static
              shared memory of
              the sliced-ELL, bf16 attention, ILU(0) wavefront,
              batched_cgs2, streamed GS (gs_stream_kernel), block-GS
              pass, ELL powers (by storage and width bucket), banded
              powers and Chebyshev apply (by storage and band count) and the
              projections' column-sweep and block-a-row kernels (by
              storage, bucket, pieces at once and right-hand columns:
              row 4 and the payload), the SSD scan's kernels (state and
              output by storage and column tiles, and the pass), the
              s-step projections (block_gs_project_gram_kernel by
              storage, s and M: rows 12 and 10), and the
              HGMMA (wgmma) instructions in each attention
              instantiation's SASS and the HMMA (mma.sync) ones in each
              SSD product kernel's (``cuobjdump -sass``); a missing
              instantiation or tensor-core instruction fails the run.
2. kernels    every kernel of the main path against its plain PyTorch
              version on the card, at the main path's shapes (n = 10,000,
              m1 = 31), float32 and bfloat16 storage.  Bars: max relative
              error 1e-4 (float32; another summation order over 10^4 terms)
              and 2e-2 (bfloat16).  block_matvec also at n = 10,003 (rows
              off the 16-byte grid: its one-row route), k = 1 and 4, each
              call's route and the same bits on a second call.
3. solve      the main path: restarted GMRES(30), tol 1e-5, 50 restarts, on
              two numpy-seeded random_diagdom(n = 10,000) systems
              (dominance 2.0 and 0.015), through gs = cgs2 / cgs2_fused /
              fused with ``DenseOperator(backend="cuda")``.  Every launch
              counter is set to 0 just before and read just after; each
              kernel must have launched, and as often as the scheme implies.
              Checks: converged, true relres <= 2 tol, restarts within +-1
              across schemes, solutions within 1e-3 (norm-wise relative),
              and a small system solved on the card agreeing with the CPU.
4. strategies the paper's four strategies (Table 1) at n = 1,000 / 4,000 /
              10,000, dominance 2.0, and at n = 10,000 on the dominance-0.015
              system that runs whole cycles: wall time (host clock ending in
              torch.cuda.synchronize()) and speedup over serial_numpy.
5. timing     each kernel over 50 warm launches at the main path's shape:
              device time from the profiler's kernel records, and CUDA-event
              time of the back-to-back calls; beside it its plain version,
              one PyTorch call where one computes the same function, and the
              bound (the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s
              float32).  The cooperative kernels' blocks per SM are swept
              (each setting checked against the plain version), and
              gs_project's streamed kernel is timed at the same shape
              beside its shared-memory pass.  Per solve: wall and device
              time per Arnoldi step.

The sparse slice (stencil and graph systems, the block multi-RHS solver):

6. sparse_kernels  the SpMV kernels (ELL, banded, sliced ELL) and
              ``batched_cgs2`` against their plain versions on the card,
              float32 and bfloat16 storage, same bars as phase 2, at every
              k the solves give them: ELL and banded on
              convection_diffusion_2d(1024, 1024) (n = 2^20, 5 bands) at
              k = 1 and 4; sliced ELL on pagerank_system(8192) (rows
              sorted, <= 8 bins) and on the 1024^2 stencil (identity order)
              at k = 1, 4 and 8, in the sorted frame and through the
              operator (the permutation applied in the kernel);
              batched_cgs2 at k = 4, n = 2^20, m1 = 31,
              per-lane j = (0, 7, 15, 29), and at k = 8, n = 8192, with
              its split of the grid over the lanes and the same bits on a
              second call; the kernel's own launch rule (bucket, pieces
              at once, block size) equal to ``tuning``'s copy at 1-31 rows;
              gs_project and the streamed cgs2 (one launch) at n = 2^20,
              j = 0, 15, 29 and 30, and on their scalar route (n = 2^20 +
              3; w one element off 16 bytes), each call's route counted
              and the same bits on a second call.
7. sparse_solve GMRES(30), tol 1e-5, 200 restarts, on the 1024^2
              convection-diffusion system (b from numpy seed 1) through
              fmt = banded / ell / sell (each on its SpMV kernel), under gs =
              cgs2 and cgs2_fused.  Counters zeroed around each solve and
              held to the scheme (SpMV launches = steps + restarts + 1, one
              per mat-vec in every format; the streamed cgs2 = steps
              under cgs2_fused, no gs_project).  Checks:
              converged, true relres <= 2 tol, the true residual after the
              first restart equal across formats within 1e-4, restarts
              within 10% (about 70 restarts on an ill-conditioned system
              drift by a few with the summation order), x within 1e-3 of
              the banded solve's (norm-wise relative), and the 32^2
              system on the card against the CPU (restarts +-1, x 1e-3).
8. batched_solve  gmres_batched: a PageRank burst (pagerank_system(8192),
              8 personalization vectors from numpy seed 0, per-lane tol
              1e-6..1e-3, 100 restarts): every lane converges, sums to 1
              within 1e-4 and agrees with the scalar solve of that lane
              (restarts +-1, x 1e-3); and 4 right-hand sides (numpy seeds
              1-4) on the 1024^2 banded stencil, true relres <= 2 tol.
              batched_cgs2 launches once per lockstep step, the SpMV once
              per block mat-vec; the operator's mat-vec runs no scatter
              (no index_copy in its host profile).
9. sparse_timing  phase 5's timing for the new kernels at those shapes,
              with L2 emptied before every call (in a solve the basis
              traffic evicts the operands between two calls of one
              kernel); the warm back-to-back time stands beside it as
              ``warm_ms``.  The bound is the bytes each must move (per
              PERF.md); each sliced-ELL bin is timed alone through the
              bin-table kernel (a one-bin table), and the widest
              (hub) bin at 32, 64, 128 and 256 threads per row in
              ``tuning`` rows, each held to the plain version; the library
              yardstick is one call computing the same function (a CSR
              ``torch.mv`` of the same matrix, cuSPARSE, for ELL, banded
              and sliced ELL).  Per solve: wall / device ms per Arnoldi
              step, the device idle share and the device time per step of
              each kernel, for the banded cgs2_fused solve, the PageRank
              burst and phase 8's 4-lane 1024^2 batch (per lockstep step,
              with batched_cgs2's ms a launch in the solve).

The s-step slice (s = 5, 6 blocks: m = 30):

10. sstep_kernels  the matrix-powers kernels (banded, ELL, dense) and
              ``block_gs_pass`` against their plain versions on the card,
              float32 and bfloat16 storage, same bars as phase 2, at
              s = 2, 5 and 8: banded and ELL powers on the 1024^2
              convection-diffusion stencil, unshifted and with the Newton
              shifts of its Gershgorin interval, the ELL powers on their
              "resident" route and with banded_powers' bits (checked);
              banded_powers on each route of its plan, shifted, the same
              bits twice (nine bands at 1024^2: the stack partly resident
              in float32; a halo past any tile at n = 2^20: "far"; the
              1023 x 1021 stencil: the scalar copies; 8M rows: "l2"; one
              band at n = 1,000);
              the ELL powers' "stream" route on a table too wide to keep
              (4,096 x 1,200, ragged), the same bits twice; dense powers
              at n = 10,000;
              block_gs_pass at m1 = 31, n = 2^20 and n = 10,000, s = 1,
              2, 5 and 8, k_start 0, 10, 25 and 30, and on its scalar route
              (n = 2^20 + 3; W one element off 16 bytes), each call's route
              and the same bits on a second call.
11. sstep_solve  gmres_sstep, tol 1e-5, monomial and Newton bases: the
              dense n = 10,000 dominance-0.015 system (Newton runs the
              reference powers over the GEMV kernel) and the 1024^2 stencil
              (b from numpy seed 1, 200 restarts) as banded, ELL and sliced
              ELL (reference powers over the SpMV kernel).  Counters zeroed
              around each solve: powers launches = blocks x cycles,
              block_gs_pass = 2 x blocks x cycles, the operator's mat-vec
              (one launch in every format) once per residual (and s x
              blocks x cycles on the reference powers).  Checks:
              converged, true relres <= 2 tol, restarts
              within 10% (and +-1) of phase 3's / phase 7's gmres(30) cgs2
              count (dense Newton: +-1 of the same solve on the CPU, as its
              Gershgorin shifts cost it restarts), first-restart residuals
              equal across formats within 1e-4, and the 32^2 system on the
              card against the CPU (restarts +-1, x 1e-3).
              device_resident_sstep also runs in phase 4.
12. sstep_timing  phase 5's and phase 9's timing for the four kernels
              (dense warm, sparse cold; the composite yardstick is s
              torch.mv or CSR torch.mv calls with norms for the powers and
              four cuBLAS products for block_gs_pass), and per s-step solve
              wall and device ms per Arnoldi step, the device idle share and
              the host syncs per cycle (PyTorch's sync debug mode), beside
              the cgs2_fused / fused solves of phases 5 and 9 and their
              syncs per step.

The pipelined slice (gs = "cgs2_pipelined"):

13. pipelined_kernels  the single-reduce payload (gs_project_norm_partial),
              gs_update, block_gs_project_gram and block_gs_update against
              their plain versions on the card, float32 and bfloat16
              storage, same bars as phase 2: payload and update at
              n = 10,000 and 2^20, m1 = 31, j = 0, 15, 29 (the payload
              on its "row" and "vec" routes, and at STREAM_EDGES on the
              route its plan gives, "scalar" where misaligned, each the
              same bits twice; the update on
              the row prefix V[:j+1], as the cycle calls it, and bit-equal
              to the full call); the update at odd n and on views one
              element off 16 bytes (STREAM_EDGES), h a row view, with the
              route each call took (16-byte pieces or scalar, counted) and
              the same bits on a second call; the block pair and the
              whole single-reduce pass at n = 2^20 and 10,000, k_start 0
              and 25, s = 5.
14. pipelined_solve  gmres(gs="cgs2_pipelined"), tol 1e-5, on the dense
              n = 10,000 dominance-0.015 system and the 1024^2 stencil as
              banded, ELL and sliced ELL, held to phase 3's / phase 7's
              cgs2_fused solve of the same system: converged, true relres
              <= 2 tol, restarts within +-1 (10% on the stencil), x within
              1e-3; banded and ELL first-restart residuals the same bits.
              Counters: payload = steps, gs_update = 2 x steps (all on
              the 16-byte route), the operator's mat-vec (one launch)
              steps + 2 restarts + 1, no gs_project.  Then wall, device
              ms and idle share per step and host syncs per step (sync
              debug mode) of the dense and banded solves beside
              cgs2_fused's, timed in turn, and for
              the dense pair where a step's host time goes (the host
              profile's ops and the time outside them).
15. sstep_sr_solve  gmres_sstep(s=5, blocks=6, gs="cgs2_pipelined") on the
              dense system and the banded and ELL stencil, held to phase
              11's split solve (restarts +-1, 10% on the stencil, x 1e-3);
              block_gs_project_gram and block_gs_update launch 2 x blocks
              per cycle, block_gs_pass never; host syncs at most 3 per
              cycle; wall, device and idle per step of the dense and banded
              solves beside the split solve's, timed in turn.
              Last, the four kernels' times at the path's shapes (cold at
              n = 2^20, warm at 10,000) beside their bounds, plain versions
              and composite yardsticks (no single library call computes
              any of them).

The preconditioning slice (the 1024^2 stencil of phase 7):

16. precond_kernels  each kernel against its plain version on the card
              (the sweep's and the setup's plain versions on a host copy
              of the same inputs), bars 1e-4 (float32) and 2e-2 (bfloat16
              bands) relative to the largest entry of the plain result:
              banded_cheb_apply at 1024^2 and 32^2, order 2, 4 and 8, the
              interval of estimate_interval, float32 and bfloat16 bands,
              and on each route of its plan (phase 10's band stacks, the
              same bits twice);
              banded_trisweep lower/unit, lower/non-unit and upper/non-unit
              on the ILU(0) and line-Jacobi factors of the 1024^2 stencil
              (float32 and bfloat16 bands) and of the 1023 x 1021 one (n
              not a multiple of the scan's tile, chunks of 1,023 rows) and
              a random (-2, -1, 0) pattern at n = 200 and 2^16 (chunks of
              2), k = 1 and 4, each call's route (scan without a far band,
              else chunk) and the same bits on a second call; ilu0_factor
              at 64^2, 128^2 and 1024^2 on the five-point pattern and at
              1024^2 on line-Jacobi's (-1, 0, 1): the plain version's bits,
              and at 1024^2 the JAX test's property, (L U - A) on the
              pattern within 5e-5 of max|A|, by banded products on the
              card.
17. precond_solve  GMRES(30), tol 1e-5, 200 restarts, b from numpy seed
              1: gmres(gs="cgs2_fused") with chebyshev(order=4),
              banded_ilu0, line_jacobi and jacobi; gmres(gs=
              "cgs2_pipelined") with chebyshev(4); gmres_sstep(s=5,
              blocks=6) with chebyshev(4) and banded_ilu0; gmres_batched on
              phase 8's 4-lane batch with chebyshev(4).  Checks: converged,
              true relres <= 2 tol, x within 1e-3 of phase 7's
              unpreconditioned cgs2_fused x, strictly fewer restarts than
              it for Chebyshev, ILU(0) and line-Jacobi, and the 32^2 system
              on the card against the CPU (restarts +-1, x 1e-3).
              Counters zeroed around each setup (ILU(0) factors once,
              Chebyshev's interval makes 8 mat-vecs) and each solve: one
              apply per Arnoldi step and one per cycle (gmres), plus one
              per cycle for the pipelined prologue, s x blocks + 1 per
              cycle (gmres_sstep: the reference powers over A M^-1);
              Chebyshev launches once per apply, ILU(0) sweeps twice; the
              batched Chebyshev apply runs order - 1 block mat-vecs; each
              solve's wall time with its preconditioner's setup.  The
              sweeps' routes exactly: ILU(0) all on the chunk route,
              line-Jacobi all on the scan.  gmres(cgs2_fused) restarts
              within +-1 of PRECOND_RESTARTS.
18. precond_timing  each kernel cold at the path's shapes (order 4; the
              ILU(0) and line-Jacobi L and U sweeps, k = 1, with the
              route, and for the chunk route the chain floor, the same
              chain with nothing loaded, trisolve.chain_probe; the ILU(0)
              setup on the five-point and line-Jacobi patterns, with its
              time per link of the chain of dependent rows, 2 NX - 1 and
              NX) with its launches, bound, plain version and
              yardstick: for Chebyshev the composite of order - 1 CSR
              torch.mv calls and the vector ops, for a sweep
              torch.triangular_solve of the CSR factor (cuSPARSE) where
              PyTorch runs it (the sweep's and the setup's plain versions,
              thousands of small ops, by CUDA events over one call); the
              setup times of estimate_interval and the preconditioners;
              per solve wall, device and idle share
              per Arnoldi step and the time to solution, without and with
              the setup, beside the unpreconditioned banded cgs2_fused
              solve timed in turn.

The row-sharded slice, on a one-rank NCCL process group (``file://``
rendezvous in a temporary directory; the card has one GPU, and NCCL puts
no two ranks on one device, so multi-rank NCCL is not run here):

19. sharded_kernels  gs_project_partial, block_gs_project,
              banded_powers_halo, banded_matvec_halo and ell_matvec_halo
              against their plain versions on the card, float32 and
              bfloat16 storage, phase 2's bars, at full width (the 1024^2
              stencil, n = 2^20, j = 15, k_start 25, s = 5, the band stack
              pre-scaled as the s-step solver scales it), and split four
              ways in one process: the shards' halos cut from the global
              vectors as halo_exchange delivers them, the partials summed
              in rank order, held to the full-width call;
              gs_project_partial also at phase 13's edge shapes and
              n = 10,000, j = 0, 7, 8, 15, 30 (every row bucket and the
              block-a-row launch), with its routes and repeat bits.
20. sharded_solve  gmres_sharded and gmres_sstep_sharded at full width on
              the dense n = 10,000 dominance-0.015 system and the 1024^2
              stencil (banded, ELL, sliced ELL) under gs = cgs2_fused and
              cgs2_pipelined; s-step banded (s = 5, 6 blocks) under cgs2
              and cgs2_pipelined; chebyshev(4), jacobi and
              banded_block_jacobi on the banded stencil and block_jacobi on
              the dense system.  Each held to the one-device port solve of
              the same system (phases 3, 7, 11 where they ran it, else run
              here; banded_block_jacobi on one rank is banded_ilu0):
              converged, true relres <= 2 tol, restarts within +-1 (10% on
              the 70-restart stencil), x within 1e-3.  Counters zeroed
              around each solve and held to the scheme, and the
              collectives (tuning.COLLECTIVES) to the JAX package's count
              per step (per block) plus the solve's own; the 32^2 system on
              the card (NCCL) against the CPU (a gloo group).
21. sharded_timing  each new kernel cold (L2 emptied) and warm at the
              path's shapes, float32 and bfloat16, beside its bound, its
              plain version, a composite over the rows the kernel reads
              (row 4: torch.mv(V[:j+1], w) + pad; row 10: two
              torch.matmul over V[:k_start+1] + pad; row 15: s CSR
              torch.mv + norms) and a library call (row 4: the cuBLAS
              GEMV torch.mv(V[:j+1], w); the halo SpMVs: the CSR torch.mv
              of the same matrix, cuSPARSE), row 4 also at n = 10,000;
              then the dense and banded
              cgs2_fused, banded cgs2_pipelined and banded s-step solves
              over their first TIMING_RESTARTS cycles, one device and
              sharded in turn (one device, sharded, sharded, one
              device): wall and device ms
              per step, idle share, and the time spent in collectives per
              step (host, around the calls, and per call by kind; device,
              the NCCL kernels in the profile).  The sharded solves
              also count gs_project_partial's routes (none scalar).

The model slice, zamba2-7b serving at full published width and depth
(81 Mamba2 layers, 13 shared-attention sites, 6.75e9 float32 parameters
drawn from torch.Generator("cuda") seed 0, bfloat16 compute):

22. model_kernels  attention, ssd_scan and gated_rmsnorm against their
              plain versions on the card, float32 and bfloat16 storage
              (attention: bfloat16 through the wgmma kernel, float32
              through the float32 one, each call's route counted),
              phase 2's bars (ssd_scan 3e-4 in float32, the JAX test's
              own bar: it takes exps of cumulative sums), at the JAX
              package's sweep shapes and at zamba2's prefill shapes
              (attention (2, 32, 512, 112); ssd_scan (224, 512, 64),
              N = 64, Q = 256; gated_rmsnorm (1024, 7168)); ssd_scan
              also with zamba2's decays (lg = dt A, A from -1 to -16:
              cum down to -10^3 in a chunk) at SSD_STRONG_SHAPES (the
              prefill, eight chunks, off the 16-byte route, G by
              windows, P > 64), with each call's route.
23. model_serve  make_prefill_step at b = 2, S = 512 (numpy seed 0
              tokens): counters zeroed before and read after, exactly 13
              attention (all 13 on the wgmma kernel), 81 ssd_scan (81
              launches of each of its two kernels) and 81
              gated_rmsnorm launches; logits
              finite; the same prefill at compute_dtype float32 through
              the kernels against their plain versions (patched in here
              with unittest.mock, not switched in the package) within 1e-3
              of max|logit| (its 13 attention launches on the float32
              kernel), and the bfloat16 difference printed.  Greedy
              serving through launch.serve.generate: 512 prompt steps and
              32 tokens (the decode path is plain PyTorch, as in JAX: no
              kernel launches), tokens in range, the last prompt step's
              logits against the prefill's printed; the float32 prefill
              of the first 16 tokens against 16 float32 decode steps,
              printed.  zamba2_7b.reduced() on the card against the port
              on the CPU: prefill and 12 decode steps (float32 cache)
              within 1e-4.
24. model_timing  each kernel cold and warm at zamba2's shapes beside its
              bound, its plain version and a library call (attention: the
              wgmma kernel, and the float32 kernel at the same shape)
              (scaled_dot_product_attention(is_causal=True); the composite
              F.rms_norm(y * F.silu(z)); none for the SSD scan, whose
              bound counts the flops it needs (C B^T once per batch row
              and chunk, no C H in the first chunk, no state update in
              the last) in three TF32 passes, and whose kernels are also
              timed apart, from the same profile); per
              prefill wall ms, device ms by kernel class (the three
              kernels, GEMMs, other), idle share and prompt tokens/s; per
              decode token wall and device ms and idle share.

Then one ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises: the script exits non-zero and prints no result line.  Without a
CUDA device it fails at once.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs.gmres_paper import CONFIG  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bfloat16, tensor cores, dense
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32, tensor cores, dense
# The paper's experiment: its largest system, m = 30, 50 restarts.  tol is
# 1e-5, not the config's 1e-6, as in benchmarks/gmres_strategies.py: the
# solves run in float32.
N = CONFIG.sizes[-1]
M = CONFIG.restart_m
MAX_RESTARTS = CONFIG.max_restarts
TOL = 1e-5
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLUSH_BYTES = 256 << 20        # rewritten before a cold call: 5x the L2
PROFILE_TRIES = 3              # profiles taken before a time is "not measured"
SCHEMES = ("cgs2", "cgs2_fused", "fused")
# The sparse slice: the JAX package's sparse walkthrough
# (examples/sparse_poisson.py) at a grid its users solve, n = 2^20.
NX = 1024
BETA = (0.5, 0.25)
SPARSE_RESTARTS = 200          # the 1024^2 system needs about 71
FORMATS = ("banded", "ell", "sell")
SPARSE_SCHEMES = ("cgs2", "cgs2_fused")
PAGERANK_N = 8192
PAGERANK_K = 8
PAGERANK_TOLS = (1e-6, 1e-5, 1e-4, 1e-3)
BGS_SHAPES = ((4, NX * NX, (0, 7, 15, 29)),
              (8, PAGERANK_N, (0, 3, 7, 12, 15, 20, 25, 29)))
# The s-step slice: s = 5, 6 blocks (m = 30, the paper's m); kernels held
# to their plain versions at s = 2, 5, 8 and block-GS k_start 0, 10, 25.
SSTEP_S = 5
SSTEP_BLOCKS = 6
SSTEP_S_CHECK = (2, 5, 8)
BGS_K = (0, 10, 25)
SSTEP_BASES = ("monomial", "newton")
# The pipelined slice: the payload and update at steps j = 0, 15, 29, the
# single-reduce block pair at k_start = 0 and 25 (s = 5).
PIPE_J = (0, 15, 29)
PIPE_K = (0, 25)
# The streaming GEMV pair's edge shapes (phases 13 and 19): (n, elements
# into a buffer).  Odd n and views one element off 16 bytes.
STREAM_EDGES = ((N + 3, 0), (N, 1), (NX * NX + 3, 0), (NX * NX, 1), (5, 0))
# The sharded slice's timing runs the first 10 of the stencil's 70 cycles.
TIMING_RESTARTS = 10
# gmres(30, cgs2_fused) restarts of the preconditioned 1024^2 solves
# (phase 17; PERF.md section 5): held within +-1
PRECOND_RESTARTS = {"chebyshev": 20, "banded_ilu0": 16, "line_jacobi": 45,
                    "jacobi": 70}
# The model slice: zamba2-7b at full size, batch 2, a 512-token prompt (two
# SSD chunks), 32 generated tokens; the kernels at the JAX package's sweep
# shapes (tests/test_kernels.py) and at the prefill's.
ZAMBA_BATCH = 2
ZAMBA_PROMPT = 512
ZAMBA_GEN = 32
REDUCED_DECODE_STEPS = 12
DECODE_TIMING_TOKENS = 16
# (b, hq, hkv, sq, skv, window, causal, d)
ATTN_SHAPES = ((2, 4, 2, 256, 256, None, True, 64),
               (1, 8, 8, 128, 128, None, True, 64),
               (1, 8, 2, 128, 384, None, True, 64),
               (2, 4, 4, 256, 256, 64, True, 64),
               (1, 4, 2, 1, 300, None, True, 64),
               (1, 4, 4, 128, 128, None, False, 64),
               (1, 2, 2, 320, 320, 96, True, 64),
               (ZAMBA_BATCH, 32, 32, ZAMBA_PROMPT, ZAMBA_PROMPT, None, True,
                112))
# (batch, heads, s, p, n, chunk)
SSD_SHAPES = ((2, 3, 64, 16, 8, 16), (1, 2, 96, 32, 16, 32),
              (1, 1, 48, 8, 8, 48), (ZAMBA_BATCH, 112, ZAMBA_PROMPT, 64, 64,
                                     256))
# zamba2's decays (cum down to -10^3 in a chunk) at its prefill, eight
# chunks, a sweep shape, and off the 16-byte route and tiles (N = 6, P = 5,
# Q = 20: scalar; Q = 512: G by windows; P = 100: the wide instantiation)
SSD_STRONG_SHAPES = ((ZAMBA_BATCH, 112, ZAMBA_PROMPT, 64, 64, 256),
                     (1, 4, 2048, 64, 64, 256), (2, 3, 64, 16, 8, 16),
                     (1, 2, 40, 5, 6, 20), (1, 2, 1024, 64, 64, 512),
                     (1, 2, 128, 100, 64, 64))
NORM_SHAPES = ((4, 64, 256), (100, 512), (2, 33, 384),
               (ZAMBA_BATCH * ZAMBA_PROMPT, 7168),
               (5, 7, 99))                # element loads: 99 % 4 != 0
SSD_TOLS = {torch.float32: 3e-4, torch.bfloat16: 2e-2}
# zamba2-7b cut to this depth (full width) for the in-turn prefill of
# row 21: two shared-attention sites, twelve Mamba2 layers
REDESIGN8_LAYERS = 12


T0 = time.perf_counter()


def emit(**row) -> None:
    if "phase" in row:                   # seconds since the script started
        row["t_s"] = round(time.perf_counter() - T0, 1)
    print(json.dumps(row), flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def relerr(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def abserr(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def timed(fn, iters=50, warmup=5, cold=False) -> dict:
    """Per-call times of fn() over `iters` calls.

    ``ms`` is device time: the profiler's kernel records summed (what the
    card spent on the call).  ``event_ms`` is CUDA-event time, which also
    holds any gaps left by host-side launch cost.  ``host_ms`` is the
    host's time to enqueue one call (Python, the wrapper, the launch).  If
    the profiler records no device time, ``ms`` is "not measured" (None)
    and only ``event_ms`` stands.

    Warm (the default): back-to-back calls, so operands that fit the 50 MB
    L2 stay there.  ``cold``: a FLUSH_BYTES buffer is rewritten before
    every call, outside the times (its kernel is left out of ``ms``, and
    events time each call alone), so every call reads its operands from
    HBM, as a solve's calls do once the basis traffic has evicted them.
    Where the profile does not show one flush kernel per call (none to
    leave out, or records lost), ``ms`` is "not measured" (None) and only
    ``event_ms`` stands.  A profile that shows
    neither is taken again, up to PROFILE_TRIES times.  Cold, a profile
    counts only if every kernel in it was recorded a whole number of times
    a call, and ``by_kernel`` is that profile's device ms a call by kernel
    name (the flush left out; summing to ``ms``), else None.
    """
    from torch.profiler import ProfilerActivity, profile

    flush = (torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
             if cold else None)

    def call():
        if cold:
            flush.bitwise_not_()
        fn()

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    if cold:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        host_s = 0.0
        for start, stop in pairs:
            flush.bitwise_not_()
            t0 = time.perf_counter()
            start.record()
            fn()
            stop.record()
            host_s += time.perf_counter() - t0
        torch.cuda.synchronize()
        event_ms = sum(a.elapsed_time(b) for a, b in pairs) / iters
        host_ms = host_s * 1e3 / iters
    else:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        stop.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(stop) / iters
    dev_ms, by_kernel = 0.0, None
    for _ in range(PROFILE_TRIES):       # a profile may record no kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        if cold:
            # a profile that lost kernel records (fewer flushes than
            # calls, or a kernel recorded a fraction of times a call)
            # would undercount the calls' time: take it again
            counts = {e.key: e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
            whole = all(n % iters == 0 for n in counts.values()) and sum(
                n for key, n in counts.items() if is_flush(key)) == iters
            names = {key: ms / iters for key, ms in kernel_ms(prof).items()
                     if not is_flush(key)}
            dev_ms = sum(names.values()) if whole else 0.0
            if whole:
                by_kernel = {}
                for key, ms in names.items():
                    by_kernel[key[:80]] = by_kernel.get(key[:80], 0.0) + ms
        else:
            dev_ms = device_ms(prof) / iters
        if dev_ms > 0:
            break
    out = {"ms": dev_ms if dev_ms > 0 else None, "event_ms": event_ms,
           "host_ms": host_ms}
    if cold:
        out["by_kernel"] = by_kernel if dev_ms > 0 else None
    return out


def cold_ms(fn, iters=50) -> float:
    """Device time of one cold call (``timed(cold=True)``), or its
    CUDA-event time where the profile lost kernel records."""
    t = timed(fn, iters=iters, cold=True)
    return t["ms"] if t["ms"] is not None else t["event_ms"]


def device_ms(prof) -> float:
    """Device time (ms) of the kernels and copies a profile recorded."""
    return sum(kernel_ms(prof).values())


def kernel_ms(prof) -> dict:
    """Device time (ms) of each kernel and copy a profile recorded, by
    name."""
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def is_flush(key: str) -> bool:
    """Is this the cold timing's L2 flush kernel (``bitwise_not_``; the
    name holds it mangled or not)?"""
    return "bitwise_not" in key


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type (float32 by default)."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def basis(n, m1, j, dtype, gen):
    """Orthonormal rows 0..j, zeros after: the state at Arnoldi step j."""
    q, _ = torch.linalg.qr(torch.randn(n, j + 1, device="cuda",
                                       generator=gen))
    v = torch.zeros(m1, n, device="cuda")
    v[: j + 1] = q.T
    return v.to(dtype).contiguous()


def banded_route_cases(gen):
    """Band stacks that take each route of the banded powers and the
    Chebyshev apply (``matrix_powers.banded_plan``), float32, each with the
    route, the residency and the 16-byte flag its plan must have: the
    1024^2 stencil with nine bands (the stack partly resident in float32),
    a halo past any tile at n = 2^20 (route "far", the near bands in the
    tile), the 1023 x 1021 stencil (n odd: the scalar copies), 8M rows (route
    "l2": not even a block's rows fit), one band at n = 1,000."""
    from repro_torch.core import stencils

    big = 1 << 20
    odd = stencils.convection_diffusion_2d(1023, 1021, beta=BETA)
    both = {torch.float32: "all", torch.bfloat16: "all"}
    yield ("nine bands 1024^2", torch.randn(9, big, device="cuda",
                                            generator=gen) / 3,
           tuple(range(-4, 5)), "tile",
           {torch.float32: "partly", torch.bfloat16: "all"}, 1)
    yield ("far bands n = 2^20", torch.randn(5, big, device="cuda",
                                             generator=gen) / 3,
           (-300_000, -1, 0, 1, 300_000), "far", both, 1)
    yield "1023 x 1021", odd.bands, odd.offsets, "tile", both, 0
    yield ("8M rows", torch.randn(3, 8_000_000, device="cuda",
                                  generator=gen) / 2,
           (-1, 0, 1), "l2", {torch.float32: "partly",
                              torch.bfloat16: "partly"}, 1)
    yield ("one band n = 1,000", torch.randn(1, 1000, device="cuda",
                                             generator=gen), (0,), "tile",
           both, 1)


def banded_route_check(name, bands, offsets, route, resident, vec, x):
    """The plan of a route case against what it must be (``resident``: by
    storage type); returns it."""
    from repro_torch.kernels import matrix_powers as mp

    plan = mp.banded_plan(bands, offsets, x)
    got = ("all" if plan["res_seg"] == plan["per"] else "partly",
           plan["route"], plan["vec"])
    resident = resident[bands.dtype]
    check(got == (resident, route, vec),
          f"banded route case {name} {bands.dtype}: (resident, route, vec) "
          f"{got}, wanted {(resident, route, vec)}")
    return plan


def stream_edge(nb, m1, off, dtype, gen):
    """V (m1, nb) and w (nb,) for the streaming GEMV pair's edges: random,
    rows of norm about 1, each ``off`` elements into a buffer of its own
    (off = 1: not 16-byte aligned, the scalar route)."""
    vbuf = (torch.randn(m1 * nb + off, device="cuda", generator=gen)
            / nb ** 0.5).to(dtype)
    wbuf = torch.randn(nb + off, device="cuda", generator=gen)
    return vbuf[off:].view(m1, nb), wbuf[off:]


def zero_routes(*fns) -> None:
    """Set the route counters of the streaming GEMV pair to 0."""
    for fn in fns:
        fn.routes = dict.fromkeys(fn.routes, 0)


def lane_bases(k, n, m1, js, dtype, gen):
    """(k, m1, n) lane bases: lane l orthonormal in rows 0..js[l]."""
    v = torch.zeros(k, m1, n, device="cuda")
    for lane, j in enumerate(js):
        v[lane] = basis(n, m1, j, torch.float32, gen)
    return v.to(dtype).contiguous()


def csr_of(values, cols):
    """The stored nonzeros of an ELL table as a CSR tensor (cuSPARSE's
    format): the library yardstick of the ELL kernels."""
    n, width = values.shape
    rows = torch.arange(n, device=values.device).repeat_interleave(width)
    keep = values.reshape(-1) != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols.reshape(-1)[keep].long()]),
        values.reshape(-1)[keep].float(), (n, n))
    return coo.coalesce().to_sparse_csr()


def solve_timing(run, steps: int, phase="sparse_timing", walls: int = 1,
                 **info) -> dict:
    """Wall (host clock ending in a sync) and device (profiler) time of one
    solve, per Arnoldi step, the device's idle share, and each kernel's
    device time per step inside the solve (operands as the solve leaves
    them in L2, not as a timing loop does).  The profile records the
    card's activity only: per-op host records cost tens of seconds over a
    solve of some 30,000 small ops.  ``walls`` > 1: the solve's wall is
    the median of that many runs (host time varies from run to run), each
    listed in ``wall_ms_per_step_runs``."""
    from torch.profiler import ProfilerActivity, profile

    run()                                     # warm
    runs = []
    for _ in range(walls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(runs)[len(runs) // 2]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_ms = device_ms(prof)
    by_kernel = sorted(kernel_ms(prof).items(), key=lambda kv: -kv[1])
    row = dict(info, steps=steps, wall_ms=wall_ms,
               wall_ms_per_step=wall_ms / steps,
               device_ms=dev_ms if dev_ms > 0 else None,
               device_ms_per_step=dev_ms / steps if dev_ms > 0 else None,
               host_overhead_ms_per_step=(wall_ms - dev_ms) / steps
               if dev_ms > 0 else None,
               device_idle_share=1 - dev_ms / wall_ms if dev_ms > 0 else None,
               device_ms_per_step_by_kernel={name[:100]: ms / steps
                                             for name, ms in by_kernel[:8]})
    if walls > 1:
        row["wall_ms_per_step_runs"] = [ms / steps for ms in runs]
    emit(phase=phase, **row)
    return row


def bgs_split(v, w, js) -> dict:
    """The blocks ``batched_cgs2`` gives each lane for these operands
    (``block_gs.launch_plan``; trees without it: None)."""
    from repro_torch.kernels import block_gs

    if not hasattr(block_gs, "launch_plan"):
        return None
    wf = w.float().contiguous()
    plan = block_gs.launch_plan(v, wf, torch.empty_like(wf), js)
    return {key: plan[key] for key in ("blocks", "grid", "route")}


def batch_timing(run, lockstep: int, phase: str, **info) -> dict:
    """``solve_timing`` of a ``gmres_batched`` solve per lockstep step,
    with ``batched_cgs2``'s device ms a launch in the solve (it launches
    once a lockstep step)."""
    row = solve_timing(run, lockstep, phase=phase, **info)
    per = [ms for name, ms in row["device_ms_per_step_by_kernel"].items()
           if "batched_cgs2" in name]
    row["batched_cgs2_ms_per_launch"] = per[0] if per else None
    emit(phase=phase, solve=info.get("solve"),
         batched_cgs2_ms_per_launch=row["batched_cgs2_ms_per_launch"],
         device_idle_share=row["device_idle_share"])
    return row


class Counters:
    """The launch counters of a phase: ``zero`` just before a solve,
    ``read`` just after it (adding the phase's own kernels' counts to
    ``totals``), ``expect`` holds every counter to the scheme's count."""

    def __init__(self, kernels: dict, **others):
        self.kernels = kernels
        self.counted = dict(kernels, **others)
        self.totals = {name: 0 for name in kernels}

    def zero(self) -> None:
        for fn in self.counted.values():
            fn.launches = 0

    def read(self) -> dict:
        d = {name: fn.launches for name, fn in self.counted.items()}
        for name in self.kernels:
            self.totals[name] += d[name]
        return d

    def expect(self, d: dict, expect: dict, what: str) -> None:
        for name in self.counted:
            check(d[name] == expect.get(name, 0),
                  f"{what}: {name} launched {d[name]}, expected "
                  f"{expect.get(name, 0)}")


def sparse_phases(smi, gen):
    """Phases 6-9: the sparse slice.  Returns (max abs errors, main-path
    launches, timing rows) of its kernels, keyed by wrapper name, the
    banded gmres(30) cgs2 restart count and the banded cgs2_fused solve's
    timing row."""
    from repro_torch.core import (gmres, gmres_batched, graphs, operators,
                                  stencils)
    from repro_torch.kernels import (arnoldi_fused, block_gs, cgs2, matvec,
                                     spmv, tuning)

    ctr = Counters({"ell_matvec": spmv.ell_matvec,
                    "sell_matvec": spmv.sell_matvec,
                    "banded_matvec": spmv.banded_matvec,
                    "batched_cgs2": block_gs.batched_cgs2,
                    "cgs2": cgs2.cgs2},
                   block_matvec=matvec.block_matvec,
                   gs_project=cgs2.gs_project,
                   arnoldi_step=arnoldi_fused.arnoldi_step)
    kernels, launches = ctr.kernels, ctr.totals
    zero, read, expect_counts = ctr.zero, ctr.read, ctr.expect
    fmt_kernel = {"banded": "banded_matvec", "ell": "ell_matvec",
                  "sell": "sell_matvec"}
    errs = {name: [] for name in (*kernels, "gs_project")}
    n = NX * NX

    # ---- the systems ----------------------------------------------------
    t0 = time.perf_counter()
    ops = {fmt: stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt=fmt)
           for fmt in FORMATS}
    stencil_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr_op, make_rhs = graphs.pagerank_system(PAGERANK_N, seed=0, fmt="sell")
    pagerank_s = time.perf_counter() - t0
    emit(phase="sparse_build", n=n, stencil_s=stencil_s,
         stencil_sell_bins=[list(v.shape) for v in ops["sell"].bin_values],
         stencil_sell_identity=ops["sell"].identity_perm,
         pagerank_n=PAGERANK_N, pagerank_s=pagerank_s,
         pagerank_bins=[list(v.shape) for v in pr_op.bin_values],
         pagerank_identity=pr_op.identity_perm,
         pagerank_storage=pr_op.storage_entries)
    check(ops["sell"].identity_perm, "the stencil's sliced ELL is not in "
                                     "identity order")
    check(not pr_op.identity_perm and 1 < len(pr_op.bin_values) <= 8,
          f"pagerank sliced ELL: {len(pr_op.bin_values)} bins, identity "
          f"{pr_op.identity_perm}")

    # ---- 6. kernels vs plain --------------------------------------------
    def compare(name, got, want, dtype, **info):
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            rel = max(relerr(g, w) for g, w in zip(got, want))
            err = max(abserr(g, w) for g, w in zip(got, want))
        else:
            rel, err = relerr(got, want), abserr(got, want)
        errs[name].append(err)
        emit(phase="sparse_kernels", kernel=name, dtype=str(dtype),
             max_rel_err=rel, max_abs_err=err, **info)
        check(rel < TOLS[dtype], f"{name} {info} {dtype}: {rel}")

    for dtype in (torch.float32, torch.bfloat16):
        ell = operators.with_dtype(ops["ell"], dtype)
        band = operators.with_dtype(ops["banded"], dtype)
        for system, sop in (("stencil", operators.with_dtype(ops["sell"],
                                                             dtype)),
                            ("pagerank", operators.with_dtype(pr_op,
                                                              dtype))):
            for k in (1, 4, PAGERANK_K):
                x = torch.randn(sop.shape[0], k, device="cuda", generator=gen)
                want = spmv.sell_matvec_plain(sop.bin_values, sop.bin_cols, x)
                compare("sell_matvec",
                        spmv.sell_matvec(sop.bin_values, sop.bin_cols, x),
                        want, dtype, system=system, n=sop.shape[0], k=k,
                        bins=len(sop.bin_values), frame="sorted")
                # the operator's path: perm applied in the kernel
                compare("sell_matvec", sop(x),
                        torch.zeros_like(want).index_copy_(
                            0, sop.perm.long(), want),
                        dtype, system=system, n=sop.shape[0], k=k,
                        bins=len(sop.bin_values), frame="original")
        for k in (1, 4):
            x = torch.randn(n, k, device="cuda", generator=gen)
            compare("ell_matvec", spmv.ell_matvec(ell.values, ell.cols, x),
                    spmv.ell_matvec_plain(ell.values, ell.cols, x), dtype,
                    system="stencil", n=n, k=k)
            compare("banded_matvec",
                    spmv.banded_matvec(band.bands, x, band.offsets),
                    spmv.banded_matvec_plain(band.bands, x, band.offsets),
                    dtype, system="stencil", n=n, k=k)
        for k, nb, js in BGS_SHAPES:
            v = lane_bases(k, nb, M + 1, js, dtype, gen)
            w = torch.randn(k, nb, device="cuda", generator=gen)
            got = block_gs.batched_cgs2(v, w, js)
            again = block_gs.batched_cgs2(v, w, js)
            compare("batched_cgs2", got,
                    block_gs.batched_cgs2_plain(v, w, js), dtype, k=k, n=nb,
                    m1=M + 1, j=list(js), split=bgs_split(v, w, js),
                    same_bits_twice=all(torch.equal(a, b)
                                        for a, b in zip(got, again)))
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"batched_cgs2 k={k} {dtype}: other bits on a second call")
            del v, w
        # the split (tuning) keeps the kernel's buckets, pieces at once
        # and block size
        elem = 4 if dtype == torch.float32 else 2
        rule = [(rows, block_gs.kernel_unroll(rows, elem),
                 tuning.batched_unroll(rows, elem) + (tuning.BATCHED_THREADS,))
                for rows in range(1, M + 2)]
        check(all(c == py for _, c, py in rule),
              f"batched_cgs2: the kernel's launch rule differs from "
              f"tuning's: {[r for r in rule if r[1] != r[2]]}")
        # gs_project (one pass) and cgs2 (one launch, three sweeps) at the
        # sparse solver's n: the streamed kernel from j = 0 to m1 - 1, and
        # its scalar route (n not a multiple of 4; w one element off 16
        # bytes), each call's route counted and the same bits twice
        for nb, j, off in ((n, 0, 0), (n, 15, 0), (n, 29, 0), (n, M, 0),
                           (n + 3, 15, 0), (n, 15, 1)):
            v = basis(nb, M + 1, j, dtype, gen)
            w = torch.randn(nb + off, device="cuda", generator=gen)[off:]
            want = "vec" if off == 0 and (nb * v.element_size()) % 16 == 0 \
                else "scalar"
            for name, fn, plain in (
                    ("gs_project", cgs2.gs_project, cgs2.gs_project_plain),
                    ("cgs2", cgs2.cgs2, cgs2.cgs2_plain)):
                routes = dict(fn.routes)
                got, again = fn(v, w, j), fn(v, w, j)
                route = [r for r, c in fn.routes.items() if c != routes[r]]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                compare(name, got, plain(v, w, j), dtype, n=nb, m1=M + 1,
                        j=j, w_offset=off, route=route, same_bits_twice=same,
                        plan=cgs2.launch_plan(v, w, j))
                check(route == [want] and fn.routes[want] == routes[want] + 2,
                      f"{name} n={nb} j={j} w+{off} {dtype}: route {route}")
                check(same, f"{name} n={nb} j={j} {dtype}: other bits on a "
                            f"second call")
            del v, w
        del ell, band

    # ---- 7. the sparse solves -------------------------------------------
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    bands64 = ops["banded"].bands.double()
    offsets = ops["banded"].offsets

    def relres(x, rhs) -> float:
        r = spmv.banded_matvec_plain(bands64, x.double(), offsets) \
            - rhs.double()
        return float(r.norm() / rhs.double().norm())

    bnorm = float(b.double().norm())
    solves = {}
    for gs in SPARSE_SCHEMES:
        for fmt in FORMATS:
            op = ops[fmt]
            zero()
            t0 = time.perf_counter()
            res = gmres(op, b, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
                        gs=gs, history=SPARSE_RESTARTS + 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = read()
            rr = relres(res.x, b)
            first = float(res.residual_history[-res.restarts]) / bnorm
            emit(phase="sparse_solve", fmt=fmt, gs=gs, n=n,
                 converged=res.converged, restarts=res.restarts,
                 inner_steps=res.inner_steps, true_relres=rr,
                 first_restart_relres=first, wall_s=wall, launches=d)
            check(res.converged, f"{fmt}/{gs} did not converge")
            check(rr <= 2 * TOL, f"{fmt}/{gs}: true relres {rr}")
            check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
                  f"{fmt}/{gs}: x not finite or wrong shape")
            expect = {fmt_kernel[fmt]: res.inner_steps + res.restarts + 1}
            if gs == "cgs2_fused":     # the streamed cgs2: one launch
                expect["cgs2"] = res.inner_steps
            expect_counts(d, expect, f"{fmt}/{gs}")
            solves[(fmt, gs)] = (res, first)
        ref_first = solves[("banded", gs)][1]
        for fmt in FORMATS:
            first = solves[(fmt, gs)][1]
            check(abs(first - ref_first) <= 1e-4 * ref_first,
                  f"{gs}: first-restart residual {fmt} {first} vs banded "
                  f"{ref_first}")
    restarts = [res.restarts for res, _ in solves.values()]
    x_rel = {f"{fmt}/{gs}": float((solves[(fmt, gs)][0].x
                                   - solves[("banded", gs)][0].x).norm()
                                  / solves[("banded", gs)][0].x.norm())
             for gs in SPARSE_SCHEMES for fmt in FORMATS[1:]}
    emit(phase="sparse_solve", restarts=restarts, x_rel_to_banded=x_rel)
    check(max(restarts) <= 1.1 * min(restarts),
          f"restart counts differ by more than 10%: {restarts}")
    check(max(x_rel.values()) <= 1e-3,
          f"x differs from the banded solve's: {x_rel}")

    # the 32^2 system on the card against the CPU
    b_s = np.random.default_rng(1).standard_normal(32 * 32).astype(np.float32)
    for fmt in FORMATS:
        op_c = stencils.convection_diffusion_2d(32, 32, beta=BETA, fmt=fmt)
        op_h = stencils.convection_diffusion_2d(32, 32, beta=BETA, fmt=fmt,
                                                device="cpu")
        for gs in SPARSE_SCHEMES:
            res = gmres(op_c, torch.from_numpy(b_s).cuda(), m=M, tol=TOL,
                        max_restarts=SPARSE_RESTARTS, gs=gs)
            ref = gmres(op_h, torch.from_numpy(b_s), m=M, tol=TOL,
                        max_restarts=SPARSE_RESTARTS, gs=gs)
            diff = float((res.x.cpu() - ref.x).norm() / ref.x.norm())
            emit(phase="sparse_solve", reference="cpu", n=32 * 32, fmt=fmt,
                 gs=gs, restarts=[res.restarts, ref.restarts], x_rel=diff)
            check(res.converged and ref.converged
                  and abs(res.restarts - ref.restarts) <= 1 and diff <= 1e-3,
                  f"{fmt}/{gs}: card and CPU disagree at 32^2 ({diff})")
    zero()

    # ---- 8. the batched solves ------------------------------------------
    pv = np.random.default_rng(0).random((PAGERANK_K, PAGERANK_N))
    b_pr = torch.stack([make_rhs(v) for v in pv])
    tols = np.array([PAGERANK_TOLS[i % len(PAGERANK_TOLS)]
                     for i in range(PAGERANK_K)], np.float32)
    t0 = time.perf_counter()
    res = gmres_batched(pr_op, b_pr, m=M, tol=tols, max_restarts=100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = read()
    sums = res.x.double().sum(dim=1).cpu().numpy()
    emit(phase="batched_solve", system="pagerank", n=PAGERANK_N,
         k=PAGERANK_K, tol=tols.tolist(), converged=res.converged.tolist(),
         restarts=res.restarts.tolist(), inner_steps=res.inner_steps.tolist(),
         sums=sums.tolist(), wall_s=wall, launches=d)
    check(res.converged.all(), f"pagerank lanes not converged: "
                               f"{res.converged.tolist()}")
    check(np.abs(sums - 1).max() <= 1e-4, f"pagerank sums {sums.tolist()}")
    lockstep = d["batched_cgs2"]
    expect_counts(d, {"batched_cgs2": lockstep,
                      "sell_matvec": lockstep + int(res.restarts.max()) + 1},
                  "pagerank burst")
    check(lockstep > 0, "batched_cgs2 never launched in the PageRank burst")
    # the operator's mat-vec is the kernel's launch alone: no scatter
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pr_op(b_pr.T.contiguous())
        torch.cuda.synchronize()
    ops_seen = [e.key for e in prof.key_averages()]
    emit(phase="batched_solve", system="pagerank", matvec_ops=ops_seen)
    check(not any("index_copy" in key or "scatter" in key
                  for key in ops_seen),
          f"the sliced-ELL mat-vec scattered its output: {ops_seen}")
    pagerank_res, pagerank_lockstep = res, lockstep
    for lane in range(PAGERANK_K):
        ref = gmres(pr_op, b_pr[lane], m=M, tol=float(tols[lane]),
                    max_restarts=100)
        diff = float((res.x[lane] - ref.x).norm() / ref.x.norm())
        emit(phase="batched_solve", system="pagerank", lane=lane,
             restarts=[int(res.restarts[lane]), ref.restarts], x_rel=diff)
        check(ref.converged and abs(int(res.restarts[lane])
                                    - ref.restarts) <= 1 and diff <= 1e-3,
              f"pagerank lane {lane}: batched and scalar disagree ({diff})")
    zero()

    b4 = torch.stack([torch.from_numpy(np.random.default_rng(seed)
                                       .standard_normal(n).astype(np.float32))
                      for seed in (1, 2, 3, 4)]).cuda()
    t0 = time.perf_counter()
    res = gmres_batched(ops["banded"], b4, m=M, tol=TOL,
                        max_restarts=SPARSE_RESTARTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = read()
    rrs = [relres(res.x[lane], b4[lane]) for lane in range(4)]
    emit(phase="batched_solve", system="stencil", n=n, k=4,
         converged=res.converged.tolist(), restarts=res.restarts.tolist(),
         inner_steps=res.inner_steps.tolist(), true_relres=rrs, wall_s=wall,
         launches=d)
    check(res.converged.all() and max(rrs) <= 2 * TOL,
          f"stencil batch: converged {res.converged.tolist()}, relres {rrs}")
    lockstep = d["batched_cgs2"]
    expect_counts(d, {"batched_cgs2": lockstep,
                      "banded_matvec": lockstep + int(res.restarts.max())
                      + 1}, "stencil batch")
    stencil_batch = (b4, lockstep, res.restarts.tolist())
    del res
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the sparse path")
    emit(phase="batched_solve", launches_total=launches)
    zero()

    # ---- 9. timing ------------------------------------------------------
    def measure(fn, plain, library_fn=None, **info) -> dict:
        """Cold times of a kernel, its plain version and its library call;
        the kernel's warm time beside them as ``warm_ms``."""
        return dict(**timed(fn, cold=True), warm_ms=timed(fn)["ms"],
                    plain_ms=cold_ms(plain),
                    library_ms=cold_ms(library_fn)
                    if library_fn else None, **info)

    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.bitwise_not_()
        torch.cuda.synchronize()
    emit(phase="sparse_timing", flush_bytes=FLUSH_BYTES,
         flush_kernels={key[:100]: ms / 10
                        for key, ms in kernel_ms(prof).items()})
    del flush
    timing = {}
    lib = {"ell": csr_of(ops["ell"].values, ops["ell"].cols),
           "pagerank": csr_of(*pr_op.to_ell_arrays())}
    csr = "CSR torch.mv of the same matrix (cuSPARSE)"
    x_n = torch.randn(n, 1, device="cuda", generator=gen)
    x_pr = torch.randn(PAGERANK_N, 1, device="cuda", generator=gen)
    x_pr8 = torch.randn(PAGERANK_N, PAGERANK_K, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.empty((), dtype=dtype).element_size()
        f32 = dtype == torch.float32
        ell = operators.with_dtype(ops["ell"], dtype)
        band = operators.with_dtype(ops["banded"], dtype)
        sst = operators.with_dtype(ops["sell"], dtype)
        spr = operators.with_dtype(pr_op, dtype)
        width = ell.values.shape[1]
        # cuSPARSE's CSR product is timed on the float32 matrix only
        mv_n = (lambda: torch.mv(lib["ell"], x_n[:, 0])) if f32 else None
        mv_pr = (lambda: torch.mv(lib["pagerank"], x_pr[:, 0])) if f32 \
            else None
        mm_pr8 = (lambda: torch.sparse.mm(lib["pagerank"], x_pr8)) if f32 \
            else None
        rows = {
            ("ell_matvec", "stencil"): measure(
                lambda: spmv.ell_matvec(ell.values, ell.cols, x_n),
                lambda: spmv.ell_matvec_plain(ell.values, ell.cols, x_n),
                mv_n, library=csr if f32 else None, n=n, k=1,
                bytes=n * width * (sz + 4) + 8 * n, flops=2 * n * width),
            ("banded_matvec", "stencil"): measure(
                lambda: spmv.banded_matvec(band.bands, x_n, band.offsets),
                lambda: spmv.banded_matvec_plain(band.bands, x_n,
                                                 band.offsets),
                mv_n, library=csr if f32 else None,
                composite="the plain version (shifted products)", n=n, k=1,
                bytes=len(band.offsets) * n * sz + 8 * n,
                flops=2 * len(band.offsets) * n),
            ("sell_matvec", "pagerank"): measure(
                lambda: spmv.sell_matvec(spr.bin_values, spr.bin_cols, x_pr),
                lambda: spmv.sell_matvec_plain(spr.bin_values, spr.bin_cols,
                                               x_pr),
                mv_pr, library=csr if f32 else None, n=PAGERANK_N, k=1,
                bins=len(spr.bin_values),
                bytes=spr.storage_entries * (sz + 4) + 8 * PAGERANK_N,
                flops=2 * spr.storage_entries),
            ("sell_matvec", "pagerank, k = 8"): measure(
                lambda: spmv.sell_matvec(spr.bin_values, spr.bin_cols, x_pr8),
                lambda: spmv.sell_matvec_plain(spr.bin_values, spr.bin_cols,
                                               x_pr8),
                mm_pr8, library="CSR torch.sparse.mm of the same matrix "
                                "(cuSPARSE)" if f32 else None,
                n=PAGERANK_N, k=PAGERANK_K, bins=len(spr.bin_values),
                bytes=spr.storage_entries * (sz + 4)
                + 8 * PAGERANK_N * PAGERANK_K,
                flops=2 * spr.storage_entries * PAGERANK_K),
            ("sell_matvec", "stencil"): measure(
                lambda: spmv.sell_matvec(sst.bin_values, sst.bin_cols, x_n),
                lambda: spmv.sell_matvec_plain(sst.bin_values, sst.bin_cols,
                                               x_n),
                mv_n, library=csr if f32 else None, n=n, k=1,
                bins=len(sst.bin_values),
                bytes=sst.storage_entries * (sz + 4) + 8 * n,
                flops=2 * sst.storage_entries),
        }
        for k, nb, js in BGS_SHAPES:
            v = lane_bases(k, nb, M + 1, js, dtype, gen)
            w = torch.randn(k, nb, device="cuda", generator=gen)
            rows[("batched_cgs2", f"k = {k}, n = {nb}")] = measure(
                lambda: block_gs.batched_cgs2(v, w, js),
                lambda: block_gs.batched_cgs2_plain(v, w, js),
                composite="the plain version (4 batched matmuls)", k=k,
                n=nb, m1=M + 1, j=list(js), split=bgs_split(v, w, js),
                bytes=sum(j + 1 for j in js) * nb * sz + 8 * k * nb,
                flops=8 * sum(j + 1 for j in js) * nb)
            del v, w
        v = basis(n, M + 1, 15, dtype, gen)
        w = torch.randn(n, device="cuda", generator=gen)
        vj1 = v[:16].float()

        def two_passes():
            w1 = w - (vj1 @ w) @ vj1
            return w1 - (vj1 @ w1) @ vj1
        rows[("gs_project", "streamed, n = 2^20")] = measure(
            lambda: cgs2.gs_project(v, w, 15),
            lambda: cgs2.gs_project_plain(v, w, 15),
            composite_ms=cold_ms(lambda: w - (vj1 @ w) @ vj1),
            n=n, m1=M + 1, j=15, shape=cgs2.launch_shape(dtype, M + 1, n),
            bytes=16 * n * sz + 8 * n + (M + 1) * 4, flops=4 * 16 * n)
        # the bound of cgs2 is one pass's bytes: V once, w in, w'' out
        rows[("cgs2", "streamed, n = 2^20")] = measure(
            lambda: cgs2.cgs2(v, w, 15), lambda: cgs2.cgs2_plain(v, w, 15),
            composite_ms=cold_ms(two_passes), n=n, m1=M + 1, j=15,
            plan=cgs2.launch_plan(v, w, 15),
            bytes=16 * n * sz + 8 * n + (M + 1) * 4, flops=8 * 16 * n)
        del v, w, vj1
        for (name, system), r in rows.items():
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"])
            emit(phase="sparse_timing", kernel=name, system=system,
                 dtype=str(dtype), card=smi, **r)
        if f32:
            timing = {"ell_matvec": rows[("ell_matvec", "stencil")],
                      "banded_matvec": rows[("banded_matvec", "stencil")],
                      "sell_matvec": rows[("sell_matvec", "pagerank")],
                      "batched_cgs2": rows[("batched_cgs2",
                                            f"k = 4, n = {NX * NX}")],
                      "cgs2": rows[("cgs2", "streamed, n = 2^20")]}
            # each sliced-ELL bin alone: the bin-table kernel on a one-bin
            # table (its rule's threads per row)
            xf = x_pr.contiguous()
            for i, (bv, bc) in enumerate(zip(spr.bin_values, spr.bin_cols)):
                y = torch.empty(bv.shape[0], 1, device="cuda")
                launch = (lambda: spmv._launch_sell((bv,), (bc,), xf, y, None,
                                                    "bin"))
                nbytes = bv.numel() * (sz + 4) + 8 * bv.shape[0]
                emit(phase="sparse_timing", kernel="sell_matvec bin",
                     system="pagerank", bin=i, rows=bv.shape[0],
                     width=bv.shape[1],
                     threads_per_row=spmv.threads_per_row(bv.shape[1]),
                     bound_ms=bound(nbytes, 2 * bv.numel())[0],
                     warm_ms=timed(launch)["ms"], card=smi,
                     **timed(launch, cold=True))
            # the hub bin (widest) at 32 to 256 threads per row, each held
            # to the plain version; the rule's choice marked
            bv, bc = spr.bin_values[0], spr.bin_cols[0]
            want = spmv.ell_matvec_plain(bv, bc, xf)
            rule = spmv.threads_per_row(bv.shape[1])
            for tpr in (32, 64, 128, 256):
                y = torch.empty(bv.shape[0], 1, device="cuda")
                launch = (lambda: spmv._launch_sell((bv,), (bc,), xf, y, None,
                                                    "hub bin", (tpr,)))
                launch()
                rel = relerr(y, want)
                check(rel < TOLS[dtype], f"hub bin at {tpr} threads a row: "
                                         f"{rel}")
                cold = timed(launch, cold=True)
                emit(phase="tuning", kernel="sell_matvec hub bin",
                     system="pagerank", rows=bv.shape[0], width=bv.shape[1],
                     threads_per_row=tpr, chosen=tpr == rule,
                     max_rel_err=rel, warm_ms=timed(launch)["ms"],
                     cold_ms=cold["ms"], cold_event_ms=cold["event_ms"],
                     card=smi)
        del ell, band, sst, spr
    zero()

    # per solve: wall and device time per Arnoldi step, idle share
    res = solves[("banded", "cgs2_fused")][0]
    banded_fused = solve_timing(lambda: gmres(ops["banded"], b, m=M, tol=TOL,
                               max_restarts=SPARSE_RESTARTS,
                               gs="cgs2_fused"),
                 res.inner_steps, solve="banded cgs2_fused", n=n,
                 restarts=res.restarts, card=smi)
    solve_timing(lambda: gmres_batched(pr_op, b_pr, m=M, tol=tols,
                                       max_restarts=100),
                 pagerank_lockstep,
                 solve="pagerank burst (per lockstep step)", n=PAGERANK_N,
                 k=PAGERANK_K, restarts=pagerank_res.restarts.tolist(),
                 card=smi)
    b4, lock4, restarts4 = stencil_batch
    batch_timing(lambda: gmres_batched(ops["banded"], b4, m=M, tol=TOL,
                                       max_restarts=SPARSE_RESTARTS),
                 lock4, phase="sparse_timing",
                 solve="4-lane 1024^2 banded batch (per lockstep step)",
                 n=n, k=4, restarts=restarts4, card=smi)
    del b4, stencil_batch
    zero()
    return (errs, launches, timing, solves[("banded", "cgs2")][0].restarts,
            banded_fused, solves)


def host_breakdown(run, steps: int) -> dict:
    """Where one solve's host time goes, per Arnoldi step: the PyTorch ops'
    own CPU time (the profiler's self time; a blocking copy's wait for the
    card is inside its op), the ten largest by name, and the rest of the
    wall time (Python, numpy, the kernels' ctypes launches).  Profiled on
    the host only, so keep the solve short."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, e.self_cpu_time_total / 1e3)
                  for e in prof.key_averages()), key=lambda kv: -kv[1])
    in_ops = sum(ms for _, ms in ops)
    allocs = {e.key: e.count for e in prof.key_averages()
              if "Malloc" in e.key or "HostAlloc" in e.key}
    return {"profiled_wall_ms_per_step": wall / steps,
            "allocation_calls_per_solve": allocs,
            "in_ops_ms_per_step": in_ops / steps,
            "outside_ops_ms_per_step": (wall - in_ops) / steps,
            "top_ops_ms_per_step": {key: ms / steps for key, ms in ops[:10]}}


def host_syncs(run) -> tuple[int, dict]:
    """Host syncs one call of ``run`` makes, as PyTorch's sync debug mode
    counts them (a warning per synchronizing CUDA operation), and where
    they happen (file:line of the Python call)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in caught:
        if "synchronizing CUDA operation" in str(w.message):
            key = f"{pathlib.Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return sum(where.values()), where


def sstep_phases(smi, gen, dense_restarts, sparse_restarts, baseline):
    """Phases 10-12: the s-step slice.  ``dense_restarts`` /
    ``sparse_restarts``: gmres(30) cgs2 restart counts of phases 3 and 7 on
    the same systems; ``baseline``: the cgs2_fused solve rows of phases 5
    and 9.  Returns (max abs errors, main-path launches, timing rows) of its
    kernels, keyed by wrapper name."""
    from repro_torch.core import gmres, gmres_sstep, operators, stencils
    from repro_torch.core.sstep import _newton_shifts
    from repro_torch.kernels import block_gs, matvec, spmv
    from repro_torch.kernels import matrix_powers as mp

    ctr = Counters({"banded_powers": mp.banded_powers,
                    "ell_powers": mp.ell_powers,
                    "dense_powers": mp.dense_powers,
                    "block_gs_pass": block_gs.block_gs_pass},
                   block_matvec=matvec.block_matvec,
                   banded_matvec=spmv.banded_matvec,
                   ell_matvec=spmv.ell_matvec, sell_matvec=spmv.sell_matvec)
    kernels, launches = ctr.kernels, ctr.totals
    zero, read, expect_counts = ctr.zero, ctr.read, ctr.expect
    fmt_kernel = {"banded": "banded_matvec", "ell": "ell_matvec",
                  "sell": "sell_matvec"}
    powers_kernel = {"banded": "banded_powers", "ell": "ell_powers",
                     "dense": "dense_powers"}
    errs = {name: [] for name in kernels}
    n = NX * NX
    s, blocks = SSTEP_S, SSTEP_BLOCKS
    m = s * blocks

    def compare(name, got, want, dtype, **info):
        torch.cuda.synchronize()
        rel = max(relerr(g, w) for g, w in zip(got, want))
        err = max(abserr(g, w) for g, w in zip(got, want))
        errs[name].append(err)
        emit(phase="sstep_kernels", kernel=name, dtype=str(dtype),
             max_rel_err=rel, max_abs_err=err, **info)
        check(rel < TOLS[dtype], f"{name} {info} {dtype}: {rel}")

    ops = {fmt: stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt=fmt)
           for fmt in FORMATS}

    # ---- 10. kernels vs plain -------------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        band = operators.with_dtype(ops["banded"], dtype)
        ell = operators.with_dtype(ops["ell"], dtype)
        a = (torch.randn(N, N, device="cuda", generator=gen)
             / N ** 0.5).to(dtype)
        x_n = torch.randn(n, device="cuda", generator=gen)
        x_d = torch.randn(N, device="cuda", generator=gen)
        for sp in SSTEP_S_CHECK:
            for shifts in (None, _newton_shifts(ops["banded"], sp)):
                shifted = shifts is not None
                b_routes = dict(mp.banded_powers.routes)
                got_b = mp.banded_powers(band.bands, x_n, band.offsets, sp,
                                         shifts=shifts)
                b_route = [r for r, c in mp.banded_powers.routes.items()
                           if c != b_routes[r]]
                compare("banded_powers", got_b,
                        mp.banded_powers_plain(band.bands, x_n, band.offsets,
                                               sp, shifts=shifts),
                        dtype, s=sp, shifted=shifted, n=n, route=b_route,
                        shape=mp.launch_shape("banded", dtype, n,
                                              band.offsets))
                check(b_route == ["tile"], f"banded_powers s={sp} {dtype}: "
                                           f"route {b_route}")
                routes = dict(mp.ell_powers.routes)
                got_e = mp.ell_powers(ell.values, ell.cols, x_n, sp,
                                      shifts=shifts)
                route = [r for r, c in mp.ell_powers.routes.items()
                         if c != routes[r]]
                same = bool(torch.equal(got_b[0], got_e[0])
                            and torch.equal(got_b[1], got_e[1]))
                compare("ell_powers", got_e,
                        mp.ell_powers_plain(ell.values, ell.cols, x_n, sp,
                                            shifts=shifts),
                        dtype, s=sp, shifted=shifted, n=n, route=route,
                        plan=mp.ell_plan(ell.values, ell.cols),
                        same_bits_as_banded=same)
                check(route == ["resident"] and same,
                      f"ell_powers s={sp} shifted={shifted} {dtype}: route "
                      f"{route}, same bits as banded_powers {same}")
            compare("dense_powers", mp.dense_powers(a, x_d, sp),
                    mp.dense_powers_plain(a, x_d, sp), dtype, s=sp, n=N,
                    shape=mp.launch_shape("dense", dtype, N))
        del a
        # the ELL powers' streamed route: a table too wide to keep one
        # chunk of 32 rows in shared memory in either storage type (width
        # 1,200: 230 KB a chunk with bf16 values), ragged rows
        wide, width_w = 4096, 1200
        vals = (torch.randn(wide, width_w, device="cuda", generator=gen)
                / width_w ** 0.5)
        cols = torch.randint(0, wide, (wide, width_w), device="cuda",
                             generator=gen, dtype=torch.int32)
        vals[:, width_w // 2:] *= (torch.rand(wide, 1, device="cuda",
                                              generator=gen) < 0.5)
        cols[vals == 0] = 0
        vals = vals.to(dtype).contiguous()
        x_w = torch.randn(wide, device="cuda", generator=gen)
        for sp in SSTEP_S_CHECK:
            routes = dict(mp.ell_powers.routes)
            got_e = mp.ell_powers(vals, cols, x_w, sp)
            route = [r for r, c in mp.ell_powers.routes.items()
                     if c != routes[r]]
            twice = all(torch.equal(a_, b_) for a_, b_ in zip(
                got_e, mp.ell_powers(vals, cols, x_w, sp)))
            compare("ell_powers", got_e,
                    mp.ell_powers_plain(vals, cols, x_w, sp), dtype, s=sp,
                    n=wide, width=width_w, route=route,
                    same_bits_twice=twice)
            check(route == ["stream"] and twice,
                  f"ell_powers width {width_w} s={sp}: route {route}, the "
                  f"same bits twice {twice}")
        del vals, cols
        # banded_powers on each of its routes, shifted, the same bits twice
        for name, bnd, offs, route, resident, vec in banded_route_cases(gen):
            bnd = bnd.to(dtype).contiguous()
            x_r = torch.randn(bnd.shape[1], device="cuda", generator=gen)
            sh = torch.linspace(0.5, 1.5, SSTEP_S, device="cuda")
            plan = banded_route_check(name, bnd, offs, route, resident, vec,
                                      x_r)
            routes = dict(mp.banded_powers.routes)
            got_b = mp.banded_powers(bnd, x_r, offs, SSTEP_S, shifts=sh)
            got_route = [r for r, c in mp.banded_powers.routes.items()
                         if c != routes[r]]
            twice = all(torch.equal(a_, b_) for a_, b_ in zip(
                got_b, mp.banded_powers(bnd, x_r, offs, SSTEP_S,
                                        shifts=sh)))
            compare("banded_powers", got_b,
                    mp.banded_powers_plain(bnd, x_r, offs, SSTEP_S,
                                           shifts=sh), dtype, s=SSTEP_S,
                    n=bnd.shape[1], case=name, route=got_route,
                    plan={k_: plan[k_] for k_ in ("route", "vec", "res_seg",
                                                  "per", "tile_halo", "far")},
                    same_bits_twice=twice)
            check(got_route == [route] and twice,
                  f"banded_powers {name}: route {got_route}, the same bits "
                  f"twice {twice}")
            del bnd
        # block_gs_pass at s = 1 .. 8 and k_start 0 .. m1 - 1, and on its
        # scalar route (n not a multiple of 4; W one element off 16 bytes,
        # k_start 25, s = 5), each call's route counted and the same bits
        # twice
        cases = [(nb, k, sp, 0) for nb in (n, N) for k in BGS_K + (M,)
                 for sp in (1,) + SSTEP_S_CHECK]
        cases += [(n + 3, 25, SSTEP_S, 0), (n, 25, SSTEP_S, 1)]
        for nb, k, sp, off in cases:
            v = basis(nb, M + 1, k, dtype, gen)
            w = torch.randn(sp * nb + off, device="cuda",
                            generator=gen)[off:].view(sp, nb)
            tin = (torch.triu(torch.randn(sp, sp, device="cuda",
                                          generator=gen))
                   + 2 * torch.eye(sp, device="cuda"))
            want = "vec" if off == 0 and nb % 8 == 0 else "scalar"
            routes = dict(block_gs.block_gs_pass.routes)
            got = block_gs.block_gs_pass(v, w, tin, k)
            again = block_gs.block_gs_pass(v, w, tin, k)
            route = [r for r, c in block_gs.block_gs_pass.routes.items()
                     if c != routes[r]]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            compare("block_gs_pass", got,
                    block_gs.block_gs_pass_plain(v, w, tin, k),
                    dtype, n=nb, m1=M + 1, k_start=k, s=sp, w_offset=off,
                    route=route, same_bits_twice=same,
                    plan=block_gs.block_gs_plan(v, w, k))
            check(route == [want], f"block_gs_pass n={nb} k={k} s={sp} "
                                   f"w+{off}: route {route}")
            check(same and not got[0][k + 1:].any(),
                  f"block_gs_pass n={nb} k={k} s={sp}: other bits on a "
                  f"second call, or C past k_start not zero")
            del v, w
        del band, ell
    zero()

    # ---- 11. the s-step solves ------------------------------------------
    def agree(restarts, ref):
        """Within 10% of the gmres(30) count, and never closer than the
        +-1 restart contract allows."""
        return abs(restarts - ref) <= max(1, 0.1 * ref)

    a = operators.random_diagdom(N, dominance=0.015, seed=0)
    b_d = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                           .astype(np.float32)).cuda()
    dense_op = operators.DenseOperator(a, backend="cuda")
    solves = {}
    for basis_name in SSTEP_BASES:
        zero()
        t0 = time.perf_counter()
        res = gmres_sstep(dense_op, b_d, s=s, blocks=blocks, tol=TOL,
                          max_restarts=MAX_RESTARTS, basis=basis_name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = read()
        r = torch.mv(a.double(), res.x.double()) - b_d.double()
        rr = float(r.norm() / b_d.double().norm())
        cyc = res.restarts
        # The Newton shifts come from the Gershgorin interval, [-77, 82] on
        # this system, whose eigenvalues lie within about 1 of 1.2: the
        # basis is worse than the monomial one and the solve takes more
        # restarts than gmres(30) (4 against 2 in the JAX package too), so
        # it is held to the same solve on the CPU instead.
        cpu = None
        if basis_name == "newton":
            cpu = gmres_sstep(operators.DenseOperator(a.cpu(), device="cpu"),
                              b_d.cpu(), s=s, blocks=blocks, tol=TOL,
                              max_restarts=MAX_RESTARTS,
                              basis=basis_name).restarts
        emit(phase="sstep_solve", system="dense", basis=basis_name, n=N,
             dominance=0.015, s=s, blocks=blocks, converged=res.converged,
             restarts=cyc, gmres_cgs2_restarts=dense_restarts,
             cpu_restarts=cpu, inner_steps=res.inner_steps, true_relres=rr,
             wall_s=wall, launches=d)
        check(res.converged and rr <= 2 * TOL,
              f"dense s-step {basis_name}: converged {res.converged}, "
              f"relres {rr}")
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (N,),
              f"dense s-step {basis_name}: x not finite or wrong shape")
        check(agree(cyc, dense_restarts) if cpu is None
              else abs(cyc - cpu) <= 1,
              f"dense s-step {basis_name}: {cyc} restarts vs gmres "
              f"{dense_restarts}, CPU {cpu}")
        expect = {"block_gs_pass": 2 * blocks * cyc,
                  "block_matvec": cyc + 1}
        if basis_name == "monomial":
            expect["dense_powers"] = blocks * cyc
        else:                       # reference powers over the GEMV kernel
            expect["block_matvec"] += s * blocks * cyc
        expect_counts(d, expect, f"dense s-step {basis_name}")
        solves[("dense", basis_name)] = res

    bands64 = ops["banded"].bands.double()
    offsets = ops["banded"].offsets
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    bnorm = float(b.double().norm())
    for basis_name in SSTEP_BASES:
        firsts = {}
        for fmt in FORMATS:
            op = ops[fmt]
            zero()
            t0 = time.perf_counter()
            res = gmres_sstep(op, b, s=s, blocks=blocks, tol=TOL,
                              max_restarts=SPARSE_RESTARTS, basis=basis_name,
                              history=SPARSE_RESTARTS + 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = read()
            r = spmv.banded_matvec_plain(bands64, res.x.double(), offsets) \
                - b.double()
            rr = float(r.norm()) / bnorm
            cyc = res.restarts
            firsts[fmt] = float(res.residual_history[-cyc]) / bnorm
            emit(phase="sstep_solve", system="stencil", fmt=fmt,
                 basis=basis_name, n=n, s=s, blocks=blocks,
                 converged=res.converged, restarts=cyc,
                 gmres_cgs2_restarts=sparse_restarts,
                 inner_steps=res.inner_steps, true_relres=rr,
                 first_restart_relres=firsts[fmt], wall_s=wall, launches=d)
            check(res.converged and rr <= 2 * TOL,
                  f"{fmt} s-step {basis_name}: converged {res.converged}, "
                  f"relres {rr}")
            check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
                  f"{fmt} s-step {basis_name}: x not finite or wrong shape")
            check(agree(cyc, sparse_restarts), f"{fmt} s-step {basis_name}: "
                  f"{cyc} restarts vs gmres {sparse_restarts}")
            kernel = powers_kernel.get(fmt)
            expect = {"block_gs_pass": 2 * blocks * cyc,
                      fmt_kernel[fmt]: cyc + 1}
            if kernel:
                expect[kernel] = blocks * cyc
            else:                   # reference powers over the SpMV kernel
                expect[fmt_kernel[fmt]] += s * blocks * cyc
            expect_counts(d, expect, f"{fmt} s-step {basis_name}")
            solves[(fmt, basis_name)] = res
        for fmt in FORMATS:
            check(abs(firsts[fmt] - firsts["banded"])
                  <= 1e-4 * firsts["banded"],
                  f"s-step {basis_name}: first-restart residual {fmt} "
                  f"{firsts[fmt]} vs banded {firsts['banded']}")

    # the 32^2 system on the card against the CPU
    b_s = np.random.default_rng(1).standard_normal(32 * 32).astype(np.float32)
    op_c = stencils.convection_diffusion_2d(32, 32, beta=BETA)
    op_h = stencils.convection_diffusion_2d(32, 32, beta=BETA, device="cpu")
    for basis_name in SSTEP_BASES:
        res = gmres_sstep(op_c, torch.from_numpy(b_s).cuda(), s=s,
                          blocks=blocks, tol=TOL, max_restarts=SPARSE_RESTARTS,
                          basis=basis_name)
        ref = gmres_sstep(op_h, torch.from_numpy(b_s), s=s, blocks=blocks,
                          tol=TOL, max_restarts=SPARSE_RESTARTS,
                          basis=basis_name)
        diff = float((res.x.cpu() - ref.x).norm() / ref.x.norm())
        emit(phase="sstep_solve", reference="cpu", n=32 * 32, fmt="banded",
             basis=basis_name, restarts=[res.restarts, ref.restarts],
             x_rel=diff)
        check(res.converged and ref.converged
              and abs(res.restarts - ref.restarts) <= 1 and diff <= 1e-3,
              f"s-step {basis_name}: card and CPU disagree at 32^2 ({diff})")
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched on the s-step path")
    emit(phase="sstep_solve", launches_total=launches)
    zero()

    # ---- 12. timing -----------------------------------------------------
    def measure(fn, plain, composite_fn=None, cold=True, **info) -> dict:
        # cold: CUDA-event time where the profile lost records (cold_ms)
        def ms(f):
            return cold_ms(f) if cold else timed(f)["ms"]
        row = dict(**timed(fn, cold=cold), plain_ms=ms(plain),
                   library_ms=None,
                   composite_ms=ms(composite_fn) if composite_fn else None,
                   **info)
        if cold:
            row["warm_ms"] = timed(fn)["ms"]
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
        return row

    timing = {}
    csr = csr_of(ops["ell"].values, ops["ell"].cols)
    x_n = torch.randn(n, device="cuda", generator=gen)
    x_d = torch.randn(N, device="cuda", generator=gen)
    k_t = BGS_K[-1]
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.empty((), dtype=dtype).element_size()
        f32 = dtype == torch.float32
        band = operators.with_dtype(ops["banded"], dtype)
        ell = operators.with_dtype(ops["ell"], dtype)
        nbands, width = band.bands.shape[0], ell.values.shape[1]
        ar = (torch.randn(N, N, device="cuda", generator=gen)
              / N ** 0.5).to(dtype)

        def powers_composite(mv, x):
            def run():
                u = x
                for _ in range(s):
                    w = mv(u)
                    u = w / w.norm()
                return u
            return run

        rows = {
            "dense_powers": measure(
                lambda: mp.dense_powers(ar, x_d, s),
                lambda: mp.dense_powers_plain(ar, x_d, s),
                powers_composite(lambda u: torch.mv(ar, u), x_d.to(dtype)),
                cold=False, composite=f"{s} x (torch.mv + norm + scale)",
                n=N, s=s, shape=mp.launch_shape("dense", dtype, N),
                bytes=s * N * N * sz + 4 * N + 4 * s * N,
                flops=2 * s * N * N),
            "banded_powers": measure(
                lambda: mp.banded_powers(band.bands, x_n, band.offsets, s),
                lambda: mp.banded_powers_plain(band.bands, x_n, band.offsets,
                                               s),
                powers_composite(lambda u: torch.mv(csr, u), x_n)
                if f32 else None,
                composite=f"{s} x (CSR torch.mv + norm + scale)"
                if f32 else None,
                n=n, s=s, shape=mp.launch_shape("banded", dtype, n,
                                                band.offsets),
                bytes=nbands * n * sz + 4 * n + 4 * s * n,
                flops=2 * s * nbands * n),
            "ell_powers": measure(
                lambda: mp.ell_powers(ell.values, ell.cols, x_n, s),
                lambda: mp.ell_powers_plain(ell.values, ell.cols, x_n, s),
                powers_composite(lambda u: torch.mv(csr, u), x_n)
                if f32 else None,
                composite=f"{s} x (CSR torch.mv + norm + scale)"
                if f32 else None,
                n=n, s=s, shape=mp.ell_plan(ell.values, ell.cols),
                bytes=n * width * (sz + 4) + 4 * n + 4 * s * n,
                flops=2 * s * width * n),
        }
        del ar
        for nb, cold in ((n, True), (N, False)):
            v = basis(nb, M + 1, k_t, dtype, gen)
            w = torch.randn(s, nb, device="cuda", generator=gen)
            tin = torch.triu(torch.randn(s, s, device="cuda", generator=gen)) \
                + 2 * torch.eye(s, device="cuda")
            vv = v[:k_t + 1]

            def gs_composite():
                q = tin @ w
                c = vv @ q.T
                w2 = q - c.T @ vv
                return c, w2, w2 @ w2.T
            rows[f"block_gs_pass n = {nb}"] = measure(
                lambda: block_gs.block_gs_pass(v, w, tin, k_t),
                lambda: block_gs.block_gs_pass_plain(v, w, tin, k_t),
                gs_composite if f32 else None,
                composite="4 cuBLAS products" if f32 else None, cold=cold,
                n=nb, m1=M + 1, k_start=k_t, s=s,
                shape=block_gs.block_gs_launch_shape(dtype, M + 1, nb, s),
                bytes=(k_t + 1) * nb * sz + 8 * s * nb,
                flops=(4 * (k_t + 1) * s + 3 * s * s) * nb)
            del v, w, vv
        for name, r in rows.items():
            emit(phase="sstep_timing", kernel=name, dtype=str(dtype),
                 card=smi, **r)
        if f32:
            timing = {"dense_powers": rows["dense_powers"],
                      "banded_powers": rows["banded_powers"],
                      "ell_powers": rows["ell_powers"],
                      "block_gs_pass": rows[f"block_gs_pass n = {n}"]}
        del band, ell

    # per solve: wall and device time per Arnoldi step, idle share, host
    # syncs per cycle, beside the standard solver's rows of phases 5 and 9
    runs = [("dense", lambda: gmres_sstep(dense_op, b_d, s=s, blocks=blocks,
                                          tol=TOL, max_restarts=MAX_RESTARTS),
             "dense fused")]
    for fmt in FORMATS:
        runs.append((fmt, lambda op=ops[fmt]: gmres_sstep(
            op, b, s=s, blocks=blocks, tol=TOL,
            max_restarts=SPARSE_RESTARTS), "banded cgs2_fused"))
    for system, run, base in runs:
        res = solves[(system, "monomial")]
        syncs, where = host_syncs(run)
        solve_timing(run, res.inner_steps, phase="sstep_timing",
                     solve=f"{system} s-step monomial", s=s, blocks=blocks,
                     restarts=res.restarts, host_syncs=syncs,
                     host_syncs_per_cycle=syncs / max(res.restarts, 1),
                     host_syncs_at=where, beside=baseline.get(base),
                     card=smi)
    std = {"dense fused": lambda: gmres(dense_op, b_d, m=M, tol=TOL,
                                        gs="fused"),
           "banded cgs2_fused": lambda: gmres(
               ops["banded"], b, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
               gs="cgs2_fused")}
    for name, run in std.items():
        row = baseline.get(name) or {}
        syncs, where = host_syncs(run)
        emit(phase="sstep_timing", solve=f"{name} (gmres, phase 5 / 9)",
             host_syncs=syncs,
             host_syncs_per_step=syncs / max(row.get("steps", 1), 1),
             host_syncs_at=where, card=smi)
    zero()
    del dense_op, a
    return errs, launches, timing, solves


def pipelined_phases(smi, gen, dense_fused, sparse_solves, sstep_solves):
    """Phases 13-15: the pipelined slice.  ``dense_fused``: phase 3's
    cgs2_fused solve of the dense dominance-0.015 system; ``sparse_solves``
    phase 7's stencil solves by (fmt, gs); ``sstep_solves`` phase 11's by
    (system, basis).  Returns (max abs errors, main-path launches, timing
    rows) of its kernels, keyed by wrapper name."""
    from repro_torch.core import gmres, gmres_sstep, operators, stencils
    from repro_torch.kernels import (arnoldi_fused, block_gs, cgs2, matvec,
                                     spmv, tuning)
    from repro_torch.kernels import matrix_powers as mp

    ctr = Counters({"gs_project_norm_partial": cgs2.gs_project_norm_partial,
                    "gs_update": cgs2.gs_update,
                    "block_gs_project_gram": block_gs.block_gs_project_gram,
                    "block_gs_update": block_gs.block_gs_update},
                   gs_project=cgs2.gs_project, cgs2=cgs2.cgs2,
                   arnoldi_step=arnoldi_fused.arnoldi_step,
                   block_gs_pass=block_gs.block_gs_pass,
                   block_matvec=matvec.block_matvec,
                   banded_matvec=spmv.banded_matvec,
                   ell_matvec=spmv.ell_matvec, sell_matvec=spmv.sell_matvec,
                   banded_powers=mp.banded_powers, ell_powers=mp.ell_powers,
                   dense_powers=mp.dense_powers)
    errs = {name: [] for name in ctr.kernels}
    fmt_kernel = {"banded": "banded_matvec", "ell": "ell_matvec",
                  "sell": "sell_matvec", "dense": "block_matvec"}
    powers_kernel = {"banded": "banded_powers", "ell": "ell_powers",
                     "dense": "dense_powers"}
    n = NX * NX
    m1 = M + 1
    s, blocks = SSTEP_S, SSTEP_BLOCKS

    def compare(name, got, want, dtype, **info):
        torch.cuda.synchronize()
        rel = max(relerr(g, w) for g, w in zip(got, want))
        err = max(abserr(g, w) for g, w in zip(got, want))
        if name in errs:
            errs[name].append(err)
        emit(phase="pipelined_kernels", kernel=name, dtype=str(dtype),
             max_rel_err=rel, max_abs_err=err, **info)
        check(rel < TOLS[dtype], f"{name} {info} {dtype}: {rel}")

    def payload_check(v, z, j, want, dtype, **info):
        """The payload against plain, on route ``want``, the same bits on a
        second call, rows j+1 .. m1-1 zero."""
        zero_routes(cgs2.gs_project_norm_partial)
        got = cgs2.gs_project_norm_partial(v, z, j)
        again = cgs2.gs_project_norm_partial(v, z, j)
        routes = dict(cgs2.gs_project_norm_partial.routes)
        compare("gs_project_norm_partial", (got,),
                (cgs2.gs_project_norm_partial_plain(v, z, j),), dtype,
                n=v.shape[1], m1=v.shape[0], j=j, route=want, routes=routes,
                **info)
        check(routes[want] == 2 and sum(routes.values()) == 2,
              f"gs_project_norm_partial n={v.shape[1]} j={j} {info}: "
              f"routes {routes}, expected {want}")
        check(torch.equal(got, again) and not got[j + 1:v.shape[0]].any(),
              f"gs_project_norm_partial n={v.shape[1]} j={j} {info}: other "
              f"bits on a second call, or masked rows not zero")

    # ---- 13. kernels vs plain -------------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        for nb in (N, n):
            for j in PIPE_J:
                v = basis(nb, m1, j, dtype, gen)
                z = torch.randn(nb, device="cuda", generator=gen)
                payload_check(v, z, j, "row" if nb == N else "vec", dtype)
                h = torch.randn(j + 1, device="cuda", generator=gen)
                got = cgs2.gs_update(v[:j + 1], z, h)
                compare("gs_update", (got,),
                        (cgs2.gs_update_plain(v[:j + 1], z, h),), dtype,
                        n=nb, rows=j + 1)
                h_full = torch.zeros(m1, device="cuda")
                h_full[:j + 1] = h
                check(torch.equal(cgs2.gs_update(v, z, h_full), got),
                      f"gs_update n={nb} j={j} {dtype}: the row prefix "
                      f"does not give the full call's bits")
                del v, z
        # the streaming update's edges: odd n (one row read: 16-byte
        # pieces and a scalar tail; more: the scalar route) and views one
        # element off 16 bytes (the scalar route), h a row view as hc[1]
        for nb, off in STREAM_EDGES:
            v, z = stream_edge(nb, m1, off, dtype, gen)
            for j in PIPE_J:
                plan = tuning.gemv_partial_shape(
                    cgs2.stream_plan(v, z, j + 1), j + 1, k=2)
                payload_check(v, z, j, "row" if plan["by_row"]
                              else plan["route"], dtype, offset=off)
                h = torch.randn(2, j + 1, device="cuda", generator=gen)[1]
                want = cgs2.stream_plan(v, z, j + 1)["route"]
                zero_routes(cgs2.gs_update)
                got = cgs2.gs_update(v[:j + 1], z, h)
                compare("gs_update", (got,),
                        (cgs2.gs_update_plain(v[:j + 1], z, h),), dtype,
                        n=nb, rows=j + 1, offset=off, route=want,
                        routes=dict(cgs2.gs_update.routes))
                check(cgs2.gs_update.routes[want] == 1,
                      f"gs_update n={nb} offset={off}: routes "
                      f"{cgs2.gs_update.routes}, expected {want}")
                check(want == "scalar" or (off == 0 and (
                    j == 0 or nb * v.element_size() % 16 == 0)),
                      f"gs_update n={nb} offset={off} rows={j + 1}: "
                      f"16-byte route on misaligned operands")
                check(torch.equal(cgs2.gs_update(v[:j + 1], z, h), got),
                      f"gs_update n={nb} offset={off}: two calls differ")
            del v, z
        for nb in (n, N):
            for k in PIPE_K:
                v = basis(nb, m1, k, dtype, gen)
                vp = v[:k + 1]
                w = torch.randn(s, nb, device="cuda", generator=gen)
                tin = (torch.triu(torch.randn(s, s, device="cuda",
                                              generator=gen))
                       + 2 * torch.eye(s, device="cuda"))
                got = block_gs.block_gs_project_gram(vp, w, tin)
                compare("block_gs_project_gram", got,
                        block_gs.block_gs_project_gram_plain(vp, w, tin),
                        dtype, n=nb, rows=k + 1, s=s,
                        grid=block_gs.block_gs_plan(vp, w, k)["grid"])
                check(torch.equal(got[2], got[2].T),
                      "block_gs_project_gram: M is not symmetric")
                c = torch.randn(k + 1, s, device="cuda", generator=gen)
                compare("block_gs_update",
                        block_gs.block_gs_update(vp, got[0], c),
                        block_gs.block_gs_update_plain(vp, got[0], c),
                        dtype, n=nb, rows=k + 1, s=s)
                gram = torch.eye(m1, device="cuda")
                compare("block_gs_pass_single_reduce",
                        block_gs.block_gs_pass_single_reduce(v, w, tin, k,
                                                             gram),
                        block_gs.block_gs_pass_single_reduce_ref(v, w, tin,
                                                                 k, gram),
                        dtype, n=nb, k_start=k, s=s)
                del v, vp, w
    ctr.zero()

    # ---- 14. pipelined gmres --------------------------------------------
    def agree(restarts, ref):
        return abs(restarts - ref) <= max(1, 0.1 * ref)

    def x_rel(x, ref):
        return float((x - ref).norm() / ref.norm())

    a = operators.random_diagdom(N, dominance=0.015, seed=0)
    b_d = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                           .astype(np.float32)).cuda()
    dense_op = operators.DenseOperator(a, backend="cuda")
    ops = {fmt: stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt=fmt)
           for fmt in FORMATS}
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    bnorm = float(b.double().norm())
    bands64 = ops["banded"].bands.double()
    offsets = ops["banded"].offsets

    def relres(system, x, rhs):
        if system == "dense":
            r = torch.mv(a.double(), x.double()) - rhs.double()
        else:
            r = spmv.banded_matvec_plain(bands64, x.double(), offsets) \
                - rhs.double()
        return float(r.norm() / rhs.double().norm())

    systems = [("dense", dense_op, b_d, MAX_RESTARTS, dense_fused)]
    systems += [(fmt, ops[fmt], b, SPARSE_RESTARTS,
                 sparse_solves[(fmt, "cgs2_fused")][0]) for fmt in FORMATS]
    firsts, pipe = {}, {}
    for system, op, rhs, budget, ref in systems:
        ctr.zero()
        zero_routes(cgs2.gs_update)
        t0 = time.perf_counter()
        res = gmres(op, rhs, m=M, tol=TOL, max_restarts=budget,
                    gs="cgs2_pipelined", history=budget + 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = ctr.read()
        routes = dict(cgs2.gs_update.routes)
        rr = relres(system, res.x, rhs)
        xr = x_rel(res.x, ref.x)
        first = float(res.residual_history[-res.restarts]) \
            / float(rhs.double().norm())
        firsts[system] = first
        emit(phase="pipelined_solve", system=system, n=rhs.shape[0],
             gs="cgs2_pipelined", converged=res.converged,
             restarts=res.restarts, cgs2_fused_restarts=ref.restarts,
             inner_steps=res.inner_steps, true_relres=rr,
             x_rel_to_cgs2_fused=xr, first_restart_relres=first,
             wall_s=wall, launches=d, gs_update_routes=routes)
        check(res.converged and rr <= 2 * TOL,
              f"pipelined {system}: converged {res.converged}, relres {rr}")
        check(bool(torch.isfinite(res.x).all())
              and res.x.shape == rhs.shape,
              f"pipelined {system}: x not finite or wrong shape")
        check(abs(res.restarts - ref.restarts) <= 1 if system == "dense"
              else agree(res.restarts, ref.restarts),
              f"pipelined {system}: {res.restarts} restarts vs cgs2_fused "
              f"{ref.restarts}")
        check(xr <= 1e-3, f"pipelined {system}: x differs from cgs2_fused "
                          f"by {xr}")
        steps = res.inner_steps
        ctr.expect(d, {"gs_project_norm_partial": steps,
                       "gs_update": 2 * steps,
                       fmt_kernel[system]: steps + 2 * res.restarts + 1},
                   f"pipelined {system}")
        check(routes == {"vec": 2 * steps, "scalar": 0},
              f"pipelined {system}: gs_update routes {routes}")
        pipe[system] = res
    check(firsts["ell"] == firsts["banded"],
          f"pipelined: first-restart residual ell {firsts['ell']!r} vs "
          f"banded {firsts['banded']!r} (not the same bits)")
    check(abs(firsts["sell"] - firsts["banded"]) <= 1e-4 * firsts["banded"],
          f"pipelined: first-restart residual sell {firsts['sell']} vs "
          f"banded {firsts['banded']}")
    ctr.zero()

    # wall, device and idle per step, and host syncs per step, beside
    # cgs2_fused on the same system in the same run
    for system, op, rhs, budget, ref in systems[:2]:
        for gs, res in (("cgs2_fused", ref), ("cgs2_pipelined",
                                               pipe[system])):
            def run(op=op, rhs=rhs, budget=budget, gs=gs):
                return gmres(op, rhs, m=M, tol=TOL, max_restarts=budget,
                             gs=gs)
            syncs, where = host_syncs(run)
            host = (host_breakdown(run, res.inner_steps)
                    if system == "dense" else None)
            solve_timing(run, res.inner_steps, phase="pipelined_timing",
                         solve=f"{system} {gs}", restarts=res.restarts,
                         host_syncs=syncs,
                         host_syncs_per_step=syncs / res.inner_steps,
                         host_syncs_at=where, host=host, card=smi)
            if gs == "cgs2_pipelined":
                check(syncs <= res.inner_steps + 2 * res.restarts + 2,
                      f"pipelined {system}: {syncs} host syncs for "
                      f"{res.inner_steps} steps")
    ctr.zero()

    # ---- 15. single-reduce gmres_sstep ----------------------------------
    cycles = {}
    for system, op, rhs, budget, _ in systems[:3]:
        ref = sstep_solves[(system, "monomial")]
        ctr.zero()
        t0 = time.perf_counter()
        res = gmres_sstep(op, rhs, s=s, blocks=blocks, tol=TOL,
                          max_restarts=budget, gs="cgs2_pipelined",
                          history=budget + 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = ctr.read()
        rr = relres(system, res.x, rhs)
        xr = x_rel(res.x, ref.x)
        cyc = cycles[system] = res.restarts
        firsts[system] = float(res.residual_history[-cyc]) \
            / float(rhs.double().norm())
        emit(phase="sstep_sr_solve", system=system, n=rhs.shape[0], s=s,
             blocks=blocks, converged=res.converged, restarts=cyc,
             split_restarts=ref.restarts, inner_steps=res.inner_steps,
             true_relres=rr, x_rel_to_split=xr,
             first_restart_relres=firsts[system], wall_s=wall, launches=d)
        check(res.converged and rr <= 2 * TOL,
              f"single-reduce s-step {system}: converged {res.converged}, "
              f"relres {rr}")
        check(bool(torch.isfinite(res.x).all())
              and res.x.shape == rhs.shape,
              f"single-reduce s-step {system}: x not finite or wrong shape")
        check(abs(cyc - ref.restarts) <= 1 if system == "dense"
              else agree(cyc, ref.restarts),
              f"single-reduce s-step {system}: {cyc} restarts vs split "
              f"{ref.restarts}")
        check(xr <= 1e-3, f"single-reduce s-step {system}: x differs from "
                          f"the split solve's by {xr}")
        ctr.expect(d, {"block_gs_project_gram": 2 * blocks * cyc,
                       "block_gs_update": 2 * blocks * cyc,
                       powers_kernel[system]: blocks * cyc,
                       fmt_kernel[system]: cyc + 1},
                   f"single-reduce s-step {system}")
    check(abs(firsts["ell"] - firsts["banded"]) <= 1e-4 * firsts["banded"],
          f"single-reduce s-step: first-restart residual ell "
          f"{firsts['ell']} vs banded {firsts['banded']}")
    ctr.zero()
    for system, op, rhs, budget, _ in systems[:2]:
        for gs, cyc in (("cgs2", sstep_solves[(system, "monomial")].restarts),
                        ("cgs2_pipelined", cycles[system])):
            def run(op=op, rhs=rhs, budget=budget, gs=gs):
                return gmres_sstep(op, rhs, s=s, blocks=blocks, tol=TOL,
                                   max_restarts=budget, gs=gs)
            syncs, where = host_syncs(run)
            solve_timing(run, cyc * s * blocks, phase="sstep_sr_timing",
                         solve=f"{system} s-step {gs}", s=s, blocks=blocks,
                         restarts=cyc, host_syncs=syncs,
                         host_syncs_per_cycle=syncs / cyc,
                         host_syncs_at=where, card=smi)
            check(syncs <= 3 * cyc + 2,
                  f"s-step {gs} {system}: {syncs} host syncs for {cyc} "
                  f"cycles")
    ctr.zero()
    del dense_op, a, ops

    # ---- kernel times at the path's shapes --------------------------------
    def measure(fn, plain, composite_fn, cold, library_fn=None,
                **info) -> dict:
        # cold: CUDA-event time where the profile lost records (cold_ms)
        def ms(f):
            return cold_ms(f) if cold else timed(f)["ms"]
        row = dict(**timed(fn, cold=cold), plain_ms=ms(plain),
                   library_ms=ms(library_fn) if library_fn else None,
                   composite_ms=ms(composite_fn) if composite_fn else None,
                   **info)
        if cold:
            row["warm_ms"] = timed(fn)["ms"]
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
        return row

    timing = {}
    j, k = PIPE_J[1], PIPE_K[-1]
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.empty((), dtype=dtype).element_size()
        f32 = dtype == torch.float32
        rows = {}
        for nb, cold in ((n, True), (N, False)):
            v = basis(nb, m1, j, dtype, gen)
            vp = v[:j + 1]
            z = torch.randn(nb, device="cuda", generator=gen)
            h = torch.randn(j + 1, device="cuda", generator=gen)
            vpf = vp.float()

            def payload_composite():
                st = torch.stack([z, vpf[j]], 1)
                return vpf @ st, (st * st).sum(0)
            rows[f"gs_project_norm_partial n = {nb}"] = measure(
                lambda: cgs2.gs_project_norm_partial(v, z, j),
                lambda: cgs2.gs_project_norm_partial_plain(v, z, j),
                payload_composite if f32 else None, cold,
                composite="V[:j+1] @ stack([z, v_j]) + norms"
                if f32 else None, n=nb, m1=m1, j=j,
                shape=tuning.gemv_partial_shape(
                    cgs2.stream_plan(v, z, j + 1), j + 1, k=2),
                bytes=((j + 1) * sz + 4) * nb + (m1 + 1) * 8,
                flops=(4 * (j + 1) + 4) * nb)
            rows[f"gs_update n = {nb}"] = measure(
                lambda: cgs2.gs_update(vp, z, h),
                lambda: cgs2.gs_update_plain(vp, z, h),
                (lambda: z - h @ vpf) if f32 else None, cold,
                library_fn=(lambda: torch.addmv(z, vpf.T, h, alpha=-1))
                if f32 else None,
                library="torch.addmv(w, V[:j+1].T, h, alpha=-1)"
                if f32 else None,
                composite="w - h @ V[:j+1]" if f32 else None, n=nb,
                rows=j + 1, bytes=((j + 1) * sz + 8) * nb,
                flops=2 * (j + 1) * nb)
            del v, vp, vpf
            v = basis(nb, m1, k, dtype, gen)
            vp = v[:k + 1]
            vpf = vp.float()
            w = torch.randn(s, nb, device="cuda", generator=gen)
            tin = (torch.triu(torch.randn(s, s, device="cuda",
                                          generator=gen))
                   + 2 * torch.eye(s, device="cuda"))
            q = tin @ w
            c = torch.randn(k + 1, s, device="cuda", generator=gen)

            def gram_composite():
                qq = tin @ w
                return qq, vpf @ qq.T, qq @ qq.T

            def update_composite():
                w2 = q - c.T @ vpf
                return w2, w2 @ w2.T
            rows[f"block_gs_project_gram n = {nb}"] = measure(
                lambda: block_gs.block_gs_project_gram(vp, w, tin),
                lambda: block_gs.block_gs_project_gram_plain(vp, w, tin),
                gram_composite if f32 else None, cold,
                composite="3 cuBLAS products" if f32 else None, n=nb,
                rows=k + 1, s=s,
                grid=block_gs.block_gs_plan(vp, w, k)["grid"],
                bytes=((k + 1) * sz + 8 * s) * nb + (m1 + s) * s * 4,
                flops=(2 * s * s + 2 * (k + 1) * s + s * (s + 1)) * nb)
            rows[f"block_gs_update n = {nb}"] = measure(
                lambda: block_gs.block_gs_update(vp, q, c),
                lambda: block_gs.block_gs_update_plain(vp, q, c),
                update_composite if f32 else None, cold,
                composite="2 cuBLAS products" if f32 else None, n=nb,
                rows=k + 1, s=s, grid=tuning.sr_grid("cuda", nb),
                bytes=((k + 1) * sz + 8 * s) * nb,
                flops=(2 * (k + 1) * s + s * (s + 1)) * nb)
            del v, vp, vpf, w, q
        for name, r in rows.items():
            r["launches_per_path"] = ctr.totals[name.split()[0]]
            emit(phase="pipelined_timing", kernel=name, dtype=str(dtype),
                 card=smi, **r)
        if f32:
            timing = {name: rows[f"{name} n = {n}"] for name in ctr.kernels}
    ctr.zero()
    return errs, ctr.totals, timing


def lu_on_pattern(l_bands, l_offsets, u_bands, u_offsets, offsets):
    """The entries of L U (unit-diagonal L) at the band offsets, float64,
    by banded products on the card: (L U)[i, i + o] = sum over l + u = o
    of L[i, i + l] U[i + l, i + l + u]."""
    n = u_bands.shape[1]
    ls = {0: torch.ones(n, dtype=torch.float64, device=u_bands.device)}
    ls.update({o: l_bands[d].double() for d, o in enumerate(l_offsets)})
    us = {o: u_bands[d].double() for d, o in enumerate(u_offsets)}
    out = {}
    for o in offsets:
        acc = torch.zeros(n, dtype=torch.float64, device=u_bands.device)
        for lo, lb in ls.items():
            if o - lo not in us:
                continue
            shifted = torch.zeros_like(acc)       # U[i + lo, .] at row i
            a, e = max(0, -lo), min(n, n - lo)
            if a < e:
                shifted[a:e] = us[o - lo][a + lo:e + lo]
            acc = acc + lb * shifted
        out[o] = acc
    return out


def precond_phases(smi, gen, sparse_solves):
    """Phases 16-18: the preconditioning slice.  ``sparse_solves``: phase
    7's stencil solves by (fmt, gs).  Returns (max abs errors, main-path
    launches, timing rows) of its kernels, keyed by wrapper name."""
    from repro_torch.core import gmres, gmres_batched, gmres_sstep
    from repro_torch.core import operators, stencils
    from repro_torch.core import preconditioners as P
    from repro_torch.kernels import block_gs, cgs2, spmv, trisolve, tuning
    from repro_torch.kernels import matrix_powers as mp

    ctr = Counters({"banded_cheb_apply": mp.banded_cheb_apply,
                    "banded_trisweep": trisolve.banded_trisweep,
                    "ilu0_factor": trisolve.ilu0_factor},
                   banded_matvec=spmv.banded_matvec,
                   gs_project=cgs2.gs_project, cgs2=cgs2.cgs2,
                   gs_project_norm_partial=cgs2.gs_project_norm_partial,
                   gs_update=cgs2.gs_update,
                   block_gs_pass=block_gs.block_gs_pass,
                   batched_cgs2=block_gs.batched_cgs2,
                   banded_powers=mp.banded_powers)
    errs = {name: [] for name in ctr.kernels}
    n = NX * NX
    f32 = torch.float32
    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    small = stencils.convection_diffusion_2d(32, 32, beta=BETA)

    def compare(name, got, want, dtype, **info):
        torch.cuda.synchronize()
        got, want = got.cpu(), want.cpu()
        rel, err = relerr(got, want), abserr(got, want)
        errs[name].append(err)
        emit(phase="precond_kernels", kernel=name, dtype=str(dtype),
             max_rel_err=rel, max_abs_err=err, **info)
        check(rel < TOLS[dtype], f"{name} {info} {dtype}: {rel}")

    # ---- 16. kernels vs plain ---------------------------------------------
    for o in (op, small):
        lo, hi = P.estimate_interval(o)
        nn = o.shape[0]
        v = torch.randn(nn, device="cuda", generator=gen)
        for dtype in (f32, torch.bfloat16):
            bands = o.bands.to(dtype)
            for order in (2, 4, 8):
                theta, delta, rhos = P.cheb_coeffs(order, lo, hi)
                kw = dict(theta=theta, delta=delta, rhos=rhos)
                compare("banded_cheb_apply",
                        mp.banded_cheb_apply(bands, v, o.offsets, **kw),
                        mp.banded_cheb_apply_plain(bands, v, o.offsets, **kw),
                        dtype, n=nn, order=order, interval=[lo, hi])
    # each route of the Chebyshev apply (order 4 of an interval for these
    # diagonally shifted random stacks), the same bits twice
    kw = dict(theta=3.0, delta=2.0, rhos=((0.5, 0.0), (0.6, 0.5),
                                          (0.7, 0.6)))
    for name, bnd, offs, route, resident, vec in banded_route_cases(gen):
        for dtype in (f32, torch.bfloat16):
            bt = bnd.to(dtype).contiguous()
            v_r = torch.randn(bt.shape[1], device="cuda", generator=gen)
            banded_route_check(name, bt, offs, route, resident, vec, v_r)
            routes = dict(mp.banded_cheb_apply.routes)
            z = mp.banded_cheb_apply(bt, v_r, offs, **kw)
            got_route = [r for r, c in mp.banded_cheb_apply.routes.items()
                         if c != routes[r]]
            twice = torch.equal(z, mp.banded_cheb_apply(bt, v_r, offs, **kw))
            compare("banded_cheb_apply", z,
                    mp.banded_cheb_apply_plain(bt, v_r, offs, **kw), dtype,
                    n=bt.shape[1], case=name, route=got_route,
                    same_bits_twice=twice)
            check(got_route == [route] and twice,
                  f"banded_cheb_apply {name} {dtype}: route {got_route}, the "
                  f"same bits twice {twice}")
            del bt
        del bnd

    ilu, lj = P.banded_ilu0(op), P.line_jacobi(op)
    # 1023 x 1021: n = 1,044,483, not a multiple of the scan's 2,048-row
    # tile (nor of 8: loads one by one), chunks of 1,023 rows (not a
    # multiple of 4: loads one chunk at a time)
    odd = stencils.convection_diffusion_2d(1023, 1021, beta=BETA)
    cases = []
    for name, pc in (("ilu0 1024^2", ilu), ("line_jacobi 1024^2", lj),
                     ("ilu0 1023 x 1021", P.banded_ilu0(odd)),
                     ("line_jacobi 1023 x 1021", P.line_jacobi(odd))):
        cases += [(name, "lower/unit", pc.l_bands, pc.l_offsets, True, True),
                  (name, "lower/non-unit",
                   torch.cat([pc.l_bands, pc.u_bands[:1]]),
                   pc.l_offsets + (0,), False, True),
                  (name, "upper/non-unit", pc.u_bands, pc.u_offsets, False,
                   False)]
    del odd
    for nr in (200, 1 << 16):
        for direction, offs, unit, lower in (
                ("lower/unit", (-2, -1, 0), True, True),
                ("lower/non-unit", (-2, -1, 0), False, True),
                ("upper/non-unit", (0, 1, 2), False, False)):
            bands = torch.rand(3, nr, device="cuda", generator=gen) * 0.8 \
                + 0.2
            bands[offs.index(0)] += 2.0
            cases.append((f"random n = {nr}", direction,
                          trisolve._mask_oob(bands, offs).contiguous(), offs,
                          unit, lower))
    for system, direction, bands, offs, unit, lower in cases:
        nb = bands.shape[1]
        far = any(abs(o) >= 2 for o in offs)
        for dtype in (f32, torch.bfloat16):
            if dtype != f32 and "1023" in system:
                continue
            bt = bands.to(dtype).contiguous()
            # one plain solve of four right-hand sides; k = 1 takes the
            # first (the plain version treats each on its own)
            v4 = torch.randn(4, nb, device="cuda", generator=gen)
            want4 = trisolve.banded_trisweep_plain(
                bt.cpu(), v4.cpu(), offs, unit_diag=unit, lower=lower)
            for k in (1, 4):
                v = v4[0] if k == 1 else v4
                want = want4[0] if k == 1 else want4
                routes = dict(trisolve.banded_trisweep.routes)
                got = trisolve.banded_trisweep(bt, v, offs, unit_diag=unit,
                                               lower=lower)
                route = [r for r, c in trisolve.banded_trisweep.routes.items()
                         if c != routes[r]]
                again = trisolve.banded_trisweep(bt, v, offs,
                                                 unit_diag=unit, lower=lower)
                vf = v.reshape(-1, nb)
                plan = trisolve.sweep_plan(bt, vf, torch.empty_like(vf),
                                           offs)
                compare("banded_trisweep", got, want, dtype, system=system,
                        direction=direction, n=nb, k=k, route=route,
                        chunk=plan["chunk"], vec=plan["vec"],
                        same_bits_twice=torch.equal(got, again))
                check(route == [plan["route"]]
                      and (plan["route"] != "scan") == far,
                      f"banded_trisweep {system} {direction}: route {route}")
                check(torch.equal(got, again),
                      f"banded_trisweep {system} {direction} k={k}: other "
                      f"bits on a second call")

    ilu_cases = [(nx, "five-point") for nx in (64, 128, NX)]
    ilu_cases.append((NX, "line-Jacobi (-1, 0, 1)"))
    for nx, pattern in ilu_cases:
        o = op if nx == NX else stencils.convection_diffusion_2d(
            nx, nx, beta=BETA)
        bands, offs = ((o.bands, o.offsets) if pattern == "five-point"
                       else (o.bands[1:4].contiguous(), (-1, 0, 1)))
        got = trisolve.ilu0_factor(bands, offs)
        want = trisolve.ilu0_factor_plain(bands.cpu(), offs)
        torch.cuda.synchronize()
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        rel = max(relerr(g.cpu(), w) for g, w in zip(got, want))
        errs["ilu0_factor"].append(max(abserr(g.cpu(), w)
                                       for g, w in zip(got, want)))
        info = {"n": nx * nx, "pattern": pattern, "same_bits": same,
                "max_rel_err": rel}
        if nx == NX and pattern == "five-point":
            # the JAX test's property: L U = A on the pattern
            l_off = tuple(sorted(x for x in o.offsets if x < 0))
            u_off = tuple([0] + sorted(x for x in o.offsets if x > 0))
            lu = lu_on_pattern(got[0], l_off, got[1], u_off, o.offsets)
            a = trisolve._mask_oob(o.bands, o.offsets).double()
            scale = float(a.abs().max())
            info["lu_minus_a_on_pattern"] = max(
                float((lu[x] - a[d]).abs().max()) / scale
                for d, x in enumerate(o.offsets))
            check(info["lu_minus_a_on_pattern"] <= 5e-5,
                  f"ilu0_factor: (L U - A) on the pattern "
                  f"{info['lu_minus_a_on_pattern']}")
        emit(phase="precond_kernels", kernel="ilu0_factor", **info)
        check(same, f"ilu0_factor {nx}^2 {pattern}: not the plain version's "
                    f"bits ({rel})")
    ctr.zero()

    # ---- 17. preconditioned solves ----------------------------------------
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    ref = sparse_solves[("banded", "cgs2_fused")][0]
    bands64 = op.bands.double()

    def relres(x, rhs) -> float:
        r = spmv.banded_matvec_plain(bands64, x.double(), op.offsets) \
            - rhs.double()
        return float(r.norm() / rhs.double().norm())

    def x_rel(x, want):
        return float((x - want).norm() / want.norm())

    setups = {"chebyshev": {"banded_matvec": 8},      # power iterations
              "banded_ilu0": {"ilu0_factor": 1},
              "line_jacobi": {"ilu0_factor": 1}, "jacobi": {}}
    pcs, setup_s = {}, {}
    for name, expect in setups.items():
        ctr.zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pcs[name] = P.make_preconditioner(name, op, order=4)
        torch.cuda.synchronize()
        setup_s[name] = time.perf_counter() - t0
        ctr.expect(ctr.read(), expect, f"{name} setup")
    emit(phase="precond_solve", setup_s=setup_s,
         cheb_interval=[pcs["chebyshev"].lam_min, pcs["chebyshev"].lam_max])

    s, blocks = SSTEP_S, SSTEP_BLOCKS
    runs = [("chebyshev", "gmres", "cgs2_fused"),
            ("banded_ilu0", "gmres", "cgs2_fused"),
            ("line_jacobi", "gmres", "cgs2_fused"),
            ("jacobi", "gmres", "cgs2_fused"),
            ("chebyshev", "gmres", "cgs2_pipelined"),
            ("chebyshev", "gmres_sstep", "cgs2"),
            ("banded_ilu0", "gmres_sstep", "cgs2")]
    solves = {}
    for name, solver, gs in runs:
        pc = pcs[name]
        ctr.zero()
        trisolve.banded_trisweep.routes = dict.fromkeys(
            trisolve.banded_trisweep.routes, 0)
        t0 = time.perf_counter()
        if solver == "gmres":
            res = gmres(op, b, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
                        gs=gs, precond=pc, history=SPARSE_RESTARTS + 8)
        else:
            res = gmres_sstep(op, b, s=s, blocks=blocks, tol=TOL,
                              max_restarts=SPARSE_RESTARTS, gs=gs,
                              precond=pc, history=SPARSE_RESTARTS + 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = ctr.read()
        rr, xr = relres(res.x, b), x_rel(res.x, ref.x)
        emit(phase="precond_solve", precond=name, solver=solver, gs=gs,
             n=n, converged=res.converged, restarts=res.restarts,
             unpreconditioned_restarts=ref.restarts,
             inner_steps=res.inner_steps, true_relres=rr,
             x_rel_to_unpreconditioned=xr, wall_s=wall,
             setup_s=setup_s[name], wall_with_setup_s=wall + setup_s[name],
             launches=d,
             sweep_routes=dict(trisolve.banded_trisweep.routes))
        what = f"{name} {solver} {gs}"
        check(res.converged and rr <= 2 * TOL,
              f"{what}: converged {res.converged}, relres {rr}")
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
              f"{what}: x not finite or wrong shape")
        check(xr <= 1e-3, f"{what}: x differs from the unpreconditioned "
                          f"solve's by {xr}")
        if name != "jacobi":
            check(res.restarts < ref.restarts,
                  f"{what}: {res.restarts} restarts, not fewer than the "
                  f"unpreconditioned {ref.restarts}")
        if solver == "gmres" and gs == "cgs2_fused":
            check(abs(res.restarts - PRECOND_RESTARTS[name]) <= 1,
                  f"{what}: {res.restarts} restarts, expected "
                  f"{PRECOND_RESTARTS[name]} +-1")
        steps, cyc = res.inner_steps, res.restarts
        if solver == "gmres_sstep":
            applies = (s * blocks + 1) * cyc
            expect = {"banded_matvec": s * blocks * cyc + cyc + 1,
                      "block_gs_pass": 2 * blocks * cyc}
        elif gs == "cgs2_pipelined":
            applies = steps + 2 * cyc
            expect = {"banded_matvec": steps + 2 * cyc + 1,
                      "gs_project_norm_partial": steps,
                      "gs_update": 2 * steps}
        else:
            applies = steps + cyc
            expect = {"banded_matvec": steps + cyc + 1, "cgs2": steps}
        if name == "chebyshev":
            expect["banded_cheb_apply"] = applies
        elif name != "jacobi":
            expect["banded_trisweep"] = 2 * applies
        ctr.expect(d, expect, what)
        # ILU(0)'s factors have far bands (the chunk route), line-Jacobi's
        # none (the scan)
        routes = dict(trisolve.banded_trisweep.routes)
        want = dict.fromkeys(routes, 0)
        if name in ("banded_ilu0", "line_jacobi"):
            want["chunk" if name == "banded_ilu0" else "scan"] = 2 * applies
        check(routes == want, f"{what}: sweep routes {routes}, expected "
                              f"{want}")
        solves[(name, solver, gs)] = res

    # phase 8's 4-lane stencil batch, Chebyshev through the block mat-vec
    b4 = torch.stack([torch.from_numpy(np.random.default_rng(seed)
                                       .standard_normal(n).astype(np.float32))
                      for seed in (1, 2, 3, 4)]).cuda()
    ctr.zero()
    t0 = time.perf_counter()
    res = gmres_batched(op, b4, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
                        precond=pcs["chebyshev"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = ctr.read()
    rrs = [relres(res.x[lane], b4[lane]) for lane in range(4)]
    xr = x_rel(res.x[0], ref.x)
    emit(phase="precond_solve", precond="chebyshev", solver="gmres_batched",
         k=4, converged=res.converged.tolist(),
         restarts=res.restarts.tolist(), inner_steps=res.inner_steps.tolist(),
         true_relres=rrs, lane0_x_rel_to_unpreconditioned=xr, wall_s=wall,
         launches=d)
    check(res.converged.all() and max(rrs) <= 2 * TOL and xr <= 1e-3,
          f"chebyshev batch: converged {res.converged.tolist()}, relres "
          f"{rrs}, lane 0 x {xr}")
    lock, cyc = d["batched_cgs2"], int(res.restarts.max())
    steps_mv = len(pcs["chebyshev"].rhos)      # block mat-vecs per apply
    ctr.expect(d, {"batched_cgs2": lock,
                   "banded_matvec": (steps_mv + 1) * lock
                   + steps_mv * cyc + cyc + 1}, "chebyshev batch")
    del res, b4

    # the 32^2 system on the card against the CPU
    b_s = np.random.default_rng(1).standard_normal(32 * 32).astype(np.float32)
    host = stencils.convection_diffusion_2d(32, 32, beta=BETA, device="cpu")
    for name in setups:
        res = gmres(small, torch.from_numpy(b_s).cuda(), m=M, tol=TOL,
                    max_restarts=SPARSE_RESTARTS, gs="cgs2_fused",
                    precond=P.make_preconditioner(name, small, order=4))
        want = gmres(host, torch.from_numpy(b_s), m=M, tol=TOL,
                     max_restarts=SPARSE_RESTARTS, gs="cgs2_fused",
                     precond=P.make_preconditioner(name, host, order=4))
        diff = x_rel(res.x.cpu(), want.x)
        emit(phase="precond_solve", reference="cpu", n=32 * 32,
             precond=name, restarts=[res.restarts, want.restarts],
             x_rel=diff)
        check(res.converged and want.converged
              and abs(res.restarts - want.restarts) <= 1 and diff <= 1e-3,
              f"{name}: card and CPU disagree at 32^2 ({diff})")
    for name, count in ctr.totals.items():
        check(count > 0, f"{name} was never launched on the "
                         f"preconditioned path")
    emit(phase="precond_solve", launches_total=ctr.totals)
    ctr.zero()

    # ---- 18. timing -------------------------------------------------------
    def event_ms(fn) -> float:
        """CUDA-event time of one call after a warm one: the plain versions
        of the sweep and the setup are thousands of small ops, whose
        profile alone takes minutes."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    def measure(fn, plain, iters=50, plain_by_events=False,
                composite_fn=None, library_fn=None, **info) -> dict:
        row = dict(**timed(fn, iters=iters, warmup=min(iters, 5), cold=True),
                   warm_ms=timed(fn, iters=iters,
                                 warmup=min(iters, 5))["ms"],
                   plain_ms=event_ms(plain) if plain_by_events
                   else cold_ms(plain),
                   plain_timing="CUDA events, one call" if plain_by_events
                   else "profiler, cold",
                   library_ms=cold_ms(library_fn)
                   if library_fn else None,
                   composite_ms=cold_ms(composite_fn)
                   if composite_fn else None, **info)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
        return row

    timing = {}
    nbands = op.bands.shape[0]
    v = torch.randn(n, device="cuda", generator=gen)
    cheb = pcs["chebyshev"]
    kw = dict(theta=cheb.theta, delta=cheb.delta, rhos=cheb.rhos)
    csr = csr_of(*(lambda e: (e.values, e.cols))(op.to_ell()))

    def cheb_composite():
        z, z_old = v / cheb.theta, torch.zeros_like(v)
        for rho, rho_old in cheb.rhos:
            z_new = rho * (2.0 / cheb.delta * (v - torch.mv(csr, z))
                           + rho_old * (z - z_old)) + z
            z_old, z = z, z_new
        return z

    apply_launches = ctr.totals
    for dtype in (f32, torch.bfloat16):
        sz = torch.empty((), dtype=dtype).element_size()
        bands = op.bands.to(dtype)
        row = measure(
            lambda: mp.banded_cheb_apply(bands, v, op.offsets, **kw),
            lambda: mp.banded_cheb_apply_plain(bands, v, op.offsets, **kw),
            composite_fn=cheb_composite if dtype == f32 else None,
            composite=f"{len(cheb.rhos)} x CSR torch.mv + the recurrence's "
                      f"vector ops" if dtype == f32 else None,
            n=n, order=cheb.order, bytes=nbands * n * sz + 8 * n,
            flops=len(cheb.rhos) * (2 * nbands + 7) * n + n)
        row["launches_per_path"] = apply_launches["banded_cheb_apply"]
        emit(phase="precond_timing", kernel="banded_cheb_apply",
             dtype=str(dtype), card=smi, **row)
        if dtype == f32:
            timing["banded_cheb_apply"] = row

    for label, bands, offs, unit, lower in (
            ("ILU(0) L", ilu.l_bands, ilu.l_offsets, True, True),
            ("ILU(0) U", ilu.u_bands, ilu.u_offsets, False, False),
            ("line-Jacobi L", lj.l_bands, lj.l_offsets, True, True),
            ("line-Jacobi U", lj.u_bands, lj.u_offsets, False, False)):
        mat = torch.cat([bands, torch.ones_like(bands[:1])]) if unit \
            else bands
        sp = operators.BandedOperator(
            mat, offs + ((0,) if unit else ()), device="cuda").to_ell()
        tri = csr_of(sp.values, sp.cols)
        vv = v[:, None]
        library, lib_note = None, None
        try:
            torch.triangular_solve(vv, tri, upper=not lower,
                                   unitriangular=unit)
            torch.cuda.synchronize()

            def library():
                return torch.triangular_solve(vv, tri, upper=not lower,
                                              unitriangular=unit)
            lib_note = "torch.triangular_solve(CSR factor) (cuSPARSE)"
        except (RuntimeError, NotImplementedError) as exc:
            lib_note = f"none: torch.triangular_solve raised {exc!r:.120}"
        nb = bands.shape[0]
        vf = v[None]
        plan = trisolve.sweep_plan(bands, vf, torch.empty_like(vf), offs)
        row = measure(
            lambda: trisolve.banded_trisweep(bands, v, offs, unit_diag=unit,
                                             lower=lower),
            lambda: trisolve.banded_trisweep_plain(
                bands, v, offs, unit_diag=unit, lower=lower),
            plain_by_events=True, library_fn=library, library=lib_note, n=n,
            offsets=list(offs), route=plan["route"], chunk=plan["chunk"],
            chunks=plan["chunks"], rows_per_thread=plan["rows"],
            bytes=(nb * 4 + 8) * n, flops=(2 * nb + 2) * n)
        if plan["route"] != "scan":
            # the chain's floor: the same chunks with nothing loaded
            t = timed(lambda: trisolve.chain_probe(
                offs, n, unit_diag=unit, lower=lower))
            row["chain_floor_ms"] = t["ms"] or t["event_ms"]
        row["launches_per_path"] = apply_launches["banded_trisweep"]
        emit(phase="precond_timing", kernel=f"banded_trisweep {label}",
             card=smi, **row)
        if label == "ILU(0) L":
            timing["banded_trisweep"] = row

    # the setup on the five-point pattern (2 NX - 1 dependent rows: the
    # anti-diagonals) and on line-Jacobi's (NX independent chains of NX)
    for pattern, bands, offs, chain in (
            ("five-point", op.bands, op.offsets, 2 * NX - 1),
            ("line-Jacobi (-1, 0, 1)", op.bands[1:4].contiguous(),
             (-1, 0, 1), NX)):
        nb = bands.shape[0]
        lower = [x for x in offs if x < 0]
        pairs = sum(1 for lo in lower for up in offs
                    if up > 0 and lo + up in offs)
        row = measure(lambda bands=bands, offs=offs:
                      trisolve.ilu0_factor(bands, offs),
                      lambda bands=bands, offs=offs:
                      trisolve.ilu0_factor_plain(bands, offs),
                      iters=20, plain_by_events=True, n=n, pattern=pattern,
                      bytes=nb * n * (4 + 4),
                      flops=(len(lower) + 2 * pairs + 2 * nb) * n)
        ms = row["ms"] or row["event_ms"]
        row.update(chain_rows=chain, us_per_link=ms * 1e3 / chain,
                   launches_per_path=apply_launches["ilu0_factor"],
                   tile_rows=tuning.ilu0_plan(offs)["tile_rows"])
        if pattern == "five-point":
            t0 = time.perf_counter()
            P.estimate_interval(op)
            torch.cuda.synchronize()
            row["estimate_interval_s"] = time.perf_counter() - t0
            row["setup_s"] = setup_s
            timing["ilu0_factor"] = row
        emit(phase="precond_timing", kernel="ilu0_factor", card=smi, **row)

    # per solve: wall, device and idle per Arnoldi step and time to
    # solution, beside the unpreconditioned banded cgs2_fused solve
    turn = [("none", "gmres", "cgs2_fused", ref)]
    turn += [(name, solver, gs, solves[(name, solver, gs)])
             for name, solver, gs in runs]
    for name, solver, gs, res in turn:
        pc = pcs.get(name)
        if solver == "gmres":
            def run(pc=pc, gs=gs):
                return gmres(op, b, m=M, tol=TOL,
                             max_restarts=SPARSE_RESTARTS, gs=gs, precond=pc)
        else:
            def run(pc=pc, gs=gs):
                return gmres_sstep(op, b, s=s, blocks=blocks, tol=TOL,
                                   max_restarts=SPARSE_RESTARTS, gs=gs,
                                   precond=pc)
        r = solve_timing(run, res.inner_steps, phase="precond_timing",
                         solve=f"{name} {solver} {gs}", restarts=res.restarts,
                         card=smi)
        emit(phase="precond_timing", solve=f"{name} {solver} {gs}",
             restarts=res.restarts, time_to_solution_s=r["wall_ms"] / 1e3,
             setup_s=setup_s.get(name, 0.0),
             time_to_solution_with_setup_s=r["wall_ms"] / 1e3
             + setup_s.get(name, 0.0))
    ctr.zero()
    return errs, ctr.totals, timing


class Collectives:
    """Host time spent in the row-sharded solvers' collective calls (the
    all-reduces, all-gathers and halo exchanges), by wrapping the three
    entry points the port routes every collective through: seconds in
    all, and seconds and calls by entry point.  A call that issues no
    collective (``all_reduce(x, None)`` on one device's path, a zero-width
    halo) counts neither time nor call."""

    def __init__(self):
        from repro_torch.kernels import spmv, tuning
        self.targets = ((tuning, "all_reduce"), (tuning, "all_gather"),
                        (spmv, "halo_exchange"))
        self.seconds = 0.0
        self.by_name = {name: [0.0, 0] for _, name in self.targets}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.targets]
        from repro_torch.kernels import tuning
        issued = tuning.COLLECTIVES

        for (mod, name), fn in zip(self.targets, self.saved):
            def timed_call(*a, _fn=fn, _name=name, **k):
                before = sum(issued.values())
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    dt = time.perf_counter() - t0
                    if sum(issued.values()) > before:
                        self.seconds += dt
                        self.by_name[_name][0] += dt
                        self.by_name[_name][1] += 1
            setattr(mod, name, timed_call)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)


def sharded_expected(fmt, solver, gs, pc, res, blocks, n_rhos):
    """Kernel launches, collectives and collectives per Arnoldi step (per
    s-step block) of one sharded solve on one rank (phase 20): the counts
    the CPU tests take from the JAX package per step, plus the solve's own
    (||b||, the true residuals, the final gather of x; s-step: the band
    exchange and theta).  ``n_rhos``: mat-vecs per Chebyshev apply."""
    st, rs = res.inner_steps, res.restarts
    mv = {"dense": "block_matvec", "banded": "banded_matvec_halo",
          "ell": "ell_matvec_halo",
          "sell": "ell_matvec_halo"}[fmt]
    coll = {"all_reduce": 0, "all_gather": 1, "halo": 0}  # x gather
    op_coll = "all_gather" if fmt == "dense" else "halo"
    if solver == "sstep":
        nb = blocks * rs
        launches = {"banded_powers_halo": nb,
                    "block_gs_update": 2 * nb, mv: rs + 1,
                    ("block_gs_project" if gs == "cgs2"
                     else "block_gs_project_gram"): 2 * nb}
        per_block = 5 if gs == "cgs2" else 3
        # bnorm, residuals, theta; bands once, u_0 per block
        coll["all_reduce"] += per_block * nb + rs + 3
        coll["halo"] += nb + rs + 2
        return launches, coll, {"all_reduce": per_block,
                                "halo": 1, "all_gather": 0}
    mvs = st + rs + 1 + (rs if gs == "cgs2_pipelined" else 0)
    launches = {mv: mvs, "gs_update": 2 * st}
    if gs == "cgs2_pipelined":
        launches["gs_project_norm_partial"] = st
        coll["all_reduce"] += st + rs + 2
        per_step = {"all_reduce": 1}
    else:
        launches["gs_project_partial"] = 2 * st
        coll["all_reduce"] += 3 * st + rs + 2
        per_step = {"all_reduce": 3}
    per_step[op_coll] = 1
    if pc == "chebyshev":     # the interval's 8 power iterations
        launches["banded_matvec"] = 8
        launches[mv] += n_rhos * (st + rs)
        per_step["halo"] += n_rhos
    elif pc == "banded_block_jacobi":
        launches["ilu0_factor"] = 1
        launches["banded_trisweep"] = 2 * (st + rs)
    coll[op_coll] += launches[mv]
    return launches, coll, dict({"all_reduce": 0, "all_gather": 0,
                                 "halo": 0}, **per_step)


def sharded_phases(smi, gen, dense_fused, sparse_solves, sstep_solves):
    """Phases 19-21: the row-sharded slice on a one-rank NCCL group.
    ``dense_fused``: phase 3's dense cgs2_fused solve; ``sparse_solves``
    phase 7's stencil solves by (fmt, gs); ``sstep_solves`` phase 11's by
    (system, basis).  Returns (max abs errors, main-path launches, timing
    rows) of its kernels, keyed by wrapper name."""
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (gmres, gmres_sharded, gmres_sstep,
                                  gmres_sstep_sharded, operators, stencils)
    from repro_torch.core import preconditioners as P
    from repro_torch.kernels import (arnoldi_fused, block_gs, cgs2, matvec,
                                     spmv, trisolve, tuning)
    from repro_torch.kernels import matrix_powers as mp

    ctr = Counters({"gs_project_partial": cgs2.gs_project_partial,
                    "block_gs_project": block_gs.block_gs_project,
                    "banded_powers_halo": mp.banded_powers_halo,
                    "banded_matvec_halo": spmv.banded_matvec_halo,
                    "ell_matvec_halo": spmv.ell_matvec_halo},
                   banded_matvec=spmv.banded_matvec,
                   ell_matvec=spmv.ell_matvec, sell_matvec=spmv.sell_matvec,
                   block_matvec=matvec.block_matvec,
                   gs_project=cgs2.gs_project, cgs2=cgs2.cgs2,
                   arnoldi_step=arnoldi_fused.arnoldi_step,
                   gs_project_norm_partial=cgs2.gs_project_norm_partial,
                   gs_update=cgs2.gs_update,
                   block_gs_pass=block_gs.block_gs_pass,
                   block_gs_project_gram=block_gs.block_gs_project_gram,
                   block_gs_update=block_gs.block_gs_update,
                   banded_powers=mp.banded_powers,
                   banded_cheb_apply=mp.banded_cheb_apply,
                   banded_trisweep=trisolve.banded_trisweep,
                   ilu0_factor=trisolve.ilu0_factor)
    errs = {name: [] for name in ctr.kernels}
    f32 = torch.float32
    n, halo, s, blocks = NX * NX, NX, SSTEP_S, SSTEP_BLOCKS
    j, k_start = 15, 25
    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    ell = op.to_ell()
    offsets = op.offsets
    # the band stack as the s-step solver pre-scales it (theta >= ||A||_inf)
    scaled = op.bands / op.bands.abs().sum(dim=0).max()
    pad = torch.nn.functional.pad

    def compare(name, got, want, dtype, **info):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rel = max(relerr(g, w) for g, w in zip(got, want))
        err = max(abserr(g, w) for g, w in zip(got, want))
        errs[name].append(err)
        emit(phase="sharded_kernels", kernel=name, dtype=str(dtype),
             max_rel_err=rel, max_abs_err=err, **info)
        check(rel < TOLS[dtype], f"{name} {info} {dtype}: {rel}")

    tmp = tempfile.TemporaryDirectory()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/pg",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        cpu_group = dist.new_group(ranks=[0], backend="gloo")
        # ---- 19. the per-shard kernels vs plain ---------------------------
        for dtype in (f32, torch.bfloat16):
            v = basis(n, M + 1, j, dtype, gen)
            w = torch.randn(n, device="cuda", generator=gen)
            vb = basis(n, M + 1, k_start, dtype, gen)
            wb = torch.randn(s, n, device="cuda", generator=gen)
            tin = torch.eye(s, device="cuda") + 0.1 * torch.randn(
                s, s, device="cuda", generator=gen)
            bands = scaled.to(dtype)
            x = torch.randn(n, device="cuda", generator=gen)
            xk = torch.randn(n, 4, device="cuda", generator=gen)
            vals = ell.values.to(dtype)
            full = {
                "gs_project_partial": cgs2.gs_project_partial(v, w, j),
                "block_gs_project": block_gs.block_gs_project(vb, wb, tin,
                                                              k_start),
                "banded_powers_halo": mp.banded_powers_halo(
                    pad(bands, (s * halo, s * halo)).contiguous(),
                    pad(x, (s * halo, s * halo)), offsets, s),
                "banded_matvec_halo": spmv.banded_matvec_halo(
                    bands, pad(xk, (0, 0, halo, halo)), offsets),
                "ell_matvec_halo": spmv.ell_matvec_halo(
                    vals, ell.cols + halo, pad(xk, (0, 0, halo, halo)))}
            plain = {
                "gs_project_partial": cgs2.gs_project_partial_plain(v, w, j),
                "block_gs_project": block_gs.block_gs_project_plain(
                    vb, wb, tin, k_start),
                "banded_powers_halo": mp.banded_powers_halo_plain(
                    pad(bands, (s * halo, s * halo)),
                    pad(x, (s * halo, s * halo)), offsets, s),
                "banded_matvec_halo": spmv.banded_matvec_halo_plain(
                    bands, pad(xk, (0, 0, halo, halo)), offsets),
                "ell_matvec_halo": spmv.ell_matvec_halo_plain(
                    vals, ell.cols + halo, pad(xk, (0, 0, halo, halo)))}
            for name in full:
                compare(name, full[name], plain[name], dtype, n=n,
                        width="full", j=j, k_start=k_start, s=s)
            # four shards in one process: halos cut from the global
            # vectors as halo_exchange delivers them, partials summed in
            # rank order, against the full-width call
            nl = n // 4
            ex = (s - 1) * halo
            bands_ex = pad(bands, (ex, ex))
            x_s = pad(x, (s * halo, s * halo))
            xk_h = pad(xk, (0, 0, halo, halo))
            parts = {name: [] for name in full}
            for p in range(4):
                r0, rows = p * nl, slice(p * nl, (p + 1) * nl)
                parts["gs_project_partial"].append(cgs2.gs_project_partial(
                    v[:, rows].contiguous(), w[rows], j))
                parts["block_gs_project"].append(block_gs.block_gs_project(
                    vb[:, rows].contiguous(), wb[:, rows].contiguous(), tin,
                    k_start))
                parts["banded_powers_halo"].append(mp.banded_powers_halo(
                    pad(bands_ex[:, r0:r0 + nl + 2 * ex],
                        (halo, halo)).contiguous(),
                    x_s[r0:r0 + nl + 2 * s * halo].contiguous(), offsets, s))
                parts["banded_matvec_halo"].append(spmv.banded_matvec_halo(
                    bands[:, rows].contiguous(),
                    xk_h[r0:r0 + nl + 2 * halo].contiguous(), offsets))
                cols_p = torch.clamp(ell.cols[rows] - r0 + halo, 0,
                                     nl + 2 * halo - 1).contiguous()
                parts["ell_matvec_halo"].append(spmv.ell_matvec_halo(
                    vals[rows].contiguous(), cols_p,
                    xk_h[r0:r0 + nl + 2 * halo].contiguous()))
            c_sum = parts["block_gs_project"][0][1].clone()
            nrm_sum = parts["banded_powers_halo"][0][1].clone()
            h_sum = parts["gs_project_partial"][0].clone()
            for p in range(1, 4):                 # rank order
                h_sum += parts["gs_project_partial"][p]
                c_sum += parts["block_gs_project"][p][1]
                nrm_sum += parts["banded_powers_halo"][p][1]
            split = {
                "gs_project_partial": h_sum,
                "block_gs_project": (torch.cat(
                    [q for q, _ in parts["block_gs_project"]], dim=1), c_sum),
                "banded_powers_halo": (torch.cat(
                    [z for z, _ in parts["banded_powers_halo"]], dim=1),
                    nrm_sum),
                "banded_matvec_halo": torch.cat(parts["banded_matvec_halo"]),
                "ell_matvec_halo": torch.cat(parts["ell_matvec_halo"])}
            for name in full:
                compare(name, split[name], full[name], dtype, n=n,
                        width="4 shards in rank order vs full", j=j,
                        k_start=k_start, s=s)
            del v, vb, wb, parts, split, full, plain
            # the streaming projection's edges (phase 13's shapes) and
            # n = 10^4, rows 0..j of 31 (j = 30 takes the 32-row bucket)
            for nb, off in STREAM_EDGES + ((N, 0),):
                v, w = stream_edge(nb, M + 1, off, dtype, gen)
                for jj in (0, 7, 8, 15, 30):
                    want = cgs2.stream_plan(v, w, jj + 1)["route"]
                    zero_routes(cgs2.gs_project_partial)
                    got = cgs2.gs_project_partial(v, w, jj)
                    compare("gs_project_partial", got,
                            cgs2.gs_project_partial_plain(v, w, jj), dtype,
                            n=nb, j=jj, offset=off, width="edge",
                            route=want,
                            routes=dict(cgs2.gs_project_partial.routes))
                    check(cgs2.gs_project_partial.routes[want] == 1,
                          f"gs_project_partial n={nb} offset={off}: routes "
                          f"{cgs2.gs_project_partial.routes}, expected "
                          f"{want}")
                    check(torch.equal(cgs2.gs_project_partial(v, w, jj),
                                      got),
                          f"gs_project_partial n={nb} j={jj}: two calls "
                          f"differ")
                del v, w

        # ---- 20. the sharded solves --------------------------------------
        b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                             .astype(np.float32)).cuda()
        a_d = operators.random_diagdom(N, dominance=0.015, seed=0)
        b_d = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                               .astype(np.float32)).cuda()
        dense = operators.DenseOperator(a_d, backend="cuda")
        systems = {"banded": op, "ell": ell,
                   "sell": operators.SlicedEllOperator.from_ell(ell),
                   "dense": dense}
        bands64 = op.bands.double()

        def relres(fmt, x):
            if fmt == "dense":
                r = torch.mv(a_d.double(), x.double()) - b_d.double()
                return float(r.norm() / b_d.double().norm())
            r = spmv.banded_matvec_plain(bands64, x.double(), offsets) \
                - b.double()
            return float(r.norm() / b.double().norm())

        n_rhos = len(P.cheb_coeffs(4, 0.5, 1.0)[2])
        runs = [(fmt, "gmres", gs, None)
                for gs in ("cgs2_fused", "cgs2_pipelined")
                for fmt in ("dense", "banded", "ell", "sell")]
        runs += [("banded", "sstep", gs, None)
                 for gs in ("cgs2", "cgs2_pipelined")]
        runs += [("banded", "gmres", "cgs2_fused", pc)
                 for pc in ("chebyshev", "jacobi", "banded_block_jacobi")]
        runs += [("dense", "gmres", "cgs2_fused", "block_jacobi")]

        def sharded(fmt, solver, gs, pc, budget=SPARSE_RESTARTS):
            rhs = b_d if fmt == "dense" else b
            if solver == "sstep":
                return lambda: gmres_sstep_sharded(
                    group, systems[fmt], rhs, s=s, blocks=blocks, tol=TOL,
                    max_restarts=budget, gs=gs, precond=pc)
            return lambda: gmres_sharded(
                group, systems[fmt], rhs, m=M, tol=TOL, max_restarts=budget,
                gs=gs, precond=pc)

        def single(fmt, solver, gs, pc, budget=SPARSE_RESTARTS):
            rhs = b_d if fmt == "dense" else b
            if pc == "banded_block_jacobi":   # one rank: the whole block
                pc_obj = P.banded_ilu0(op)
            elif pc == "block_jacobi":
                pc_obj = P.block_jacobi(a_d, N)
            else:
                pc_obj = None if pc is None else P.make_preconditioner(
                    pc, systems[fmt], order=4)
            if solver == "sstep":
                return lambda: gmres_sstep(systems[fmt], rhs, s=s,
                                           blocks=blocks, tol=TOL,
                                           max_restarts=budget, gs=gs,
                                           precond=pc_obj)
            return lambda: gmres(systems[fmt], rhs, m=M, tol=TOL,
                                 max_restarts=budget, gs=gs, precond=pc_obj)

        refs = {("banded", "gmres", "cgs2_fused", None):
                sparse_solves[("banded", "cgs2_fused")][0],
                ("ell", "gmres", "cgs2_fused", None):
                sparse_solves[("ell", "cgs2_fused")][0],
                ("sell", "gmres", "cgs2_fused", None):
                sparse_solves[("sell", "cgs2_fused")][0],
                ("dense", "gmres", "cgs2_fused", None): dense_fused,
                ("banded", "sstep", "cgs2", None):
                sstep_solves[("banded", "monomial")]}
        results = {}
        for key in runs:
            fmt, solver, gs, pc = key
            if key not in refs:
                refs[key] = single(*key)()
            ref = refs[key]
            ctr.zero()
            zero_routes(cgs2.gs_project_partial)
            for kind in tuning.COLLECTIVES:
                tuning.COLLECTIVES[kind] = 0
            t0 = time.perf_counter()
            res = sharded(*key)()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = ctr.read()
            routes = dict(cgs2.gs_project_partial.routes)
            coll = dict(tuning.COLLECTIVES)
            rr = relres(fmt, res.x)
            diff = float((res.x - ref.x).norm() / ref.x.norm())
            launches, want_coll, per_step = sharded_expected(
                *key, res, blocks, n_rhos)
            emit(phase="sharded_solve", fmt=fmt, solver=solver, gs=gs,
                 precond=pc, n=res.x.shape[0], converged=res.converged,
                 restarts=res.restarts, single_restarts=ref.restarts,
                 inner_steps=res.inner_steps, true_relres=rr,
                 x_rel_to_single=diff, wall_s=wall, launches=d,
                 collectives=coll, collectives_per_step=per_step,
                 gs_project_partial_routes=routes)
            what = f"sharded {fmt}/{solver}/{gs}/{pc}"
            check(res.converged, f"{what} did not converge")
            check(rr <= 2 * TOL, f"{what}: true relres {rr}")
            check(bool(torch.isfinite(res.x).all())
                  and res.x.shape == ref.x.shape, f"{what}: x not finite")
            check(abs(res.restarts - ref.restarts)
                  <= max(1, 0.1 * ref.restarts),
                  f"{what}: {res.restarts} restarts vs {ref.restarts}")
            check(diff <= 1e-3, f"{what}: x differs from one device by "
                                f"{diff}")
            ctr.expect(d, launches, what)
            check(coll == want_coll, f"{what}: collectives {coll}, "
                                     f"expected {want_coll}")
            check(routes["scalar"] == 0, f"{what}: gs_project_partial "
                                         f"routes {routes}")
            results[key] = res
        for name, count in ctr.totals.items():
            check(count > 0, f"{name} was never launched on the sharded "
                             f"path")
        launches_total = dict(ctr.totals)
        emit(phase="sharded_solve", launches_total=launches_total)

        # the 32^2 system on the card against the same solve on the CPU
        b_s = np.random.default_rng(1).standard_normal(32 * 32) \
            .astype(np.float32)
        for solver in ("gmres", "sstep"):
            got, want = [
                (gmres_sstep_sharded if solver == "sstep" else
                 gmres_sharded)(
                    g, stencils.convection_diffusion_2d(
                        32, 32, beta=BETA, device=dv), b_s,
                    **(dict(s=s, blocks=blocks) if solver == "sstep"
                       else dict(m=M)), tol=TOL,
                    max_restarts=SPARSE_RESTARTS, device=dv)
                for g, dv in ((group, "cuda"), (cpu_group, "cpu"))]
            diff = float((got.x.cpu() - want.x).norm() / want.x.norm())
            emit(phase="sharded_solve", reference="cpu", n=32 * 32,
                 solver=solver, restarts=[got.restarts, want.restarts],
                 x_rel=diff)
            check(got.converged and want.converged
                  and abs(got.restarts - want.restarts) <= 1
                  and diff <= 1e-3,
                  f"sharded {solver}: card and CPU disagree at 32^2 "
                  f"({diff})")
        ctr.zero()

        # ---- 21. timing ---------------------------------------------------
        timing = {}
        nbands = op.bands.shape[0]
        csr = csr_of(ell.values, ell.cols)
        w = torch.randn(n, device="cuda", generator=gen)
        wb = torch.randn(s, n, device="cuda", generator=gen)
        tin = torch.eye(s, device="cuda") + 0.1 * torch.randn(
            s, s, device="cuda", generator=gen)
        x = torch.randn(n, device="cuda", generator=gen)
        csr_name = "CSR torch.mv of the same matrix (cuSPARSE)"
        per_path = {"gs_project_partial": "gs_project_partial",
                    "block_gs_project": "block_gs_project",
                    "banded_powers_halo": "banded_powers_halo",
                    "banded_matvec_halo": "banded_matvec_halo",
                    "ell_matvec_halo": "ell_matvec_halo"}
        for dtype in (f32, torch.bfloat16):
            sz = torch.empty((), dtype=dtype).element_size()
            v = basis(n, M + 1, j, dtype, gen)
            vb = basis(n, M + 1, k_start, dtype, gen)
            bands_pad = pad(scaled, (s * halo, s * halo)).to(dtype) \
                .contiguous()
            width = n + 2 * s * halo
            x_s = pad(x, (s * halo, s * halo))
            x_h = pad(x, (halo, halo))
            bands = op.bands.to(dtype)
            vals = ell.values.to(dtype)
            cols_h = (ell.cols + halo).contiguous()
            vf, vbf = v.float(), vb.float()

            def powers_composite():
                z, out = x, []
                for _ in range(s):
                    z = torch.mv(csr, z)
                    out.append(z)
                zs = torch.stack(out)
                return zs, (zs * zs).sum(dim=1)

            rows = {
                "gs_project_partial": dict(
                    fn=lambda: cgs2.gs_project_partial(v, w, j),
                    plain=lambda: cgs2.gs_project_partial_plain(v, w, j),
                    composite=lambda: pad(torch.mv(vf[:j + 1], w),
                                          (0, M - j)),
                    composite_name="torch.mv(V[:j+1], w) + pad",
                    library=lambda: torch.mv(v[:j + 1], w),
                    library_name="torch.mv(V[:j+1], w) (cuBLAS GEMV)",
                    bytes=((j + 1) * sz + 4) * n, flops=2 * (j + 1) * n),
                "block_gs_project": dict(
                    fn=lambda: block_gs.block_gs_project(vb, wb, tin,
                                                         k_start),
                    plain=lambda: block_gs.block_gs_project_plain(
                        vb, wb, tin, k_start),
                    composite=lambda: (lambda q: (q, pad(
                        vbf[:k_start + 1] @ q.T, (0, 0, 0, M - k_start))))(
                        torch.matmul(tin, wb)),
                    composite_name="2 torch.matmul (T W, V[:k+1] Q^T) + pad",
                    library=None,
                    grid=block_gs.block_gs_plan(vb, wb, k_start)["grid"],
                    bytes=((k_start + 1) * sz + 8 * s) * n,
                    flops=2 * s * s * n + 2 * (k_start + 1) * s * n),
                "banded_powers_halo": dict(
                    fn=lambda: mp.banded_powers_halo(bands_pad, x_s,
                                                     offsets, s),
                    plain=lambda: mp.banded_powers_halo_plain(
                        bands_pad, x_s, offsets, s),
                    composite=powers_composite,
                    composite_name=f"{s} CSR torch.mv + norms",
                    library=None,
                    bytes=nbands * width * sz + 4 * width + 4 * s * n
                    + 4 * s,
                    flops=s * (2 * nbands * width + 2 * n)),
                "banded_matvec_halo": dict(
                    fn=lambda: spmv.banded_matvec_halo(bands, x_h, offsets),
                    plain=lambda: spmv.banded_matvec_halo_plain(
                        bands, x_h, offsets),
                    composite=None, composite_name=None,
                    library=lambda: torch.mv(csr, x),
                    library_name=csr_name,
                    bytes=nbands * n * sz + 4 * (n + 2 * halo) + 4 * n,
                    flops=2 * nbands * n),
                "ell_matvec_halo": dict(
                    fn=lambda: spmv.ell_matvec_halo(vals, cols_h, x_h),
                    plain=lambda: spmv.ell_matvec_halo_plain(vals, cols_h,
                                                             x_h),
                    composite=None, composite_name=None,
                    library=lambda: torch.mv(csr, x),
                    library_name=csr_name,
                    bytes=ell.values.numel() * (sz + 4)
                    + 4 * (n + 2 * halo) + 4 * n,
                    flops=2 * ell.values.numel())}
            for name, spec in rows.items():
                row = dict(**timed(spec["fn"], cold=True),
                           warm_ms=timed(spec["fn"])["ms"],
                           plain_ms=cold_ms(spec["plain"])
                           if dtype == f32 else None,
                           composite_ms=cold_ms(spec["composite"])
                           if spec["composite"] and dtype == f32 else None,
                           composite=spec["composite_name"],
                           library_ms=cold_ms(spec["library"])
                           if spec["library"] and dtype == f32 else None,
                           library=spec.get("library_name"),
                           bytes=spec["bytes"], flops=spec["flops"], n=n,
                           j=j, k_start=k_start, s=s, grid=spec.get("grid"),
                           launches_per_path=launches_total[per_path[name]])
                row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                         row["flops"])
                emit(phase="sharded_timing", kernel=name, dtype=str(dtype),
                     card=smi, **row)
                if dtype == f32:
                    timing[name] = row
            del v, vb, bands_pad
            # row 4 at the dense system's n = 10^4, beside cuBLAS's GEMV
            v = basis(N, M + 1, j, dtype, gen)
            w10 = torch.randn(N, device="cuda", generator=gen)
            row = dict(**timed(lambda: cgs2.gs_project_partial(v, w10, j),
                               cold=True),
                       warm_ms=timed(lambda: cgs2.gs_project_partial(
                           v, w10, j))["ms"],
                       plain_ms=cold_ms(lambda: cgs2.gs_project_partial_plain(
                           v, w10, j)) if dtype == f32 else None,
                       library_ms=cold_ms(lambda: torch.mv(v[:j + 1], w10))
                       if dtype == f32 else None,
                       library="torch.mv(V[:j+1], w) (cuBLAS GEMV)",
                       bytes=((j + 1) * sz + 4) * N, flops=2 * (j + 1) * N,
                       n=N, j=j)
            row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                     row["flops"])
            emit(phase="sharded_timing", kernel="gs_project_partial n = 10000",
                 dtype=str(dtype), card=smi, **row)
            del v

        # per solve: wall, device, idle share and collectives per step of
        # each sharded solve beside its one-device solve, in turn
        # (one device, sharded, sharded, one device), over the first
        # TIMING_RESTARTS cycles (whole cycles of m steps: the per-step
        # mix of the full solve at a seventh of its time)
        def one_run(run):
            with Collectives() as cl:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            return res, wall, cl

        def profiled(run):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            by = kernel_ms(prof)
            return (sum(by.values()),
                    sum(ms for key, ms in by.items() if "nccl" in key.lower()))

        pairs = [("dense", "gmres", "cgs2_fused", None),
                 ("banded", "gmres", "cgs2_fused", None),
                 ("banded", "gmres", "cgs2_pipelined", None),
                 ("banded", "sstep", "cgs2", None)]
        for key in pairs:
            walls = {"single": [], "sharded": []}
            steps, colls = {}, []
            for which in ("single", "sharded", "sharded", "single"):
                run = (single if which == "single" else sharded)(
                    *key, budget=TIMING_RESTARTS)
                res, wall, cl = one_run(run)
                walls[which].append(wall)
                steps[which] = res.inner_steps
                if which == "sharded":
                    colls.append(cl)
            dev_single, _ = profiled(single(*key, budget=TIMING_RESTARTS))
            dev_sharded, nccl = profiled(sharded(*key,
                                                 budget=TIMING_RESTARTS))
            st, st1 = steps["sharded"], steps["single"]
            cl = min(colls, key=lambda c: c.seconds)
            row = dict(
                solve="/".join(str(k) for k in key), steps=st,
                single_steps=st1, restarts=TIMING_RESTARTS,
                wall_ms_per_step=min(walls["sharded"]) / st,
                single_wall_ms_per_step=min(walls["single"]) / st1,
                walls_ms=walls,
                device_ms_per_step=dev_sharded / st,
                single_device_ms_per_step=dev_single / st1,
                device_idle_share=1 - dev_sharded / min(walls["sharded"]),
                single_device_idle_share=1 - dev_single
                / min(walls["single"]),
                collective_host_ms_per_step=cl.seconds * 1e3 / st,
                collective_host_ms_per_call={
                    name: sec * 1e3 / calls
                    for name, (sec, calls) in cl.by_name.items() if calls},
                collective_calls_per_step={
                    name: calls / st
                    for name, (sec, calls) in cl.by_name.items()},
                nccl_device_ms_per_step=nccl / st, card=smi)
            emit(phase="sharded_timing", **row)
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return errs, launches_total, timing


def to_device(tree, device):
    """A nested dict / list of tensors, every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def kernel_class(key: str) -> str:
    """The part of the prefill a device kernel belongs to, by its name."""
    k = key.lower()
    if "attention_wgmma_kernel" in k:
        return "attention"
    if any(f"ssd_{part}_kernel" in k for part in ("state", "pass", "scan")):
        return "ssd_scan"
    for name in ("attention_kernel", "gated_rmsnorm_kernel"):
        if name in k:
            return name.removesuffix("_kernel")
    if any(t in k for t in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "gemm"
    return "other"


def model_phases(smi):
    """Phases 22-24: zamba2-7b serving (prefill and cached greedy decode)
    on the attention, SSD-scan and gated-RMSNorm kernels."""
    import dataclasses
    from unittest import mock

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import attention as attention_k
    from repro_torch.kernels import gated_norm, ssd
    from repro_torch.launch import make_prefill_step, make_serve_step, serve
    from repro_torch.models import build, hybrid
    from repro_torch.models.model import leaves

    f32, bf16 = torch.float32, torch.bfloat16
    kernels = {"attention": attention_k.attention, "ssd_scan": ssd.ssd_scan,
               "gated_rmsnorm": gated_norm.gated_rmsnorm}
    errs = {name: [] for name in kernels}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=f32):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    def attn_inputs(b, hq, hkv, sq, skv, d, dtype):
        return (randn(b, hq, sq, d, dtype=dtype),
                randn(b, hkv, skv, d, dtype=dtype),
                randn(b, hkv, skv, d, dtype=dtype))

    def ssd_inputs(batch, heads, s, p, n, dtype):
        bh = batch * heads
        return (randn(bh, s, p, dtype=dtype), F.softplus(randn(bh, s)),
                -randn(bh, s).abs() * 0.1, randn(batch, s, n, dtype=dtype),
                randn(batch, s, n, dtype=dtype))

    def record(name, got, want, bar, **info):
        torch.cuda.synchronize()
        rel = relerr(got, want)
        errs[name].append(abserr(got, want))
        emit(phase="model_kernels", kernel=name, max_rel_err=rel, bar=bar,
             **info)
        check(rel < bar, f"{name} {info}: {rel}")

    # ---- 22. kernels vs plain ---------------------------------------------
    by_kernel = attention_k.attention.launches_by_kernel
    for dtype in (f32, bf16):
        route = "wgmma" if dtype == bf16 else "simt"
        for b, hq, hkv, sq, skv, window, causal, d in ATTN_SHAPES:
            q, k, v = attn_inputs(b, hq, hkv, sq, skv, d, dtype)
            before = dict(by_kernel)
            record("attention",
                   attention_k.attention(q, k, v, causal=causal,
                                         window=window),
                   attention_k.attention_plain(q, k, v, causal=causal,
                                               window=window),
                   TOLS[dtype], shape=[b, hq, hkv, sq, skv, d],
                   window=window, causal=causal, dtype=str(dtype),
                   kernel_route=route,
                   plan=attention_k.launch_plan(q, k, v))
            check(by_kernel[route] == before[route] + 1
                  and sum(by_kernel.values()) == sum(before.values()) + 1,
                  f"attention {dtype} did not launch the {route} kernel "
                  f"({before} -> {by_kernel})")
        for batch, heads, s, p, n, chunk in SSD_SHAPES:
            args = ssd_inputs(batch, heads, s, p, n, dtype)
            record("ssd_scan", ssd.ssd_scan(*args, heads=heads, chunk=chunk),
                   ssd.ssd_scan_plain(*args, heads=heads, chunk=chunk),
                   SSD_TOLS[dtype], shape=[batch * heads, s, p, n],
                   chunk=chunk, dtype=str(dtype))
        for batch, heads, s, p, n, chunk in SSD_STRONG_SHAPES:
            args = ssd_strong_inputs(batch, heads, s, p, n, dtype, seed=s)
            routes = dict(ssd.ssd_scan.routes)
            record("ssd_scan", ssd.ssd_scan(*args, heads=heads, chunk=chunk),
                   ssd.ssd_scan_plain(*args, heads=heads, chunk=chunk),
                   SSD_TOLS[dtype], shape=[batch * heads, s, p, n],
                   chunk=chunk, dtype=str(dtype), decays="zamba2",
                   route=[k for k, v in ssd.ssd_scan.routes.items()
                          if v != routes[k]],
                   plan={k: v for k, v in ssd.launch_plan(
                       args[0], args[3], heads=heads, chunk=chunk).items()
                         if k in ("head_group", "window", "route")})
        for shape in NORM_SHAPES:
            y, z, w = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), \
                randn(shape[-1], dtype=dtype)
            record("gated_rmsnorm", gated_norm.gated_rmsnorm(y, z, w),
                   gated_norm.gated_rmsnorm_plain(y, z, w), TOLS[dtype],
                   shape=list(shape), dtype=str(dtype))

    # ---- 23. zamba2-7b serving at full size --------------------------------
    cfg = configs.get("zamba2-7b")
    vocab = cfg.vocab_size
    sites = cfg.num_layers // cfg.attn_every
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(0).integers(
        2, vocab, (ZAMBA_BATCH, ZAMBA_PROMPT)).astype(np.int32)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(cfg)
    ctr = Counters(kernels)

    def zero_routes():
        for route in by_kernel:
            by_kernel[route] = 0
        for name in ssd.ssd_scan.kernel_launches:
            ssd.ssd_scan.kernel_launches[name] = 0

    ctr.zero()
    zero_routes()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    launches = ctr.read()
    routes = dict(by_kernel)
    ssd_kernels = dict(ssd.ssd_scan.kernel_launches)
    # two chunks: no pass between the two kernels
    check(ssd_kernels == {"ssd_state_kernel": cfg.num_layers,
                          "ssd_pass_kernel": 0,
                          "ssd_scan_kernel": cfg.num_layers},
          f"zamba2-7b prefill: SSD kernel launches {ssd_kernels}, expected "
          f"{cfg.num_layers} of the state and scan kernels")
    ctr.expect(launches, {"attention": sites, "ssd_scan": cfg.num_layers,
                          "gated_rmsnorm": cfg.num_layers},
               "zamba2-7b prefill")
    check(routes == {"wgmma": sites, "simt": 0},
          f"bf16 prefill attention launches by kernel {routes}, expected "
          f"{sites} wgmma")
    check(tuple(logits.shape) == (ZAMBA_BATCH, vocab)
          and bool(torch.isfinite(logits).all()),
          f"zamba2-7b prefill logits {tuple(logits.shape)} not finite")

    # the same prefill through the kernels' plain versions (patched here,
    # not switched in the package): at float32, TF32 off, and at the
    # config's bfloat16
    plain = (mock.patch.object(attention_k, "attention",
                               attention_k.attention_plain),
             mock.patch.object(ssd, "ssd_scan", ssd.ssd_scan_plain),
             mock.patch.object(gated_norm, "gated_rmsnorm",
                               gated_norm.gated_rmsnorm_plain))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prefill32 = make_prefill_step(cfg32)
    zero_routes()
    got32 = prefill32(params, batch)
    routes32 = dict(by_kernel)
    check(routes32 == {"wgmma": 0, "simt": sites},
          f"f32 prefill attention launches by kernel {routes32}, expected "
          f"{sites} simt")
    with plain[0], plain[1], plain[2]:
        want32 = prefill32(params, batch)
        want16 = prefill(params, batch)
    rel32, rel16 = relerr(got32, want32), relerr(logits, want16)
    emit(phase="model_serve", arch=cfg.name,
         params=sum(t.numel() for t in leaves(params)), init_s=init_s,
         batch=ZAMBA_BATCH, prompt=ZAMBA_PROMPT, launches=launches,
         attention_launches_by_kernel={"bf16 prefill": routes,
                                       "f32 prefill": routes32},
         ssd_kernel_launches=ssd_kernels,
         f32_kernels_vs_plain_rel=rel32, bf16_kernels_vs_plain_rel=rel16,
         logits_max_abs=float(logits.abs().max()), card=smi)
    check(rel32 < 1e-3, f"f32 prefill, kernels vs plain: {rel32}")
    del got32, want32, want16

    # greedy serving through launch.serve: 512 prompt steps, 32 tokens;
    # the decode path is plain PyTorch (as JAX's) and launches no kernel
    seen = {}
    decode = hybrid.zamba_decode

    def recording(params_, cfg_, cache, token, pos):
        out = decode(params_, cfg_, cache, token, pos)
        if pos == ZAMBA_PROMPT - 1:
            seen["logits"] = out[0]
        return out

    ctr.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(hybrid, "zamba_decode", recording):
        toks = serve.generate(cfg, params, tokens, ZAMBA_GEN)
    serve_s = time.perf_counter() - t0
    d = ctr.read()
    ctr.expect(d, {}, "zamba2-7b greedy decode")
    check(toks.shape == (ZAMBA_BATCH, ZAMBA_GEN)
          and bool(((toks >= 0) & (toks < vocab)).all()),
          f"generated tokens {toks.shape} out of range")
    rel_last = relerr(seen["logits"], logits)
    emit(phase="model_serve", path="launch.serve.generate",
         steps=ZAMBA_PROMPT + ZAMBA_GEN, seconds=serve_s,
         last_prompt_step_vs_prefill_rel=rel_last,
         argmax_agrees=bool((seen["logits"].argmax(-1)
                             == logits.argmax(-1)).all()),
         sample=toks[0][:16].tolist(), card=smi)

    # prefill against its own decode replay at float32 and full width, on
    # the prompt's first 16 tokens (one chunk of 16): printed, as the
    # bfloat16 comparison above
    short = {"tokens": tokens[:, :16]}
    want = prefill32(params, short)
    model32 = build(cfg32)
    cache = model32.init_cache(ZAMBA_BATCH, 16, f32)
    for i in range(16):
        got, cache = model32.decode(params, cache, tokens[:, i], i)
    emit(phase="model_serve", check="f32 prefill vs decode replay, 16 tokens",
         rel=relerr(got, want),
         argmax_agrees=bool((got.argmax(-1) == want.argmax(-1)).all()))
    del cache

    # the reduced config on the card against the port on the CPU
    rcfg = configs.get("zamba2-7b").reduced()
    rmodel = build(rcfg)
    rparams = rmodel.init(torch.Generator().manual_seed(0), device="cpu")
    rparams_c = to_device(rparams, "cuda")
    rtoks = np.random.default_rng(1).integers(2, rcfg.vocab_size, (2, 32))
    rel = relerr(rmodel.prefill(rparams_c, {"tokens": rtoks}).cpu(),
                 rmodel.prefill(rparams, {"tokens": rtoks}))
    check(rel < 1e-4, f"reduced prefill, card vs CPU: {rel}")
    cache_c = rmodel.init_cache(2, REDUCED_DECODE_STEPS, f32)
    cache_h = rmodel.init_cache(2, REDUCED_DECODE_STEPS, f32, device="cpu")
    rels = []
    for i in range(REDUCED_DECODE_STEPS):
        lc, cache_c = rmodel.decode(rparams_c, cache_c, rtoks[:, i], i)
        lh, cache_h = rmodel.decode(rparams, cache_h, rtoks[:, i], i)
        rels.append(relerr(lc.cpu(), lh))
    emit(phase="model_serve", reference="cpu", config="zamba2-7b reduced",
         prefill_rel=rel, decode_rel_max=max(rels))
    check(max(rels) < 1e-4, f"reduced decode, card vs CPU: {max(rels)}")

    # ---- 24. timing -------------------------------------------------------
    timing = {}
    b, hq, S, hd = ZAMBA_BATCH, cfg.num_heads, ZAMBA_PROMPT, cfg.head_dim
    q, k, v = attn_inputs(b, hq, cfg.num_kv_heads, S, S, hd, bf16)
    pairs = S * (S + 1) // 2
    d_inner = cfg.ssm_expand * cfg.d_model
    nh, P, N, Q = d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state, cfg.ssm_chunk
    sargs = ssd_inputs(b, nh, S, P, N, f32)
    rows_ = b * S
    y, z, w = randn(rows_, d_inner), randn(rows_, d_inner), randn(d_inner)
    cases = {
        "attention": dict(
            fn=lambda: attention_k.attention(q, k, v),
            plain=lambda: attention_k.attention_plain(q, k, v),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            library_name="F.scaled_dot_product_attention(is_causal=True)",
            shape=[b, hq, S, hd], dtype="bfloat16",
            bytes=4 * b * hq * S * hd * 2, flops=4 * b * hq * pairs * hd,
            rate=BF16_FLOPS_PER_S),
        "ssd_scan": dict(
            fn=lambda: ssd.ssd_scan(*sargs, heads=nh, chunk=Q),
            plain=lambda: ssd.ssd_scan_plain(*sargs, heads=nh, chunk=Q),
            library=None, library_name=None,
            shape=[b * nh, S, P, N, Q], dtype="float32",
            bytes=4 * (2 * b * nh * S * P + 2 * b * nh * S + 2 * b * S * N),
            # C B^T once per (batch row, chunk); three TF32 passes a
            # product (split TF32) on the tensor cores
            flops=ssd_flops(b, nh, S, P, N, Q)[0],
            ops=ssd_flops(b, nh, S, P, N, Q)[1], rate=TF32_FLOPS_PER_S),
        "gated_rmsnorm": dict(
            fn=lambda: gated_norm.gated_rmsnorm(y, z, w),
            plain=lambda: gated_norm.gated_rmsnorm_plain(y, z, w),
            library=lambda: F.rms_norm(y * F.silu(z), (d_inner,), w,
                                       cfg.norm_eps),
            library_name="F.rms_norm(y * F.silu(z), (d,), w, eps)",
            shape=[rows_, d_inner], dtype="float32",
            bytes=4 * (3 * rows_ * d_inner + d_inner),
            flops=8 * rows_ * d_inner, rate=F32_FLOPS_PER_S),
    }
    q32, k32, v32 = q.float(), k.float(), v.float()
    cases["attention"]["simt"] = lambda: attention_k.attention(q32, k32, v32)
    for name, c in cases.items():
        cold = timed(c["fn"], iters=20, cold=True)
        row = dict(
            **cold, warm_ms=timed(c["fn"], iters=20)["ms"],
            plain_ms=cold_ms(c["plain"], iters=10),
            library_ms=cold_ms(c["library"], iters=20) if c["library"]
            else None,
            library=c["library_name"], shape=c["shape"], dtype=c["dtype"],
            bytes=c["bytes"], flops=c["flops"],
            launches_per_prefill=launches[name])
        row["bound_ms"], row["bound_by"] = bound(
            c["bytes"], c.get("ops", c["flops"]), c["rate"])
        if "simt" in c:       # the float32 kernel at the same shape
            simt = timed(c["simt"], iters=20, cold=True)
            row["ms_by_kernel"] = {
                "wgmma (bf16)": row["ms"] or row["event_ms"],
                "simt (float32)": simt["ms"] or simt["event_ms"]}
        if name == "ssd_scan":
            # its kernels' launches and cold ms, from the profile that gave
            # the row's ms (None where that profile lost records), and
            # their shared memory
            by = cold["by_kernel"]
            row["kernels"] = {k: {"launches": ssd_kernels[k], "ms": sum(
                ms for key, ms in by.items() if k in key) if by else None}
                for k in ssd.KERNELS}
            row["smem_bytes"] = ssd.kernel_smem(sargs[0], sargs[3],
                                                heads=nh, chunk=Q)
        emit(phase="model_timing", kernel=name, card=smi, **row)
        timing[name] = row
    del q, k, v, q32, k32, v32, sargs, y, z, w

    # per prefill: wall (host clock ending in a sync), device time by
    # kernel class, idle share, prompt tokens/s
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    by = kernel_ms(prof)
    dev = sum(by.values())
    by_class = {}
    for key, ms in by.items():
        by_class[kernel_class(key)] = by_class.get(kernel_class(key), 0) + ms
    wall = min(walls)
    emit(phase="model_timing", path="prefill", batch=ZAMBA_BATCH,
         prompt=ZAMBA_PROMPT, wall_ms=wall, walls_ms=walls,
         prompt_tokens_per_s=ZAMBA_BATCH * ZAMBA_PROMPT / (wall / 1e3),
         device_ms=dev if dev > 0 else None,
         device_idle_share=1 - dev / wall if dev > 0 else None,
         device_ms_by_class=by_class,
         device_share_by_class={k: v / dev for k, v in by_class.items()}
         if dev > 0 else None,
         top_kernels_ms={key[:90]: ms for key, ms in
                         sorted(by.items(), key=lambda kv: -kv[1])[:8]},
         card=smi)

    # per decode token: wall over DECODE_TIMING_TOKENS steps after 4 warm
    # ones, device time from a profile of 4 more
    step = make_serve_step(cfg)
    n_tok = DECODE_TIMING_TOKENS
    cache = model.init_cache(ZAMBA_BATCH, 8 + n_tok)
    tok = torch.as_tensor(tokens[:, 0], device="cuda")
    for i in range(4):
        tok, cache = step(params, cache, tok, i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(4, 4 + n_tok):
        tok, cache = step(params, cache, tok, i)
    torch.cuda.synchronize()
    wall_tok = (time.perf_counter() - t0) * 1e3 / n_tok
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(4 + n_tok, 8 + n_tok):
            tok, cache = step(params, cache, tok, i)
        torch.cuda.synchronize()
    by = kernel_ms(prof)
    dev_tok = sum(by.values()) / 4
    by_class = {}
    for key, ms in by.items():
        by_class[kernel_class(key)] = (by_class.get(kernel_class(key), 0)
                                       + ms / 4)
    emit(phase="model_timing", path="decode", batch=ZAMBA_BATCH,
         wall_ms_per_token=wall_tok,
         device_ms_per_token=dev_tok if dev_tok > 0 else None,
         device_idle_share=1 - dev_tok / wall_tok if dev_tok > 0 else None,
         device_ms_per_token_by_class=by_class,
         top_kernels_ms_per_token={key[:90]: ms / 4 for key, ms in
                                   sorted(by.items(),
                                          key=lambda kv: -kv[1])[:6]},
         serve_s_per_token=serve_s / (ZAMBA_PROMPT + ZAMBA_GEN), card=smi)
    del params, cache
    return errs, launches, timing



def kernel_resources(so, names) -> dict:
    """Every instantiation of the named kernels (mangled name): ``ptxas
    -v``'s registers, spills and static shared memory (the build's log),
    and the HGMMA (wgmma) and HMMA (mma.sync) instructions in its SASS
    (``cuobjdump -sass`` of the built library)."""
    import os
    import re

    from repro_torch.kernels import _build

    res, cur = {}, None
    for line in _build.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m[1] if any(n in m[1] for n in names) else None
            if cur:
                res[cur] = {"registers": 0, "spill_stores": 0,
                            "spill_loads": 0, "static_smem": 0, "hgmma": 0,
                            "hmma": 0}
            continue
        if cur is None:
            continue
        if m := re.search(r"(\d+) bytes stack frame", line):
            res[cur]["stack_frame"] = int(m[1])
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            res[cur]["spill_stores"] = int(m[1])
            res[cur]["spill_loads"] = int(m[2])
        if m := re.search(r"Used (\d+) registers", line):
            res[cur]["registers"] = int(m[1])
        if m := re.search(r"(\d+) bytes smem", line):
            res[cur]["static_smem"] = int(m[1])
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m[1]
        elif fn in res and "HGMMA" in line:
            res[fn]["hgmma"] += 1
        elif fn in res and "HMMA" in line:
            res[fn]["hmma"] += 1
    return res


def template_name(mangled: str) -> str:
    """A kernel instantiation's readable name from its mangled one:
    ``_ZN5repro17ell_powers_kernelIfLi8EE...`` -> ``ell_powers_kernel<float,
    8>`` (a bool argument ``Lb1E`` -> ``true``)."""
    import re

    m = re.search(r"repro\d+(\w+?_kernel)I(f|13__nv_bfloat16)"
                  r"((?:L[ib]\d+E)*)E", mangled)
    if m is None:
        return mangled
    args = ["float" if m[2] == "f" else "bf16"] + [
        x if kind == "i" else ("true" if x == "1" else "false")
        for kind, x in re.findall(r"L([ib])(\d+)E", m[3])]
    return f"{m[1]}<{', '.join(args)}>"


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device is available")
    from repro_torch.core import gmres, operators, strategies
    from repro_torch.kernels import _build, arnoldi_fused, cgs2, matvec, tuning

    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    warnings.filterwarnings("ignore", message="Sparse")    # the CSR yardstick

    kernels = {"block_matvec": matvec.block_matvec,
               "gs_project": cgs2.gs_project,
               "arnoldi_step": arnoldi_fused.arnoldi_step}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    res = kernel_resources(so, ("sell_kernel", "attention_wgmma_kernel",
                                "ilu0_wave_kernel", "batched_cgs2_kernel",
                                "gs_stream_kernel", "block_gs_kernel",
                                "ell_powers_kernel", "gs_partial_",
                                "banded_powers_kernel", "banded_cheb_kernel",
                                "ssd_state_kernel", "ssd_scan_kernel",
                                "ssd_pass_kernel",
                                "block_gs_project_gram_kernel"))
    sell = [r for name, r in res.items() if "sell_kernel" in name]
    attn = {f"attention_wgmma_kernel<NB={nb}>": r for name, r in res.items()
            for nb in (1, 2) if f"attention_wgmma_kernelILi{nb}E" in name}
    redesign4 = {name: r for name, r in res.items()
                 if "ilu0_wave_kernel" in name or "batched_cgs2_kernel" in name}
    # rows 2 and 9: the streamed pass (storage) and the block pass
    # (storage, s = 1..8), the latter summed by storage
    stream = {name: r for name, r in res.items()
              if "gs_stream_kernel" in name}
    bgs = {name: r for name, r in res.items() if "block_gs_kernel" in name}
    # rows 17 and 5: the ELL powers by storage and width bucket; the
    # projections' column sweep by storage, bucket, pieces at once and
    # right-hand columns, and their block-a-row kernel
    redesign6 = {template_name(name): r for name, r in res.items()
                 if "ell_powers_kernel" in name or "gs_partial_" in name}
    # rows 14 and 18: the banded powers and the Chebyshev apply by storage
    # and band count (0: the offsets from shared memory)
    redesign7 = {template_name(name): r for name, r in res.items()
                 if "banded_powers_kernel" in name
                 or "banded_cheb_kernel" in name}

    # row 21: the SSD scan's state and output kernels by storage and
    # column tiles, and the pass between them
    redesign8 = {template_name(name): r for name, r in res.items()
                 if "ssd_state_kernel" in name or "ssd_scan_kernel" in name
                 or "ssd_pass_kernel" in name}

    # rows 12 and 10: the projections by storage, s and M (true: row 12)
    redesign9 = {template_name(name): r for name, r in res.items()
                 if "block_gs_project_gram_kernel" in name}

    def summary(rs):
        return {"registers_max": max(r["registers"] for r in rs),
                "spill_bytes": sum(r["spill_stores"] + r["spill_loads"]
                                   for r in rs),
                "spill_bytes_max": max(r["spill_stores"] + r["spill_loads"]
                                       for r in rs)}
    bgs_summary = {
        f"block_gs_kernel<{t}, S = 1..8>": summary(
            [r for name, r in bgs.items() if tag in name])
        for t, tag in (("float", "block_gs_kernelIf"),
                       ("bf16", "block_gs_kernelI13__nv_bfloat16"))}
    emit(phase="build", seconds=build_s, library=so.name, nvcc=nvcc[-1],
         card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         resources=dict(attn, **redesign4, **stream, **bgs_summary,
                        **redesign6, **redesign7, **redesign8, **redesign9,
                        **{f"sell_kernel ({len(sell)} instantiations)":
                           dict(summary(sell), static_smem_max=max(
                               r["static_smem"] for r in sell))}))
    check(len(redesign4) == 8, f"ilu0_wave_kernel / batched_cgs2_kernel: "
                               f"{len(redesign4)} instantiations")
    check(len(stream) == 2 and len(bgs) == 16,
          f"gs_stream_kernel / block_gs_kernel: {len(stream)} / {len(bgs)} "
          f"instantiations")
    check(sum("ell_powers" in k for k in redesign6) == 8
          and sum("gs_partial_stream" in k for k in redesign6) == 18
          and sum("gs_partial_rows" in k for k in redesign6) == 4,
          f"ell_powers_kernel / gs_partial_*: {sorted(redesign6)}")
    check(sum("banded_powers" in k for k in redesign7) == 10
          and sum("banded_cheb" in k for k in redesign7) == 10,
          f"banded_powers_kernel / banded_cheb_kernel: {sorted(redesign7)}")
    check(len(redesign8) == 9 and all(r["hmma"] > 0
                                      for k, r in redesign8.items()
                                      if "pass" not in k),
          f"ssd_state_kernel / ssd_scan_kernel / ssd_pass_kernel: "
          f"instantiations and HMMA instructions {redesign8}")
    check(len(redesign9) == 32, f"block_gs_project_gram_kernel: "
                                f"{len(redesign9)} instantiations")
    check(len(attn) == 2 and all(r["hgmma"] > 0 for r in attn.values()),
          f"attention_wgmma_kernel: HGMMA instructions {attn}")
    check(len(sell) == 16, f"sell_kernel: {len(sell)} instantiations")

    # ---- 2. kernels vs plain at the main path's shapes ----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {name: [] for name in kernels}
    for dtype in (torch.float32, torch.bfloat16):
        a = (torch.randn(N, N, device="cuda", generator=gen)
             / N ** 0.5).to(dtype)
        # n = 10,003: rows whose starts differ from a 16-byte boundary
        # take the one-row route
        a_odd = (torch.randn(N + 3, N + 3, device="cuda", generator=gen)
                 / N ** 0.5).to(dtype)
        for mat, k in ((a, 1), (a, 4), (a_odd, 1), (a_odd, 4)):
            x = torch.randn(mat.shape[1], k, device="cuda", generator=gen)
            routes = dict(matvec.block_matvec.routes)
            y = matvec.block_matvec(mat, x)
            yp = matvec.block_matvec_plain(mat, x)
            torch.cuda.synchronize()
            rel = relerr(y, yp)
            route = [r for r, c in matvec.block_matvec.routes.items()
                     if c != routes[r]]
            errs["block_matvec"].append(abserr(y, yp))
            emit(phase="kernels", kernel="block_matvec", n=mat.shape[1],
                 k=k, dtype=str(dtype), route=route, max_rel_err=rel)
            check(rel < TOLS[dtype], f"block_matvec n={mat.shape[1]} k={k} "
                                     f"{dtype}: {rel}")
            check(torch.equal(matvec.block_matvec(mat, x), y),
                  f"block_matvec n={mat.shape[1]} k={k}: other bits on a "
                  f"second call")
            want = tuning.gemv_rows_shape(
                mat.shape[0], mat.shape[1], k, mat.element_size(),
                tuning.sm_count(mat.device))["route"]
            check(route == [want] and (want == "rows") == (mat is a),
                  f"block_matvec n={mat.shape[1]} k={k}: route {route}")
        del a_odd
        for j in (0, 15, 29):
            v = basis(N, M + 1, j, dtype, gen)
            w = torch.randn(N, device="cuda", generator=gen)
            for name, got, want in (
                    ("gs_project", cgs2.gs_project(v, w, j),
                     cgs2.gs_project_plain(v, w, j)),
                    ("arnoldi_step", arnoldi_fused.arnoldi_step(a, v, j),
                     arnoldi_fused.arnoldi_step_plain(a, v, j))):
                torch.cuda.synchronize()
                rel = max(relerr(got[0], want[0]), relerr(got[1], want[1]))
                errs[name].append(max(abserr(got[0], want[0]),
                                      abserr(got[1], want[1])))
                emit(phase="kernels", kernel=name, n=N, m1=M + 1, j=j,
                     dtype=str(dtype), max_rel_err=rel)
                check(rel < TOLS[dtype], f"{name} j={j} {dtype}: {rel}")
        del a

    # ---- 3. the main path -------------------------------------------------
    def relres(a, x, b) -> float:
        r = torch.mv(a.double(), x.double()) - b.double()
        return float(r.norm() / b.double().norm())

    for fn in kernels.values():
        fn.launches = 0
    solves = {}
    for dominance in (2.0, 0.015):
        a = operators.random_diagdom(N, dominance=dominance, seed=0)
        b = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                             .astype(np.float32)).cuda()
        op = operators.DenseOperator(a, backend="cuda")
        xs = {}
        for gs in SCHEMES:
            before = {k: fn.launches for k, fn in kernels.items()}
            t0 = time.perf_counter()
            res = gmres(op, b, m=M, tol=TOL, max_restarts=MAX_RESTARTS,
                        gs=gs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            d = {k: fn.launches - before[k] for k, fn in kernels.items()}
            rr = relres(a, res.x, b)
            emit(phase="solve", dominance=dominance, gs=gs, n=N,
                 converged=res.converged, restarts=res.restarts,
                 inner_steps=res.inner_steps, true_relres=rr, wall_s=wall,
                 launches=d)
            check(res.converged,
                  f"{gs} dominance {dominance} did not converge")
            check(rr <= 2 * TOL, f"{gs}: true relres {rr} > {2 * TOL}")
            check(bool(torch.isfinite(res.x).all()) and res.x.shape == (N,),
                  f"{gs}: x not finite or wrong shape")
            matvecs = res.restarts + 1            # true residuals
            expect = {"cgs2": {"block_matvec": res.inner_steps + matvecs},
                      "cgs2_fused": {"block_matvec": res.inner_steps + matvecs,
                                     "gs_project": 2 * res.inner_steps},
                      "fused": {"block_matvec": matvecs,
                                "arnoldi_step": res.inner_steps}}[gs]
            for k in kernels:
                check(d[k] == expect.get(k, 0),
                      f"{gs}: {k} launched {d[k]}, expected "
                      f"{expect.get(k, 0)}")
            xs[gs] = res
            solves[(dominance, gs)] = res
        for gs in SCHEMES[1:]:
            check(abs(xs[gs].restarts - xs["cgs2"].restarts) <= 1,
                  f"restarts differ: {gs} {xs[gs].restarts} vs cgs2 "
                  f"{xs['cgs2'].restarts}")
            diff = float((xs[gs].x - xs["cgs2"].x).norm()
                         / xs["cgs2"].x.norm())
            check(diff <= 1e-3, f"{gs} x differs from cgs2 by {diff}")
        del a, op
    launches = {k: fn.launches for k, fn in kernels.items()}
    for k, count in launches.items():
        check(count > 0, f"{k} was never launched on the main path")
    emit(phase="solve", launches_total=launches)

    # a small system on the card against the same solve on the CPU
    a_s = operators.random_diagdom(400, dominance=0.3, seed=1, device="cpu")
    b_s = torch.from_numpy(np.random.default_rng(2).standard_normal(400)
                           .astype(np.float32))
    for gs in SCHEMES:
        ref = gmres(operators.DenseOperator(a_s, device="cpu"), b_s, m=20,
                    gs=gs)
        res = gmres(operators.DenseOperator(a_s, backend="cuda"),
                    b_s.cuda(), m=20, gs=gs)
        err = abserr(res.x.cpu(), ref.x)
        emit(phase="solve", reference="cpu", n=400, gs=gs,
             restarts=[res.restarts, ref.restarts], max_abs_err=err)
        check(res.converged and abs(res.restarts - ref.restarts) <= 1
              and torch.allclose(res.x.cpu(), ref.x, rtol=1e-4, atol=1e-5),
              f"{gs}: card and CPU disagree on the small system ({err})")

    # ---- 4. the paper's strategies ------------------------------------------
    # the paper's sizes on the dominance-2.0 system (3 steps at n = 10,000),
    # and n = 10,000 on the system that runs whole cycles (59 steps)
    for n, dominance in ((CONFIG.sizes[0], 2.0), (CONFIG.sizes[3], 2.0),
                         (N, 2.0), (N, 0.015)):
        a = operators.random_diagdom(n, dominance=dominance, seed=0,
                                     device="cpu").numpy()
        b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        row = {"phase": "strategies", "n": n, "dominance": dominance}
        t0 = time.perf_counter()
        x_ref, _, _, conv, inner = strategies.serial_numpy(a, b, m=M, tol=TOL)
        row["serial_numpy_s"] = base = time.perf_counter() - t0
        row["inner_steps"] = inner
        check(conv, f"serial_numpy n={n} dominance {dominance} did not "
                    f"converge")
        runs = [(name, strategies.STRATEGIES[name], {})
                for name in CONFIG.strategies[1:]]
        runs.append(("device_resident_fused", strategies.device_resident,
                     {"gs": "fused", "backend": "cuda"}))
        runs.append(("device_resident_sstep",
                     strategies.device_resident_sstep,
                     {"s": SSTEP_S, "backend": "cuda"}))
        for name, fn, kw in runs:
            fn(a, b, m=M, tol=TOL, **kw)          # warm: first-call costs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(a, b, m=M, tol=TOL, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            x = out.x.cpu().numpy() if hasattr(out, "x") else out[0]
            check(np.allclose(x, x_ref, rtol=2e-2, atol=1e-3),
                  f"strategy {name} n={n} disagrees with serial_numpy")
            row[f"{name}_s"] = t
            row[f"{name}_speedup"] = base / t
        emit(**row)

    # ---- 5. timing ---------------------------------------------------------
    def flush_counters():
        for fn in kernels.values():
            fn.launches = 0

    j = 15
    timing = {}
    per_solve = {"block_matvec": solves[(0.015, "cgs2")],
                 "gs_project": solves[(0.015, "cgs2_fused")],
                 "arnoldi_step": solves[(0.015, "fused")]}
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        a = (torch.randn(N, N, device="cuda", generator=gen)
             / N ** 0.5).to(dtype)
        x = torch.randn(N, 1, device="cuda", generator=gen)
        v = basis(N, M + 1, j, dtype, gen)
        w = torch.randn(N, device="cuda", generator=gen)
        vj1 = v[: j + 1].float()
        rows = {
            "block_matvec": dict(
                **timed(lambda: matvec.block_matvec(a, x)),
                plain_ms=timed(lambda: matvec.block_matvec_plain(a, x))["ms"],
                library_ms=timed(lambda: torch.mv(a, x[:, 0].to(dtype)))["ms"],
                library="torch.mv",
                bytes=N * N * size + N * 4 + N * 4, flops=2 * N * N),
            "gs_project": dict(
                **timed(lambda: cgs2.gs_project(v, w, j)),
                plain_ms=timed(lambda: cgs2.gs_project_plain(v, w, j))["ms"],
                library_ms=None, library=None,
                composite_ms=timed(lambda: w - (vj1 @ w) @ vj1)["ms"],
                shape=cgs2.launch_shape(dtype, M + 1, N),
                bytes=(j + 1) * N * size + 2 * N * 4 + (M + 1) * 4,
                flops=4 * (j + 1) * N),
            "arnoldi_step": dict(
                **timed(lambda: arnoldi_fused.arnoldi_step(a, v, j)),
                plain_ms=timed(
                    lambda: arnoldi_fused.arnoldi_step_plain(a, v, j))["ms"],
                library_ms=None, library=None,
                shape=arnoldi_fused.launch_shape(dtype, dtype, M + 1, N),
                bytes=N * N * size + (j + 1) * N * size + N * 4
                + (M + 1) * 4,
                flops=2 * N * N + 8 * (j + 1) * N),
        }

        def composite():
            wv = torch.mv(a, v[j])
            vv = v[: j + 1]
            h1 = vv @ wv
            w1 = wv - h1 @ vv
            h2 = vv @ w1
            return h1 + h2, w1 - h2 @ vv
        rows["arnoldi_step"]["composite_ms"] = timed(composite)["ms"]
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"])
            res = per_solve[name]
            r["launches_per_solve"] = {
                "block_matvec": res.inner_steps + res.restarts + 1,
                "gs_project": 2 * res.inner_steps,
                "arnoldi_step": res.inner_steps}[name]
            emit(phase="timing", kernel=name, dtype=str(dtype), n=N,
                 m1=M + 1, j=j, card=smi, **r)
            if dtype == torch.float32:
                timing[name] = r
        if dtype == torch.float32:
            # blocks per SM of the cooperative kernels (tuning.py's choice)
            for attr, name, fn, shape in (
                    ("GS_BLOCKS_PER_SM", "gs_project",
                     lambda: cgs2.gs_project(v, w, j),
                     lambda: cgs2.launch_shape(dtype, M + 1, N)),
                    ("FUSED_BLOCKS_PER_SM", "arnoldi_step",
                     lambda: arnoldi_fused.arnoldi_step(a, v, j),
                     lambda: arnoldi_fused.launch_shape(dtype, dtype, M + 1,
                                                        N))):
                chosen = getattr(tuning, attr)
                want = {"gs_project": cgs2.gs_project_plain(v, w, j),
                        "arnoldi_step": arnoldi_fused.arnoldi_step_plain(
                            a, v, j)}[name]
                for bps in (1, 2, 4, 8):
                    setattr(tuning, attr, bps)
                    got = fn()
                    rel = max(relerr(got[0], want[0]),
                              relerr(got[1], want[1]))
                    check(rel < TOLS[dtype], f"{name} at {bps} blocks/SM: "
                                             f"{rel}")
                    emit(phase="tuning", kernel=name, blocks_per_sm=bps,
                         chosen=bps == chosen, shape=shape(), max_rel_err=rel,
                         **timed(fn), card=smi)
                setattr(tuning, attr, chosen)
            # gs_project's streamed kernel at this shape (its plan,
            # launched directly): does the shared-memory pass earn its own
            # path at n = 10,000?
            want = cgs2.gs_project_plain(v, w, j)
            plan = tuning.gs_stream_plan(M + 1, N, j, size, True,
                                         cgs2.stream_capacity(v))
            got = cgs2._launch_stream(v, w, j, 1, plan)
            rel = max(relerr(got[0], want[0]), relerr(got[1], want[1]))
            check(rel < TOLS[dtype], f"streamed gs_project at n = {N}: "
                                     f"{rel}")
            emit(phase="tuning", kernel="gs_project", variant="streamed",
                 chosen=False, plan=plan, max_rel_err=rel,
                 **timed(lambda: cgs2._launch_stream(v, w, j, 1, plan)),
                 card=smi)
        del a
    flush_counters()

    # host cost per Arnoldi step: the fused solve, wall clock vs device time
    baseline = {}
    a = operators.random_diagdom(N, dominance=0.015, seed=0)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                         .astype(np.float32)).cuda()
    op = operators.DenseOperator(a, backend="cuda")
    for gs in SCHEMES:
        gmres(op, b, m=M, tol=TOL, gs=gs)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gmres(op, b, m=M, tol=TOL, gs=gs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gmres(op, b, m=M, tol=TOL, gs=gs)
            torch.cuda.synchronize()
        dev_ms = device_ms(prof)
        steps = res.inner_steps
        row = dict(solve=gs, dominance=0.015, n=N, restarts=res.restarts,
                   steps=steps, wall_ms=wall_ms,
                   wall_ms_per_step=wall_ms / steps,
                   device_ms=dev_ms if dev_ms > 0 else None,
                   device_ms_per_step=dev_ms / steps if dev_ms > 0 else None,
                   host_overhead_ms_per_step=(wall_ms - dev_ms) / steps
                   if dev_ms > 0 else None,
                   device_idle_share=1 - dev_ms / wall_ms
                   if dev_ms > 0 else None)
        emit(phase="timing", **row, card=smi)
        if gs == "fused":
            baseline["dense fused"] = row
    flush_counters()

    # ---- 6-9. the sparse slice -------------------------------------------
    s_errs, s_launches, s_timing, sparse_restarts, banded_fused, \
        sparse_solves = sparse_phases(smi, gen)
    baseline["banded cgs2_fused"] = banded_fused
    for name, e in s_errs.items():
        errs.setdefault(name, []).extend(e)
    launches.update(s_launches)
    timing.update(s_timing)

    # ---- 10-12. the s-step slice -----------------------------------------
    s_errs, s_launches, s_timing, sstep_solves = sstep_phases(
        smi, gen, solves[(0.015, "cgs2")].restarts, sparse_restarts,
        baseline)
    errs.update(s_errs)
    launches.update(s_launches)
    timing.update(s_timing)

    # ---- 13-15. the pipelined slice --------------------------------------
    p_errs, p_launches, p_timing = pipelined_phases(
        smi, gen, solves[(0.015, "cgs2_fused")], sparse_solves, sstep_solves)
    errs.update(p_errs)
    launches.update(p_launches)
    timing.update(p_timing)

    # ---- 16-18. the preconditioning slice ---------------------------------
    c_errs, c_launches, c_timing = precond_phases(smi, gen, sparse_solves)
    errs.update(c_errs)
    launches.update(c_launches)
    timing.update(c_timing)

    # ---- 19-21. the row-sharded slice (one-rank NCCL group) ---------------
    d_errs, d_launches, d_timing = sharded_phases(
        smi, gen, solves[(0.015, "cgs2_fused")], sparse_solves, sstep_solves)
    errs.update(d_errs)
    launches.update(d_launches)
    timing.update(d_timing)

    # ---- 22-24. the model slice: zamba2-7b serving ------------------------
    m_errs, m_launches, m_timing = model_phases(smi)
    errs.update(m_errs)
    launches.update(m_launches)
    timing.update(m_timing)

    sources = {"block_matvec": ("src/repro_torch/csrc/matvec.cu",
                                "src/repro/kernels/matvec.py:80"),
               "gs_project": ("src/repro_torch/csrc/cgs2.cu",
                              "src/repro/kernels/cgs2.py:116"),
               "cgs2": ("src/repro_torch/csrc/cgs2.cu",
                        "src/repro/kernels/cgs2.py:116"),
               "arnoldi_step": ("src/repro_torch/csrc/arnoldi_fused.cu",
                                "src/repro/kernels/arnoldi_fused.py:123"),
               "ell_matvec": ("src/repro_torch/csrc/spmv.cu",
                              "src/repro/kernels/spmv.py:138"),
               "sell_matvec": ("src/repro_torch/csrc/spmv.cu",
                               "src/repro/kernels/spmv.py:138"),
               "banded_matvec": ("src/repro_torch/csrc/spmv.cu",
                                 "src/repro/kernels/spmv.py:286"),
               "batched_cgs2": ("src/repro_torch/csrc/batched_cgs2.cu",
                                "src/repro/kernels/block_gs.py:456"),
               "block_gs_pass": ("src/repro_torch/csrc/block_gs.cu",
                                 "src/repro/kernels/block_gs.py:125"),
               "banded_powers": ("src/repro_torch/csrc/matrix_powers.cu",
                                 "src/repro/kernels/matrix_powers.py:166"),
               "dense_powers": ("src/repro_torch/csrc/matrix_powers.cu",
                                "src/repro/kernels/matrix_powers.py:351"),
               "ell_powers": ("src/repro_torch/csrc/matrix_powers.cu",
                              "src/repro/kernels/matrix_powers.py:439"),
               "gs_project_norm_partial": (
                   "src/repro_torch/csrc/sr_payload.cu",
                   "src/repro/kernels/cgs2.py:257"),
               "gs_update": ("src/repro_torch/csrc/sr_payload.cu",
                             "src/repro/kernels/cgs2.py:291"),
               "block_gs_project_gram": ("src/repro_torch/csrc/block_gs.cu",
                                         "src/repro/kernels/block_gs.py:334"),
               "block_gs_update": ("src/repro_torch/csrc/block_gs.cu",
                                   "src/repro/kernels/block_gs.py:259"),
               "banded_cheb_apply": ("src/repro_torch/csrc/matrix_powers.cu",
                                     "src/repro/kernels/matrix_powers.py:518"),
               "banded_trisweep": ("src/repro_torch/csrc/trisolve.cu",
                                   "src/repro/kernels/trisolve.py:257"),
               "ilu0_factor": ("src/repro_torch/csrc/trisolve.cu",
                               "src/repro/kernels/trisolve.py:82"),
               "gs_project_partial": ("src/repro_torch/csrc/sr_payload.cu",
                                      "src/repro/kernels/cgs2.py:194"),
               "block_gs_project": ("src/repro_torch/csrc/block_gs.cu",
                                    "src/repro/kernels/block_gs.py:216"),
               "banded_powers_halo": (
                   "src/repro_torch/csrc/matrix_powers.cu",
                   "src/repro/kernels/matrix_powers.py:253"),
               "banded_matvec_halo": ("src/repro_torch/csrc/spmv.cu",
                                      "src/repro/kernels/spmv.py:286"),
               "ell_matvec_halo": ("src/repro_torch/csrc/spmv.cu",
                                   "src/repro/kernels/spmv.py:138"),
               "attention": ("src/repro_torch/csrc/attention_sm90.cu",
                             "src/repro/kernels/attention.py:139"),
               "ssd_scan": ("src/repro_torch/csrc/ssd.cu",
                            "src/repro/kernels/ssd.py:86"),
               "gated_rmsnorm": ("src/repro_torch/csrc/gated_norm.cu",
                                 "src/repro/kernels/gated_norm.py:51")}
    emit(kernels=[{
        "name": name, "route": "cuda", "source": sources[name][0],
        "replaces": sources[name][1], "launches": launches[name],
        "max_abs_err": max(errs[name]),
        "ms": timing[name]["ms"] or timing[name]["event_ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
        **({"ms_by_kernel": timing[name]["ms_by_kernel"],
            "sources": ["src/repro_torch/csrc/attention_sm90.cu",
                        "src/repro_torch/csrc/attention.cu"]}
           if "ms_by_kernel" in timing[name] else {}),
        **({"kernels": timing[name]["kernels"]}
           if "kernels" in timing[name] else {})}
        for name in sources])
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


CELL_GROUPS = ("redesign1", "gemv", "redesign3", "redesign4", "redesign5",
               "redesign6", "redesign7", "redesign8", "redesign9")
# a tuning sweep, run only when named: ``--in-turn DIR redesign3_sweep``
SWEEP_GROUPS = ("redesign3_sweep",)


def measure_cells(label: str, groups=CELL_GROUPS) -> None:
    """The redesigned kernels' rows and the cells they serve, on whichever
    ``repro_torch`` this process imported (``in_turn``), by group:
    ``redesign1`` (kernel-table rows 7 and 20, ``redesign1_cells``),
    ``gemv`` (rows 4 and 6, ``gemv_cells``), ``redesign3`` (rows 1 and
    19, ``redesign3_cells``) and so on to ``redesign9`` (rows 12 and 10
    and the s-step solves, ``redesign9_cells``); the ``redesign3_sweep``
    group, on a tree
    that has the launch helpers it times, emits ``tuning`` lines of its
    own.  One JSON line."""
    from repro_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device is available")
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    warnings.filterwarnings("ignore", message="Sparse")
    _build.build()
    out = {"tree": label, "package": str(pathlib.Path(_build.__file__)
                                          .parents[2]),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}
    if "gemv" in groups:
        out.update(gemv_cells(label))
    if "redesign1" in groups:
        out.update(redesign1_cells(label))
    if "redesign3" in groups:
        out.update(redesign3_cells(label))
    if "redesign4" in groups:
        out.update(redesign4_cells(label))
    if "redesign5" in groups:
        out.update(redesign5_cells(label))
    if "redesign6" in groups:
        out.update(redesign6_cells(label))
    if "redesign7" in groups:
        out.update(redesign7_cells(label))
    if "redesign8" in groups:
        out.update(redesign8_cells(label))
    if "redesign9" in groups:
        out.update(redesign9_cells(label))
    if "redesign3_sweep" in groups:
        from repro_torch.kernels import trisolve

        if hasattr(trisolve, "chain_probe"):
            redesign3_sweep(label)
    emit(phase="in_turn", **out)


def redesign1_cells(label: str) -> dict:
    """Kernel-table rows 7 and 20 and their cells: the sliced-ELL product
    on the PageRank operator (k = 1, 8; and through the operator, k = 8)
    and the 1024^2 stencil, cold and warm, beside cuSPARSE; the PageRank
    burst per lockstep step; bf16 attention at zamba2's prefill shape
    beside SDPA; the zamba2-7b prefill (b = 2, S = 512)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core import gmres_batched, graphs, stencils
    from repro_torch.kernels import block_gs, spmv
    from repro_torch.kernels import attention as attention_k
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import build

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    pr, make_rhs = graphs.pagerank_system(PAGERANK_N, seed=0, fmt="sell")
    st = stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt="sell")
    x1 = torch.randn(PAGERANK_N, 1, device="cuda", generator=gen)
    x8 = torch.randn(PAGERANK_N, PAGERANK_K, device="cuda", generator=gen)
    xn = torch.randn(NX * NX, 1, device="cuda", generator=gen)
    for name, fn in (
            ("sell_matvec pagerank k=1",
             lambda: spmv.sell_matvec(pr.bin_values, pr.bin_cols, x1)),
            ("sell_matvec pagerank k=8",
             lambda: spmv.sell_matvec(pr.bin_values, pr.bin_cols, x8)),
            ("sell_matvec stencil k=1",
             lambda: spmv.sell_matvec(st.bin_values, st.bin_cols, xn)),
            ("pagerank operator k=8", lambda: pr(x8))):
        t = timed(fn, cold=True)
        out[name] = dict(t, warm_ms=timed(fn)["ms"])
    lib = csr_of(*pr.to_ell_arrays())
    out["cusparse pagerank k=1"] = cold_ms(lambda: torch.mv(lib, x1[:, 0]))
    out["cusparse pagerank k=8"] = cold_ms(lambda: torch.sparse.mm(lib, x8))
    pv = np.random.default_rng(0).random((PAGERANK_K, PAGERANK_N))
    b_pr = torch.stack([make_rhs(v) for v in pv])
    tols = np.array([PAGERANK_TOLS[i % len(PAGERANK_TOLS)]
                     for i in range(PAGERANK_K)], np.float32)
    block_gs.batched_cgs2.launches = 0
    res = gmres_batched(pr, b_pr, m=M, tol=tols, max_restarts=100)
    out["burst"] = solve_timing(
        lambda: gmres_batched(pr, b_pr, m=M, tol=tols, max_restarts=100),
        block_gs.batched_cgs2.launches, phase="in_turn",
        solve="pagerank burst (per lockstep step)", tree=label,
        restarts=res.restarts.tolist())
    del pr, st, lib
    q, k, v = (torch.randn(ZAMBA_BATCH, ZAMBA_PROMPT, 32, 112, device="cuda",
                           generator=gen).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    t = timed(lambda: attention_k.attention(q, k, v), iters=20, cold=True)
    out["attention bf16"] = dict(t, warm_ms=timed(
        lambda: attention_k.attention(q, k, v), iters=20)["ms"])
    out["sdpa"] = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=20)
    del q, k, v
    cfg = configs.get("zamba2-7b")
    params = build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    batch = {"tokens": np.random.default_rng(0).integers(
        2, cfg.vocab_size, (ZAMBA_BATCH, ZAMBA_PROMPT)).astype(np.int32)}
    prefill = make_prefill_step(cfg)
    prefill(params, batch)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    by = kernel_ms(prof)
    out["prefill"] = {"walls_ms": walls, "device_ms": sum(by.values()),
                      "attention_ms": sum(ms for key, ms in by.items()
                                          if kernel_class(key)
                                          == "attention")}
    return out


def clean_cold_ms(fn, iters=50):
    """Device ms of one call after a read-only pass over FLUSH_BYTES (an
    ``amax``): the L2 then holds clean lines of another buffer, where
    ``timed(cold=True)``'s rewrite leaves it full of dirty lines that the
    call's reads must first write back.  None where the profile does not
    show one flush kernel per call."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush.amax()
        torch.cuda.synchronize()
    keys = set(kernel_ms(prof))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.amax()
            fn()
        torch.cuda.synchronize()
    flushes = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key in keys)
    if flushes != iters * len(keys):
        return None
    return sum(ms for key, ms in kernel_ms(prof).items()
               if key not in keys) / iters


def gemv_cells(label: str) -> dict:
    """Kernel-table rows 4 (``gs_project_partial``) and 6 (``gs_update``)
    and the solves they serve.  Both at n = 2^20 and 10^4, 16 rows, f32
    and bf16 storage, cold (by kernel too) and warm, beside their bound and
    ``torch.mv`` / ``torch.addmv`` on V's type; the SHA-256 of ``gs_update``'s
    output bytes for seeded inputs (equal across trees: the same bits);
    the banded 1024^2 ``cgs2_pipelined`` solve and the one-rank sharded
    banded ``cgs2_fused`` solve over TIMING_RESTARTS cycles (wall, device
    ms and idle share per step, the SHA-256 of x).  Cold is timed both
    ways: after ``timed``'s rewrite of FLUSH_BYTES (dirty L2) and after a
    read of it (``clean_cold_ms``).  Where the tree has the streaming
    pair's shape rule, the shapes it chose among are timed too
    (``gemv_shape_sweep``)."""
    import hashlib
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import gmres, gmres_sharded, stencils
    from repro_torch.kernels import cgs2

    def sha(t):
        return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()

    out = {}
    m1 = M + 1
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.empty((), dtype=dtype).element_size()
        f32 = dtype == torch.float32
        for nb, j in ((NX * NX, PIPE_J[1]), (N, PIPE_J[1]),
                      (NX * NX, PIPE_J[2])):
            gen = torch.Generator(device="cuda").manual_seed(nb + j)
            v = basis(nb, m1, j, dtype, gen)
            vp = v[:j + 1]
            w = torch.randn(nb, device="cuda", generator=gen)
            h = torch.randn(j + 1, device="cuda", generator=gen)
            # the library calls on V's type (w and h rounded to bf16 for
            # bf16 V: cuBLAS takes one type)
            wl, hl = w.to(dtype), h.to(dtype)
            cells = {
                "gs_project_partial": (
                    lambda: cgs2.gs_project_partial(v, w, j),
                    lambda: torch.mv(vp, wl), "torch.mv(V[:j+1], w)",
                    ((j + 1) * sz + 4) * nb),
                "gs_update": (
                    lambda: cgs2.gs_update(vp, w, h),
                    lambda: torch.addmv(wl, vp.T, hl, alpha=-1),
                    "torch.addmv(w, V[:j+1].T, h, alpha=-1)",
                    ((j + 1) * sz + 8) * nb)}
            for name, (fn, lib, lib_name, nbytes) in cells.items():
                row = {"cold": timed(fn, cold=True), "warm": timed(fn),
                       "clean_cold_ms": clean_cold_ms(fn),
                       "bytes": nbytes, "flops": 2 * (j + 1) * nb}
                row["cold_by_kernel"] = row["cold"]["by_kernel"]
                row.update(library=lib_name + ("" if f32 else " (bf16)"),
                           library_cold=timed(lib, cold=True),
                           library_clean_cold_ms=clean_cold_ms(lib),
                           library_warm=timed(lib))
                row["bound_ms"], row["bound_by"] = bound(nbytes,
                                                         row["flops"])
                out[f"{name} {str(dtype)[6:]} n={nb} rows={j + 1}"] = row
            del v, vp
    hashes = {}
    for dtype in (torch.float32, torch.bfloat16):
        for nb, rows in ((NX * NX, 16), (N, 31), (N + 3, 16)):
            gen = torch.Generator(device="cuda").manual_seed(19)
            v = (torch.randn(rows, nb, device="cuda", generator=gen)
                 / nb ** 0.5).to(dtype)
            w = torch.randn(nb, device="cuda", generator=gen)
            h = torch.randn(rows, device="cuda", generator=gen)
            hashes[f"{str(dtype)[6:]} n={nb} rows={rows}"] = sha(
                cgs2.gs_update(v, w, h))
    out["gs_update sha256"] = hashes

    if hasattr(cgs2, "_launch_gs_update"):
        gemv_shape_sweep(label)

    n = NX * NX
    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt="banded")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()

    def pipelined():
        return gmres(op, b, m=M, tol=TOL, max_restarts=TIMING_RESTARTS,
                     gs="cgs2_pipelined")
    res = pipelined()
    out["banded cgs2_pipelined"] = dict(solve_timing(
        pipelined, res.inner_steps, phase="in_turn",
        solve="banded cgs2_pipelined", tree=label,
        restarts=TIMING_RESTARTS), x_sha256=sha(res.x))
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/pg",
                            rank=0, world_size=1)
    try:
        def sharded():
            return gmres_sharded(dist.group.WORLD, op, b, m=M, tol=TOL,
                                 max_restarts=TIMING_RESTARTS,
                                 gs="cgs2_fused")
        res = sharded()
        out["sharded banded cgs2_fused"] = dict(solve_timing(
            sharded, res.inner_steps, phase="in_turn",
            solve="sharded banded cgs2_fused (one rank)", tree=label,
            restarts=TIMING_RESTARTS), x_sha256=sha(res.x))
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return out


def gemv_shape_sweep(label: str) -> None:
    """The launch shapes of the streaming GEMV pair that
    ``tuning.gemv_stream_shape`` and ``gemv_partial_shape`` choose among,
    each launched through the wrappers' launch helpers (so no ``.launches``
    count) at 16 rows unless said: the grid cap at n = 2^20 (0: none, a
    thread a 16-byte piece in waves; 1, 2 or 4 blocks an SM, two pieces at
    once where a thread owns more than one), also at 30 rows; the block
    size at n = 10^4 (warm: the call is a launch and a round trip); the
    projection's block a row against its capped grid at n = 10^4 to 2^17.
    Each shape is held to the rule's bits for the update and to the plain
    version for the projection.  One ``tuning`` line a shape."""
    from repro_torch.kernels import cgs2, tuning

    sms = tuning.sm_count(torch.device("cuda"))

    def capped(plan, cap, threads=None):
        t = threads or plan["threads"]
        items = max(plan["pieces"], plan["tail"])
        blocks = max(1, -(-items // t))
        if cap:
            blocks = min(blocks, cap * sms)
        return dict(plan, threads=t, blocks=blocks,
                    unroll=2 if items > blocks * t else 1)

    gen = torch.Generator(device="cuda").manual_seed(1)
    m1 = M + 1
    for dtype in (torch.float32, torch.bfloat16):
        for nb, j, cold, what in (
                (NX * NX, PIPE_J[1], True, "cap"),
                (NX * NX, PIPE_J[2], True, "cap"),
                (N, PIPE_J[1], False, "threads"),
                (N, PIPE_J[1], True, "by_row"),
                (1 << 15, PIPE_J[1], True, "by_row"),
                (1 << 17, PIPE_J[1], True, "by_row")):
            v = basis(nb, m1, j, dtype, gen)
            vp = v[:j + 1]
            w = torch.randn(nb, device="cuda", generator=gen)
            h = torch.randn(j + 1, device="cuda", generator=gen)
            base = cgs2.stream_plan(v, w, j + 1)
            chosen = {"update": base,
                      "partial": tuning.gemv_partial_shape(base, j + 1)}
            if what == "cap":
                shapes = [(f"cap={c}", {"update": capped(base, c),
                                        "partial": dict(capped(base, c),
                                                        by_row=0)})
                          for c in (0, 1, 2, 4)]
            elif what == "threads":
                shapes = [(f"threads={t}", {"update": capped(base, 1, t)})
                          for t in (32, 64, 128, 256)]
            else:
                shapes = [("by_row=1", {"partial": dict(
                              base, by_row=1, threads=0, blocks=j + 1,
                              unroll=1)}),
                          ("by_row=0", {"partial": dict(capped(base, 1),
                                                        by_row=0)})]
            want_u = cgs2.gs_update(vp, w, h)
            want_p = cgs2.gs_project_partial_plain(v, w, j)
            for name, plans in shapes:
                row = dict(phase="tuning", tree=label, shape=name,
                           dtype=str(dtype), n=nb, rows=j + 1, cold=cold)
                if "update" in plans:
                    plan = plans["update"]

                    def upd(plan=plan):
                        return cgs2._launch_gs_update(vp, w, h, plan)
                    check(torch.equal(upd(), want_u),
                          f"gs_update {name} n={nb}: other bits")
                    row.update(gs_update_ms=timed(upd, cold=cold),
                               gs_update_chosen=plan == chosen["update"])
                if "partial" in plans:
                    plan = plans["partial"]

                    def part(plan=plan):
                        return cgs2._launch_gs_project_partial(v, w, j,
                                                               plan)
                    rel = relerr(part(), want_p)
                    check(rel < TOLS[dtype],
                          f"gs_project_partial {name} n={nb}: {rel}")
                    row.update(gs_project_partial_ms=timed(part, cold=cold),
                               partial_rel_err=rel,
                               partial_chosen=plan == chosen["partial"])
                emit(**row)
            del v, vp


def redesign3_cells(label: str) -> dict:
    """Kernel-table rows 1 (``block_matvec``) and 19 (``banded_trisweep``)
    and the cells they serve.  Row 1 at n = 10,000, k = 1 and 4, f32 and
    bf16 storage, cold and warm, beside ``torch.mv`` / ``torch.mm`` (on
    A's type: x rounded to bf16 for bf16 A); row 19 on the ILU(0) and
    line-Jacobi L and U factors of the 1024^2 stencil, k = 1 and 4, cold,
    with the route each call took and the SHA-256 of its output; the chunk
    route's chain floor (``trisolve.chain_probe``, where the tree has it);
    the dense n = 10,000 ``cgs2_fused`` solve over TIMING_RESTARTS cycles;
    the ILU(0) and line-Jacobi ``gmres(gs="cgs2_fused")`` solves to
    convergence (restarts, time to solution, device ms per step, idle
    share), their x saved for ``in_turn``'s comparison."""
    import hashlib

    from repro_torch.core import gmres, operators, stencils
    from repro_torch.core import preconditioners as P
    from repro_torch.kernels import matvec, trisolve

    def sha(t):
        return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()

    def routes_of(fn):
        return dict(getattr(fn, "routes", {}))

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(20)
    for dtype in (torch.float32, torch.bfloat16):
        sz = torch.empty((), dtype=dtype).element_size()
        a = (torch.randn(N, N, device="cuda", generator=gen)
             / N ** 0.5).to(dtype)
        for k in (1, 4):
            x = torch.randn(N, k, device="cuda", generator=gen)
            xl = x.to(dtype)

            def fn(a=a, x=x):
                return matvec.block_matvec(a, x)

            def lib(a=a, xl=xl, k=k):
                return torch.mv(a, xl[:, 0]) if k == 1 else torch.mm(a, xl)
            before = routes_of(matvec.block_matvec)
            fn()
            row = {"cold": timed(fn, cold=True), "warm": timed(fn),
                   "route": [r for r, c in routes_of(
                       matvec.block_matvec).items() if c != before.get(r)],
                   "library": "torch.mv" if k == 1 else "torch.mm",
                   "library_cold": timed(lib, cold=True),
                   "library_warm": timed(lib),
                   "bytes": N * N * sz + 8 * N * k, "flops": 2 * N * N * k}
            row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                     row["flops"])
            out[f"block_matvec {str(dtype)[6:]} n={N} k={k}"] = row
        del a

    n = NX * NX
    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    t0 = time.perf_counter()
    ilu = P.make_preconditioner("banded_ilu0", op)
    torch.cuda.synchronize()
    ilu_setup = time.perf_counter() - t0
    lj = P.make_preconditioner("line_jacobi", op)
    sweeps = (("ILU(0) L", ilu.l_bands, ilu.l_offsets, True, True),
              ("ILU(0) U", ilu.u_bands, ilu.u_offsets, False, False),
              ("line-Jacobi L", lj.l_bands, lj.l_offsets, True, True),
              ("line-Jacobi U", lj.u_bands, lj.u_offsets, False, False))
    shas = {}
    for name, bands, offs, unit, lower in sweeps:
        for k in (1, 4):
            v = torch.randn(k, n, device="cuda", generator=gen)
            v = v[0] if k == 1 else v

            def fn(bands=bands, v=v, offs=offs, unit=unit, lower=lower):
                return trisolve.banded_trisweep(bands, v, offs,
                                                unit_diag=unit, lower=lower)
            before = routes_of(trisolve.banded_trisweep)
            z = fn()
            shas[f"{name} k={k}"] = sha(z)
            row = {"cold": timed(fn, iters=20, cold=True),
                   "route": [r for r, c in routes_of(
                       trisolve.banded_trisweep).items()
                       if c != before.get(r)],
                   "bytes": bands.shape[0] * n * bands.element_size()
                   + 8 * n * k, "flops": (2 * bands.shape[0] + 2) * n * k}
            row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                     row["flops"])
            if hasattr(trisolve, "chain_probe") and k == 1 \
                    and "ILU" in name:
                t = timed(lambda offs=offs, unit=unit, lower=lower:
                          trisolve.chain_probe(offs, n, unit_diag=unit,
                                               lower=lower))
                row["chain_floor_ms"] = t["ms"] or t["event_ms"]
            out[f"banded_trisweep {name} k={k}"] = row
    out["banded_trisweep sha256"] = shas

    a = operators.random_diagdom(N, dominance=0.015, seed=0)
    b_d = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                           .astype(np.float32)).cuda()
    op_d = operators.DenseOperator(a, backend="cuda")

    def dense():
        return gmres(op_d, b_d, m=M, tol=TOL, max_restarts=TIMING_RESTARTS,
                     gs="cgs2_fused")
    res = dense()
    out["dense cgs2_fused"] = solve_timing(
        dense, res.inner_steps, phase="in_turn", solve="dense cgs2_fused",
        tree=label, restarts=res.restarts)
    del a, op_d

    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    save = ROOT / "build" / "in_turn"
    save.mkdir(parents=True, exist_ok=True)
    for name, pc in (("banded_ilu0", ilu), ("line_jacobi", lj)):
        def run(pc=pc):
            return gmres(op, b, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
                         gs="cgs2_fused", precond=pc)
        before = routes_of(trisolve.banded_trisweep)
        res = run()
        routes = {r: c - before.get(r, 0) for r, c in routes_of(
            trisolve.banded_trisweep).items()}
        r = solve_timing(run, res.inner_steps, phase="in_turn",
                         solve=f"{name} gmres cgs2_fused", tree=label,
                         restarts=res.restarts)
        path = save / f"{label}-{name}-{os.getpid()}.pt"
        torch.save(res.x.cpu(), path)
        out[f"{name} gmres cgs2_fused"] = dict(
            r, restarts=res.restarts, converged=res.converged,
            time_to_solution_s=r["wall_ms"] / 1e3, sweep_routes=routes,
            x_path=str(path))
    out["banded_ilu0 setup_s"] = ilu_setup
    return out


def redesign4_cells(label: str) -> dict:
    """Kernel-table row 13 (``batched_cgs2``) and the ILU(0) setup, and the
    cells they serve.  Row 13 at k = 4, n = 2^20 with j = (0, 7, 15, 29)
    and j = (15, 15, 15, 15), and at k = 8, n = 8192 with the PageRank
    burst's j, f32 and bf16 bases, cold (L2 rewritten before each call)
    and warm, with the SHA-256 of (h, w''); the ILU(0) setup on the 1024^2
    stencil's five-point pattern and on line-Jacobi's (-1, 0, 1), one
    call at a time by CUDA events after an L2 rewrite, with the SHA-256 of
    the factors; the 4-lane 1024^2 banded batch per lockstep step (wall,
    device, idle share, row 13's ms a launch in the solve); the ILU(0)
    and line-Jacobi ``gmres(gs="cgs2_fused")`` solves' time to solution
    with their setup (``make_preconditioner`` and the solve, one host
    clock)."""
    import hashlib

    from repro_torch.core import gmres, gmres_batched, stencils
    from repro_torch.core import preconditioners as P
    from repro_torch.kernels import block_gs, trisolve

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def one_call_ms(fn, iters):
        """CUDA-event ms of single cold calls (median), after a warm one."""
        flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32,
                            device="cuda")
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(iters):
            flush.bitwise_not_()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(stop))
        return sorted(out)[len(out) // 2]

    out = {}
    for k, nb, js in BGS_SHAPES[:1] + ((4, NX * NX, (15, 15, 15, 15)),) \
            + BGS_SHAPES[1:]:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(nb + k)
            v = lane_bases(k, nb, M + 1, js, dtype, gen)
            w = torch.randn(k, nb, device="cuda", generator=gen)
            sz = v.element_size()

            def fn(v=v, w=w, js=js):
                return block_gs.batched_cgs2(v, w, js)
            row = {"cold": timed(fn, iters=20, cold=True),
                   "warm": timed(fn, iters=20), "sha256": sha(*fn()),
                   "split": bgs_split(v, w, js),
                   "bytes": sum(j + 1 for j in js) * nb * sz + 8 * k * nb,
                   "flops": 8 * sum(j + 1 for j in js) * nb}
            row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                     row["flops"])
            out[f"batched_cgs2 {str(dtype)[6:]} k={k} n={nb} "
                f"j={list(js)}"] = row
            del v, w

    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    for name, bands, offs in (
            ("five-point", op.bands, op.offsets),
            ("line-Jacobi", op.bands[1:4].contiguous(), (-1, 0, 1))):
        out[f"ilu0_factor {name}"] = {
            "ms": one_call_ms(lambda bands=bands, offs=offs:
                              trisolve.ilu0_factor(bands, offs), 5),
            "sha256": sha(*trisolve.ilu0_factor(bands, offs)),
            "bound_ms": bound(bands.shape[0] * NX * NX * 8, 0)[0]}

    n = NX * NX
    b4 = torch.stack([torch.from_numpy(np.random.default_rng(seed)
                                       .standard_normal(n).astype(np.float32))
                      for seed in (1, 2, 3, 4)]).cuda()
    block_gs.batched_cgs2.launches = 0
    res = gmres_batched(op, b4, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS)
    lock = block_gs.batched_cgs2.launches
    out["stencil batch"] = dict(batch_timing(
        lambda: gmres_batched(op, b4, m=M, tol=TOL,
                              max_restarts=SPARSE_RESTARTS),
        lock, phase="in_turn", tree=label,
        solve="4-lane 1024^2 banded batch (per lockstep step)"),
        restarts=res.restarts.tolist(), converged=res.converged.tolist(),
        lockstep=lock)
    del b4, res

    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    for name in ("banded_ilu0", "line_jacobi"):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc = P.make_preconditioner(name, op)
            res = gmres(op, b, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
                        gs="cgs2_fused", precond=pc)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{name} setup + gmres cgs2_fused"] = {
            "time_to_solution_with_setup_s": walls, "restarts": res.restarts,
            "converged": res.converged}
    return out


def redesign5_cells(label: str) -> dict:
    """Kernel-table rows 2 (``gs_project`` and the streamed ``cgs2``) and 9
    (``block_gs_pass``) and the solves they serve.  Rows 2 at n = 2^20,
    j = 0, 7, 15 and 29, and row 9 at n = 2^20, s = 5, k_start 0, 12 and
    25, f32 and bf16 bases, cold (L2 rewritten before each call) and warm,
    with the SHA-256 of the outputs ((h, w'') and (C, W', G)) and the
    bound; each timing's ``host_ms`` is the wrapper's enqueue cost a call
    (warm: the solver's), also for ``cgs2`` at the dense n = 10,000 (two
    shared-memory passes); the dense 10,000 and banded 1024^2
    ``gmres(gs="cgs2_fused")`` solves and the banded ``gmres_sstep(s=5,
    blocks=6, gs="cgs2")`` solve: wall (the median of five runs, each
    listed), device, idle share and kernels' device ms a step, restarts,
    x (saved for the comparison across the trees)."""
    import hashlib

    from repro_torch.core import gmres, gmres_sstep, operators, stencils
    from repro_torch.kernels import block_gs, cgs2

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    n = NX * NX
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype)[6:]
        for j in (0, 7, 15, 29):
            gen = torch.Generator(device="cuda").manual_seed(1000 + j)
            v = basis(n, M + 1, j, dtype, gen)
            w = torch.randn(n, device="cuda", generator=gen)
            nbytes = (j + 1) * n * v.element_size() + 8 * n
            for name, fn in (("cgs2", cgs2.cgs2),
                             ("gs_project", cgs2.gs_project)):
                def call(fn=fn, v=v, w=w, j=j):
                    return fn(v, w, j)
                row = {"cold": timed(call, iters=20, cold=True),
                       "warm": timed(call, iters=20), "sha256": sha(*call()),
                       "bytes": nbytes, "bound_ms": bound(nbytes, 0)[0]}
                out[f"{name} {name_t} n={n} j={j}"] = row
            del v, w
        for k in (0, 12, 25):
            gen = torch.Generator(device="cuda").manual_seed(2000 + k)
            v = basis(n, M + 1, k, dtype, gen)
            w = torch.randn(SSTEP_S, n, device="cuda", generator=gen)
            tin = torch.triu(torch.randn(SSTEP_S, SSTEP_S, device="cuda",
                                         generator=gen)) \
                + 2 * torch.eye(SSTEP_S, device="cuda")

            def call(v=v, w=w, tin=tin, k=k):
                return block_gs.block_gs_pass(v, w, tin, k)
            nbytes = (k + 1) * n * v.element_size() + 8 * SSTEP_S * n
            out[f"block_gs_pass {name_t} n={n} s={SSTEP_S} k_start={k}"] = {
                "cold": timed(call, iters=20, cold=True),
                "warm": timed(call, iters=20), "sha256": sha(*call()),
                "bytes": nbytes, "bound_ms": bound(nbytes, 0)[0]}
            del v, w, tin
        # the dense s-step solver's shape, warm (phase 12's method)
        gen = torch.Generator(device="cuda").manual_seed(3000)
        v = basis(N, M + 1, 25, dtype, gen)
        w = torch.randn(SSTEP_S, N, device="cuda", generator=gen)
        tin = torch.eye(SSTEP_S, device="cuda")
        out[f"block_gs_pass {name_t} n={N} s={SSTEP_S} k_start=25"] = {
            "warm": timed(lambda: block_gs.block_gs_pass(v, w, tin, 25)),
            "sha256": sha(*block_gs.block_gs_pass(v, w, tin, 25))}
        del v, w, tin
        # the dense solver's cgs2 (two shared-memory passes), warm
        gen = torch.Generator(device="cuda").manual_seed(3001)
        v = basis(N, M + 1, 15, dtype, gen)
        w = torch.randn(N, device="cuda", generator=gen)
        out[f"cgs2 {name_t} n={N} j=15"] = {
            "warm": timed(lambda: cgs2.cgs2(v, w, 15)),
            "sha256": sha(*cgs2.cgs2(v, w, 15))}
        del v, w

    a = operators.random_diagdom(N, dominance=0.015, seed=0)
    b_d = torch.from_numpy(np.random.default_rng(1).standard_normal(N)
                           .astype(np.float32)).cuda()
    op_d = operators.DenseOperator(a, backend="cuda")
    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    save = ROOT / "build" / "in_turn"
    save.mkdir(parents=True, exist_ok=True)
    for name, run in (
            ("dense gmres cgs2_fused",
             lambda: gmres(op_d, b_d, m=M, tol=TOL,
                           max_restarts=TIMING_RESTARTS, gs="cgs2_fused")),
            ("banded gmres cgs2_fused",
             lambda: gmres(op, b, m=M, tol=TOL, max_restarts=SPARSE_RESTARTS,
                           gs="cgs2_fused")),
            ("banded gmres_sstep cgs2",
             lambda: gmres_sstep(op, b, s=SSTEP_S, blocks=SSTEP_BLOCKS,
                                 tol=TOL, max_restarts=SPARSE_RESTARTS,
                                 gs="cgs2"))):
        res = run()
        r = solve_timing(run, res.inner_steps, phase="in_turn", walls=5,
                         solve=name, tree=label, restarts=res.restarts)
        path = save / f"{label}-{name.replace(' ', '_')}-{os.getpid()}.pt"
        torch.save(res.x.cpu(), path)
        out[name] = dict(r, restarts=res.restarts, converged=res.converged,
                         x_path=str(path))
    return out


def redesign6_cells(label: str) -> dict:
    """Kernel-table rows 17 (``ell_powers``) and 5 (the payload) and the
    solves they serve, and the rows that share their code or their
    partition.  Rows 17 and 14 (``banded_powers``) on the 1024^2 stencil
    at s = 2, 5 and 8, f32 and bf16 storage, cold (L2 rewritten before
    each call) and warm, with the SHA-256 of (u, sigma); row 5
    at n = 2^20, j = 0, 15 and 29, and n = 10^4, j = 15; row 4
    (``gs_project_partial``) at n = 2^20 and 10^4, j = 15; rows 15 (one
    shard of the stencil, s = 5) and 18 (Chebyshev order 4); the ELL
    ``gmres_sstep(s=5, blocks=6, gs="cgs2")`` and banded
    ``gmres(gs="cgs2_pipelined")`` solves: wall (the median of five runs,
    each listed), device, idle share and kernels' device ms a step,
    restarts, x (saved for the comparison across the trees)."""
    import hashlib

    from repro_torch.core import gmres, gmres_sstep, stencils
    from repro_torch.core import preconditioners as P
    from repro_torch.kernels import cgs2
    from repro_torch.kernels import matrix_powers as mp

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def cell(fn, nbytes, cold=True):
        row = {"warm": timed(fn, iters=20), "sha256": sha(*fn())}
        if cold:
            row["cold"] = timed(fn, iters=20, cold=True)
        if nbytes:
            row.update(bytes=nbytes, bound_ms=bound(nbytes, 0)[0])
        return row

    out = {}
    n = NX * NX
    band = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    ell = band.to_ell()
    x = torch.randn(n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6))
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype)[6:]
        sz = torch.empty((), dtype=dtype).element_size()
        bands = band.bands.to(dtype)
        vals = ell.values.to(dtype)
        nb, width = bands.shape[0], vals.shape[1]
        for sp in (2, 5, 8):
            out[f"ell_powers {name_t} s={sp}"] = cell(
                lambda: mp.ell_powers(vals, ell.cols, x, sp),
                n * width * (sz + 4) + 4 * n + 4 * sp * n)
            out[f"banded_powers {name_t} s={sp}"] = cell(
                lambda: mp.banded_powers(bands, x, band.offsets, sp),
                nb * n * sz + 4 * n + 4 * sp * n)
        # row 15: one shard holding the whole stencil, s = 5, the band
        # stack scaled as the s-step solver scales it
        halo = max(abs(o) for o in band.offsets)
        pad = torch.nn.functional.pad
        scaled = band.bands / band.bands.abs().sum(dim=0).max()
        bands_pad = pad(scaled, (SSTEP_S * halo, SSTEP_S * halo)).to(
            dtype).contiguous()
        x_s = pad(x, (SSTEP_S * halo, SSTEP_S * halo))
        out[f"banded_powers_halo {name_t} s={SSTEP_S}"] = cell(
            lambda: mp.banded_powers_halo(bands_pad, x_s, band.offsets,
                                          SSTEP_S),
            nb * bands_pad.shape[1] * sz + 4 * bands_pad.shape[1]
            + 4 * SSTEP_S * n)
        cheb = P.make_preconditioner("chebyshev", band, order=4)
        out[f"banded_cheb_apply {name_t} order=4"] = cell(
            lambda: mp.banded_cheb_apply(bands, x, band.offsets,
                                         theta=cheb.theta, delta=cheb.delta,
                                         rhos=cheb.rhos),
            nb * n * sz + 8 * n)
        del bands_pad, x_s
        for nn, js in ((n, (0, 15, 29)), (N, (15,))):
            for j in js:
                gen = torch.Generator(device="cuda").manual_seed(600 + j)
                v = basis(nn, M + 1, j, dtype, gen)
                z = torch.randn(nn, device="cuda", generator=gen)
                nbytes = ((j + 1) * sz + 4) * nn
                out[f"payload {name_t} n={nn} j={j}"] = cell(
                    lambda: (cgs2.gs_project_norm_partial(v, z, j),), nbytes)
                if j == 15:
                    out[f"gs_project_partial {name_t} n={nn} j={j}"] = cell(
                        lambda: (cgs2.gs_project_partial(v, z, j),), nbytes)
                del v, z

    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    save = ROOT / "build" / "in_turn"
    save.mkdir(parents=True, exist_ok=True)
    ell_op = stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt="ell")
    for name, run in (
            ("ell gmres_sstep cgs2",
             lambda: gmres_sstep(ell_op, b, s=SSTEP_S, blocks=SSTEP_BLOCKS,
                                 tol=TOL, max_restarts=SPARSE_RESTARTS,
                                 gs="cgs2")),
            ("banded gmres cgs2_pipelined",
             lambda: gmres(band, b, m=M, tol=TOL,
                           max_restarts=SPARSE_RESTARTS,
                           gs="cgs2_pipelined"))):
        res = run()
        r = solve_timing(run, res.inner_steps, phase="in_turn", walls=5,
                         solve=name, tree=label, restarts=res.restarts)
        path = save / f"{label}-{name.replace(' ', '_')}-{os.getpid()}.pt"
        torch.save(res.x.cpu(), path)
        out[name] = dict(r, restarts=res.restarts, converged=res.converged,
                         x_path=str(path), x_sha256=sha(res.x))
    return out


def redesign7_cells(label: str) -> dict:
    """Kernel-table rows 14 (``banded_powers``) and 18
    (``banded_cheb_apply``), the rows that share their code or partition,
    and the solves they serve.  Row 14 on the 1024^2 stencil at s = 2, 5
    and 8, float32 and bfloat16 storage, cold (L2 rewritten before each
    call) and warm, the SHA-256 of (u, sigma) unshifted and with the Newton
    shifts; row 17 (``ell_powers``) the same, whose bits must be row 14's;
    row 18 at orders 2, 4 and 8 (the stencil's interval), cold and warm, the
    SHA-256 of its output; row 15 (one shard of the stencil, s = 5); the
    banded ``gmres_sstep(s=5, blocks=6, gs="cgs2")`` and the Chebyshev(4)
    ``gmres(gs="cgs2_fused")`` solves: wall (the median of five runs, each
    listed), device, idle share and kernels' device ms a step, restarts, x
    (saved for the comparison across the trees)."""
    import hashlib

    from repro_torch.core import gmres, gmres_sstep, stencils
    from repro_torch.core import preconditioners as P
    from repro_torch.core.sstep import _newton_shifts
    from repro_torch.kernels import matrix_powers as mp

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def cell(fn, nbytes):
        return {"warm": timed(fn, iters=20), "sha256": sha(*fn()),
                "cold": timed(fn, iters=20, cold=True), "bytes": nbytes,
                "bound_ms": bound(nbytes, 0)[0]}

    out = {}
    n = NX * NX
    band = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    ell = band.to_ell()
    x = torch.randn(n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    lo, hi = P.estimate_interval(band)
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype)[6:]
        sz = torch.empty((), dtype=dtype).element_size()
        bands = band.bands.to(dtype)
        vals = ell.values.to(dtype)
        nb, width = bands.shape[0], vals.shape[1]
        if hasattr(mp, "banded_plan"):
            out[f"banded plan {name_t}"] = mp.banded_plan(bands, band.offsets,
                                                          x)
        for sp in (2, 5, 8):
            out[f"banded_powers {name_t} s={sp}"] = cell(
                lambda: mp.banded_powers(bands, x, band.offsets, sp),
                nb * n * sz + 4 * n + 4 * sp * n)
            out[f"ell_powers {name_t} s={sp}"] = cell(
                lambda: mp.ell_powers(vals, ell.cols, x, sp),
                n * width * (sz + 4) + 4 * n + 4 * sp * n)
            sh = _newton_shifts(band, sp)
            out[f"banded_powers {name_t} s={sp} shifted sha256"] = sha(
                *mp.banded_powers(bands, x, band.offsets, sp, shifts=sh))
            out[f"ell_powers {name_t} s={sp} shifted sha256"] = sha(
                *mp.ell_powers(vals, ell.cols, x, sp, shifts=sh))
        for order in (2, 4, 8):
            theta, delta, rhos = P.cheb_coeffs(order, lo, hi)
            out[f"banded_cheb_apply {name_t} order={order}"] = cell(
                lambda: (mp.banded_cheb_apply(bands, x, band.offsets,
                                              theta=theta, delta=delta,
                                              rhos=rhos),),
                nb * n * sz + 8 * n)
        # row 15: one shard holding the whole stencil, s = 5, the band
        # stack scaled as the s-step solver scales it
        halo = max(abs(o) for o in band.offsets)
        pad = torch.nn.functional.pad
        scaled = band.bands / band.bands.abs().sum(dim=0).max()
        bands_pad = pad(scaled, (SSTEP_S * halo, SSTEP_S * halo)).to(
            dtype).contiguous()
        x_s = pad(x, (SSTEP_S * halo, SSTEP_S * halo))
        out[f"banded_powers_halo {name_t} s={SSTEP_S}"] = cell(
            lambda: mp.banded_powers_halo(bands_pad, x_s, band.offsets,
                                          SSTEP_S),
            nb * bands_pad.shape[1] * sz + 4 * bands_pad.shape[1]
            + 4 * SSTEP_S * n)
        del bands_pad, x_s

    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()
    save = ROOT / "build" / "in_turn"
    save.mkdir(parents=True, exist_ok=True)
    cheb = P.make_preconditioner("chebyshev", band, order=4)
    for name, run in (
            ("banded gmres_sstep cgs2",
             lambda: gmres_sstep(band, b, s=SSTEP_S, blocks=SSTEP_BLOCKS,
                                 tol=TOL, max_restarts=SPARSE_RESTARTS,
                                 gs="cgs2")),
            ("chebyshev(4) gmres cgs2_fused",
             lambda: gmres(band, b, m=M, tol=TOL,
                           max_restarts=SPARSE_RESTARTS, gs="cgs2_fused",
                           precond=cheb))):
        res = run()
        r = solve_timing(run, res.inner_steps, phase="in_turn", walls=5,
                         solve=name, tree=label, restarts=res.restarts)
        path = save / f"{label}-{name.replace(' ', '_')}-{os.getpid()}.pt"
        torch.save(res.x.cpu(), path)
        out[name] = dict(r, restarts=res.restarts, converged=res.converged,
                         x_path=str(path), x_sha256=sha(res.x))
    return out


def ssd_flops(batch, heads, s, p, n, q, bf16=False) -> tuple[int, int]:
    """The SSD scan's products, as (flops, tensor-core operations).

    The flops the function needs with C B^T formed once per (batch row,
    chunk): the triangle of C B^T a batch row and chunk; a row's triangle
    of W x every chunk; its (e^cum C) H every chunk but the first (whose
    entering state is 0) and its state update every chunk but the last
    (whose state is never read).  The operations are each product's flops
    times the TF32 passes it takes in split TF32: three, less one for each
    operand read from bf16 storage (exact in TF32: C and B, x)."""
    tri = q * (q + 1) // 2
    nc = s // q
    cb = batch * nc * tri * 2 * n                    # C, B
    wx = batch * heads * nc * tri * 2 * p            # W, x
    ch = batch * heads * (nc - 1) * 2 * q * n * p    # e^cum C, H
    su = batch * heads * (nc - 1) * 2 * q * n * p    # B, w x
    passes = (1, 2, 3, 2) if bf16 else (3, 3, 3, 3)
    return (cb + wx + ch + su,
            sum(f * k for f, k in zip((cb, wx, ch, su), passes)))


def ssd_strong_inputs(batch, heads, s, p, n, dtype, seed=0):
    """SSD operands with zamba2's decays: lg = dt A, A = -linspace(1, 16,
    heads) per head (its ``a_log``), so cum reaches -10^3 within a chunk."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bh = batch * heads
    x = torch.randn(bh, s, p, device="cuda", generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(bh, s, device="cuda",
                                                  generator=gen))
    a = -torch.linspace(1.0, 16.0, heads, device="cuda")
    lg = (dt.view(batch, heads, s) * a[None, :, None]).reshape(bh, s)
    b = torch.randn(batch, s, n, device="cuda", generator=gen).to(dtype)
    c = torch.randn(batch, s, n, device="cuda", generator=gen).to(dtype)
    return x, dt, lg, b, c


def redesign8_cells(label: str) -> dict:
    """Kernel-table row 21 (``ssd_scan``) and the prefill it serves.  The
    scan with zamba2's decays at its prefill shape (224 rows, S = 512, P =
    N = 64, Q = 256) and at S = 2,048 (eight chunks), float32 and bfloat16
    storage: cold (L2 rewritten before each call) and warm, device ms by
    kernel, the SHA-256 of the output, the output saved for the comparison
    across the trees; then zamba2-7b at full width cut to REDESIGN8_LAYERS
    layers, prefill b = 2, S = 512: wall ms (three runs), device ms, the
    SSD scan's device ms and launches."""
    import dataclasses
    import hashlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import ssd
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import build

    out = {}
    save = ROOT / "build" / "in_turn"
    save.mkdir(parents=True, exist_ok=True)
    for s_len in (ZAMBA_PROMPT, 4 * ZAMBA_PROMPT):
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_strong_inputs(ZAMBA_BATCH, 112, s_len, 64, 64, dtype)

            def fn(args=args):
                return ssd.ssd_scan(*args, heads=112, chunk=256)
            y = fn()
            torch.cuda.synchronize()
            key = f"ssd_scan {str(dtype)[6:]} S={s_len}"
            path = save / f"{label}-{key.replace(' ', '_')}-{os.getpid()}.pt"
            torch.save(y.cpu(), path)
            nbytes = (y.element_size() * (2 * y.numel() + 2 * ZAMBA_BATCH
                                          * s_len * 64) + 8 * y.shape[0]
                      * s_len)
            cold = timed(fn, iters=20, cold=True)
            flops, ops = ssd_flops(ZAMBA_BATCH, 112, s_len, 64, 64, 256,
                                   bf16=dtype == torch.bfloat16)
            out[key] = {"cold": cold, "warm": timed(fn, iters=20),
                        # from the profile that gave cold's ms
                        "by_kernel": cold["by_kernel"],
                        "sha256": hashlib.sha256(
                            y.cpu().view(torch.int16 if dtype
                                         == torch.bfloat16 else torch.int32)
                            .numpy().tobytes()).hexdigest(),
                        "y_path": str(path), "bytes": nbytes,
                        "flops": flops, "tf32_ops": ops}
            out[key]["bound_ms"], out[key]["bound_by"] = bound(
                nbytes, ops, TF32_FLOPS_PER_S)
            del args, y
    cfg = dataclasses.replace(configs.get("zamba2-7b"),
                              num_layers=REDESIGN8_LAYERS)
    params = build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    batch = {"tokens": np.random.default_rng(0).integers(
        2, cfg.vocab_size, (ZAMBA_BATCH, ZAMBA_PROMPT)).astype(np.int32)}
    prefill = make_prefill_step(cfg)
    prefill(params, batch)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    calls = ssd.ssd_scan.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    by = kernel_ms(prof)
    out["prefill"] = {
        "layers": cfg.num_layers, "walls_ms": walls,
        "device_ms": sum(by.values()),
        "ssd_scan_ms": sum(ms for key, ms in by.items()
                           if kernel_class(key) == "ssd_scan"),
        "ssd_scan_calls": ssd.ssd_scan.launches - calls,
        "logits_finite": bool(torch.isfinite(logits).all())}
    return out


def redesign9_cells(label: str) -> dict:
    """Kernel-table rows 12 (``block_gs_project_gram``) and 10
    (``block_gs_project``) and the solves they serve.  Both at n = 2^20,
    s = 5, k_start 0, 12 and 25 (row 12 over the prefix V[:k_start+1], as
    the single-reduce pass calls it; row 10 over V with its rows past
    k_start NaN, which it must never read), f32 and bf16 bases: cold (L2
    rewritten before each call, by kernel) and warm, beside the bound, the
    SHA-256 of Q and of every output, a second call's bits, the distance
    to the plain version, C and M saved for the comparison across the
    trees; row 12 warm at the dense n = 10^4; the SHA-256 of row 11
    (``block_gs_update``) and row 9 (``block_gs_pass``) at k_start 25; the
    banded 1024^2 ``gmres_sstep(s=5, blocks=6, gs="cgs2_pipelined")``
    solve (wall the median of five, device, idle, kernels' device ms a
    step, restarts, x saved) and the one-rank NCCL
    ``gmres_sstep_sharded(gs="cgs2")`` solve, which runs row 10.  On a tree
    with the projections' launch helper, both kernels also cold at one and
    two blocks an SM (the plan taken on twice the SMs; uncounted
    launches)."""
    import hashlib
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import gmres_sstep, gmres_sstep_sharded, stencils
    from repro_torch.kernels import block_gs, tuning

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    n, s = NX * NX, SSTEP_S
    save = ROOT / "build" / "in_turn"
    save.mkdir(parents=True, exist_ok=True)
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype)[6:]
        for k in (0, 12, 25):
            gen = torch.Generator(device="cuda").manual_seed(9000 + k)
            v = basis(n, M + 1, k, dtype, gen)
            vp = v[:k + 1]
            v_nan = v.clone()
            v_nan[k + 1:] = float("nan")
            w = torch.randn(s, n, device="cuda", generator=gen)
            tin = torch.triu(torch.randn(s, s, device="cuda",
                                         generator=gen)) \
                + 2 * torch.eye(s, device="cuda")
            nbytes = (k + 1) * n * v.element_size() + 8 * s * n
            cells = {
                "block_gs_project_gram": (
                    lambda: block_gs.block_gs_project_gram(vp, w, tin),
                    lambda: block_gs.block_gs_project_gram_plain(vp, w,
                                                                 tin),
                    2 * s * s + 2 * (k + 1) * s + s * (s + 1)),
                "block_gs_project": (
                    lambda: block_gs.block_gs_project(v_nan, w, tin, k),
                    lambda: block_gs.block_gs_project_plain(v, w, tin, k),
                    2 * s * s + 2 * (k + 1) * s)}
            for name, (fn, plain, flops) in cells.items():
                got = fn()
                again = fn()
                want = plain()
                torch.cuda.synchronize()
                key = f"{name} {name_t} n={n} s={s} k_start={k}"
                path = save / (f"{label}-{key.replace(' ', '_')}-"
                               f"{os.getpid()}.pt")
                torch.save([t.cpu() for t in got[1:]], path)
                row = {"cold": timed(fn, iters=20, cold=True),
                       "warm": timed(fn, iters=20),
                       "q_sha256": sha(got[0]), "sha256": sha(*got),
                       "again_same_bits": all(torch.equal(a, b)
                                              for a, b in zip(got, again)),
                       "rel_to_plain": max(relerr(a, b)
                                           for a, b in zip(got, want)),
                       "out_path": str(path), "bytes": nbytes,
                       "flops": flops * n}
                row["cold_by_kernel"] = row["cold"]["by_kernel"]
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops * n)
                if hasattr(block_gs, "launch_project"):
                    row["grid"] = block_gs.block_gs_plan(v, w, k)["grid"]
                out[key] = row
                check(row["rel_to_plain"] < TOLS[dtype]
                      and row["again_same_bits"],
                      f"redesign9 {key}: {row['rel_to_plain']} from plain, "
                      f"second call the same bits {row['again_same_bits']}")
            if k == 25:
                q = tin @ w
                c = torch.randn(k + 1, s, device="cuda", generator=gen)
                out[f"block_gs_update {name_t} sha256"] = sha(
                    *block_gs.block_gs_update(vp, q, c))
                out[f"block_gs_pass {name_t} sha256"] = sha(
                    *block_gs.block_gs_pass(v, w, tin, k))
                if hasattr(block_gs, "launch_project"):
                    # the plan's one block an SM against two (the plan
                    # taken on twice the SMs)
                    sweep = {}
                    for name, vv, gram in (
                            ("block_gs_project_gram", vp, True),
                            ("block_gs_project", v, False)):
                        one = block_gs.block_gs_plan(vv, w, k)
                        two = tuning.block_gs_plan(
                            vv.shape[0], n, s, k + 1, vv.element_size(),
                            one["route"] == "vec",
                            2 * tuning.sm_count("cuda"))
                        for per_sm, plan in ((1, one), (2, two)):
                            sweep[f"{name} blocks_per_sm={per_sm}"] = dict(
                                timed(lambda: block_gs.launch_project(
                                    vv, w, tin, k + 1, plan, gram),
                                    iters=20, cold=True), grid=plan["grid"])
                    out[f"blocks_per_sm sweep {name_t} k_start=25"] = sweep
            del v, vp, v_nan, w
        # the dense s-step solver's shape, warm
        gen = torch.Generator(device="cuda").manual_seed(9100)
        v = basis(N, M + 1, 25, dtype, gen)
        vp = v[:26]
        w = torch.randn(s, N, device="cuda", generator=gen)
        tin = torch.eye(s, device="cuda")
        out[f"block_gs_project_gram {name_t} n={N} s={s} k_start=25"] = {
            "warm": timed(lambda: block_gs.block_gs_project_gram(vp, w,
                                                                 tin)),
            "sha256": sha(*block_gs.block_gs_project_gram(vp, w, tin))}
        del v, vp, w

    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA, fmt="banded")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).cuda()

    def keep(name, res, row):
        path = save / f"{label}-{name.replace(' ', '_')}-{os.getpid()}.pt"
        torch.save(res.x.cpu(), path)
        out[name] = dict(row, restarts=res.restarts,
                         converged=res.converged, x_path=str(path))

    def pipelined():
        return gmres_sstep(op, b, s=s, blocks=SSTEP_BLOCKS, tol=TOL,
                           max_restarts=SPARSE_RESTARTS,
                           gs="cgs2_pipelined")
    res = pipelined()
    keep("banded gmres_sstep cgs2_pipelined", res, solve_timing(
        pipelined, res.inner_steps, phase="in_turn", walls=5,
        solve="banded gmres_sstep cgs2_pipelined", tree=label,
        restarts=res.restarts))
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/pg",
                            rank=0, world_size=1)
    try:
        def sharded():
            return gmres_sstep_sharded(dist.group.WORLD, op, b, s=s,
                                       blocks=SSTEP_BLOCKS, tol=TOL,
                                       max_restarts=SPARSE_RESTARTS,
                                       gs="cgs2")
        calls = block_gs.block_gs_project.launches
        res = sharded()
        launches = block_gs.block_gs_project.launches - calls
        keep("sharded banded gmres_sstep cgs2", res, dict(solve_timing(
            sharded, res.inner_steps, phase="in_turn", walls=3,
            solve="sharded banded gmres_sstep cgs2 (one rank)", tree=label,
            restarts=res.restarts), block_gs_project_launches=launches))
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return out


def redesign3_sweep(label: str) -> None:
    """The launch shapes ``tuning.gemv_rows_shape`` and
    ``tuning.trisweep_plan`` choose among, each launched through the
    wrappers' launch helpers (so no ``.launches`` count) and held to the
    plain version: ``block_matvec`` at n = 10,000, k = 1 and 4, f32 and
    bf16, cold, with R = 1, 2, 4, 8 rows a warp, 2 to 8 (k = 1) or 1 to 4
    (k = 4) blocks an SM, 2 or 4 pieces of each row in flight and A read
    evict-first or not; the chunk route on the ILU(0) L and U sweeps of
    the 1024^2 stencil with 2, 4, 8 stages in flight, cold, beside the
    chain probe; the scan route on the line-Jacobi sweeps with 1, 2, 4
    blocks an SM.  One ``tuning`` line a shape."""
    from repro_torch.core import preconditioners as P
    from repro_torch.core import stencils
    from repro_torch.kernels import matvec, trisolve, tuning

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = tuning.sm_count(torch.device("cuda"))
    for dtype in (torch.float32, torch.bfloat16):
        a = (torch.randn(N, N, device="cuda", generator=gen)
             / N ** 0.5).to(dtype)
        for k in (1, 4):
            x = torch.randn(N, k, device="cuda", generator=gen)
            want = matvec.block_matvec_plain(a, x)
            chosen = tuning.gemv_rows_shape(N, N, k, a.element_size(), sms)
            for rows in tuning.GEMV_ROWS_CHOICES:
                for bps in (2, 4, 6, 8) if k == 1 else (1, 2, 4):
                    for u, cs in (((2, True), (2, False), (4, True),
                                   (4, False)) if rows > 1
                                  else ((2, True),)):
                        shape = tuning.gemv_rows_shape(
                            N, N, k, a.element_size(), sms, rows=rows,
                            blocks_per_sm=bps, unroll=u, evict_first=cs)

                        def fn(shape=shape):
                            return matvec._launch_block_matvec(a, x, shape)
                        rel = relerr(fn(), want)
                        check(rel < TOLS[dtype],
                              f"block_matvec {shape}: {rel}")
                        emit(phase="tuning", tree=label,
                             kernel="block_matvec", dtype=str(dtype), n=N,
                             k=k, rows=rows, blocks_per_sm=bps, unroll=u,
                             evict_first=cs, chosen=shape == chosen,
                             max_rel_err=rel,
                             cold=timed(fn, iters=20, cold=True))
        del a
    n = NX * NX
    op = stencils.convection_diffusion_2d(NX, NX, beta=BETA)
    ilu = P.make_preconditioner("banded_ilu0", op)
    lj = P.make_preconditioner("line_jacobi", op)
    v = torch.randn(1, n, device="cuda", generator=gen)
    for name, bands, offs, unit, lower in (
            ("ILU(0) L", ilu.l_bands, ilu.l_offsets, True, True),
            ("ILU(0) U", ilu.u_bands, ilu.u_offsets, False, False),
            ("line-Jacobi L", lj.l_bands, lj.l_offsets, True, True),
            ("line-Jacobi U", lj.u_bands, lj.u_offsets, False, False)):
        want = trisolve.banded_trisweep_plain(bands, v, offs,
                                              unit_diag=unit, lower=lower)
        chosen = trisolve.sweep_plan(bands, v, torch.empty_like(v), offs)
        if chosen["route"] == "scan":
            plans = [dict(chosen, blocks_per_sm=c) for c in (1, 2, 4)]
        else:
            plans = [dict(chosen, stages=st) for st in (2, 4, 8)
                     if st <= chosen["stages"]]
        for plan in plans:

            def fn(plan=plan):
                z = torch.empty_like(v)
                trisolve._launch_trisweep(bands, v, z, offs, plan, unit,
                                          lower)
                return z
            rel = relerr(fn(), want)
            check(rel < TOLS[torch.float32], f"banded_trisweep {name} "
                                             f"{plan}: {rel}")
            row = dict(phase="tuning", tree=label,
                       kernel=f"banded_trisweep {name}", route=plan["route"],
                       rows=plan["rows"], threads=plan["threads"],
                       stages=plan["stages"],
                       blocks_per_sm=plan["blocks_per_sm"],
                       chosen=plan == chosen, max_rel_err=rel,
                       cold=timed(fn, iters=20, cold=True))
            if plan["route"] != "scan" and plan["stages"] == 8:
                t = timed(lambda: trisolve.chain_probe(
                    offs, n, unit_diag=unit, lower=lower))
                row["chain_floor_ms"] = t["ms"] or t["event_ms"]
            emit(**row)


def in_turn(parent: pathlib.Path, groups=CELL_GROUPS) -> None:
    """``measure_cells`` on the tree at ``parent`` (an unpacked ``git
    archive`` of the commit to compare with) and on this one, each in its
    own process, in turn: parent, this, this, parent.  With the ``gemv``
    group, the four runs must agree on the SHA-256 of ``gs_update``'s
    output and of the pipelined solve's x (the same bits)."""
    check(torch.cuda.is_available(), "no CUDA device is available")
    parent = parent.resolve()
    check((parent / "src" / "repro_torch").is_dir(),
          f"{parent} holds no src/repro_torch")
    rows = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        code = (f"import sys; sys.path.insert(0, {str(tree / 'src')!r}); "
                f"import repro_torch; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke; chip_smoke.measure_cells({label!r}, "
                f"{tuple(groups)!r})")
        run = subprocess.run([sys.executable, "-c", code], timeout=900,
                             stdout=subprocess.PIPE, text=True)
        sys.stdout.write(run.stdout)
        sys.stdout.flush()
        check(run.returncode == 0, f"in turn: the {label} run at {tree} "
                                   f"exited {run.returncode}")
        rows += [json.loads(line) for line in run.stdout.splitlines()
                 if line.startswith("{") and '"in_turn"' in line
                 and '"tree"' in line and '"package"' in line]
    if "gemv" in groups:
        shas = [(r["gs_update sha256"],
                 r["banded cgs2_pipelined"]["x_sha256"]) for r in rows]
        emit(phase="in_turn", same_bits=all(x == shas[0] for x in shas),
             trees=[r["tree"] for r in rows])
        check(len(shas) == 4 and all(x == shas[0] for x in shas),
              "in turn: gs_update's output or the pipelined solve's x "
              "differs between the trees")
    if "redesign3" in groups:
        # each tree's sweeps give the same bits in both its runs; the
        # preconditioned solves keep their restarts (+-1) and x (1e-3)
        sweep_bits = {t: [r["banded_trisweep sha256"] for r in rows
                          if r["tree"] == t] for t in ("parent", "this")}
        out = {"sweep_same_bits_per_tree": {
            t: len(b) == 2 and b[0] == b[1] for t, b in sweep_bits.items()}}
        for name in ("banded_ilu0", "line_jacobi"):
            solves = [r[f"{name} gmres cgs2_fused"] for r in rows]
            xs = [torch.load(s_["x_path"]) for s_ in solves]
            ref = xs[0]
            out[name] = {
                "restarts": [s_["restarts"] for s_ in solves],
                "x_rel_to_parent": [float((x - ref).norm() / ref.norm())
                                    for x in xs]}
            check(all(s_["converged"] for s_ in solves)
                  and max(out[name]["restarts"])
                  - min(out[name]["restarts"]) <= 1
                  and max(out[name]["x_rel_to_parent"]) <= 1e-3,
                  f"in turn: {name} solves differ between the trees: "
                  f"{out[name]}")
        emit(phase="in_turn", **out)
        check(all(out["sweep_same_bits_per_tree"].values()),
              "in turn: a tree's sweeps gave other bits in its two runs")
    if "redesign4" in groups:
        # the ILU(0) factors are the plain version's bits in every run;
        # each tree's batched_cgs2 gives the same bits in both its runs;
        # the batch's lanes converge with the same restarts (+-1)
        ilu = [(r["ilu0_factor five-point"]["sha256"],
                r["ilu0_factor line-Jacobi"]["sha256"]) for r in rows]
        bgs = {t: [{key: cell["sha256"] for key, cell in r.items()
                    if key.startswith("batched_cgs2")}
                   for r in rows if r["tree"] == t] for t in ("parent", "this")}
        batch = [r["stencil batch"] for r in rows]
        out = {"ilu0_same_bits": all(x == ilu[0] for x in ilu),
               "batched_cgs2_same_bits_per_tree": {
                   t: len(b) == 2 and b[0] == b[1] for t, b in bgs.items()},
               "batch_restarts": [c["restarts"] for c in batch]}
        emit(phase="in_turn", **out)
        check(out["ilu0_same_bits"], "in turn: the ILU(0) factors differ "
                                     "between runs")
        check(all(out["batched_cgs2_same_bits_per_tree"].values()),
              "in turn: a tree's batched_cgs2 gave other bits in its two "
              "runs")
        check(all(all(c["converged"]) for c in batch)
              and all(max(abs(a - b) for a, b in zip(c["restarts"],
                                                      batch[0]["restarts"]))
                      <= 1 for c in batch),
              f"in turn: the 4-lane batch differs between the trees: "
              f"{out['batch_restarts']}")

    if "redesign5" in groups:
        # each tree's kernels give the same bits in both its runs; the
        # solves end as the parent's (the banded two converged) with
        # restarts within 10% and x within 1e-3 of the parent's
        keys = [key for key in rows[0] if key.startswith(
            ("cgs2 ", "gs_project ", "block_gs_pass "))]
        bits = {t: [{key: r[key]["sha256"] for key in keys}
                    for r in rows if r["tree"] == t]
                for t in ("parent", "this")}
        out = {"same_bits_per_tree": {
            t: len(b) == 2 and b[0] == b[1] for t, b in bits.items()}}
        for name in ("dense gmres cgs2_fused", "banded gmres cgs2_fused",
                     "banded gmres_sstep cgs2"):
            solves = [r[name] for r in rows]
            xs = [torch.load(s_["x_path"]) for s_ in solves]
            ref = xs[0]
            restarts = [s_["restarts"] for s_ in solves]
            out[name] = {"restarts": restarts,
                         "x_rel_to_parent": [float((x - ref).norm()
                                                   / ref.norm()) for x in xs]}
            check(all(s_["converged"] == solves[0]["converged"]
                      for s_ in solves)
                  and (solves[0]["converged"] or name.startswith("dense"))
                  and max(restarts) <= 1.1 * min(restarts)
                  and max(out[name]["x_rel_to_parent"]) <= 1e-3,
                  f"in turn: {name} differs between the trees: {out[name]}")
        emit(phase="in_turn", **out)
        check(all(out["same_bits_per_tree"].values()),
              "in turn: a tree's rows 2 / 9 gave other bits in its two runs")

    if "redesign6" in groups:
        # each tree's kernels give the same bits in both its runs; in each
        # run ell_powers gives banded_powers' bits; row 4 the parent's bits
        # in all four runs; the solves converge with restarts within 10%
        # and x within 1e-3 of the parent's
        keys = [key for key in rows[0] if isinstance(rows[0][key], dict)
                and "sha256" in rows[0][key]]
        bits = {t: [{key: r[key]["sha256"] for key in keys}
                    for r in rows if r["tree"] == t]
                for t in ("parent", "this")}
        out = {"same_bits_per_tree": {
            t: len(b) == 2 and b[0] == b[1] for t, b in bits.items()},
            "ell_same_bits_as_banded": [all(
                r[f"ell_powers {t} s={sp}"]["sha256"]
                == r[f"banded_powers {t} s={sp}"]["sha256"]
                for t in ("float32", "bfloat16") for sp in (2, 5, 8))
                for r in rows]}
        out["row4_same_bits"] = all(
            len({r[f"gs_project_partial {t} n={nn} j=15"]["sha256"]
                 for r in rows}) == 1
            for t in ("float32", "bfloat16") for nn in (NX * NX, N))
        for name in ("ell gmres_sstep cgs2", "banded gmres cgs2_pipelined"):
            solves = [r[name] for r in rows]
            xs = [torch.load(s_["x_path"]) for s_ in solves]
            ref = xs[0]
            restarts = [s_["restarts"] for s_ in solves]
            out[name] = {"restarts": restarts,
                         "x_rel_to_parent": [float((x - ref).norm()
                                                   / ref.norm()) for x in xs]}
            check(all(s_["converged"] for s_ in solves)
                  and max(restarts) <= 1.1 * min(restarts)
                  and max(out[name]["x_rel_to_parent"]) <= 1e-3,
                  f"in turn: {name} differs between the trees: {out[name]}")
        emit(phase="in_turn", **out)
        check(all(out["same_bits_per_tree"].values()),
              "in turn: a tree's rows 17 / 5 / 4 / 14 / 15 / 18 gave other "
              "bits in its two runs")
        check(all(out["ell_same_bits_as_banded"]),
              "in turn: ell_powers and banded_powers gave other bits")
        check(out["row4_same_bits"],
              "in turn: gs_project_partial's bits differ between the trees")

    if "redesign7" in groups:
        # row 14's (u, sigma) and row 18's output: the parent's bits in all
        # four runs; row 17 row 14's bits in every run; row 15 the same bits
        # in each tree's two runs; the solves converge with restarts within
        # 10% and x within 1e-3 of the parent's
        dts = ("float32", "bfloat16")
        row14 = [f"banded_powers {t} s={sp}{sh}" for t in dts
                 for sp in (2, 5, 8) for sh in ("", " shifted sha256")]
        row18 = [f"banded_cheb_apply {t} order={o}" for t in dts
                 for o in (2, 4, 8)]

        def bits(r, key):
            return r[key]["sha256"] if isinstance(r[key], dict) else r[key]
        out = {"row14_parent_bits": all(
            len({bits(r, k) for r in rows}) == 1 for k in row14),
            "row18_parent_bits": all(
                len({bits(r, k) for r in rows}) == 1 for k in row18),
            "row17_is_row14": [all(
                bits(r, k.replace("banded_powers", "ell_powers"))
                == bits(r, k) for k in row14) for r in rows],
            "row15_same_bits_per_tree": {
                f"{t} {d}": len({r[f"banded_powers_halo {d} s={SSTEP_S}"]
                                 ["sha256"] for r in rows
                                 if r["tree"] == t}) == 1
                for t in ("parent", "this") for d in dts}}
        for name in ("banded gmres_sstep cgs2",
                     "chebyshev(4) gmres cgs2_fused"):
            solves = [r[name] for r in rows]
            xs = [torch.load(s_["x_path"]) for s_ in solves]
            ref = xs[0]
            restarts = [s_["restarts"] for s_ in solves]
            out[name] = {"restarts": restarts,
                         "x_rel_to_parent": [float((x - ref).norm()
                                                   / ref.norm()) for x in xs]}
            check(all(s_["converged"] for s_ in solves)
                  and max(restarts) <= 1.1 * min(restarts)
                  and max(out[name]["x_rel_to_parent"]) <= 1e-3,
                  f"in turn: {name} differs between the trees: {out[name]}")
        emit(phase="in_turn", **out)
        check(out["row14_parent_bits"] and out["row18_parent_bits"],
              "in turn: rows 14 / 18 gave other bits than the parent's")
        check(all(out["row17_is_row14"]),
              "in turn: ell_powers and banded_powers gave other bits")
        check(all(out["row15_same_bits_per_tree"].values()),
              "in turn: a tree's row 15 gave other bits in its two runs")

    if "redesign8" in groups:
        # row 21: each tree's two runs give the same bits; this tree's
        # output within the kernel's bar (3e-4 float32, 2e-2 bfloat16) of
        # the parent's; the cut prefill runs the scan once a layer
        keys = [k for k in rows[0] if k.startswith("ssd_scan ")]
        out = {"same_bits_per_tree": {
            f"{t} {k}": len({r[k]["sha256"] for r in rows
                             if r["tree"] == t}) == 1
            for t in ("parent", "this") for k in keys}}
        for k in keys:
            ys = [torch.load(r[k]["y_path"]).float() for r in rows]
            ref = ys[0]
            out[f"{k} rel_to_parent"] = [
                float((y - ref).abs().max() / ref.abs().max()) for y in ys]
        out["prefill_ssd_calls"] = [r["prefill"]["ssd_scan_calls"]
                                    for r in rows]
        emit(phase="in_turn", **out)
        check(all(out["same_bits_per_tree"].values()),
              "in turn: a tree's row 21 gave other bits in its two runs")
        for k in keys:
            bar = SSD_TOLS[torch.bfloat16 if "bfloat16" in k
                           else torch.float32]
            check(max(out[f"{k} rel_to_parent"]) < bar,
                  f"in turn: {k} differs from the parent's output: "
                  f"{out[f'{k} rel_to_parent']}")
        check(all(c == REDESIGN8_LAYERS for c in out["prefill_ssd_calls"])
              and all(r["prefill"]["logits_finite"] for r in rows),
              f"in turn: the cut prefill's scan calls "
              f"{out['prefill_ssd_calls']} or its logits")

    if "redesign9" in groups:
        # Q the parent's bits in all four runs; each tree's outputs the same
        # bits in both its runs; C, C_hat and M within the bars of the
        # parent's output; rows 9 and 11 the parent's bits; the solves
        # converge with restarts within +-1 and x within 1e-3
        keys = [k for k in rows[0] if k.startswith(
            ("block_gs_project_gram ", "block_gs_project "))
            and "out_path" in rows[0][k]]
        out = {"q_parent_bits": all(len({r[k]["q_sha256"] for r in rows})
                                    == 1 for k in keys),
               "same_bits_per_tree": {
                   t: all(len({r[k]["sha256"] for r in rows
                               if r["tree"] == t}) == 1 for k in keys)
                   for t in ("parent", "this")},
               "rows_9_11_parent_bits": all(
                   len({r[k] for r in rows}) == 1 for k in rows[0]
                   if k.endswith(" sha256") and k.startswith(
                       ("block_gs_update ", "block_gs_pass ")))}
        for k in keys:
            outs = [torch.load(r[k]["out_path"]) for r in rows]
            out[f"{k} rel_to_parent"] = [max(relerr(a, b) for a, b in
                                             zip(o, outs[0])) for o in outs]
        for name in ("banded gmres_sstep cgs2_pipelined",
                     "sharded banded gmres_sstep cgs2"):
            solves = [r[name] for r in rows]
            xs = [torch.load(s_["x_path"]) for s_ in solves]
            restarts = [s_["restarts"] for s_ in solves]
            out[name] = {"restarts": restarts,
                         "x_rel_to_parent": [float((x - xs[0]).norm()
                                                   / xs[0].norm())
                                             for x in xs]}
            check(all(s_["converged"] for s_ in solves)
                  and max(restarts) - min(restarts) <= 1
                  and max(out[name]["x_rel_to_parent"]) <= 1e-3,
                  f"in turn: {name} differs between the trees: {out[name]}")
        emit(phase="in_turn", **out)
        check(out["q_parent_bits"], "in turn: Q differs from the parent's")
        check(all(out["same_bits_per_tree"].values()),
              "in turn: a tree's rows 12 / 10 gave other bits in its two "
              "runs")
        check(out["rows_9_11_parent_bits"],
              "in turn: rows 9 / 11 gave other bits than the parent's")
        for k in keys:
            bar = TOLS[torch.bfloat16 if "bfloat16" in k else torch.float32]
            check(max(out[f"{k} rel_to_parent"]) < bar,
                  f"in turn: {k} differs from the parent's output: "
                  f"{out[f'{k} rel_to_parent']}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--in-turn"]:
        groups = tuple(sys.argv[3:]) or CELL_GROUPS
        check(set(groups) <= set(CELL_GROUPS + SWEEP_GROUPS),
              f"--in-turn: groups {groups}, known "
              f"{CELL_GROUPS + SWEEP_GROUPS}")
        in_turn(pathlib.Path(sys.argv[2]), groups)
    else:
        main()
