"""Build ``csrc/*.cu`` into one shared library and bind it with ctypes.

The kernels have a plain C interface (pointers, ints, a stream), so they
build with ``nvcc`` alone in seconds; ``torch.utils.cpp_extension.load``
would compile PyTorch's headers and take minutes.  Each source compiles in
its own ``nvcc`` process, all started together, and the objects link into
``build/repro_torch_kernels/librepro_torch_kernels-<hash>.so``.  The hash
covers the sources and flags, so a stale library is never loaded and a
finished build is reused by later processes.

Nothing builds at import: ``library()`` runs at the first kernel launch.
A failed build raises with ``nvcc``'s stderr.  A finished one leaves
``ptxas -v``'s report of every kernel (registers, shared memory, spills)
beside the library, as ``<library>.log`` (``ptxas_log()``).

The kernels need only the CUDA runtime: the one libcuda function they use
(``cuTensorMapEncodeTiled``, for the bf16 attention kernel's TMA maps) is
fetched through ``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
COMPILE_FLAGS = ("-Xptxas=-v",)      # each kernel's resources, to the log

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C entry points: name -> argtypes.  Every entry returns the cudaError_t of
# its launch (0 on success).
SIGNATURES = {
    # a, a_bf16, x, y, m, n, k, rows, unroll, cs, grid, threads, stream
    # (the shape: tuning.gemv_rows_shape)
    "repro_block_matvec": (P, I, P, P, I, I, I, I, I, I, I, I, P),
    # The shared-memory pass: v, v_bf16, w, h, w_out, partials,
    # partial_blocks, m1, n, j, smem_cap, blocks_per_sm, stream
    "repro_gs_project": (P, I, P, P, P, P, I, I, I, I, I, I, P),
    # The streamed pass (tuning.gs_stream_plan): v, v_bf16, w, h, w_out,
    # partials, grid, m1, n, j, pieces, passes (2: cgs2), stream
    "repro_gs_stream": (P, I, P, P, P, P, I, I, I, I, I, I, P),
    # v_bf16, m1, out (int[2]: co-resident blocks, shared memory bytes)
    "repro_gs_stream_capacity": (I, I, P),
    # a, a_bf16, v, v_bf16, h, w_out, partials, partial_blocks, m1, n, j,
    # smem_cap, blocks_per_sm, stream
    "repro_arnoldi_step": (P, I, P, I, P, P, P, I, I, I, I, I, I, P),
    # Launch shapes, out = int[3] {grid, cols, smem bytes}:
    # v_bf16, m1, n, smem_cap, blocks_per_sm, out
    "repro_gs_project_shape": (I, I, I, I, I, P),
    # a_bf16, v_bf16, m1, n, smem_cap, blocks_per_sm, out
    "repro_arnoldi_step_shape": (I, I, I, I, I, I, P),
    # values, v_bf16, cols, x, y, rows, width, k, threads, stream
    "repro_ell_matvec": (P, I, P, P, P, I, I, I, I, P),
    # Sliced ELL, one launch over a bin table: values (host void*[nbins]),
    # v_bf16, cols (host int*[nbins]), meta (host int[5 nbins]: rows,
    # width, row0, block0, threads per row), nbins, x, y, k, perm (device
    # int[rows] or null), stream
    "repro_sell_matvec": (P, I, P, P, I, P, P, I, P, P),
    # bands, b_bf16, offsets (host int[nbands]), nbands, x, y, n, k,
    # threads, stream
    "repro_banded_matvec": (P, I, P, I, P, P, I, I, I, P),
    # The halo modes of a row-sharded solve's shard:
    # bands, b_bf16, offsets, nbands, x (n + 2 halo, k), y, n, halo, k,
    # threads, stream
    "repro_banded_matvec_halo": (P, I, P, I, P, P, I, I, I, I, P),
    # values, v_bf16, cols, x, x_rows, y, rows, width, k, threads, stream
    "repro_ell_matvec_halo": (P, I, P, P, I, P, I, I, I, I, P),
    # v, v_bf16, w, meta (device int[2 k + 1]: j, then the split's prefix
    # sums), h, w_out, partials, grid, k, m1, n, pieces, stream (the
    # split: tuning.batched_cgs2_split)
    "repro_batched_cgs2": (P, I, P, P, P, P, P, I, I, I, I, I, P),
    # v_bf16, m1, out (int[1]: co-resident blocks)
    "repro_batched_cgs2_capacity": (I, I, P),
    # rows, elem_size, out (int[3]: bucket of rows, pieces at once,
    # threads a block; tuning.batched_unroll's rule)
    "repro_batched_cgs2_unroll": (I, I, P),
    # bands, b_bf16, offsets (host int[nbands]), nbands, x, shifts (device
    # float[s] or null), u, sigma, raw, partials, partial_blocks, n, s, eps,
    # then the plan (tuning.banded_plan): segments, segments a block,
    # blocks, threads, resident rows a segment, tile halo, tile rows, vec,
    # smem, smem_cap; stream
    "repro_banded_powers": (P, I, P, I, P, P, P, P, P, P, I, I, I, F, I, I,
                            I, I, I, I, I, I, I, I, P),
    # values, v_bf16, cols, width, x, shifts, u, sigma, raw, partials,
    # partial_blocks, n, s, eps, then the plan (tuning.ell_powers_plan):
    # segments, segments a block, blocks, threads, resident rows a segment,
    # bucket, vec, smem, smem_cap; stream
    "repro_ell_powers": (P, I, P, I, P, P, P, P, P, P, I, I, I, F, I, I, I,
                         I, I, I, I, I, I, P),
    # a, a_bf16, x, u, sigma, raw, partials, partial_blocks, n, s, eps,
    # smem_cap, blocks_per_sm, stream
    "repro_dense_powers": (P, I, P, P, P, P, P, I, I, I, F, I, I, P),
    # kind (0 banded, 2 dense), bf16, n, blocks_per_sm, out
    "repro_matrix_powers_shape": (I, I, I, I, I, I, I, I, I, P),
    # The row-sharded banded powers: bands, b_bf16, offsets (host
    # int[nbands]), nbands, x, z, nrm, raw, partials, partial_blocks, width,
    # s, blocks_per_sm, stream
    "repro_banded_powers_halo": (P, I, P, I, P, P, P, P, P, I, I, I, I, P),
    # v, v_bf16, w, tin, c, w_out, g, partials, grid, m1, n, s, rows,
    # pieces, stream (the plan: tuning.block_gs_plan)
    "repro_block_gs_pass": (P, I, P, P, P, P, P, P, I, I, I, I, I, I, P),
    # m1, s, out (int[1]: shared memory bytes)
    "repro_block_gs_pass_smem": (I, I, P),
    # The single-reduce payload (the projection's kernels with two columns:
    # the column sweep and the partials' reduction, or a block a row): v,
    # v_bf16, z, out (m1 + 1, 2), partials, m1, n, j, by_row, threads,
    # blocks, unroll, bucket, pieces, stream (tuning.gemv_partial_shape(k=2))
    "repro_sr_payload": (P, I, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # The streaming GEMV pair (launch shape: tuning.gemv_stream_shape):
    # v, v_bf16, w, h, out, m1, n, threads, blocks, unroll, pieces, stream
    "repro_gs_update": (P, I, P, P, P, I, I, I, I, I, I, P),
    # the split-phase projection of a row-sharded CGS2 step (the column
    # sweep and the partials' reduction, or a block a row): v, v_bf16, w,
    # out (m1,), partials, m1, n, j, by_row, threads, blocks, unroll,
    # pieces, stream
    "repro_gs_project_partial": (P, I, P, P, P, I, I, I, I, I, I, I, I, P),
    # The single-reduce block pair (two launches each: partials, then their
    # reduction): v, v_bf16, w, tin, q, out (m1 + s, s) = [c_hat; m],
    # partials, grid, m1, n, s, pieces, stream (the plan:
    # tuning.block_gs_plan)
    "repro_block_gs_project_gram": (P, I, P, P, P, P, P, I, I, I, I, I, P),
    # v, v_bf16, q, c, w_out, g, partials, grid, m1, n, s, stream (grid =
    # tuning.sr_grid)
    "repro_block_gs_update": (P, I, P, P, P, P, P, I, I, I, I, P),
    # The row-sharded split pass's projection:
    # v, v_bf16, w, tin, q, c (m1, s), partials, grid, m1, rows, n, s,
    # pieces, stream (tuning.block_gs_plan)
    "repro_block_gs_project": (P, I, P, P, P, P, P, I, I, I, I, I, I, P),
    # The preconditioning kernels:
    # bands, b_bf16, offsets (host int[nbands]), nbands, v, zbuf (2 n),
    # out, n, theta, 2 / delta, rho, rho_old (host float[steps]), steps,
    # then the plan as repro_banded_powers'; stream
    "repro_banded_cheb_apply": (P, I, P, I, P, P, P, I, F, F, P, P, I, I,
                                I, I, I, I, I, I, I, I, I, P),
    # bands, b_bf16, offsets (host int[nbands]), nbands, v (k, n), z (k, n),
    # agg (route "scan": scratch, else null), n, k, chunk (0: route
    # "scan"), threads, ring, far_l2, stages, vec, unit, reverse,
    # blocks_per_sm, stream (the shape: tuning.trisweep_plan)
    "repro_banded_trisweep": (P, I, P, I, P, P, P, I, I, I, I, I, I, I, I,
                              I, I, I, P),
    # the chunk route's chain on register data: offsets, nbands, out (1,),
    # n, chunk, threads, ring, far_l2, unit, reverse, stream
    "repro_trisweep_probe": (P, I, P, I, I, I, I, I, I, I, P),
    # bands, b_bf16, offsets (host int[nbands]), nbands, fact (nbands, n),
    # flags (zeroed int[n + 1]), wait_mask, tile_rows, n, eps, guard,
    # stream (the plan: tuning.ilu0_plan)
    "repro_ilu0_factor": (P, I, P, I, P, P, I, I, I, F, F, P),
    # The model stack's kernels:
    # float32 attention: q, k, v, o, b, hq, hkv, sq, skv, d, strides (host
    # long long[12]: batch, head, position strides of q, k, v, o), scale,
    # causal, window (0 = none), stream
    "repro_attention": (P, P, P, P, I, I, I, I, I, I, P, F, I, I, P),
    # bf16 attention (TMA + wgmma): the same arguments; q, k, v 16-byte
    # aligned, their strides multiples of 8 elements
    "repro_attention_wgmma": (P, P, P, P, I, I, I, I, I, I, P, F, I, I, P),
    # x, bf16, dt, lg, b, c, y, then the scratch cum, dtp, tot, states;
    # bh, s, p, n, heads, chunk, the scratch's padded pc and qp, heads a
    # block, vec, stream (the plan: tuning.ssd_plan)
    "repro_ssd_scan": (P, I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       I, I, I, P),
    # pc, qp, out (int[2]: the state and output kernels' shared memory)
    "repro_ssd_smem": (I, I, P),
    # y, z, bf16, w, out, rows, d, eps, stream
    "repro_gated_rmsnorm": (P, P, I, P, P, I, I, F, P),
}

_LIB = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("repro_torch: nvcc not found (no CUDA toolkit on PATH "
                       "or under CUDA_HOME); the kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (if this exact build is absent); return the .so."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors, log = [], []
        for src, proc in procs:
            _, err = proc.communicate()
            log.append(f"--- {src.name}\n{err}")
            if proc.returncode != 0:
                errors.append(f"--- {src.name} (exit {proc.returncode})\n"
                              f"{err}")
        if errors:
            raise RuntimeError("repro_torch: nvcc failed\n"
                               + "\n".join(errors))
        tmp_so = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"repro_torch: nvcc link failed\n{link.stderr}")
        tmp_log = pathlib.Path(tmp) / (out.name + ".log")
        tmp_log.write_text("\n".join(log))
        os.replace(tmp_log, out.with_name(out.name + ".log"))
        os.replace(tmp_so, out)   # atomic: concurrent builders race safely
    return out


def ptxas_log() -> str:
    """``ptxas -v``'s report of the current build (built if absent)."""
    so = build()
    return so.with_name(so.name + ".log").read_text()


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"repro_torch: {name} launch failed: "
                           f"CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def shape(name: str, *args) -> dict:
    """The cooperative launch shape a kernel would use (for the record)."""
    out = (ctypes.c_int * 3)()
    check(name, getattr(library(), name)(*args, out))
    return {"grid": out[0], "cols": out[1], "smem_bytes": out[2]}
