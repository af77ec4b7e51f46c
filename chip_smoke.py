"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (``"phase": ...``):

1. build      compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process
              per source, in parallel); nvcc version; card and power limit.
2. kernels    every kernel of the main path against its plain PyTorch
              version on the card, at the main path's shapes (n = 10,000,
              m1 = 31), float32 and bfloat16 storage.  Bars: max relative
              error 1e-4 (float32; another summation order over 10^4 terms)
              and 2e-2 (bfloat16).
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
              (each setting checked against the plain version).  Per solve:
              wall and device time per Arnoldi step.

Then one ``kernels`` line, the card's name and power limit as nvidia-smi
prints them, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises: the script exits non-zero and prints no result line.  Without a
CUDA device it fails at once.
"""
from __future__ import annotations

import json
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
# The paper's experiment: its largest system, m = 30, 50 restarts.  tol is
# 1e-5, not the config's 1e-6, as in benchmarks/gmres_strategies.py: the
# solves run in float32.
N = CONFIG.sizes[-1]
M = CONFIG.restart_m
MAX_RESTARTS = CONFIG.max_restarts
TOL = 1e-5
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SCHEMES = ("cgs2", "cgs2_fused", "fused")


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def relerr(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def abserr(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def timed(fn, iters=50, warmup=5) -> dict:
    """Per-call times of fn() over `iters` warm calls.

    ``ms`` is device time: the profiler's kernel records summed (what the
    card spent on the call).  ``event_ms`` is CUDA-event time over the
    back-to-back calls, which also holds any gaps left by host-side launch
    cost.  ``host_ms`` is the host's time to enqueue one call (Python, the
    wrapper, the launch).  If the profiler records no device time, ``ms``
    is "not measured" (None) and only ``event_ms`` stands.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_ms = device_ms(prof) / iters
    return {"ms": dev_ms if dev_ms > 0 else None, "event_ms": event_ms,
            "host_ms": host_ms}


def device_ms(prof) -> float:
    """Device time (ms) of the kernels and copies a profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def basis(n, m1, j, dtype, gen):
    """Orthonormal rows 0..j, zeros after: the state at Arnoldi step j."""
    q, _ = torch.linalg.qr(torch.randn(n, j + 1, device="cuda",
                                       generator=gen))
    v = torch.zeros(m1, n, device="cuda")
    v[: j + 1] = q.T
    return v.to(dtype).contiguous()


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device is available")
    from repro_torch.core import gmres, operators, strategies
    from repro_torch.kernels import _build, arnoldi_fused, cgs2, matvec, tuning

    warnings.filterwarnings("ignore", message=".*Profiler clears events")

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
    emit(phase="build", seconds=build_s, library=so.name, nvcc=nvcc[-1],
         card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. kernels vs plain at the main path's shapes ----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {name: [] for name in kernels}
    for dtype in (torch.float32, torch.bfloat16):
        a = (torch.randn(N, N, device="cuda", generator=gen)
             / N ** 0.5).to(dtype)
        for k in (1, 4):
            x = torch.randn(N, k, device="cuda", generator=gen)
            y = matvec.block_matvec(a, x)
            yp = matvec.block_matvec_plain(a, x)
            torch.cuda.synchronize()
            rel = relerr(y, yp)
            errs["block_matvec"].append(abserr(y, yp))
            emit(phase="kernels", kernel="block_matvec", n=N, k=k,
                 dtype=str(dtype), max_rel_err=rel)
            check(rel < TOLS[dtype], f"block_matvec k={k} {dtype}: {rel}")
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
        del a
    flush_counters()

    # host cost per Arnoldi step: the fused solve, wall clock vs device time
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
        emit(phase="timing", solve=gs, dominance=0.015, n=N,
             restarts=res.restarts, inner_steps=steps, wall_ms=wall_ms,
             wall_ms_per_step=wall_ms / steps,
             device_ms=dev_ms if dev_ms > 0 else None,
             device_ms_per_step=dev_ms / steps if dev_ms > 0 else None,
             host_overhead_ms_per_step=(wall_ms - dev_ms) / steps
             if dev_ms > 0 else None,
             device_idle_share=1 - dev_ms / wall_ms if dev_ms > 0 else None,
             card=smi)
    flush_counters()

    sources = {"block_matvec": ("src/repro_torch/csrc/matvec.cu",
                                "src/repro/kernels/matvec.py:80"),
               "gs_project": ("src/repro_torch/csrc/cgs2.cu",
                              "src/repro/kernels/cgs2.py:116"),
               "arnoldi_step": ("src/repro_torch/csrc/arnoldi_fused.cu",
                                "src/repro/kernels/arnoldi_fused.py:123")}
    emit(kernels=[{
        "name": name, "route": "cuda", "source": sources[name][0],
        "replaces": sources[name][1], "launches": launches[name],
        "max_abs_err": max(errs[name]),
        "ms": timing[name]["ms"] or timing[name]["event_ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"]} for name in kernels])
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
