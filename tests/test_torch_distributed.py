"""The port's row-sharded solvers on a 4-rank gloo group against JAX's
4-device ``shard_map``, on the CPU.

Two child processes run side by side, once per test session.  They start
when the module is imported, at collection, so they run while the other
modules' tests do: the first xdist worker to import the module starts them
(a file made with ``O_EXCL`` in a directory named by the session's
``PYTEST_XDIST_TESTRUNUID``), one waiter process collects their JSON, and
every worker's fixture reads it:

- a 4-rank ``torch.distributed`` group on gloo (``torch.multiprocessing``
  spawn, ``init_method="file://..."`` in a temporary directory: no port
  number to collide across workers), running ``gmres_sharded`` /
  ``gmres_sstep_sharded`` with ``device="cpu"``, the per-shard pieces
  (``halo_exchange``, ``cgs2_split``, ``block_gs_pass_sharded``, the
  single-reduce pass), the rejection paths, and the collectives counted
  by ``tuning.COLLECTIVES``;
- the JAX package on 4 host devices (``XLA_FLAGS`` set before JAX is
  imported) solving the same systems with ``gmres_sharded`` /
  ``gmres_sstep_sharded`` under ``jax.jit``, and counting the collectives
  of one Arnoldi step (one s-step block) in the traced program.

The systems are made here with numpy from seeds and handed to both as one
``.npz``: the 16^2 convection-diffusion stencil (n = 256: 64 rows a rank,
so s = 4 powers of the halo-16 stencil fit one shard and the
communication-avoiding powers kernel runs) as banded, ELL and sliced ELL
(rows sorted), and a dense ``random_diagdom`` (dominance 0.1).

Bars (``tests/test_sharded.py``'s): converged, true relative residual
below 5e-5, x within 2e-3 of JAX's (norm-wise relative), restarts within
+-1.  The per-shard pieces are held to slices of the single-process plain
result at 1e-5 (float32, sums over four shards in rank order).  Every rank
must return the same x, to the bit.

Jacobi on ELL and sliced-ELL shards is held to the one-process
preconditioned solve instead of JAX: JAX's ``rebind`` reads no diagonal
on those shards past rank 0 (ROADMAP queue 3), which one test shows.  The
sliced-ELL and ELL operators also run without a halo bound there, so the
all-gather paths of both run on four ranks.

Collectives per Arnoldi step (per s-step block) are counted on both sides
and must be equal: JAX's ``psum`` / ``pmax`` are the port's all-reduces,
its ``all_gather`` the port's all-gather, and a halo exchange is two
``ppermute``s in JAX and one ``batch_isend_irecv`` in the port.  The port's
count comes from two solves that differ only in m (in blocks), with tol 0
and one restart, so every step runs; JAX's from the loop body of the
traced program.  MGS is the one difference: the JAX loop runs all m + 1
rows with the rows past j masked (m + 2 psums a step), the port the valid
rows (j + 2 all-reduces at step j).

JAX's own sharded ``banded_block_jacobi`` runs under
``force_kernel_mode("ref")``: its Pallas sweep fails on jax 0.9.0
(``pl.load`` is gone; ROADMAP queue 3).
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import operators, stencils  # noqa: E402
from repro_torch.kernels import block_gs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANKS = 4
NX = 16
N = NX * NX
M = 16
TOL = 1e-5
SOLVE_RTOL = 2e-3
PIECE = dict(rtol=1e-5, atol=1e-5)

# (case, operator, scheme or "sstep_<gs>", precond)
CASES = [
    ("dense_cgs2_fused", "dense", "cgs2_fused", None),
    ("ell_cgs2_fused", "ell", "cgs2_fused", None),
    ("banded_cgs2_fused", "banded", "cgs2_fused", None),
    ("sell_cgs2_fused", "sell", "cgs2_fused", None),
    ("banded_cgs2", "banded", "cgs2", None),
    ("banded_mgs", "banded", "mgs", None),
    ("banded_cgs2_pipelined", "banded", "cgs2_pipelined", None),
    ("sstep_cgs2", "banded", "sstep_cgs2", None),
    ("sstep_cgs2_pipelined", "banded", "sstep_cgs2_pipelined", None),
    ("pc_chebyshev", "banded", "cgs2_fused", "chebyshev"),
    ("pc_jacobi", "banded", "cgs2_fused", "jacobi"),
    ("pc_banded_block_jacobi", "banded", "cgs2_fused",
     "banded_block_jacobi"),
    ("pc_block_jacobi", "dense", "cgs2_fused", "block_jacobi"),
]
# Jacobi on ELL / sliced-ELL shards, held to the one-process solve (case,
# operator); "_gathered": the operator without a halo bound (all-gather).
JACOBI_CASES = [("pc_jacobi_ell", "ell"), ("pc_jacobi_sell", "sell"),
                ("pc_jacobi_ell_gathered", "ell_gathered"),
                ("pc_jacobi_sell_gathered", "sell_gathered")]
# Collectives per step (per block for s-step) compared with JAX's.
COUNTED = ["dense_cgs2_fused", "ell_cgs2_fused", "banded_cgs2_fused",
           "sell_cgs2_fused", "banded_cgs2_pipelined", "sstep_cgs2",
           "sstep_cgs2_pipelined", "pc_chebyshev", "banded_mgs"]
S, BLOCKS = 4, 4

# The shared part of both children: load the systems and name the cases.
_COMMON = f"""
import json, sys
import numpy as np
CASES = {CASES!r}
JACOBI_CASES = {JACOBI_CASES!r}
COUNTED = {COUNTED!r}
M, TOL, S, BLOCKS, RANKS = {M}, {TOL}, {S}, {BLOCKS}, {RANKS}
sysz = np.load(sys.argv[1])
OFFSETS = tuple(int(o) for o in sysz["offsets"])
"""

_GLOO = _COMMON + textwrap.dedent("""
    import os
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def operators_of():
        from repro_torch.core import operators as O
        banded = O.BandedOperator(sysz["bands"], OFFSETS, device="cpu")
        ell = O.SparseOperator(sysz["values"], sysz["cols"],
                               int(sysz["halo"]), device="cpu")
        sell = O.SlicedEllOperator.from_ell(ell, slice_height=16, sort=True)
        return {"banded": banded, "ell": ell, "sell": sell,
                "dense": O.DenseOperator(sysz["a"], device="cpu"),
                "ell_gathered": O.SparseOperator(ell.values, ell.cols, None,
                                                 device="cpu"),
                "sell_gathered": O.SlicedEllOperator(
                    sell.bin_values, sell.bin_cols, sell.perm, None,
                    sell.slice_height, sell.identity_perm, device="cpu")}


    def solve(g, op, b, scheme, precond, **kw):
        from repro_torch.core import gmres_sharded, gmres_sstep_sharded
        if scheme.startswith("sstep_"):
            return gmres_sstep_sharded(
                g, op, b, s=S, blocks=kw.get("blocks", BLOCKS),
                tol=kw.get("tol", TOL), max_restarts=kw.get("restarts", 60),
                gs=scheme[len("sstep_"):], precond=precond, device="cpu")
        return gmres_sharded(g, op, b, m=kw.get("m", M),
                             tol=kw.get("tol", TOL),
                             max_restarts=kw.get("restarts", 150), gs=scheme,
                             precond=precond, device="cpu")


    def counted(g, op, b, scheme, precond):
        # collectives of one step (block): two one-cycle solves, tol 0
        from repro_torch.kernels import tuning
        totals = []
        for size in (2, 3) if scheme.startswith("sstep_") else (4, 6):
            for k in tuning.COLLECTIVES:
                tuning.COLLECTIVES[k] = 0
            kw = {"blocks": size} if scheme.startswith("sstep_") else \\
                {"m": size}
            solve(g, op, b, scheme, precond, tol=0.0, restarts=1, **kw)
            totals.append(dict(tuning.COLLECTIVES))
        span = 1 if scheme.startswith("sstep_") else 2
        return {k: (totals[1][k] - totals[0][k]) / span
                for k in totals[0]}


    def pieces(g, rank):
        from repro_torch.kernels import block_gs, cgs2, spmv
        out = {}
        nl = sysz["x"].shape[0] // RANKS
        rows = slice(rank * nl, (rank + 1) * nl)
        x = torch.from_numpy(sysz["x"])
        out["halo_1d"] = spmv.halo_exchange(x[rows], 3, g).tolist()
        out["halo_2d"] = spmv.halo_exchange(
            torch.from_numpy(sysz["xk"])[rows], 5, g).tolist()
        v = torch.from_numpy(sysz["v"])
        h, w2 = cgs2.cgs2_split(v[:, rows].contiguous(), x[rows],
                                int(sysz["j"]), g)
        out["cgs2_split"] = [h.tolist(), w2.tolist()]
        vb = torch.from_numpy(sysz["vb"])[:, rows].contiguous()
        wb = torch.from_numpy(sysz["wb"])[:, rows].contiguous()
        tb = torch.from_numpy(sysz["tb"])
        c, wo, gg = block_gs.block_gs_pass_sharded(vb, wb, tb,
                                                   int(sysz["k"]), g)
        out["block_gs_pass_sharded"] = [c.tolist(), wo.tolist(),
                                        gg.tolist()]
        gram = torch.eye(vb.shape[0])
        c, wo, gg, ch = block_gs.block_gs_pass_single_reduce(
            vb, wb, tb, int(sysz["k"]), gram, g)
        out["single_reduce"] = [c.tolist(), wo.tolist(), gg.tolist(),
                                ch.tolist()]
        return out


    def rejections(g, ops, b):
        from repro_torch.core import (FunctionOperator, gmres_sharded,
                                      preconditioners)
        out = {}
        tries = {
            "not_divisible": lambda: gmres_sharded(
                g, ops["dense"].a[:254, :254], b[:254], device="cpu"),
            "matrix_free": lambda: gmres_sharded(
                g, FunctionOperator(lambda v: v, b.shape[0]), b,
                device="cpu"),
            "not_shard_aware": lambda: gmres_sharded(
                g, ops["banded"], b, device="cpu",
                precond=preconditioners.banded_ilu0(ops["banded"])),
            "unknown_precond": lambda: gmres_sharded(
                g, ops["banded"], b, precond="ilu", device="cpu"),
        }
        for name, fn in tries.items():
            try:
                fn()
                out[name] = None
            except Exception as exc:   # the type is what the test checks
                out[name] = type(exc).__name__
        return out


    def jacobi(g, rank, ops, b):
        # the shard solves, the one-process solves (rank 0) and each
        # rank's rebound inv_d
        from repro_torch.core import distributed as D
        from repro_torch.core import gmres, preconditioners as P
        from repro_torch.kernels import tuning
        out = {}
        for case, fmt in JACOBI_CASES:
            r = solve(g, ops[fmt], b, "cgs2_fused", "jacobi")
            out[case] = {"x": r.x.tolist(), "restarts": int(r.restarts),
                         "converged": bool(r.converged)}
            if rank == 0:
                one = gmres(ops[fmt], b, m=M, tol=TOL, max_restarts=150,
                            gs="cgs2_fused", precond=P.jacobi(ops[fmt]))
                out[case]["one_process"] = {
                    "x": one.x.tolist(), "restarts": int(one.restarts),
                    "converged": bool(one.converged)}
            with tuning.shard_context(g):
                pc = P.jacobi(ops[fmt]).rebind(
                    D.local_operator(ops[fmt], rank, RANKS))
            out[case]["inv_d"] = pc.inv_d.tolist()
        return out


    def rank_main(rank, path, queue):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + path,
                                rank=rank, world_size=RANKS)
        g = dist.group.WORLD
        ops = operators_of()
        b = torch.from_numpy(sysz["b"])
        res = {"pieces": pieces(g, rank)}
        if rank == 0:
            res["rejections"] = rejections(g, ops, b)
        else:
            rejections(g, ops, b)
        for case, fmt, scheme, precond in CASES:
            r = solve(g, ops[fmt], b, scheme, precond)
            res[case] = {"x": r.x.tolist(), "restarts": int(r.restarts),
                         "converged": bool(r.converged)}
        res.update(jacobi(g, rank, ops, b))
        for case in COUNTED:
            _, fmt, scheme, precond = [c for c in CASES if c[0] == case][0]
            res[case]["per_step"] = counted(g, ops[fmt], b, scheme, precond)
        dist.destroy_process_group()
        queue.put((rank, res))


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        path = sys.argv[2]
        procs = [ctx.Process(target=rank_main, args=(r, path, queue))
                 for r in range(RANKS)]
        for p in procs:
            p.start()
        out = dict(queue.get(timeout=900) for _ in procs)
        for p in procs:
            p.join(timeout=60)
        print(json.dumps(out))
""")

_JAX = ("import os\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=4'\n" + _COMMON
        + textwrap.dedent("""
    from collections import Counter
    import jax
    import jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.core import (gmres_sharded, gmres_sstep_sharded,
                            operators as O)
    from repro.kernels import tuning

    mesh = make_mesh((RANKS,), ("rows",))
    banded = O.BandedOperator(jnp.asarray(sysz["bands"]), OFFSETS, "pallas")
    ell = O.SparseOperator(jnp.asarray(sysz["values"]),
                           jnp.asarray(sysz["cols"]), "pallas",
                           int(sysz["halo"]))
    ops = {"banded": banded, "ell": ell,
           "sell": O.SlicedEllOperator.from_ell(ell, slice_height=16,
                                                backend="pallas", sort=True),
           "dense": O.DenseOperator(jnp.asarray(sysz["a"]), "pallas")}
    b = jnp.asarray(sysz["b"])

    def solver(fmt, scheme, precond, **kw):
        op = ops[fmt]
        if scheme.startswith("sstep_"):
            return lambda b: gmres_sstep_sharded(
                mesh, "rows", op, b, s=S, blocks=kw.get("blocks", BLOCKS),
                tol=TOL, max_restarts=60, gs=scheme[len("sstep_"):],
                precond=precond)
        return lambda b: gmres_sharded(
            mesh, "rows", op, b, m=kw.get("m", M), tol=TOL,
            max_restarts=150, gs=scheme, precond=precond)

    KINDS = {"psum": "all_reduce", "pmax": "all_reduce",
             "all_gather": "all_gather", "ppermute": "halo"}

    def subjaxprs(eqn):
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else [v]):
                if hasattr(x, "eqns"):
                    yield x
                elif hasattr(getattr(x, "jaxpr", None), "eqns"):
                    yield x.jaxpr

    def count(jaxpr):
        # collectives of one pass of a loop body; nested while loops are
        # not entered, a scan counts times its length
        c = Counter()
        for e in jaxpr.eqns:
            kind = KINDS.get(e.primitive.name)
            if kind:
                c[kind] += 0.5 if kind == "halo" else 1
            if e.primitive.name == "while":
                continue
            mult = e.params.get("length", 1) if e.primitive.name == "scan" \\
                else 1
            for sub in subjaxprs(e):
                for k, v in count(sub).items():
                    c[k] += v * mult
        return c

    def loop_bodies(jaxpr, depth=0, out=None):
        out = [] if out is None else out
        for e in jaxpr.eqns:
            if e.primitive.name == "while":
                out.append((depth, e.params["body_jaxpr"].jaxpr))
                loop_bodies(e.params["body_jaxpr"].jaxpr, depth + 1, out)
            else:
                for sub in subjaxprs(e):
                    loop_bodies(sub, depth, out)
        return out

    def per_step(fmt, scheme, precond):
        zero = {"all_reduce": 0, "all_gather": 0, "halo": 0}
        if scheme.startswith("sstep_"):
            # restart-loop body at blocks 3 minus blocks 2: one block
            c = []
            for blocks in (2, 3):
                jp = jax.make_jaxpr(solver(fmt, scheme, precond,
                                           blocks=blocks))(b)
                c.append(count([body for d, body in loop_bodies(jp.jaxpr)
                                if d == 0][0]))
            return dict(zero, **{k: c[1][k] - c[0][k]
                                 for k in set(c[0]) | set(c[1])})
        jp = jax.make_jaxpr(solver(fmt, scheme, precond))(b)
        return dict(zero, **count([body for d, body in loop_bodies(jp.jaxpr)
                                   if d == 1][0]))

    def member(name, fmt):
        # The string members' eager setup (Chebyshev's interval, the ILU(0)
        # factors) runs here, outside the trace; the wrapper rebinds the
        # instance per shard as it rebinds the string's.
        # Chebyshev estimates its interval on the "jnp" backend: under
        # ensure_compile_time_eval the interpret-mode Pallas SpMV fails on
        # jax 0.9.0 (no evaluation rule for program_id); same storage, so
        # the same interval.
        from repro.core import preconditioners as P
        if name in (None, "block_jacobi"):
            return name
        if name == "chebyshev":
            op = ops[fmt]
            return P.chebyshev(O.BandedOperator(op.bands, op.offsets, "jnp"))
        return {"jacobi": P.jacobi,
                "banded_block_jacobi": P.banded_block_jacobi}[name](ops[fmt])

    out = {}
    for case, fmt, scheme, precond in CASES:
        if precond == "banded_block_jacobi":
            with tuning.force_kernel_mode("ref"):
                r = jax.jit(solver(fmt, scheme, member(precond, fmt)))(b)
        else:
            r = jax.jit(solver(fmt, scheme, member(precond, fmt)))(b)
        out[case] = {"x": np.asarray(r.x).tolist(),
                     "restarts": int(r.restarts),
                     "converged": bool(r.converged)}
    for case in COUNTED:
        _, fmt, scheme, precond = [c for c in CASES if c[0] == case][0]
        out[case]["per_step"] = per_step(fmt, scheme, member(precond, fmt))
    print(json.dumps(out))
"""))


def _systems(path: pathlib.Path) -> dict:
    op = stencils.convection_diffusion_2d(NX, NX, beta=(0.5, 0.25),
                                          device="cpu")
    ell = op.to_ell()
    rng = np.random.default_rng(7)
    j, k = 5, 4
    vq, _ = np.linalg.qr(rng.standard_normal((N, j + 1)))
    v = np.zeros((M + 1, N), np.float32)
    v[:j + 1] = vq.T
    bq, _ = np.linalg.qr(rng.standard_normal((N, k + 1)))
    vb = np.zeros((13, N), np.float32)
    vb[:k + 1] = bq.T
    sysz = dict(
        bands=op.bands.numpy(), offsets=np.asarray(op.offsets),
        values=ell.values.numpy(), cols=ell.cols.numpy(),
        halo=np.asarray(ell.halo),
        a=operators.random_diagdom(N, dominance=0.1, seed=0,
                                   device="cpu").numpy(),
        b=np.random.default_rng(1).standard_normal(N).astype(np.float32),
        x=rng.standard_normal(N).astype(np.float32),
        xk=rng.standard_normal((N, 3)).astype(np.float32),
        v=v, j=np.asarray(j), vb=vb,
        wb=rng.standard_normal((S, N)).astype(np.float32),
        tb=(np.eye(S) + 0.1 * rng.standard_normal((S, S))).astype(
            np.float32),
        k=np.asarray(k))
    np.savez(path, **sysz)
    return sysz


# Runs both children side by side and leaves their results (or the error)
# in results.json, written whole with one rename.
_WAITER = textwrap.dedent("""
    import json, os, subprocess, sys
    root = sys.argv[1]
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(root, name + "_child.py"),
         os.path.join(root, "systems.npz"), os.path.join(root, "gloo_group")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("gloo", "jax")}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode:
                raise RuntimeError(f"{name} child failed:\\n{stderr[-4000:]}")
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    except Exception as exc:
        out = {"error": repr(exc)}
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    with open(os.path.join(root, "results.json.tmp"), "w") as f:
        json.dump(out, f)
    os.replace(os.path.join(root, "results.json.tmp"),
               os.path.join(root, "results.json"))
""")


def _start_children() -> pathlib.Path:
    """Start the children once per session, without waiting for them; the
    directory their results will be in."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    root = pathlib.Path(tempfile.gettempdir()) / f"repro_torch_dist_{run}"
    root.mkdir(parents=True, exist_ok=True)
    try:
        os.close(os.open(root / "started", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        return root
    _systems(root / "systems.npz")
    for name, code in (("gloo", _GLOO), ("jax", _JAX)):
        (root / f"{name}_child.py").write_text(code)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    _WAITERS.append(subprocess.Popen(
        [sys.executable, "-c", _WAITER, str(root)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    return root


_WAITERS = []
_ROOT = _start_children()


@pytest.fixture(scope="module")
def runs():
    """Both children's results, read once per worker."""
    done = _ROOT / "results.json"
    deadline = time.monotonic() + 1000
    while not done.exists():
        assert time.monotonic() < deadline, "no result from the children"
        assert not (_WAITERS and _WAITERS[0].poll() is not None
                    and not done.exists()), "the waiter died"
        time.sleep(0.2)
    out = json.loads(done.read_text())
    assert "error" not in out, out.get("error")
    with np.load(_ROOT / "systems.npz") as sysz:
        out["systems"] = {k: sysz[k] for k in sysz.files}
    return out


def _dense_of(systems, fmt) -> np.ndarray:
    if fmt == "dense":
        return systems["a"].astype(np.float64)
    op = operators.BandedOperator(systems["bands"], systems["offsets"],
                                  device="cpu")
    return op.todense().numpy().astype(np.float64)


# --------------------------------------------------------------------------
# the solves: 4 gloo ranks vs JAX's 4 devices
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case,fmt,scheme,precond", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_solve_matches_jax_4_ranks(runs, case, fmt, scheme,
                                           precond):
    port = runs["gloo"]["0"][case]
    jx = runs["jax"][case]
    assert port["converged"] and jx["converged"], (port["converged"],
                                                   jx["converged"])
    assert abs(port["restarts"] - jx["restarts"]) <= 1, \
        (port["restarts"], jx["restarts"])
    b = runs["systems"]["b"].astype(np.float64)
    x = np.asarray(port["x"], np.float64)
    a = _dense_of(runs["systems"], fmt)
    relres = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    assert relres < 5e-5, relres
    xj = np.asarray(jx["x"], np.float64)
    err = np.linalg.norm(x - xj) / np.linalg.norm(xj)
    assert err < SOLVE_RTOL, err


@pytest.mark.parametrize("case", [c[0] for c in CASES + JACOBI_CASES])
def test_every_rank_returns_the_same_x(runs, case):
    xs = [runs["gloo"][str(r)][case]["x"] for r in range(RANKS)]
    assert all(x == xs[0] for x in xs[1:])


# --------------------------------------------------------------------------
# Jacobi on ELL / sliced-ELL shards: 4 gloo ranks vs one process
# --------------------------------------------------------------------------
def _inv_diag(systems) -> np.ndarray:
    return 1.0 / np.diag(_dense_of(systems, "ell"))


@pytest.mark.parametrize("case,fmt", JACOBI_CASES,
                         ids=[c[0] for c in JACOBI_CASES])
def test_sharded_jacobi_matches_one_process_4_ranks(runs, case, fmt):
    port = runs["gloo"]["0"][case]
    one = port["one_process"]
    assert port["converged"] and one["converged"]
    assert abs(port["restarts"] - one["restarts"]) <= 1, \
        (port["restarts"], one["restarts"])
    b = runs["systems"]["b"].astype(np.float64)
    x = np.asarray(port["x"], np.float64)
    a = _dense_of(runs["systems"], fmt)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 5e-5
    x1 = np.asarray(one["x"], np.float64)
    assert np.linalg.norm(x - x1) / np.linalg.norm(x1) < SOLVE_RTOL


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("case", [c[0] for c in JACOBI_CASES])
def test_sharded_jacobi_takes_the_rank_diagonal(runs, case, rank):
    got = np.asarray(runs["gloo"][str(rank)][case]["inv_d"])
    np.testing.assert_allclose(got, _inv_diag(runs["systems"])[_rows(rank)],
                               rtol=1e-6)


def test_jax_jacobi_rebind_misses_the_diagonal_past_rank_0(runs):
    """The JAX fault the port repairs (ROADMAP queue 3): rank 1's ELL shard
    holds global columns, JAX's rebind matches them against local row
    indices, finds no diagonal and guards every entry at 1 / tiny^(1/2)."""
    import jax.numpy as jnp
    from repro.core import operators as jax_ops
    from repro.core import preconditioners as jax_pc
    sysz = runs["systems"]
    vals, cols = sysz["values"], sysz["cols"]
    shard = jax_ops.SparseOperator(jnp.asarray(vals[_rows(1)]),
                                   jnp.asarray(cols[_rows(1)]), "jnp",
                                   int(sysz["halo"]))
    full = jax_ops.SparseOperator(jnp.asarray(vals), jnp.asarray(cols),
                                  "jnp", int(sysz["halo"]))
    got = np.asarray(jax_pc.jacobi(full).rebind(shard).inv_d)
    want = _inv_diag(sysz)[_rows(1)]
    assert not np.allclose(got, want, rtol=1e-2)
    assert np.all(np.abs(got) > 1e10)


@pytest.mark.parametrize("case", COUNTED)
def test_collectives_per_step_match_jax(runs, case):
    port = runs["gloo"]["0"][case]["per_step"]
    jx = runs["jax"][case]["per_step"]
    if case == "banded_mgs":
        # JAX: m + 2 psums a step (all m + 1 rows, masked); the port: j + 2
        # at step j, over the steps j = 4, 5 of the differential
        assert jx["all_reduce"] == M + 2
        assert port["all_reduce"] == ((4 + 2) + (5 + 2)) / 2
        assert (port["halo"], port["all_gather"]) == (jx["halo"],
                                                      jx["all_gather"])
        return
    assert port == jx, (port, jx)


def test_pipelined_step_pays_one_all_reduce(runs):
    """The single-reduce scheme's contract: one all-reduce per step, and
    Chebyshev's mat-vecs add halo exchanges only."""
    assert runs["gloo"]["0"]["banded_cgs2_pipelined"]["per_step"] == {
        "all_reduce": 1, "all_gather": 0, "halo": 1}
    cheb = runs["gloo"]["0"]["pc_chebyshev"]["per_step"]
    assert cheb["all_reduce"] == 3 and cheb["halo"] > 1


# --------------------------------------------------------------------------
# the per-shard pieces on 4 ranks vs slices of one process
# --------------------------------------------------------------------------
def _rows(rank):
    nl = N // RANKS
    return slice(rank * nl, (rank + 1) * nl)


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("piece,halo", [("halo_1d", 3), ("halo_2d", 5)])
def test_halo_exchange_matches_the_global_vector(runs, rank, piece, halo):
    x = runs["systems"]["x" if piece == "halo_1d" else "xk"]
    nl = N // RANKS
    pad = np.zeros((halo,) + x.shape[1:], x.dtype)
    want = np.concatenate([pad, x, pad])[rank * nl:rank * nl + nl + 2 * halo]
    got = np.asarray(runs["gloo"][str(rank)]["pieces"][piece])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", range(RANKS))
def test_cgs2_split_matches_one_process(runs, rank):
    sysz = runs["systems"]
    v, x, j = (torch.from_numpy(sysz["v"]), torch.from_numpy(sysz["x"]),
               int(sysz["j"]))
    h, w2 = ref.cgs2(v, x, ref.row_mask(v.shape[0], j))
    got_h, got_w = runs["gloo"][str(rank)]["pieces"]["cgs2_split"]
    np.testing.assert_allclose(got_h, h.numpy(), **PIECE)
    np.testing.assert_allclose(got_w, w2[_rows(rank)].numpy(), **PIECE)


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("piece", ["block_gs_pass_sharded", "single_reduce"])
def test_block_pass_sharded_matches_one_process(runs, rank, piece):
    sysz = runs["systems"]
    vb, wb, tb = (torch.from_numpy(sysz[k]) for k in ("vb", "wb", "tb"))
    k = int(sysz["k"])
    if piece == "single_reduce":
        want = block_gs.block_gs_pass_single_reduce_ref(
            vb, wb, tb, k, torch.eye(vb.shape[0]))
    else:
        want = block_gs.block_gs_pass_plain(vb, wb, tb, k)
    got = runs["gloo"][str(rank)]["pieces"][piece]
    for i, (g, w) in enumerate(zip(got, want)):
        w = w[:, _rows(rank)] if i == 1 else w
        np.testing.assert_allclose(np.asarray(g), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------------------
# rejections
# --------------------------------------------------------------------------
@pytest.mark.parametrize("what,error", [
    ("not_divisible", "ValueError"), ("matrix_free", "TypeError"),
    ("not_shard_aware", "ValueError"), ("unknown_precond", "ValueError")])
def test_sharded_entry_points_reject(runs, what, error):
    assert runs["gloo"]["0"]["rejections"][what] == error
