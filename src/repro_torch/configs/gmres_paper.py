"""The paper's own experiment config: dense nonsymmetric systems,
N = 1000..10000, restarted GMRES(m=30), four offload strategies.

The port's own copy of ``repro/configs/gmres_paper.py``; ``chip_smoke.py``
runs the strategies at a subset of these sizes."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GmresExperiment:
    sizes: tuple = (1_000, 2_000, 3_000, 4_000, 5_000,
                    6_000, 7_000, 8_000, 9_000, 10_000)
    restart_m: int = 30
    tol: float = 1e-6
    max_restarts: int = 50
    strategies: tuple = ("serial_numpy", "offload_matvec",
                         "transfer_per_call", "device_resident")
    # distributed extension (beyond the paper's 2 GB wall)
    sharded_sizes: tuple = (16_384, 65_536)


CONFIG = GmresExperiment()
