"""The benchmark's frozen work counts against the port's own cost
functions at the cells' shapes."""
import pytest

from portbench.counts import fleet_step
from portbench.reference.fleet_v24 import coupling_matrix

torch = pytest.importorskip("torch")

BANDS = dict(self=1.0, vertical=0.8, lateral=0.275, distant=0.07)


def test_fleet_step_count_at_the_stream_window():
    """[256, 47, 4,096]: 622.2 MB and 10.117 GFLOP, as the kernel table."""
    nnz = int((coupling_matrix(47, 7, BANDS) != 0).sum())
    nbytes, ops = fleet_step.cost(256, 47, 4096, gamma_nonzeros=nnz)
    assert round(nbytes / 1e6, 1) == 622.2
    assert round(ops / 1e9, 3) == 10.117


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_fleet_step_count_matches_the_port(n):
    from repro_torch.core.scheduler import SchedulerConfig, ThermalScheduler
    from repro_torch.fleet.backends.fused import FusedBackend
    from repro_torch.kernels.fleet_step import fleet_step_cost
    sched = ThermalScheduler(SchedulerConfig(n_tiles=47, mode="v24"),
                             device="cpu")
    be = FusedBackend(sched)
    rho = torch.empty((256, 47, n), device="meta")
    nnz = int((sched.gamma != 0).sum())
    assert fleet_step.cost(256, 47, n, gamma_nonzeros=nnz) == \
        fleet_step_cost(rho, sched.gamma, be.params)
