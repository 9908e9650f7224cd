"""What the fleet cells' readers share: the traced flushes and the work
of one flush's `fleet_step` window."""
from portbench.counts import fleet_step
from portbench.reference.fleet_v24 import coupling_matrix


def traced_flushes(ctx) -> int:
    return len(ctx.trace.spans_named("portbench.run_block"))


def window_cost(ctx) -> tuple[int, int]:
    """(bytes, operations) of one flush's kernel window."""
    s = ctx.config["scheduler"]
    nnz = 0
    if s["use_coupling"] and s["n_tiles"] > 1:
        nnz = int((coupling_matrix(s["n_tiles"], s["coupling_cols"],
                                   s["coupling_bands"]) != 0).sum())
    return fleet_step.cost(ctx.traffic["flush"], s["n_tiles"],
                           ctx.traffic["packages"],
                           window=s["filtration_window"],
                           gamma_nonzeros=nnz)
