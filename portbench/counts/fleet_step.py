"""Work of one `fleet_step` window (the fused v24 scheduler step over
[T, tiles, n]), counted from the kernel's code: adds, multiplies,
divisions, compares, min/max and pow count 1, an FMA 2; each Γ mat-vec 2
per non-zero of Γ, four a step for coupled v24 (hint, load floor,
neighbour heat, plant).  Bytes: ρ, the ring, the pole states, the three
sliding sums, f, the events and Γ read once; temperature and frequency
traces, the ring, the pole states, f and events written once.  Products in
f32 on the CUDA cores."""

PRECISION = "f32"


def cost(t: int, n_tiles: int, n: int, *, window: int = 16,
         n_poles: int = 2, gamma_nonzeros: int = 0) -> tuple[int, int]:
    """(bytes, operations) of a homogeneous v24 window without the
    fallback, pin or heterogeneous planes."""
    q = max(window // 4, 1)
    ew = 9 + (3 * window + q) / window + 5 + (n_poles - 1) + 3 \
        + 4 * n_poles + 1 + 1
    ew += 6 + 5 + 3 + 1 + 3 + 5 + (13 if gamma_nonzeros else 0)
    ops = ew * t * n_tiles * n + 4 * 2 * gamma_nonzeros * t * n
    plane = n_tiles * n
    floats = (t * plane + window * plane + n_poles * plane + 3 * plane
              + plane + n + (n_tiles * n_tiles if gamma_nonzeros else 0)
              + 2 * t * plane + window * plane + n_poles * plane + n)
    return 4 * floats, int(ops)
