"""Whole-trace thermal plants: the Γ-coupled pole bank and the RC grid.

Port of the TPU kernels `repro.kernels.thermal_conv.thermal_conv` (Pallas
body `_kernel`) and `repro.kernels.thermal_conv.grid_conv` (body
`_grid_kernel`), with their plain versions (`repro.kernels.ref`'s
`thermal_conv_ref` and `grid_conv_ref`).

  * `thermal_conv` — ΔT of a Γ-coupled n-pole bank over a [T, N] power
    stream: p_eff = Γ·P, then per tile and pole
    ``state' = a·state + (1 − a)·G·p_eff`` and ΔT = Σ_poles state.  On CUDA
    tensors one launch of ``csrc/thermal_conv.cu`` (a sparse Γ walk beside
    a warp that runs the pole recurrence, `conv_tiles_per_block` tiles a
    block); on CPU tensors `thermal_conv_reference`.
  * `grid_conv` — the `GridPlant` trace: per step drive = Rth·P fanned out
    over each tile's gy×gx patch, ``substeps`` explicit-Euler 5-point
    stencil updates, readout as patch means.  On CUDA tensors one launch of
    ``csrc/grid_conv.cu``; on CPU tensors `grid_conv_reference` over the
    operators `grid_operators` builds from the same geometry.

Both wrappers count their kernel launches (``.launches``) and raise on a
failed build or launch; neither falls back to its plain version on a card.

Rounding is pinned so each kernel can equal its plain version bit for bit:
Γ·P accumulates source tile by source tile, j = 0 … N−1, one f32 FMA each
(`repro_torch.core.coupling.apply_coupling`; the CUDA kernel skips Γ's
zeros, exact zeros for finite power, and gives a row NaN where the dense
sum meets 0·inf or 0·NaN), every other multiply and add
rounds on its own (the kernels build with ``-fmad=false``), each pole's
(1 − a)·G is one f32 product, and ΔT sums the poles in order.  The grid's
adjacency products have at most two non-zero unit terms per cell, so any
summation order gives the same f32 sum.  Only the grid readout (patch
mean) may round differently from a BLAS product; it is held to 1e-5.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.coupling import apply_coupling

_MAX_POLES = 8
# the CUDA kernel's widest tile block is 16 tiles, which keeps 2,048 tiles
# to one wave of 128 blocks on an H100's 132 SMs (every tile's recurrence
# runs at once); its union list, one int per tile, sits in shared memory
_MAX_CONV_TILES = 2048
_CONV_TILE_BLOCKS = (1, 2, 4, 8, 16)   # tiles a block the kernel compiles
_MAX_GRID_CELLS = 16     # cells per tile edge (a lane's rows in registers)


# ------------------------------------------------------------ thermal_conv
def _pole_consts(decay, gain) -> tuple[np.ndarray, np.ndarray]:
    """(a, (1 − a)·G) as f32 — the constants both versions multiply by."""
    decay = np.asarray(torch.as_tensor(decay, dtype=torch.float32).cpu(),
                       np.float32)
    gain = np.asarray(torch.as_tensor(gain, dtype=torch.float32).cpu(),
                      np.float32)
    if decay.ndim != 1 or gain.shape != decay.shape:
        raise ValueError(f"decay and gain must both be [n_poles], got "
                         f"{decay.shape} and {gain.shape}")
    if not 1 <= decay.shape[0] <= _MAX_POLES:
        raise ValueError(f"thermal_conv supports 1..{_MAX_POLES} poles")
    return decay, (np.float32(1.0) - decay) * gain


def _check_conv(power, gamma, state0, n_poles: int) -> None:
    if power.ndim != 2:
        raise ValueError(f"power must be [T, N], got {tuple(power.shape)}")
    t, n = power.shape
    if t == 0 or n == 0:
        raise ValueError(f"thermal_conv: empty power trace {tuple(power.shape)}")
    if n > _MAX_CONV_TILES:
        raise ValueError(f"thermal_conv supports up to {_MAX_CONV_TILES} "
                         f"tiles, got {n}")
    for name, x, shape in (("power", power, (t, n)), ("gamma", gamma, (n, n)),
                           ("state0", state0, (n, n_poles))):
        if x is None:
            continue
        if tuple(x.shape) != shape:
            raise ValueError(f"thermal_conv: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"thermal_conv: {name} must be float32, got "
                            f"{x.dtype}")
        if x.device != power.device:
            raise ValueError(f"thermal_conv: {name} is on {x.device}, power "
                             f"on {power.device}")
        if not x.is_contiguous():
            raise ValueError(f"thermal_conv: {name} must be contiguous")


def thermal_conv(power, gamma, decay, gain, state0=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """ΔT trace of a Γ-coupled pole bank (see the module docstring).

    power [T, N], gamma [N, N], state0 [N, n_poles] (zeros if None):
    tensors or arrays, made contiguous f32 on ``power``'s device — which
    decides the route (a numpy ``power`` runs on the CPU); decay, gain
    [n_poles].  Returns (dts [T, N], final state [N, n_poles]).
    """
    power = torch.as_tensor(power, dtype=torch.float32).contiguous()
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=power.device).contiguous()
    gamma = f32(gamma)
    state0 = None if state0 is None else f32(state0)
    a, coef = _pole_consts(decay, gain)
    _check_conv(power, gamma, state0, a.shape[0])
    if power.device.type == "cpu":
        return thermal_conv_reference(power, gamma, decay, gain, state0)
    if power.device.type != "cuda":
        raise ValueError(f"thermal_conv runs on cuda or cpu, got "
                         f"{power.device}")
    return _launch_conv(power, gamma, a, coef, state0)


thermal_conv.launches = 0


def conv_tiles_per_block(n: int, sms: int = 132) -> int:
    """Tiles a block of the CUDA kernel takes at ``n`` tiles on a card of
    ``sms`` SMs: the fewest (of 1, 2, 4, 8, 16) that keep the grid to one
    block an SM — every tile's serial recurrence then runs at once, and
    fewer tiles a block mean a smaller union of Γ columns to stage (4 at
    512 tiles on an H100: 128 blocks)."""
    for tb in _CONV_TILE_BLOCKS:
        if -(-n // tb) <= sms:
            return tb
    return _CONV_TILE_BLOCKS[-1]


class _ConvConsts(ctypes.Structure):
    """Mirrors ``struct ThermalConvConsts`` in csrc/thermal_conv.cu."""

    _fields_ = [("T", ctypes.c_int), ("n", ctypes.c_int),
                ("n_poles", ctypes.c_int),
                ("decay", ctypes.c_float * _MAX_POLES),
                ("coef", ctypes.c_float * _MAX_POLES),
                ("tiles_per_block", ctypes.c_int)]


def _launch_conv(power, gamma, a, coef, state0):
    from repro_torch.kernels import _build

    lib = _build.load("thermal_conv")
    fn = lib.thermal_conv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_ConvConsts)] + [ctypes.c_void_p] * 7
    words = lib.thermal_conv_scratch_words
    words.restype = ctypes.c_int
    words.argtypes = [ctypes.c_int] * 3
    t, n = power.shape
    tb = conv_tiles_per_block(n, torch.cuda.get_device_properties(
        power.device).multi_processor_count)
    c = _ConvConsts(T=t, n=n, n_poles=a.shape[0], tiles_per_block=tb)
    for k in range(a.shape[0]):
        c.decay[k], c.coef[k] = float(a[k]), float(coef[k])
    if state0 is None:
        state0 = torch.zeros((n, a.shape[0]), dtype=torch.float32,
                             device=power.device)
    dts = torch.empty_like(power)
    state = torch.empty_like(state0)
    # the kernel's step mask, finished-block counter and union masks
    scratch = torch.empty(words(t, n, tb), dtype=torch.int32,
                          device=power.device)
    err = fn(ctypes.byref(c), power.data_ptr(), gamma.data_ptr(),
             state0.data_ptr(), dts.data_ptr(), state.data_ptr(),
             scratch.data_ptr(),
             torch.cuda.current_stream(power.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"thermal_conv kernel launch failed: cudaError_t "
                           f"{err}")
    thermal_conv.launches += 1
    return dts, state


def thermal_conv_reference(power: torch.Tensor, gamma: torch.Tensor, decay,
                           gain, state0: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `thermal_conv`: same arguments and outputs.

    Γ·P for the whole trace through `apply_coupling` (every multiply-add
    rounded once, as the kernel's fmaf, on a card too), then a Python loop
    over T in the kernel's op order.  Runs on any device; nothing on the
    main path calls it when a card is present.
    """
    a, coef = _pole_consts(decay, gain)
    _check_conv(power, gamma, state0, a.shape[0])
    dev = power.device
    a_t = torch.as_tensor(a, device=dev)
    coef_t = torch.as_tensor(coef, device=dev)
    state = (torch.zeros((power.shape[1], a.shape[0]), dtype=torch.float32,
                         device=dev) if state0 is None else state0.clone())
    p_eff = apply_coupling(gamma, power)
    dts = torch.empty_like(power)
    for s in range(power.shape[0]):
        state = a_t * state + coef_t * p_eff[s][:, None]
        dt = state[:, 0]
        for k in range(1, a.shape[0]):
            dt = dt + state[:, k]
        dts[s] = dt
    return dts, state


def thermal_conv_cost(power: torch.Tensor, gamma: torch.Tensor,
                      n_poles: int) -> dict:
    """Bytes and f32 operations `thermal_conv` must spend on these inputs.

    Bytes: power, Γ and state0 read once, dts and the final state written
    once.  Operations: Γ·P counted dense (2·N²·T) and by Γ's non-zeros
    (2·nnz·T — the work this Γ needs; the bound uses this count), plus per
    (step, tile) three per pole for the update and n_poles − 1 adds for ΔT.
    """
    t, n = power.shape
    nnz = int((gamma != 0).sum())
    iir = (3 * n_poles + n_poles - 1) * t * n
    return {"bytes": 4 * (2 * t * n + n * n + 2 * n * n_poles),
            "ops_dense": 2 * n * n * t + iir,
            "ops_nnz": 2 * nnz * t + iir}


# --------------------------------------------------------------- grid_conv
def grid_operators(gy: int, gx: int, n_tiles: int, rth) -> dict:
    """The RC grid's operators as f32 numpy arrays, from its geometry.

    ``adj_h`` [W, W] links horizontal neighbours inside a tile (no edge
    across a tile wall: the walls are adiabatic), ``adj_v`` [gy, gy] the
    vertical neighbours, ``deg`` [gy, W] each cell's neighbour count;
    ``inject`` [n_tiles, W] fans tile power out over its patch scaled by
    Rth, ``readout`` [W, n_tiles] averages a patch (1/(gy·gx) weights —
    the column sums of the grid are read through it).  W = n_tiles·gx.
    """
    w = n_tiles * gx
    adj_h = np.zeros((w, w), np.float32)
    for x in range(w - 1):
        if (x % gx) != gx - 1:
            adj_h[x, x + 1] = adj_h[x + 1, x] = 1.0
    adj_v = np.zeros((gy, gy), np.float32)
    for y in range(gy - 1):
        adj_v[y, y + 1] = adj_v[y + 1, y] = 1.0
    deg = np.asarray(adj_h.sum(0)[None, :] + adj_v.sum(0)[:, None],
                     np.float32)
    inject = np.zeros((n_tiles, w), np.float32)
    readout = np.zeros((w, n_tiles), np.float32)
    for t in range(n_tiles):
        inject[t, t * gx:(t + 1) * gx] = rth
        readout[t * gx:(t + 1) * gx, t] = 1.0 / (gy * gx)
    return dict(adj_h=adj_h, adj_v=adj_v, deg=deg, inject=inject,
                readout=readout)


def _check_grid(power, ghat, deg, state0, gy: int, gx: int,
                substeps: int) -> None:
    if power.ndim != 2 or 0 in power.shape:
        raise ValueError(f"power must be a non-empty [T, n_tiles], got "
                         f"{tuple(power.shape)}")
    if gy != gx or not 2 <= gy <= _MAX_GRID_CELLS:
        raise ValueError(f"grid_conv supports square tile patches of "
                         f"2..{_MAX_GRID_CELLS} cells a side (GridPlant's "
                         f"grid_cells), got {gy}x{gx}")
    if substeps < 1:
        raise ValueError("grid_conv: substeps must be >= 1")
    shape = (gy, power.shape[1] * gx)
    for name, x in (("power", power), ("ghat", ghat), ("deg", deg),
                    ("state0", state0)):
        if name != "power" and tuple(x.shape) != shape:
            raise ValueError(f"grid_conv: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"grid_conv: {name} must be float32, got "
                            f"{x.dtype}")
        if x.device != power.device:
            raise ValueError(f"grid_conv: {name} is on {x.device}, power on "
                             f"{power.device}")
        if not x.is_contiguous():
            raise ValueError(f"grid_conv: {name} must be contiguous")


def grid_conv(power: torch.Tensor, ghat: torch.Tensor, deg: torch.Tensor,
              state0: torch.Tensor, *, gy: int, gx: int, rth: float,
              r: float, kappa: float, substeps: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RC-grid plant over a [T, n_tiles] power stream.

    ``ghat``/``deg``/``state0`` are [gy, n_tiles·gx] f32 (the plant's
    vertical-conductance map, neighbour counts and initial cell
    temperatures); ``rth``, ``r`` and ``kappa`` are the plant's f32
    constants.  The kernel derives the stencil, the tile fan-out and the
    readout from (gy, gx, n_tiles).  Returns (dts [T, n_tiles], final
    state [gy, n_tiles·gx]).
    """
    _check_grid(power, ghat, deg, state0, gy, gx, substeps)
    if power.device.type == "cpu":
        ops = grid_operators(gy, gx, power.shape[1], np.float32(rth))
        return grid_conv_reference(
            power, torch.from_numpy(ops["adj_h"]),
            torch.from_numpy(ops["adj_v"]), deg, ghat,
            torch.from_numpy(ops["inject"]), torch.from_numpy(ops["readout"]),
            state0, r=r, kappa=kappa, substeps=substeps)
    if power.device.type != "cuda":
        raise ValueError(f"grid_conv runs on cuda or cpu, got {power.device}")
    return _launch_grid(power, ghat, deg, state0, gy, gx, rth, r, kappa,
                        substeps)


grid_conv.launches = 0


class _GridConsts(ctypes.Structure):
    """Mirrors ``struct GridConvConsts`` in csrc/grid_conv.cu."""

    _fields_ = ([(k, ctypes.c_int) for k in ("T", "n_tiles", "g",
                                              "substeps")]
                + [(k, ctypes.c_float) for k in ("rth", "r", "kappa",
                                                  "inv_cells")])


def _launch_grid(power, ghat, deg, state0, gy, gx, rth, r, kappa, substeps):
    from repro_torch.kernels import _build

    fn = _build.load("grid_conv").grid_conv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_GridConsts)] + [ctypes.c_void_p] * 7
    t, nt = power.shape
    c = _GridConsts(T=t, n_tiles=nt, g=gy, substeps=substeps,
                    rth=float(np.float32(rth)), r=float(np.float32(r)),
                    kappa=float(np.float32(kappa)),
                    inv_cells=float(np.float32(1.0 / (gy * gx))))
    dts = torch.empty_like(power)
    state = torch.empty_like(state0)
    err = fn(ctypes.byref(c), power.data_ptr(), ghat.data_ptr(),
             deg.data_ptr(), state0.data_ptr(), dts.data_ptr(),
             state.data_ptr(),
             torch.cuda.current_stream(power.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid_conv kernel launch failed: cudaError_t "
                           f"{err}")
    grid_conv.launches += 1
    return dts, state


def grid_conv_reference(power, adj_h, adj_v, deg, ghat, inject, readout,
                        state0, *, r: float, kappa: float, substeps: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the grid kernel, on the reference's operands.

    Op for op `repro.kernels.ref.grid_conv_ref`: the stencil as two
    adjacency products minus the degree term, injection and readout as
    products with ``inject`` and ``readout``.  On a card the products run
    in full f32 (PyTorch's default matmul precision, never TF32).  Returns
    (dts [T, n_tiles], final state [gy, W]).
    """
    dev = power.device
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    adj_h, adj_v, deg, ghat = f(adj_h), f(adj_v), f(deg), f(ghat)
    inject, readout = f(inject), f(readout)
    r, kappa = float(np.float32(r)), float(np.float32(kappa))
    state = f(state0).clone()
    drive = power @ inject                                  # [T, W]
    dts = torch.empty_like(power)
    for s in range(power.shape[0]):
        d = drive[s][None, :]
        for _ in range(substeps):
            lap = adj_v @ state + state @ adj_h - deg * state
            state = state + r * (d - ghat * state + kappa * lap)
        dts[s] = (state.sum(0, keepdim=True) @ readout)[0]
    return dts, state


def grid_conv_cost(t: int, n_tiles: int, gy: int, gx: int,
                   substeps: int) -> dict:
    """Bytes and f32 operations `grid_conv` must spend.

    Bytes: power, ghat, deg and state0 read once, dts and the final state
    written once.  Operations per step: one multiply per tile for the
    drive; per cell and substep the stencil's neighbour adds (one per
    edge end), the degree product, and the six operations of the Euler
    update; the readout's gy·gx adds and multiplies per tile.
    """
    cells = gy * n_tiles * gx
    w = n_tiles * gx
    edges = 2 * ((gy - 1) * w + gy * n_tiles * (gx - 1))   # ordered pairs
    per_sub = edges - cells + 2 * cells + 6 * cells
    per_step = n_tiles + substeps * per_sub + 2 * cells
    return {"bytes": 4 * (t * n_tiles * 2 + 4 * cells),
            "ops": per_step * t}
