"""Deterministic deposition of per-parcel values into their cells, the
scatter-add of the Lagrangian clouds' sources (`solvers.particles`).

The JAX package deposits with `.at[flat].add`, which adds a cell's parcels
in parcel order from zero on its CPU backend, and so does `index_add_` on a
CPU tensor: that is the plain version here.  On the card `index_add_` adds
by atomics, in another order each run.  `deposit` instead sorts the parcels
by cell with a stable sort (parcel order kept within a cell) and launches
`deposit_f32` / `deposit_f64` from csrc/deposit.cu, which sums each
occupied cell's run of parcels in parcel order from zero: the card's sums
equal the CPU's bit for bit for equal inputs.  A parcel whose every value
is zero (an inactive one: its terms are 0 times a value) is sorted out of
the runs, past the last cell, where the kernel skips it: a signed zero
added to a sum that starts from +0 changes no bit, and a long run of
escaped parcels clamped into a boundary cell costs nothing.  The wrapper
counts its launches in `deposit.launches`.
"""
from __future__ import annotations

import torch

from .launch import launch


def deposit_reference(values, flat, ncell):
    """Plain version: (k, ncell) sums of the rows of values (k, n) into the
    cells flat (n,), each cell's parcels added in parcel order from zero
    (`index_add_` on the CPU)."""
    return torch.stack([
        torch.zeros(ncell, dtype=values.dtype,
                    device=values.device).index_add_(0, flat, v)
        for v in values])


def deposit(values, flat, ncell):
    """(k, ncell) sums of the rows of values (k, n), float32 or float64, into
    the cells flat (n,) int64: each cell's parcels added in parcel order
    from zero.  A CPU tensor takes `deposit_reference`; a CUDA one the
    kernel (one launch for all k rows; none for no parcel)."""
    if values.ndim != 2 or flat.shape != values.shape[1:]:
        raise ValueError(f"deposit: values {tuple(values.shape)} and cells "
                         f"{tuple(flat.shape)} do not pair")
    if values.dtype not in (torch.float32, torch.float64) \
            or flat.dtype != torch.int64 or flat.device != values.device:
        raise TypeError("deposit: float32/float64 values and int64 cells "
                        "on one device")
    dev = values.device
    if dev.type == "cpu":
        return deposit_reference(values, flat, ncell)
    if dev.type != "cuda":
        raise ValueError(f"deposit: no kernel for device {dev}")
    k, n = values.shape
    out = torch.zeros((k, ncell), dtype=values.dtype, device=dev)
    if n == 0 or k == 0:
        return out
    values = values.contiguous()
    key = torch.where((values != 0).any(dim=0), flat, ncell)
    order = torch.argsort(key, stable=True)
    cells = key[order].contiguous()
    launch(deposit, "deposit_f32" if values.dtype == torch.float32
           else "deposit_f64", values, n, k, order, cells, out, ncell,
           like=values)
    return out


deposit.launches = 0
