"""Device-mesh construction helpers.

Axis convention (SURVEY.md §5.8):
  - ``data``: read pairs / barcode groups — the outermost data-parallel
    axis; maps to the device interconnect within a host, the network
    across hosts.
  - ``cand``: per-read candidate windows (seed-hit expansion slots) — a
    model-parallel-like axis that splits the SW scoring work for one read
    across chips; combined with an all-gather argmax.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
CAND_AXIS = "cand"


def mesh_axes() -> tuple:
    return (DATA_AXIS, CAND_AXIS)


def make_mesh(n_data: Optional[int] = None, n_cand: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'cand') mesh over ``devices`` (default: all).

    With only ``devices`` given, uses all of them on the data axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_cand
    if n_data * n_cand != n:
        raise ValueError(f"mesh {n_data}x{n_cand} != {n} devices")
    arr = np.asarray(devices).reshape(n_data, n_cand)
    return Mesh(arr, (DATA_AXIS, CAND_AXIS))


def factor_devices(n: int) -> tuple:
    """Pick a (n_data, n_cand) split for n devices: cand=2 when even."""
    if n % 2 == 0 and n >= 4:
        return n // 2, 2
    return n, 1
