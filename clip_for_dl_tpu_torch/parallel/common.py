"""The 2-D ``(data, model)`` layout of a process group's ranks (counterpart
of ``clip_for_dl_tpu.parallel.common.create_2d_mesh``).

The JAX mesh puts the regime axis innermost: device d sits at data index
d // degree and model index d % degree, so the per-layer collectives of
tensor parallelism run between neighbouring devices and the once-a-step
gradient average between the slices. Here the devices are the ranks of
the ``torch.distributed`` group, one device each, in the same order:
rank r is at data index r // degree and model index r % degree.

:func:`create_2d_mesh` builds the subgroups: for every data index the
ranks of its slice (the ``model`` group: the ranks that share a batch slice
and split the towers), for every model index the ranks across slices (the
``data`` group: BatchNorm statistics, the contrastive losses' gathers and
the gradient average run over it). ``dist.new_group`` is collective, so
every rank creates every subgroup, model groups first, in the same order.
Without a process group the layout has one rank and no subgroups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_grid(world: int, degree: int, name: str = MODEL_AXIS) -> np.ndarray:
    """[world // degree, degree] rank numbers, the regime axis innermost
    (the JAX mesh's device grid); raises with the JAX message when
    ``degree`` does not divide ``world``."""
    if degree < 1 or world % degree:
        raise ValueError(f"{world} devices do not split into {name}={degree}")
    return np.arange(world).reshape(world // degree, degree)


@dataclass
class Mesh2D:
    """This rank's place in the ``(data, <axis>)`` grid, and its two
    subgroups (None without a process group)."""

    grid: np.ndarray
    axis_names: Tuple[str, str]
    rank: int
    data_group: Optional[object]
    model_group: Optional[object]

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: int(self.grid.shape[0]),
                self.axis_names[1]: int(self.grid.shape[1])}

    @property
    def data_size(self) -> int:
        return int(self.grid.shape[0])

    @property
    def model_size(self) -> int:
        return int(self.grid.shape[1])

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    def generator(self, seed: int, device) -> torch.Generator:
        """A dropout generator seeded by ``seed`` and this rank's data index:
        the ranks of one data slice draw the same masks over their shared
        activations (and the same attention seeds for their rows), the
        slices each their own."""
        return torch.Generator(device).manual_seed(int(seed) + self.data_index)


def create_2d_mesh(degree: int, axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
                   num_devices: Optional[int] = None) -> Mesh2D:
    """The ``(data, <axis>)`` layout of the process group with ``degree``
    ranks along the inner axis. ``num_devices`` must not exceed the ranks
    in the group (the JAX message), and a mesh covers every rank of it."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    n = world if num_devices is None else int(num_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, {world} visible")
    if n < world:
        raise ValueError(f"a mesh of {n} devices leaves {world - n} ranks of the group out")
    grid = rank_grid(n, degree, axis_names[1])
    if not distributed:
        return Mesh2D(grid, tuple(axis_names), 0, None, None)
    rank = dist.get_rank()
    model_group = data_group = None
    for row in grid:  # every rank creates every subgroup, in one order
        g = dist.new_group([int(r) for r in row])
        if rank in row:
            model_group = g
    for col in grid.T:
        g = dist.new_group([int(r) for r in col])
        if rank in col:
            data_group = g
    return Mesh2D(grid, tuple(axis_names), rank, data_group, model_group)
