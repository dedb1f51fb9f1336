"""PLANTED VIOLATIONS — private_mesh_plumbing.

A trainer-shaped module assembling its own mesh and process groups
instead of consuming a SpecLayout (axis names are non-canonical here so
that only this rule fires).
"""

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class PrivateTrainer:
    def __init__(self, n, axis):
        self.mesh = init_device_mesh("cuda", (n,), mesh_dim_names=(axis,))  # bad
        self.twin = DeviceMesh("cuda", torch.arange(n), mesh_dim_names=(axis,))  # bad
        self.group = tdist.new_group(list(range(n)))  # bad: a fresh communicator
        self.sub, _ = tdist.new_subgroups(2)  # bad
        self.rows, _ = tdist.new_subgroups_by_enumeration([[0, 1]])  # bad


def clean(layout, axes, mesh):
    # consuming a layout (or inspecting a mesh) stays clean
    named: DeviceMesh | None = None
    if isinstance(mesh, DeviceMesh):
        named = mesh
    return named, layout.group(axes)
