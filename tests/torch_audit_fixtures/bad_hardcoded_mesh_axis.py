"""PLANTED VIOLATIONS — hardcoded_mesh_axis.

A mesh-axis name spelled as a string literal in each position the rule
covers, outside tpu_syncbn_torch/mesh_axes.py.
"""

from torch.distributed.device_mesh import init_device_mesh

from tpu_syncbn_torch.parallel.layout import P, SpecLayout


def build_mesh(n):
    # literal axis name as init_device_mesh's mesh_dim_names
    return init_device_mesh("cuda", (n,), mesh_dim_names=("data",))  # bad  # audit: ok[private_mesh_plumbing]


def batch_spec():
    return P("data")  # bad: a spec argument


def axis_group(mesh, layout):
    g = mesh["fsdp"]  # bad: a mesh[...] index
    return g, layout.group("model")  # bad: SpecLayout.group's axis


def gather(x, axis_name="fsdp"):  # bad: the default of axis_name
    return x, axis_name


SHARD_AXIS = "fsdp"  # bad: a private *_AXIS constant


def zero_layout(mesh):
    return SpecLayout(mesh, param_shard_axis="data")  # bad: the keyword


def clean(mesh, x, axis):
    # non-axis uses of the same words stay clean: dict keys, metric
    # families, byte strings
    table = {"data": 1, "model": 2}
    _ = x[b"data"] if isinstance(x, dict) else None
    return table, mesh[axis]
