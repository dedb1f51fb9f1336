"""Canonical parallelism-axis names, kept as a copy of
``tpu_syncbn.mesh_axes`` so the port never imports the JAX package.

In the port a data-parallel "axis" is a ``torch.distributed`` process
group; the names stay so logs, configs and later multi-axis layouts
(``torch.distributed.device_mesh``) speak the same vocabulary as the
reference.
"""

#: Data-parallel axis: the recipe's process group of N single-GPU workers.
DATA_AXIS = "data"

#: Tensor (model) parallel axis.
MODEL_AXIS = "model"

#: Fully-sharded-data-parallel axis.
FSDP_AXIS = "fsdp"

#: Pipeline-parallel stage axis.
PIPE_AXIS = "pipe"

#: Expert-parallel axis.
EXPERT_AXIS = "expert"

#: Sequence/context-parallel axis.
SEQ_AXIS = "seq"

#: Every axis name, in layout order (data-like outermost).
ALL_AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS, EXPERT_AXIS,
            SEQ_AXIS)
