"""The multi-device layer of the port, counterpart of ``pai_tpu/parallel``:
one process per rank (``torchrun --nproc-per-node N``), a ``DeviceMesh``
``('dp', 'tp'[, 'sp'])`` over them, data parallelism with global-batch
BatchNorm and gradient averaging, tensor parallelism by output-channel
split convolutions, FSDP2 parameter sharding and exact ring attention over
the flash kernels. The same names as the JAX package's."""

from pai_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    place_replicated,
)
from pai_tpu_torch.parallel.partitioning import (
    tp_spec_for_leaf,
    fsdp_spec_for_leaf,
    shard_tree_for_tp,
    shard_state,
)
