"""FLOP and parameter counting, counterpart of ``pai_tpu/utils/flops.py``.

Parameters are counted by summing ``numel`` over the module's parameters
(buffers such as BatchNorm running statistics are not parameters, as in the
JAX package's ``params`` tree). FLOPs come from PyTorch's own
``torch.utils.flop_counter.FlopCounterMode`` over one real forward: it counts
two operations per multiply-add of every convolution and matrix product and
nothing for elementwise work, so it will not equal what XLA's cost model
reports for the JAX package on the same network.

``FlopCounterMode`` cannot see into a ``ctypes`` launch. A hand-written kernel
that does matrix products (flash attention: ``4*B*H*T*T*D`` per launch, the
figure the JAX package's kernel declares as its cost) adds them to
``kernels.launched_flops`` where it launches; ``count_flops`` zeroes that
before the forward and adds it after. On the CPU the same function runs as
plain matrix products, which ``FlopCounterMode`` counts itself, to the same
total.
"""

from __future__ import annotations

import torch

from pai_tpu_torch import kernels


def parameter_count(module: torch.nn.Module) -> int:
    return sum(int(p.numel()) for p in module.parameters())


def count_flops(fn, *args) -> int:
    """Total FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    kernels.launched_flops = 0
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops()) + kernels.launched_flops
