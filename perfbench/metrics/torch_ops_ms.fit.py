"""Frame set-up and autograd: device ms per step of every operation that is not
one of the port's CUDA kernels (PyTorch's elementwise, index, reduction,
copy and set operations, the loss and Adam included)."""

from perfbench import layers, spec


def read(ctx):
    return layers.mean_ms(ctx, None, exclude=spec.metric_data("torch_ops_ms.fit")["port_kernels"])
