"""Frame set-up and autograd: device ms per step of every operation that is not
one of the port's CUDA kernels (PyTorch's elementwise, index, reduction,
copy and set operations, the loss and Adam included) nor, over several
cards, one of NCCL's all-reduce kernels."""

from perfbench import layers, spec


def read(ctx):
    data = spec.metric_data("torch_ops_ms.fit")
    return layers.mean_ms(ctx, None, exclude=data["port_kernels"] + data["collectives"])
