"""Kernel nodes of the captured training step (``TrainScan.graph_kernels``)."""


def read(ctx):
    return ctx.get("graph_kernels")
