"""The whole training step's share of the H100's float32 peak: the
operations the traced steps need (``work.step_ops`` of the counted views'
mean work) over the traced window's seconds at 67 TFLOP/s."""

from port_bench import work


def read(ctx):
    if not ctx["counts"] or ctx["window_s"] <= 0:
        return None
    ops = [work.step_ops(c, ctx["pixels"], ctx["adam_elements"])
           for c in ctx["counts"]]
    per_step = sum(ops) / len(ops)
    return 100.0 * per_step * ctx["steps"] / (ctx["window_s"]
                                              * work.FP32_FLOPS_PER_S)
