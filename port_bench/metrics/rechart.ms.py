"""Mean milliseconds of the traced window's re-charts (``rechart_step``), on
the host clock with a synchronize on both sides."""


def read(ctx):
    recharts = ctx["recharts"]
    return 1e3 * sum(recharts) / len(recharts) if recharts else None
