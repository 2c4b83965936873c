"""device_idle_pct: 100 less the union of the device records (kernels,
copies, memsets) in torch.profiler's trace, as a share of the traced
window's wall time."""


def read(ctx):
    if not ctx["device_ops"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
