"""The fused front-end kernel's share of its roofline in the traced window:
the least time of the front-end work of the ready rows folded there (the
larger of its bytes at the memory rate and its operations at their route's
peak, by the yardstick) over the device time of the kernel
(``fused_log_mel``) there. Rows computed but not ready are not work."""

from benchmark.tracing import kernel_seconds


def read(run):
    c, s = run.counters, run.tracer.summary
    t = kernel_seconds(s, "fused_log_mel") if s else 0.0
    if not c.get("traced_rows") or t <= 0:
        return None
    return 100.0 * c["traced_rows"] * c["row_bound_s"] / t
