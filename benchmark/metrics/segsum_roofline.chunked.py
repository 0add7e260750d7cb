"""segsum_roofline.chunked: share (%) of its bound that the ordered
segment sum reaches: the least time of every `segment_sum` call of the
window on an H100 (stats.segment_bound per call) / all device time
launched inside the calls' ranges."""


def read(ctx):
    if ctx.kind != "chunked" or ctx.trace is None or ctx.bounds is None:
        return None
    dev_s = ctx.trace["span_device_s"].get("bench.segsum", 0.0)
    if dev_s <= 0:
        return None
    return 100.0 * ctx.bounds[1] / 1e3 / dev_s
