"""k1s_roofline.chunked: share (%) of its bound that the association
search reaches: the least time of every `hamming_search` call of the
window on an H100 (stats.search_bound of the call's own inputs) / all
device time launched inside the calls' ranges."""


def read(ctx):
    if ctx.kind != "chunked" or ctx.trace is None or ctx.bounds is None:
        return None
    dev_s = ctx.trace["span_device_s"].get("bench.k1s", 0.0)
    if dev_s <= 0:
        return None
    return 100.0 * ctx.bounds[0] / 1e3 / dev_s
