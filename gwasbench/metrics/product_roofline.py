"""The association product's share of its roofline: the least time of the
traced cells' products (``roofline.product_least_s`` from the cell's shapes)
over the device time of the kernels that ``kernels/product/*.txt`` match.
Nothing when the trace holds no such kernel."""
from gwasbench import harness, roofline, trace


def read(run):
    if run.trace is None or not run.traced_cells:
        return None
    busy, count = trace.device_seconds_matching(run.trace, harness.kernel_patterns("product"))
    if not count or busy <= 0:
        return None
    return 100.0 * run.traced_cells * roofline.product_least_s(*run.cell_shape()) / busy
