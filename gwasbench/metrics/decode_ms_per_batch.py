"""Host preparation of a marker batch (``ScanMetrics`` ``decode_s``: the
packed-slab read behind ``prepare_batch``), over the window's batches."""


def read(run):
    if not run.window_batches:
        return None
    return 1e3 * run.delta("decode_s") / run.window_batches
