"""The host epilogue of a cell (``ScanMetrics`` ``extract_s``: the pulls, the
hit extraction and the canonical refine), over the window's cells."""


def read(run):
    if not run.window_cells:
        return None
    return 1e3 * run.delta("extract_s") / run.window_cells
