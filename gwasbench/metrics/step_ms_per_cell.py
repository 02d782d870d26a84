"""The engine step of a cell (``ScanMetrics`` ``step_s``: dispatch to the
slot's fence), over the window's cells."""


def read(run):
    if not run.window_cells:
        return None
    return 1e3 * run.delta("step_s") / run.window_cells
