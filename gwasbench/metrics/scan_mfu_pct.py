"""The whole scan's share of the cards' peak: the product FLOPs (2 M N P) of
the cells delivered in the traced span over that span and the run's cards
at 989 TFLOP/s."""
from gwasbench import roofline


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.traced_cells:
        return None
    return 100.0 * run.traced_flops / run.trace.window_s / (roofline.PEAK_FLOPS * run.cell.chips)
