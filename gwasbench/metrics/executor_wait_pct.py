"""The share of the slot threads' window spent waiting on the executor
instead of driving a card: the window's ``claim`` (a worker getting its next
item), ``batch_wait`` (its decoded batch not yet landed) and ``tail_wait``
(its slot tail full) span totals, over the window's length times the cards.
None where the program records no ``claim`` spans (an untraced run, the
serial executor, a program without the executor's spans)."""
from gwasbench import spans

WAITS = ("claim", "batch_wait", "tail_wait")


def read(run):
    if spans.delta(run, "claim", "n") <= 0 or run.seconds <= 0:
        return None
    return 100.0 * sum(spans.delta(run, name) for name in WAITS) / (run.seconds * run.cell.chips)
