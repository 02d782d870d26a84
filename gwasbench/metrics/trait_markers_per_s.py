"""Marker x trait tests of every cell completed inside the window, over the
window's length (host clock); cells still in flight at its close are not
counted."""


def read(run):
    return run.window_tests / run.seconds if run.seconds > 0 else None
