"""Process start to the window's start (host clock): imports, kernel loads
(and builds, on a checkout's first run), the seeded cohort, bind,
``prepare`` and the first cell on every card."""


def read(run):
    return run.setup_s
