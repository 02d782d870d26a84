"""``ScanPlan.prepare()`` on the host clock, ended by a synchronise: the
panel's covariate residualization and standardization, the step's build."""


def read(run):
    return run.prepare_s
