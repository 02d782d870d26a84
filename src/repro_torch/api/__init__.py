"""The composable public API: bind -> plan -> execute -> emit.

    from repro_torch.api import Study, GridSpec, TsvWriter

    study = Study.from_files("cohort_chr*.bed", "panel.tsv", covar="covars.tsv")
    plan = study.plan(engine="fused", grid=GridSpec(trait_block=2048))
    session = plan.run()                       # amortized setup happens here
    summary = session.stream_to(TsvWriter("results/"))

``study.plan(..., device="cpu")`` runs on the CPU; the default is ``cuda``.

    bind     ``Study``       file opening, table alignment
    plan     ``Study.plan``  typed specs validated and normalized into the
                             internal ``ScanConfig``
    execute  ``ScanSession`` the streaming grid executor; ``events()``
                             yields per-cell ``CellResult``s, checkpoint/
                             resume included
    emit     ``ResultWriter`` registry; ``"tsv"`` and ``"npz"`` built in,
                             ``"parquet"`` when pyarrow is available
"""
from repro_torch.api.metrics import CellTiming, ScanMetrics
from repro_torch.api.session import (
    CellResult,
    CheckpointReplay,
    PreparedScan,
    ScanPlan,
    ScanSession,
    SerialExecutor,
)
from repro_torch.api.specs import (
    ExecSpec,
    GridSpec,
    IOSpec,
    LmmSpec,
    ScanConfig,
    ServeSpec,
)
from repro_torch.api.study import Study
from repro_torch.api.writers import (
    NpzShardWriter,
    ResultWriter,
    TsvWriter,
    available_writers,
    get_writer,
    register_writer,
    stream_session,
)

__all__ = [
    "Study",
    "GridSpec",
    "LmmSpec",
    "IOSpec",
    "ExecSpec",
    "ServeSpec",
    "ScanConfig",
    "ScanPlan",
    "ScanSession",
    "SerialExecutor",
    "PreparedScan",
    "CellResult",
    "CheckpointReplay",
    "CellTiming",
    "ScanMetrics",
    "ResultWriter",
    "TsvWriter",
    "NpzShardWriter",
    "register_writer",
    "get_writer",
    "available_writers",
    "stream_session",
]
