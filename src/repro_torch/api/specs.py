"""Typed scan specifications — the *plan* layer of the public API.

``ScanConfig`` grew one flag at a time into a 24-field sprawl where grid
geometry, engine selection, mixed-model knobs, IO tuning, and output policy
all share one namespace.  The public surface groups them into typed specs:

    GridSpec   the 2-D scan-grid geometry (batch/block sizes, compute tiles)
    LmmSpec    mixed-model knobs (engine="lmm" only; rejected elsewhere)
    IOSpec     host pipeline tuning (prefetch depth, decode workers, spill)
    ExecSpec   the executor: device count, cell placement policy, lease size

``Study.plan(...)`` validates a spec combination and *normalizes* it into a
``ScanConfig`` — the single internal currency.  Its field set, and so its
checkpoint fingerprint payload, matches the ``repro`` package's: a scan
checkpointed by either package resumes in the other.  The port adds one
field, ``device``, which stays out of the fingerprint like ``devices``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.association import AssocOptions
from repro_torch.runtime.scheduler import PLACEMENTS

__all__ = ["GridSpec", "LmmSpec", "IOSpec", "ExecSpec", "ServeSpec", "ScanConfig"]


@dataclass(frozen=True)
class GridSpec:
    """Geometry of the 2-D (marker-batch x trait-block) scan grid.

    ``trait_block=0`` is the unblocked degenerate grid (one block spanning
    the panel).  ``block_m``/``block_n``/``block_p`` are the device compute
    tiles; trait blocks are rounded up to multiples of ``block_p`` so every
    decomposition computes identical GEMM tiles (DESIGN.md §10).
    """

    batch_markers: int = 4096
    trait_block: int = 0
    block_m: int = 256
    block_n: int = 512
    block_p: int = 256
    panel_resident_blocks: int = 4

    def validate(self) -> None:
        for name in ("batch_markers", "block_m", "block_n", "block_p"):
            if getattr(self, name) <= 0:
                raise ValueError(f"GridSpec.{name} must be positive, got {getattr(self, name)}")
        if self.trait_block < 0:
            raise ValueError(f"GridSpec.trait_block must be >= 0, got {self.trait_block}")
        if self.panel_resident_blocks < 1:
            raise ValueError(
                f"GridSpec.panel_resident_blocks must be >= 1, got {self.panel_resident_blocks}"
            )


@dataclass(frozen=True)
class LmmSpec:
    """Mixed-model wing knobs (DESIGN.md §9); only valid with engine="lmm"."""

    loco: bool = False
    grm_method: str = "std"        # "std" (GCTA) | "centered" (EMMAX)
    grm_batch_markers: int = 4096
    delta: float | None = None     # pin se^2/sg^2 (skips the REML fit)
    epilogue: str = "dense"        # "dense" XLA | "fused" Pallas t-stat

    def validate(self) -> None:
        if self.grm_method not in ("std", "centered"):
            raise ValueError(f"unknown grm_method {self.grm_method!r}")
        if self.epilogue not in ("dense", "fused"):
            raise ValueError(f"unknown lmm epilogue {self.epilogue!r}")
        if self.grm_batch_markers <= 0:
            raise ValueError(f"LmmSpec.grm_batch_markers must be positive")


@dataclass(frozen=True)
class IOSpec:
    """Host-side pipeline tuning.  None of these enter the checkpoint
    fingerprint — elastic restarts may retune them freely."""

    prefetch_depth: int = 3
    io_workers: int = 2
    spill_dir: str | None = None       # HitSink spill location (None: in RAM)
    hit_spill_rows: int = 2_000_000
    # H2D staging currency (DESIGN.md §17): "auto" stages raw 2-bit PLINK
    # bytes with device-side decode whenever the source supports it (16x
    # less transfer, bitwise-identical output), "dense" forces decoded
    # float32, "packed" demands the packed path (raises if unavailable).
    genotype_staging: str = "auto"
    packed_cache_mb: int = 256         # shared packed-slab LRU budget

    def validate(self) -> None:
        if self.prefetch_depth < 1 or self.io_workers < 1:
            raise ValueError("IOSpec.prefetch_depth and io_workers must be >= 1")
        if self.hit_spill_rows < 1:
            raise ValueError("IOSpec.hit_spill_rows must be >= 1")
        if self.genotype_staging not in ("auto", "packed", "dense"):
            raise ValueError(
                f"IOSpec.genotype_staging must be auto|packed|dense, "
                f"got {self.genotype_staging!r}"
            )
        if self.packed_cache_mb < 0:
            raise ValueError("IOSpec.packed_cache_mb must be >= 0")


@dataclass(frozen=True)
class ExecSpec:
    """The executor layer (DESIGN.md §12): how many devices drain the scan
    grid and which staged array each one optimizes for reuse.

    Like ``IOSpec``, nothing here enters the checkpoint fingerprint — the
    grid decomposition is device-topology-free, so a scan checkpointed
    under one device count resumes under any other (elastic restarts), and
    results are bitwise-identical either way.
    """

    devices: int = 1               # executor slots; 0 = every visible device
    placement: str = "marker-major"  # lease locality: genotype- vs panel-reuse
    # Work items leased per scheduler claim.  The scheduler caps this at
    # n_items / n_devices so a short scan still spreads over every slot.
    lease_batches: int = 2
    # Scheduler backend (DESIGN.md §14): "threads" keeps the lease table
    # in-process; "shared-fs" puts it on the shared filesystem next to the
    # checkpoint (requires checkpoint_dir), letting N independent processes
    # on as many hosts drain one grid elastically.
    backend: str = "threads"
    host_id: str | None = None     # lease-table identity; None = host-pid
    lease_ttl: float = 60.0        # heartbeat expiry before peers steal (s)
    # Per-slot pipeline depth (DESIGN.md §15): how many work items a device
    # worker claims AHEAD of the one it is computing, so decode + H2D of
    # batch b+1 overlap the step of batch b.  0 disables pipelining (the
    # historical serial claim loop — decode, stage, compute, commit, repeat).
    slot_prefetch: int = 1
    # Runtime lease autotuning (DESIGN.md §15): shrink ``lease_batches``
    # toward the tail of the scan (guided self-scheduling) using the
    # scheduler's live busy/wait accounting.  The initial and final values
    # are reported in summary.json's executor block.
    autotune_lease: bool = True

    def validate(self) -> None:
        from repro_torch.runtime.workqueue import available_backends

        if self.devices < 0:
            raise ValueError(f"ExecSpec.devices must be >= 0, got {self.devices}")
        if self.slot_prefetch < 0:
            raise ValueError(
                f"ExecSpec.slot_prefetch must be >= 0, got {self.slot_prefetch}"
            )
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {self.placement!r}; available: {PLACEMENTS}"
            )
        if self.lease_batches < 1:
            raise ValueError(
                f"ExecSpec.lease_batches must be >= 1, got {self.lease_batches}"
            )
        if self.backend not in available_backends():
            raise ValueError(
                f"unknown scheduler backend {self.backend!r}; "
                f"available: {available_backends()}"
            )
        if self.lease_ttl <= 0:
            raise ValueError(
                f"ExecSpec.lease_ttl must be positive, got {self.lease_ttl}"
            )


@dataclass(frozen=True)
class ServeSpec:
    """The serve subsystem (DESIGN.md §16): a persistent multi-tenant scan
    service over the warm executor stack.

    Nothing here touches the scan math — serve requests run the same grid,
    engines, and sinks as an offline scan, so served results are
    byte-identical to offline outputs by construction.  These knobs size
    the *service*: the shared worker pool, the warm-slot cache, and the
    fair-share scheduler.
    """

    host: str = "127.0.0.1"
    port: int = 0                  # 0 = OS-assigned ephemeral port
    devices: int = 1               # shared pool slots; 0 = every visible device
    # Warm executor-slot cache capacity: (study-state, slot) entries held
    # device-resident across requests; LRU-evicted past this, pinned while
    # a request is mid-cell (DeviceLRU pinning).
    max_resident_slots: int = 8
    # Work items leased per claim on the shared serve queue.  Small leases
    # keep the deficit-round-robin responsive (a big lease would let one
    # request's cells monopolize a worker between scheduling decisions).
    lease_size: int = 1
    # Deficit-round-robin quantum: cells credited to a request queue per
    # scheduling round, scaled by the study's weight (serve/fair.py).
    drr_quantum: float = 2.0
    default_weight: float = 1.0

    def validate(self) -> None:
        if not (0 <= self.port <= 65535):
            raise ValueError(f"ServeSpec.port must be in [0, 65535], got {self.port}")
        if self.devices < 0:
            raise ValueError(f"ServeSpec.devices must be >= 0, got {self.devices}")
        if self.max_resident_slots < 1:
            raise ValueError(
                f"ServeSpec.max_resident_slots must be >= 1, "
                f"got {self.max_resident_slots}"
            )
        if self.lease_size < 1:
            raise ValueError(
                f"ServeSpec.lease_size must be >= 1, got {self.lease_size}"
            )
        if self.drr_quantum <= 0:
            raise ValueError(
                f"ServeSpec.drr_quantum must be positive, got {self.drr_quantum}"
            )
        if self.default_weight <= 0:
            raise ValueError(
                f"ServeSpec.default_weight must be positive, "
                f"got {self.default_weight}"
            )


@dataclass(frozen=True)
class ScanConfig:
    """The normalized internal scan configuration.

    Deprecated as a public construction surface — prefer
    ``Study.plan(engine=..., grid=GridSpec(...), ...)``, which validates and
    produces one of these.  It remains the checkpoint-fingerprint currency
    (``fingerprint_payload``), so its field set and semantics are stable.
    """

    batch_markers: int = 4096
    trait_block: int = 0           # trait-axis tile width; 0 = unblocked (§10)
    options: AssocOptions = AssocOptions()
    engine: str = "dense"          # registry name: core.engines.available_engines()
    mode: str = "mp"               # sharding mode; "sample" implies engine="dense"
    hit_threshold_nlp: float = 7.301  # 5e-8, the GWAS genome-wide line
    # Sparse p-value epilogue (DESIGN.md §13): screen lanes on t^2, run the
    # exact CF only on compacted survivors.  Output is bitwise-identical
    # either way, so neither knob enters the checkpoint fingerprint.
    sparse_epilogue: bool = True
    hit_capacity: int = 4096       # per-cell compacted hit-buffer slots
    maf_min: float = 0.0
    exclude_related: bool = False
    multivariate: bool = False
    checkpoint_dir: str | None = None
    prefetch_depth: int = 3
    io_workers: int = 2
    panel_resident_blocks: int = 4 # device LRU capacity for panel blocks
    spill_dir: str | None = None   # HitSink spill location (None: all in RAM)
    hit_spill_rows: int = 2_000_000  # spill past this many resident hit rows
    block_m: int = 256
    block_n: int = 512
    block_p: int = 256
    input_dtype: str = "fp32"      # fused engine GEMM input: "fp32" | "bf16"
    # mixed-model wing (engine="lmm"; DESIGN.md §9)
    loco: bool = False             # leave-one-chromosome-out GRM per shard
    grm_method: str = "std"        # "std" (GCTA) | "centered" (EMMAX)
    grm_batch_markers: int = 4096  # marker batch of the streamed GRM pass
    lmm_delta: float | None = None # pin se^2/sg^2 (skips the REML fit)
    lmm_epilogue: str = "dense"    # t/p epilogue: "dense" XLA | "fused" Pallas
    # executor (DESIGN.md §12; never fingerprinted — device topology is
    # elastic across restarts, results are bitwise-identical regardless)
    devices: int = 1               # executor slots; 0 = every visible device
    placement: str = "marker-major"  # "marker-major" | "trait-major"
    lease_batches: int = 2         # scheduler lease size (work items/claim)
    exec_backend: str = "threads"  # scheduler backend: "threads" | "shared-fs"
    host_id: str | None = None     # shared-fs lease identity (None: host-pid)
    lease_ttl: float = 60.0        # shared-fs heartbeat expiry (seconds)
    slot_prefetch: int = 1         # per-slot look-ahead depth; 0 = unpipelined
    autotune_lease: bool = True    # runtime lease_batches tuning (§15)
    # H2D staging currency (DESIGN.md §17); bitwise-neutral like the
    # epilogue strategy, so never fingerprinted
    genotype_staging: str = "auto"
    packed_cache_mb: int = 256
    # the device the scan runs on ("cuda", "cuda:i" or "cpu"); like
    # ``devices``, never fingerprinted — a checkpoint resumes on any device
    device: str = "cuda"

    def fingerprint_payload(self) -> dict:
        d = dataclasses.asdict(self)
        d["options"] = dataclasses.asdict(self.options)
        # Mesh topology, host counts, executor shape, and host-memory/spill
        # knobs never enter the fingerprint (elastic restarts may retune
        # them).  trait_block STAYS: it defines the checkpoint grid
        # decomposition.
        for k in ("prefetch_depth", "io_workers", "checkpoint_dir",
                  "panel_resident_blocks", "spill_dir", "hit_spill_rows",
                  "devices", "placement", "lease_batches",
                  "exec_backend", "host_id", "lease_ttl",
                  "slot_prefetch", "autotune_lease",
                  # bitwise-neutral epilogue strategy (§13): a scan
                  # checkpointed sparse resumes dense and vice versa
                  "sparse_epilogue", "hit_capacity",
                  # bitwise-neutral staging currency (§17): a scan
                  # checkpointed packed resumes dense and vice versa
                  "genotype_staging", "packed_cache_mb",
                  # execution placement, like devices
                  "device"):
            d.pop(k)
        d["options"].pop("sparse_epilogue", None)
        return d

    # ------------------------------------------------------ spec round-trip

    @classmethod
    def from_specs(
        cls,
        *,
        engine: str = "dense",
        grid: GridSpec | None = None,
        lmm: LmmSpec | None = None,
        io: IOSpec | None = None,
        executor: ExecSpec | None = None,
        options: AssocOptions | None = None,
        mode: str = "mp",
        hit_threshold_nlp: float = 7.301,
        maf_min: float = 0.0,
        exclude_related: bool = False,
        multivariate: bool = False,
        checkpoint_dir: str | None = None,
        input_dtype: str = "fp32",
        sparse_epilogue: bool = True,
        hit_capacity: int = 4096,
        device: str = "cuda",
    ) -> "ScanConfig":
        """Validate a spec combination and normalize it (the plan step)."""
        from repro_torch.core.engines import available_engines

        grid = grid or GridSpec()
        io = io or IOSpec()
        executor = executor or ExecSpec()
        options = options or AssocOptions()
        grid.validate()
        io.validate()
        executor.validate()
        if engine not in available_engines():
            raise ValueError(
                f"unknown scan engine {engine!r}; available: {available_engines()}"
            )
        if lmm is not None:
            lmm.validate()
            if engine != "lmm":
                raise ValueError(
                    f"LmmSpec given but engine={engine!r}; mixed-model knobs "
                    "only apply to engine='lmm'"
                )
        if input_dtype not in ("fp32", "bf16"):
            raise ValueError(f"unknown input_dtype {input_dtype!r}")
        if input_dtype == "bf16" and engine != "fused":
            raise ValueError(
                "input_dtype='bf16' selects the fused kernel's GEMM input "
                "dtype; use options=AssocOptions(precision='bf16') for the "
                "dense engine"
            )
        if mode not in ("mp", "sample"):
            raise ValueError(f"unknown sharding mode {mode!r}")
        if hit_capacity < 1:
            raise ValueError(f"hit_capacity must be >= 1, got {hit_capacity}")
        if executor.backend != "threads" and checkpoint_dir is None:
            raise ValueError(
                f"ExecSpec.backend={executor.backend!r} coordinates through "
                "the checkpoint directory; pass checkpoint_dir="
            )
        lmm = lmm or LmmSpec()
        return cls(
            batch_markers=grid.batch_markers,
            trait_block=grid.trait_block,
            options=options,
            engine=engine,
            mode=mode,
            hit_threshold_nlp=hit_threshold_nlp,
            sparse_epilogue=sparse_epilogue,
            hit_capacity=hit_capacity,
            maf_min=maf_min,
            exclude_related=exclude_related,
            multivariate=multivariate,
            checkpoint_dir=checkpoint_dir,
            prefetch_depth=io.prefetch_depth,
            io_workers=io.io_workers,
            panel_resident_blocks=grid.panel_resident_blocks,
            spill_dir=io.spill_dir,
            hit_spill_rows=io.hit_spill_rows,
            block_m=grid.block_m,
            block_n=grid.block_n,
            block_p=grid.block_p,
            input_dtype=input_dtype,
            loco=lmm.loco,
            grm_method=lmm.grm_method,
            grm_batch_markers=lmm.grm_batch_markers,
            lmm_delta=lmm.delta,
            lmm_epilogue=lmm.epilogue,
            devices=executor.devices,
            placement=executor.placement,
            lease_batches=executor.lease_batches,
            exec_backend=executor.backend,
            host_id=executor.host_id,
            lease_ttl=executor.lease_ttl,
            slot_prefetch=executor.slot_prefetch,
            autotune_lease=executor.autotune_lease,
            genotype_staging=io.genotype_staging,
            packed_cache_mb=io.packed_cache_mb,
            device=str(device),
        )

    def grid_spec(self) -> GridSpec:
        return GridSpec(
            batch_markers=self.batch_markers,
            trait_block=self.trait_block,
            block_m=self.block_m,
            block_n=self.block_n,
            block_p=self.block_p,
            panel_resident_blocks=self.panel_resident_blocks,
        )

    def lmm_spec(self) -> LmmSpec:
        return LmmSpec(
            loco=self.loco,
            grm_method=self.grm_method,
            grm_batch_markers=self.grm_batch_markers,
            delta=self.lmm_delta,
            epilogue=self.lmm_epilogue,
        )

    def io_spec(self) -> IOSpec:
        return IOSpec(
            prefetch_depth=self.prefetch_depth,
            io_workers=self.io_workers,
            spill_dir=self.spill_dir,
            hit_spill_rows=self.hit_spill_rows,
            genotype_staging=self.genotype_staging,
            packed_cache_mb=self.packed_cache_mb,
        )

    def exec_spec(self) -> ExecSpec:
        return ExecSpec(
            devices=self.devices,
            placement=self.placement,
            lease_batches=self.lease_batches,
            backend=self.exec_backend,
            host_id=self.host_id,
            lease_ttl=self.lease_ttl,
            slot_prefetch=self.slot_prefetch,
            autotune_lease=self.autotune_lease,
        )
