"""Pluggable scan engines: device step construction + host batch preparation.

An engine owns both halves of one batch's journey:

    host side    ``prepare_batch``  — read from the genotype source, compute
                 marker stats on a prefetch worker thread, returning a
                 ``HostBatch`` of host ndarrays
    device side  ``build_step``     — a callable mapping those arrays (staged
                 as tensors on the slot's device) + the trait panel block to
                 summary tiles

Engines register by name (``@register_engine``); the executor never branches
on engine identity.  This port carries the two OLS engines, ``dense``
(standardized dosages and a PyTorch GEMM; on a card under packed staging its
product runs in the hand-written ``gwas_dot`` over the staged codes, see
``dense_product_route``) and ``fused`` (the hand-written CUDA ``gwas_dot``
kernel over 2-bit packed genotypes), and the mixed-model engine
``lmm`` (streamed GRM, rotation, then the correlation epilogue; its fused
epilogue runs the hand-written CUDA t-statistic and screen kernels of
``kernels/tstat.py``).

Each ``build_*_step`` takes an optional ``mesh`` (a ``torch.distributed``
``DeviceMesh`` with axes ``("data", "model")`` or ``("pod", "data",
"model")``; ``runtime/sharding.py``).  Under a mesh every rank calls the step
with the same full inputs; the step cuts this rank's blocks
(``shard_local``), computes on them, and returns the full output tiles on
every rank (``gather_full``), as the reference's ``jit`` with in- and
out-shardings does.  The per-trait winners and hit counts are computed on
the gathered tiles.  A mesh keeps the dense p-value epilogue.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import association as _assoc
from repro_torch.core import stats as _stats
from repro_torch.core.association import (
    AssocOptions,
    assoc_from_correlation,
    assoc_from_standardized,
    correlation,
    plan_sparse_epilogue,
    sparse_epilogue_outputs,
    standardize_genotype_batch,
)
from repro_torch.runtime import spans as _spans
from repro_torch.runtime.prefetch import MarkerBatch, TraitBlock
from repro_torch.runtime.sharding import (
    P,
    axis_size,
    batch_axes,
    gather_full,
    gwas_shardings,
    shard_local,
    sum_over,
)

__all__ = [
    "EngineContext",
    "EngineDeviceState",
    "HostBatch",
    "ScanEngine",
    "DeviceLRU",
    "DenseEngine",
    "FusedEngine",
    "LMMEngine",
    "register_engine",
    "get_engine",
    "available_engines",
    "build_dense_step",
    "build_fused_step",
    "build_lmm_step",
    "dense_product_route",
    "host_batch_from_reference",
    "resolve_genotype_staging",
]

class DeviceLRU:
    """Small keyed cache of device-staged tensors with LRU eviction.

    Stage through ``loader`` on miss, refresh recency on hit, evict the least
    recently used entry past ``capacity``.  ``on_evict`` lets dependent
    caches cascade.  Thread-safe: loaders may be reached from prefetch
    workers.  ``pin``/``unpin`` hold a ref-count per key: pinned entries are
    never chosen for eviction (capacity may be transiently exceeded while
    every resident entry is pinned).
    """

    def __init__(self, capacity: int, loader: Callable[[Any], Any],
                 *, on_evict: Callable[[Any], None] | None = None):
        self.capacity = max(1, capacity)
        self._loader = loader
        self._on_evict = on_evict
        self._data: dict[Any, Any] = {}
        self._pins: dict[Any, int] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Any) -> Any:
        with self._lock:
            if key in self._data:
                self.hits += 1
                self._data[key] = self._data.pop(key)  # refresh recency
            else:
                self.misses += 1
                while len(self._data) >= self.capacity:
                    gone = next(
                        (k for k in self._data if k not in self._pins), None
                    )
                    if gone is None:
                        break  # everything resident is pinned: overshoot
                    self._data.pop(gone)
                    self.evictions += 1
                    if self._on_evict is not None:
                        self._on_evict(gone)
                self._data[key] = self._loader(key)
            return self._data[key]

    def pin(self, key: Any) -> None:
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Any) -> None:
        with self._lock:
            if key not in self._pins:
                raise KeyError(f"unpin of {key!r} without a matching pin")
            n = self._pins[key] - 1
            if n <= 0:
                del self._pins[key]
            else:
                self._pins[key] = n

    def pinned(self, key: Any) -> bool:
        with self._lock:
            return key in self._pins

    @property
    def n_pinned(self) -> int:
        return len(self._pins)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "resident": len(self._data),
                "pinned": len(self._pins),
                "hit_rate": round(self.hits / total, 4) if total else None,
            }

    def drop_if(self, pred: Callable[[Any], bool]) -> None:
        with self._lock:
            for key in [k for k in self._data if pred(k)]:
                self._data.pop(key)

    def clear(self) -> None:
        """Drop every staged entry (cascading through ``on_evict``) and the
        pin table."""
        with self._lock:
            for key in list(self._data):
                self._data.pop(key)
                if self._on_evict is not None:
                    self._on_evict(key)
            self._pins.clear()

    def __len__(self) -> int:
        return len(self._data)


@dataclass
class EngineContext:
    """Everything an engine needs, assembled once per scan by the session."""

    n_samples: int
    n_covariates: int
    options: AssocOptions
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    # the sharding mesh (a DeviceMesh; None: one device) and its GWAS mode
    mesh: Any = None
    mode: str = "mp"
    hit_threshold: float = 7.301
    maf_min: float = 0.0
    block_m: int = 256
    block_n: int = 512
    block_p: int = 256
    q_basis: torch.Tensor | None = None
    multivariate: bool = False
    n_traits_eff: float = 1.0
    whitening: torch.Tensor | None = None
    keep: np.ndarray | None = None     # host-side sample mask (None: keep all)
    excluded_samples: int = 0
    trait_blocks: tuple[TraitBlock, ...] = ()
    panel_resident_blocks: int = 4
    # fused kernel GEMM input dtype ("fp32" | "bf16"); the epilogue (t,
    # -log10 p, argmax) always runs fp32
    input_dtype: str = "fp32"
    # mixed-model knobs (consumed by the lmm engine only)
    loco: bool = False
    grm_method: str = "std"
    grm_batch_markers: int = 4096
    lmm_delta: float | None = None
    lmm_epilogue: str = "dense"
    io_workers: int = 2
    sparse_epilogue: bool = False
    hit_capacity: int = 4096
    # H2D staging currency: "dense" stages decoded float32, "packed" stages
    # raw PLINK 2-bit bytes and decodes on device (bitwise-identical results
    # on the CPU; on a card the dense engine multiplies packed codes in
    # ``gwas_dot``, ``dense_product_route``).  The session resolves "auto"
    # via ``resolve_genotype_staging``.
    genotype_staging: str = "dense"


GENOTYPE_STAGINGS = ("auto", "packed", "dense")


def resolve_genotype_staging(
    requested: str,
    source: Any,
    *,
    excluded_samples: int = 0,
    mesh: Any = None,
) -> str:
    """Negotiate the staging currency per source.

    "auto" picks packed whenever the source speaks native 2-bit bytes, no
    host-side sample subsetting applies, and no sharding mesh (its
    shardings are declared over the decoded layout).  On the CPU packed
    staging is then exactly equivalent to dense staging, bit for bit.  On a
    card the dense engine's paper-dof product runs in ``gwas_dot`` over the
    packed codes (``dense_product_route``), so there the two stagings agree
    to the fp32 contract (r 2e-6), not bitwise.  Explicit "packed" raises
    instead of silently falling back; "dense" is always honored.
    """
    if requested not in GENOTYPE_STAGINGS:
        raise ValueError(
            f"unknown genotype staging {requested!r}; expected one of {GENOTYPE_STAGINGS}"
        )
    if requested == "dense":
        return "dense"
    blockers = []
    if not getattr(source, "supports_packed", False):
        blockers.append(f"{type(source).__name__} has no native 2-bit layout")
    if excluded_samples:
        blockers.append("relatedness exclusion subsets samples on host")
    if mesh is not None:
        blockers.append("sharding mesh stages the decoded layout")
    if not blockers:
        return "packed"
    if requested == "packed":
        raise ValueError(
            "genotype_staging='packed' unavailable: " + "; ".join(blockers)
        )
    return "dense"


@dataclass
class HostBatch:
    """Host-prepared batch: positional step args (host arrays, staged onto
    the slot's device by ``EngineDeviceState.stage``), plus any marker stats
    already known on the host (fused path) so sinks need not pull them back
    from the device."""

    batch: MarkerBatch
    device_args: tuple[np.ndarray, ...]
    host_maf: np.ndarray | None = None     # (m_batch,) observed MAF
    host_valid: np.ndarray | None = None   # (m_batch,) bool


def host_batch_from_reference(ref_batch: Any) -> HostBatch:
    """The port's ``HostBatch`` for a reference ``repro`` ``HostBatch``: the
    same marker range and byte-identical copies of its numpy step arguments
    and host stats.  Staging it (``EngineDeviceState.stage``) gives the
    port's step tensors, so both packages' steps see identical inputs."""
    b = ref_batch.batch
    batch = MarkerBatch(
        index=b.index, lo=b.lo, hi=b.hi, source_id=b.source_id,
        local_lo=b.local_lo, local_hi=b.local_hi,
    )

    def copy(a):
        return None if a is None else np.array(a, copy=True)

    return HostBatch(
        batch,
        tuple(copy(a) for a in ref_batch.device_args),
        host_maf=copy(ref_batch.host_maf),
        host_valid=copy(ref_batch.host_valid),
    )


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Stage one host array onto ``device``.

    The array is always copied (packed-cache slabs are read-only and must
    not be aliased).  On CUDA the copy goes through a fresh pinned buffer
    and a ``non_blocking`` transfer; PyTorch's pinned-memory allocator
    records the transfer on its stream and does not hand the buffer out
    again until the copy has finished, so the host side can never be
    overwritten mid-flight."""
    src = np.asarray(arr)
    host = torch.empty(src.shape, dtype=torch.from_numpy(np.empty(0, src.dtype)).dtype,
                       pin_memory=device.type == "cuda")
    host.numpy()[...] = src
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


class EngineDeviceState:
    """Everything an engine stages onto one device — an executor slot: the
    step, and the placement of each claimed batch's arrays.

    The multi-device executor gives every device its own state: a step of
    its own, the staging of each claimed batch, and whatever device caches
    the engine keeps (the lmm engine's per-scope rotation pair and rotated
    panel blocks live in its subclass).  ``device=None`` is the serial slot
    on ``ctx.device``, with the plan's own context.  Host-side amortized state
    (GRM/REML results, rotated panels in float32) stays on the engine and is
    shared by every slot; only staged tensors and the step's prolog memo are
    per slot.  ``put`` is the one placement primitive; it issues the copy on
    the calling thread's current stream (the slot's, under the executor).
    """

    def __init__(self, engine: "ScanEngine", ctx: "EngineContext",
                 *, device: torch.device | None = None,
                 step: Callable[..., dict] | None = None):
        self.engine = engine
        if device is not None:
            # Steps close over context tensors (the covariate basis of the
            # exact-dof residualization, the multivariate whitening); place
            # them on this slot's device before the step is built.  A copy
            # moves bytes, never values.
            device = torch.device(device)
            ctx = dataclasses.replace(
                ctx, device=device,
                q_basis=None if ctx.q_basis is None else ctx.q_basis.to(device),
                whitening=None if ctx.whitening is None else ctx.whitening.to(device),
            )
        self.ctx = ctx
        self.device = ctx.device
        # Under a mesh the step's arguments stay on the host: each rank's
        # step moves only its own block to the card (``shard_local``), so a
        # card holds its share of the batch and panel, not the whole.
        self._stage_device = torch.device("cpu") if ctx.mesh is not None else ctx.device
        # A fresh step per slot: the one-slot prolog memo inside keys on the
        # staged tensor's identity, which is per device — sharing a step
        # across slots would thrash the memo and race it across threads.
        self.step = step if step is not None else engine.build_step(ctx)

    def put(self, arr: Any) -> torch.Tensor:
        """Stage one host array onto this slot's device (asynchronous on
        CUDA); under a mesh, into host memory."""
        return to_device(arr, self._stage_device)

    def stage(self, host_batch: HostBatch) -> tuple:
        """Device-resident positional step args for one claimed batch."""
        return tuple(self.put(a) for a in host_batch.device_args)

    def panel_block(self, batch: MarkerBatch, block: TraitBlock) -> torch.Tensor:
        raise NotImplementedError(
            f"engine {self.engine.name!r} uses the session's panel store"
        )

    def reset(self) -> None:
        """Drop per-slot pinned device state (the step memo's last batch)."""
        getattr(self.step, "reset", lambda: None)()


class ScanEngine:
    """Engine interface; subclasses register with ``@register_engine``.

    Every engine's step takes the cell's trait-block panel slice as its
    trailing argument.  ``uses_global_panel`` says who serves it: the
    session's residualized ``PanelStore`` (OLS engines), or the engine
    device state's ``panel_block`` (the lmm engine, whose panels vary per
    LOCO scope as well as per block).
    """

    name: str = "?"
    uses_global_panel: bool = True

    def validate(self, ctx: EngineContext) -> None:
        """Raise for unsupported (engine, context) combinations."""

    def setup_scan(self, source, phenotypes, covariates, ctx: EngineContext):
        """Optional amortized per-scan setup (after ``validate``, before
        ``build_step``); may return overrides ``{"dof": int, "info": dict}``."""
        return None

    def state_fingerprint(self) -> str | None:
        """Summary of engine state a resume must match (the GRM spectrum);
        folded into the checkpoint fingerprint when set."""
        return None

    def build_step(self, ctx: EngineContext) -> Callable[..., dict[str, torch.Tensor]]:
        raise NotImplementedError

    def prepare_batch(self, source: Any, batch: MarkerBatch, ctx: EngineContext) -> HostBatch:
        raise NotImplementedError

    def make_device_state(
        self, ctx: EngineContext, *, device: torch.device | None = None,
        step: Callable[..., dict] | None = None,
    ) -> EngineDeviceState:
        """One executor slot's device residency; see ``EngineDeviceState``.
        ``step`` reuses an already-built step for the slot (the serial
        executor passes the plan's); by default the slot builds its own."""
        return EngineDeviceState(self, ctx, device=device, step=step)


_REGISTRY: dict[str, type[ScanEngine]] = {}


def register_engine(name: str) -> Callable[[type[ScanEngine]], type[ScanEngine]]:
    def deco(cls: type[ScanEngine]) -> type[ScanEngine]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_engine(name: str) -> ScanEngine:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scan engine {name!r}; available: {available_engines()}"
        ) from None
    return cls()


def available_engines() -> list[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------- steps


def _dense_best_and_hits(nlp: torch.Tensor, t: torch.Tensor, hit_threshold: float) -> dict:
    """Reference-path summary outputs from a full masked nlp tile.  The
    winner is the argmax over t^2 (first index on ties) — the same winner
    rule the sparse epilogue uses, so both paths agree bitwise."""
    best_row = torch.argmax(t * t, dim=0).to(torch.int32)
    rows = best_row[None, :].to(torch.int64)
    return {
        "batch_best_nlp": torch.gather(nlp, 0, rows)[0],
        "batch_best_row": best_row,
        "batch_best_t": torch.gather(t, 0, rows)[0],
        "hit_count": torch.sum(nlp >= hit_threshold).to(torch.int32),
    }


def _resolve_sparse(sparse_epilogue, mesh, options, hit_threshold, dof, hit_capacity,
                    multivariate=False):
    """The sparse epilogue needs a meaningful threshold (plan may refuse), an
    nlp-producing scan, no sharding mesh (the compaction is data-dependent
    and does not shard; the multi-device executor is the scaling path that
    keeps it), and no multivariate omnibus (that screen consumes the full r
    tile in the step; its step keeps the dense epilogue)."""
    if (
        not sparse_epilogue
        or mesh is not None
        or multivariate
        or not options.compute_neglog10p
    ):
        return None
    return plan_sparse_epilogue(hit_threshold, dof, capacity=hit_capacity)


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _pad_to(x: torch.Tensor, dim: int, multiple: int, value) -> torch.Tensor:
    """``x`` padded with ``value`` along ``dim`` to a multiple of
    ``multiple`` (``x`` itself when it already is one).  A mesh shards a
    ragged batch or a narrow trait block this way: padded markers are
    all-missing (never valid), padded traits and samples are zero."""
    pad = (-int(x.shape[dim])) % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def _gather_tiles(tiles: dict, mesh, spec, m: int, p: int) -> dict:
    """Every rank's (M, P) output blocks gathered to the full tiles, then
    trimmed to the unpadded ``(m, p)``."""
    return {k: gather_full(v, mesh, spec)[:m, :p] for k, v in tiles.items()}


def dense_product_route(device: torch.device, *, packed_input: bool, dof_mode: str,
                        mesh: Any = None) -> str:
    """Where the dense step's product runs for a batch staged on ``device``.

    "kernel": the hand-written ``gwas_dot`` multiplies the staged 2-bit
    codes, standardized from the prolog's marker statistics, and computes r
    and t in its epilogue.  That takes packed staging (there are codes), a
    CUDA tensor (the kernel has no CPU mode), the paper's dof (exact dof
    residualizes the genotypes, which codes cannot express) and no mesh.
    "library": everything else multiplies the standardized float32
    genotypes with a PyTorch GEMM (``association.correlation``)."""
    if (packed_input and mesh is None and dof_mode == "paper"
            and torch.device(device).type == "cuda"):
        return "kernel"
    return "library"


# The widest panel one ``gwas_dot`` call of the dense kernel route takes.  The
# kernel's grid walks 128-trait tiles fastest, so over a wide panel the
# blocks in flight share one 128-marker row and each row reads the whole
# trait operand from HBM (3.8 GB a row at 20,480 traits and 23,000 samples):
# the product is then bound by bandwidth.  Over chunks of this many traits
# the blocks in flight span several rows of the same trait tiles.  Each call
# costs the host a dozen dispatches, which convoy on the interpreter lock
# when several executor slots share one process.  On H100s at 8,192 x 23,000
# x 20,480 the product took 83.9 ms in one call and 70.0, 65.8, 64.3 and 63.1
# ms in chunks of 8,192, 4,096, 2,048 and 1,024; a scan over four cards
# delivered 3.2-3.4e9, 4.2-4.9e9 and 4.5-5.5e9 tests/s in chunks of 1,024,
# 2,048 and 4,096.
KERNEL_TRAIT_CHUNK = 4096


class _Codes(NamedTuple):
    """The kernel route's genotype operand of one batch: the staged codes in
    ``gwas_dot``'s tile layout and the statistics it standardizes them by."""

    tiled: torch.Tensor
    mean: torch.Tensor
    inv_std: torch.Tensor


def build_dense_step(
    *,
    n_samples: int,
    n_covariates: int,
    options: AssocOptions,
    hit_threshold: float = 7.301,
    maf_min: float = 0.0,
    q_basis: torch.Tensor | None = None,
    multivariate: bool = False,
    n_traits_eff: float = 1.0,
    whitening: torch.Tensor | None = None,
    trait_tile: int | None = None,
    split_prolog: bool = True,
    sparse_epilogue: bool = False,
    hit_capacity: int = 4096,
    packed_input: bool = False,
    block_n: int = 512,
    mesh: Any = None,
    mode: str = "mp",
) -> Callable[..., dict[str, torch.Tensor]]:
    """Paper-faithful dense step: float dosages in, summary tiles out.  The
    GEMM is a PyTorch product (``core.association.correlation``) on the
    library route.  Under dense staging on a card only this route runs, and
    it is the port's in-package cross-check of the ``gwas_dot`` kernel.

    ``packed_input`` accepts raw PLINK 2-bit bytes ``(M, ceil(N/4)) uint8``
    and decodes them on device in front of the unchanged prolog.  On the CPU
    every emitted bit then equals dense staging.  On a card, with the
    paper's dof, the product takes the kernel route
    (``dense_product_route``): the prolog keeps only the marker statistics
    of ``standardize_genotype_batch`` (bitwise those of dense staging) and
    repacks the staged bytes into ``gwas_dot``'s layout of ``block_n``-sample
    tiles; each cell calls ``gwas_dot`` over the panel block, one call a
    ``KERNEL_TRAIT_CHUNK`` traits, which standardizes the codes by those
    statistics and returns r and t.  Its
    fp32 product is 3xTF32 with the accumulators restarted every 32 samples,
    held to r 2e-6 of the exact sum (bf16: one bf16 pass), so there packed
    and dense staging agree to that contract, not bitwise.  ``trait_tile``
    fixes the panel-axis GEMM tile (the scan passes its ``block_p``) so every
    trait-block decomposition computes identical tiles; the kernel computes
    each trait's column in one fixed order whatever the block.

    The step is a once-per-marker-batch *prolog* (standardize + the
    exact-mode FWL residualization) memoized on the staged tensor's identity,
    plus a per-cell *epilogue* (the panel GEMM + t/p).  ``split_prolog=False``
    runs the prolog on every call instead (no memo): the cell consumes the
    same float32 ``g_std`` (or codes and statistics) either way, so the
    outputs are bitwise equal.  ``sparse_epilogue`` switches the p-value
    epilogue to the threshold-compacted form (``hit_idx``/``hit_r``/``hit_t``
    + ``screen_count``).  Each cell adds 1 to the span counter
    ``product_cells_kernel`` or ``product_cells_library``.

    ``multivariate`` adds the panel omnibus (``omnibus``, ``omnibus_nlp``:
    ``S = N * ||r W||^2`` against chi^2 with ``n_traits_eff`` degrees of
    freedom) on the masked r tile, and keeps the dense p-value epilogue.

    ``mesh`` shards the step (module docstring).  ``mode="mp"`` puts markers
    over the data axes and traits over ``model``: each rank standardizes its
    rows and multiplies them by its panel columns.  ``mode="sample"`` puts
    samples over the data axes (the panel as ``(data, model)``): every sum
    over samples (the marker means and variances, the exact-dof ``g q`` and
    row variances, the ``g y`` products) becomes a sum across the data ranks
    in rank order (``sharding.sum_over``).  A batch or panel that does not
    divide over the mesh is padded (all-missing markers or samples, zero
    traits) and trimmed after the gather.
    """
    if packed_input and mesh is not None:
        raise ValueError("packed_input requires mesh=None (see resolve_genotype_staging)")
    dof = options.dof(n_samples, n_covariates)
    sparse = _resolve_sparse(sparse_epilogue, mesh, options, hit_threshold, dof,
                             hit_capacity, multivariate=multivariate)
    cell_options = (
        dataclasses.replace(options, sparse_epilogue=True) if sparse is not None
        else options
    )

    def prolog(g_raw: torch.Tensor, q=q_basis, sample_sum=None):
        with _spans.span("prolog", device_of=g_raw):
            return _prolog(g_raw, q, sample_sum)

    def _prolog(g_raw, q, sample_sum):
        staged = g_raw
        if packed_input:
            from repro_torch.kernels.gwas_dot import ops as kops

            g_raw = kops.decode_packed_device(g_raw, n_samples=n_samples)
        g_std, ms = standardize_genotype_batch(
            g_raw, sample_sum=sample_sum, n_samples=n_samples
        )
        if options.dof_mode == "exact":
            from repro_torch.core.residualize import residualize_genotypes

            g_std = residualize_genotypes(g_std, q, sample_sum=sample_sum,
                                          n_samples=n_samples)
        valid = ms.valid & (ms.maf >= maf_min) if maf_min > 0 else ms.valid
        route = dense_product_route(staged.device, packed_input=packed_input,
                                    dof_mode=options.dof_mode, mesh=mesh)
        if route == "kernel":
            # The kernel standardizes the codes itself, as (d - mean) * inv_std
            # with missing codes 0: the value g_std holds.  Rows stay unpadded.
            tiled = kops.repack_plink_tiled_device(staged, n_samples=n_samples,
                                                   block_n=block_n, block_m=1)
            g_std = _Codes(tiled, ms.mean, ms.inv_std)
        return g_std, ms.maf, valid

    def product(g_std, y_std, sample_sum=None) -> torch.Tensor:
        _spans.count("product_cells_library", 1)
        # looked up in its module at each call, as assoc_from_standardized
        # does, so a substitute installed there (a test's fault) is the one run
        return _assoc.correlation(g_std, y_std, n_samples, precision=cell_options.precision,
                                  trait_tile=trait_tile, sample_sum=sample_sum)

    def kernel_product(codes: _Codes, y_std) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.kernels.gwas_dot import gwas_dot as gd

        _spans.count("product_cells_kernel", 1)

        def call(y):
            # looked up in its module at each call, as ``product`` does
            return gd.gwas_dot_fused(
                codes.tiled, codes.mean, codes.inv_std, y, n_samples=n_samples, dof=dof,
                block_n=block_n, block_p=trait_tile or 256, input_dtype=options.precision,
                eps=options.eps,
            )

        p, chunk = int(y_std.shape[1]), KERNEL_TRAIT_CHUNK
        if p <= chunk:
            return call(y_std)
        # each trait's column is one fixed sum whatever the call's width, so
        # the chunks' columns are the one wide call's, bit for bit
        r = y_std.new_empty((codes.tiled.shape[0], p))
        t = torch.empty_like(r)
        for lo in range(0, p, chunk):
            r_c, t_c = call(y_std[:, lo:lo + chunk])
            r[:, lo:lo + chunk].copy_(r_c)
            t[:, lo:lo + chunk].copy_(t_c)
        return r, t

    def kernel_tiles(r, t, valid) -> dict[str, torch.Tensor]:
        # the kernel's fresh tiles are masked in place: the scan's widest
        # panel holds two of them (1.25 GiB at 8,192 x 20,480) and no copies
        invalid = ~valid[:, None]
        out = {"r": r.masked_fill_(invalid, 0.0), "t": t.masked_fill_(invalid, 0.0)}
        if sparse is None:
            nlp = (_stats.neglog10_p_from_t(t, dof) if options.compute_neglog10p
                   else torch.zeros_like(t))
            out["nlp"] = nlp.masked_fill_(invalid, 0.0)
        return out

    def tiles(g_std, valid, y_std, sample_sum=None) -> dict[str, torch.Tensor]:
        return tiles_from_r(product(g_std, y_std, sample_sum), valid)

    def tiles_from_r(r, valid) -> dict[str, torch.Tensor]:
        res = assoc_from_correlation(r, n_samples=n_samples, n_covariates=n_covariates,
                                     options=cell_options)
        mask = valid[:, None]
        out = {"r": _masked(res.r, mask), "t": _masked(res.t, mask)}
        if sparse is None:
            out["nlp"] = _masked(res.neglog10p, mask)
        return out

    def summarize(out: dict) -> dict[str, torch.Tensor]:
        if sparse is not None:
            out.update(sparse_epilogue_outputs(out["r"], out["t"], dof, sparse))
        else:
            out.update(_dense_best_and_hits(out["nlp"], out["t"], hit_threshold))
        if multivariate:
            from repro_torch.core import multivariate as mv

            out["omnibus"], out["omnibus_nlp"] = mv.omnibus_chi2(
                out["r"], n_samples, n_traits_eff, whitening=whitening
            )
        return out

    def cell(g_std, maf, valid, y_std) -> dict[str, torch.Tensor]:
        if isinstance(g_std, _Codes):
            with _spans.span("product", device_of=valid):
                r, t = kernel_product(g_std, y_std)
            with _spans.span("epilogue", device_of=valid):
                return summarize({**kernel_tiles(r, t, valid), "maf": maf, "valid": valid})
        with _spans.span("product", device_of=g_std):
            r = product(g_std, y_std)
        with _spans.span("epilogue", device_of=g_std):
            return summarize({**tiles_from_r(r, valid), "maf": maf, "valid": valid})

    if mesh is not None:
        return _dense_mesh_step(mesh, mode, prolog, tiles, summarize, q_basis=q_basis)

    if not split_prolog:
        return lambda g_raw, y_std: cell(*prolog(g_raw), y_std)

    # One-slot memo keyed on the staged genotype tensor's identity: the
    # executor passes the same tensor for every trait block of a batch, and a
    # fresh one per batch.  Holding the reference pins the id.
    memo: dict[str, Any] = {"g": None, "out": None}

    def step(g_raw: torch.Tensor, y_std: torch.Tensor) -> dict[str, torch.Tensor]:
        if memo["g"] is not g_raw:
            memo["out"] = prolog(g_raw)
            memo["g"] = g_raw
        return cell(*memo["out"], y_std)

    # The executor calls this at teardown so the last batch's staged tensors
    # don't stay pinned on the device for the lifetime of a cached plan.
    step.reset = lambda: memo.update(g=None, out=None)
    return step


def _dense_mesh_step(mesh, mode, prolog, tiles, summarize, *, q_basis):
    """The mesh arm of ``build_dense_step``: ``step(g_raw, y_std)`` on the
    full batch and panel block, full outputs on every rank; the prolog is
    memoized per staged batch (the outputs do not depend on it)."""
    specs = {k: v.spec for k, v in gwas_shardings(mesh, mode=mode).items()}
    dp = batch_axes(mesh)
    n_dp, n_mp = axis_size(mesh, dp), axis_size(mesh, "model")
    nan = float("nan")
    sample_sum = None
    q_loc = q_basis
    if mode == "sample":
        sample_sum = functools.partial(sum_over, mesh=mesh, axes=dp)
        if q_basis is not None:
            q_loc = shard_local(_pad_to(q_basis, 0, n_dp, 0.0), mesh, P(dp, None))

    def mesh_prolog(g_raw):
        m = int(g_raw.shape[0])
        if mode == "mp":
            g_loc = shard_local(_pad_to(g_raw, 0, n_dp, nan), mesh, specs["g"])
            g_std, maf, valid = prolog(g_loc)
            vec = specs["marker_vec"]
            return g_std, valid, gather_full(maf, mesh, vec)[:m], gather_full(valid, mesh, vec)[:m]
        g_loc = shard_local(_pad_to(g_raw, 1, n_dp, nan), mesh, specs["g"])
        g_std, maf, valid = prolog(g_loc, q_loc, sample_sum)
        return g_std, valid, maf, valid

    memo: dict[str, Any] = {"g": None, "out": None}

    def step(g_raw: torch.Tensor, y_std: torch.Tensor) -> dict[str, torch.Tensor]:
        if memo["g"] is not g_raw:
            memo["out"] = mesh_prolog(g_raw)
            memo["g"] = g_raw
        g_std, valid_loc, maf, valid = memo["out"]
        y = _pad_to(y_std, 1, n_mp, 0.0)
        if mode == "sample":
            y = _pad_to(y, 0, n_dp, 0.0)
        loc = tiles(g_std, valid_loc, shard_local(y, mesh, specs["y"]), sample_sum)
        out = _gather_tiles(loc, mesh, specs["out"], int(g_raw.shape[0]), int(y_std.shape[1]))
        out["maf"], out["valid"] = maf, valid
        return summarize(out)

    step.reset = lambda: memo.update(g=None, out=None)
    return step


def build_fused_step(
    *,
    n_samples: int,
    n_covariates: int,
    options: AssocOptions,
    hit_threshold: float = 7.301,
    block_m: int = 256,
    block_n: int = 512,
    block_p: int = 256,
    input_dtype: str | None = None,
    sparse_epilogue: bool = False,
    hit_capacity: int = 4096,
    packed_input: bool = False,
    mesh: Any = None,
) -> Callable[..., dict[str, torch.Tensor]]:
    """Fused step: 2-bit packed slabs in (kernel layout), summary tiles out.

    The GEMM runs in the hand-written CUDA ``gwas_dot`` kernel (its plain
    PyTorch version for CPU tensors), which decodes, standardizes, multiplies
    and applies the t epilogue in one pass.  ``input_dtype`` selects the
    kernel's GEMM input dtype ("fp32" | "bf16"; ``None`` defers to
    ``options.precision``); accumulation and the epilogue stay float32.
    ``block_n`` is the packed layout's sample tile; ``block_p`` the trait
    chunk of the plain version.

    ``packed_input`` takes raw PLINK bytes ``(M, ceil(N/4))`` and performs
    the tile repack on device (a byte shuffle, memoized per staged batch),
    so host prep is a memcpy plus the LUT marker-stat pass.

    ``mesh`` ('mp' only: the kernel's epilogue needs each marker's whole
    sum over samples on one rank) runs the kernel, the mask and the p-values
    on each rank's ``(M/dp)`` packed rows and ``(P/mp)`` panel columns under
    ``compat.shard_map``, and the winners on the gathered tiles.  Rows pad
    with missing codes (``valid=False``), traits with zero columns."""
    from repro_torch.kernels.gwas_dot import ops as kops
    from repro_torch.kernels.gwas_dot.gwas_dot import gwas_dot_fused

    if packed_input and mesh is not None:
        raise ValueError("packed_input requires mesh=None (see resolve_genotype_staging)")
    dof = options.dof(n_samples, n_covariates)
    sparse = _resolve_sparse(sparse_epilogue, mesh, options, hit_threshold, dof, hit_capacity)
    use_bf16 = input_dtype == "bf16" or (input_dtype is None and options.precision == "bf16")
    kernel_dtype = "bf16" if use_bf16 else "fp32"

    if mesh is not None:
        from repro_torch.runtime.compat import shard_map

        dp = batch_axes(mesh)
        n_dp, n_mp = axis_size(mesh, dp), axis_size(mesh, "model")

        def kernel_local(packed, mean2d, inv2d, valid, y):
            r, t = gwas_dot_fused(
                packed, mean2d, inv2d, y,
                n_samples=n_samples, dof=dof, block_n=block_n, block_p=block_p,
                input_dtype=kernel_dtype, eps=options.eps,
            )
            mask = valid[:, None]
            t = _masked(t, mask)
            return _masked(r, mask), t, _masked(_stats.neglog10_p_from_t(t, dof), mask)

        tile = P(dp, "model")
        kernel_fn = shard_map(
            kernel_local, mesh=mesh,
            in_specs=(P(dp, None), P(dp, None), P(dp, None), P(dp), P(None, "model")),
            out_specs=(tile, tile, tile),
        )

        def mesh_step(packed, mean2d, inv2d, valid, y_std):
            m, p = int(packed.shape[0]), int(y_std.shape[1])
            r, t, nlp = kernel_fn(
                _pad_to(packed, 0, n_dp, 0x55),    # every 2-bit code missing
                _pad_to(mean2d, 0, n_dp, 0.0),
                _pad_to(inv2d, 0, n_dp, 0.0),
                _pad_to(valid, 0, n_dp, False),
                _pad_to(y_std, 1, n_mp, 0.0),
            )
            out = {"r": r[:m, :p], "t": t[:m, :p], "nlp": nlp[:m, :p]}
            out.update(_dense_best_and_hits(out["nlp"], out["t"], hit_threshold))
            return out

        return mesh_step

    def step(packed, mean2d, inv2d, valid, y_std):
        r, t = gwas_dot_fused(
            packed, mean2d, inv2d, y_std,
            n_samples=n_samples, dof=dof, block_n=block_n, block_p=block_p,
            input_dtype=kernel_dtype, eps=options.eps,
        )
        mask = valid[:, None]
        r = _masked(r, mask)
        t = _masked(t, mask)
        out = {"r": r, "t": t}
        if sparse is not None:
            out.update(sparse_epilogue_outputs(r, t, dof, sparse))
        else:
            nlp = _masked(_stats.neglog10_p_from_t(t, dof), mask)
            out["nlp"] = nlp
            out.update(_dense_best_and_hits(nlp, t, hit_threshold))
        return out

    if not packed_input:
        return step

    # One-slot memo like the dense prolog: the device repack runs once per
    # staged batch, then every trait-block cell reuses the tiled bytes.
    memo: dict[str, Any] = {"g": None, "tiled": None}

    def step_packed(plink_packed, mean2d, inv2d, valid, y_std):
        if memo["g"] is not plink_packed:
            memo["tiled"] = kops.repack_plink_tiled_device(
                plink_packed, n_samples=n_samples, block_n=block_n, block_m=block_m,
            )
            memo["g"] = plink_packed
        return step(memo["tiled"], mean2d, inv2d, valid, y_std)

    step_packed.reset = lambda: memo.update(g=None, tiled=None)
    return step_packed


def build_lmm_step(
    *,
    n_samples: int,
    n_covariates: int,
    options: AssocOptions,
    hit_threshold: float = 7.301,
    maf_min: float = 0.0,
    epilogue: str = "dense",
    block_m: int = 256,
    block_p: int = 256,
    sparse_epilogue: bool = False,
    hit_capacity: int = 4096,
    packed_input: bool = False,
    mesh: Any = None,
) -> Callable[..., dict[str, torch.Tensor]]:
    """Mixed-model step: standardize -> rotate into the (whitened) GRM
    eigenbasis -> project out the whitened design -> the unchanged
    correlation epilogue.

    Signature: ``step(g_raw, rotation, qhat, y_std)`` — the rotation matrix
    and the whitened design basis ride in the staged args because they vary
    per LOCO scope.  The GLS dof is structurally ``N - 2 - q`` (the whitened
    design counts its intercept), so the epilogue always runs in exact-dof
    mode.

    ``epilogue="dense"`` computes t/p with PyTorch ops
    (``assoc_from_standardized``); ``"fused"`` clips and masks r, then runs
    Eq. 3 in the hand-written t-statistic kernel (``kernels.tstat.tstat``),
    or — with ``sparse_epilogue`` — in the fused screen kernel
    (``kernels.tstat.screen_compact``), which also screens t^2 and counts
    the survivors.  ``block_p`` doubles as the panel-axis GEMM tile, so
    blocked and unblocked scans compute identical tiles.

    The step is a once-per-marker-batch *prolog* (decode under packed
    staging, standardize, the (M, N) x (N, N) rotation GEMM, the whitened-
    design projection — everything trait-independent) memoized on the
    staged tensor's identity, plus a per-cell *epilogue* (the panel GEMM +
    t/p), so a blocked scan pays the rotation once per marker batch.

    ``mesh`` ('mp' only) runs the prolog on each rank's marker rows (the
    rotation and ``qhat`` replicated) and the cell on its panel columns; the
    sparse epilogue is off under a mesh, so ``epilogue="fused"`` runs the
    t-statistic kernel on each rank's r block.
    """
    if epilogue not in ("dense", "fused"):
        raise ValueError(f"unknown lmm epilogue {epilogue!r}")
    if packed_input and mesh is not None:
        raise ValueError("packed_input requires mesh=None (see resolve_genotype_staging)")
    from repro_torch.core.residualize import residualize_genotypes
    from repro_torch.kernels.tstat import screen_compact, tstat

    opts = dataclasses.replace(options, dof_mode="exact")
    dof = opts.dof(n_samples, n_covariates)
    sparse = _resolve_sparse(sparse_epilogue, mesh, opts, hit_threshold, dof, hit_capacity)
    cell_opts = (
        dataclasses.replace(opts, sparse_epilogue=True) if sparse is not None else opts
    )

    def prolog(g_raw, rotation, qhat):
        if packed_input:
            from repro_torch.kernels.gwas_dot import ops as kops

            g_raw = kops.decode_packed_device(g_raw, n_samples=n_samples)
        g_std, ms = standardize_genotype_batch(g_raw)
        g_rot = torch.matmul(g_std, rotation)
        g_fin = residualize_genotypes(g_rot, qhat)
        valid = ms.valid & (ms.maf >= maf_min) if maf_min > 0 else ms.valid
        return g_fin, ms.maf, valid

    def cell(g_fin, maf, valid, y_std, summarize: bool = True) -> dict[str, torch.Tensor]:
        mask = valid[:, None]
        screen = None
        nlp = None
        if epilogue == "fused":
            r = torch.clamp(
                correlation(g_fin, y_std, n_samples, precision=opts.precision,
                            trait_tile=block_p),
                -1.0, 1.0,
            )
            # Mask before the kernel: invalid lanes map to r=0 -> t=0
            # exactly, so the screen can never admit a masked lane.
            r = _masked(r, mask)
            if sparse is not None:
                t, idx, screen_count = screen_compact(
                    r, float(dof), sparse.t2_screen, sparse.capacity,
                    block_m=block_m, block_p=block_p, eps=opts.eps,
                )
                screen = (idx, screen_count)
            else:
                t = tstat(r, float(dof), block_m=block_m, block_p=block_p, eps=opts.eps)
                nlp = _masked(_stats.neglog10_p_from_t(t, dof), mask)
        else:
            res = assoc_from_standardized(
                g_fin, y_std, n_samples=n_samples, n_covariates=n_covariates,
                options=cell_opts, trait_tile=block_p,
            )
            r = _masked(res.r, mask)
            t = _masked(res.t, mask)
            if sparse is None:
                nlp = _masked(res.neglog10p, mask)
        out = {"r": r, "t": t, "maf": maf, "valid": valid}
        if sparse is not None:
            out.update(sparse_epilogue_outputs(r, t, dof, sparse, screen=screen))
        else:
            out["nlp"] = nlp
            if summarize:
                out.update(_dense_best_and_hits(nlp, t, hit_threshold))
        return out

    if mesh is not None:
        specs = {k: v.spec for k, v in gwas_shardings(mesh, mode="mp").items()}
        n_dp, n_mp = axis_size(mesh, batch_axes(mesh)), axis_size(mesh, "model")
        vec = specs["marker_vec"]

        def local_prolog(g_raw, rotation, qhat):
            m = int(g_raw.shape[0])
            g_loc = shard_local(_pad_to(g_raw, 0, n_dp, float("nan")), mesh, specs["g"])
            g_fin, maf, valid = prolog(
                g_loc, shard_local(rotation, mesh, P()), shard_local(qhat, mesh, P())
            )
            return g_fin, valid, gather_full(maf, mesh, vec)[:m], gather_full(valid, mesh, vec)[:m]

        def local_cell(g_fin, valid_loc, maf, valid, y_std):
            y_loc = shard_local(_pad_to(y_std, 1, n_mp, 0.0), mesh, specs["y"])
            loc = cell(g_fin, maf, valid_loc, y_loc, summarize=False)
            out = _gather_tiles(
                {k: loc[k] for k in ("r", "t", "nlp")}, mesh, specs["out"],
                int(maf.shape[0]), int(y_std.shape[1]),
            )
            out["maf"], out["valid"] = maf, valid
            out.update(_dense_best_and_hits(out["nlp"], out["t"], hit_threshold))
            return out

        prolog_fn, cell_fn = local_prolog, local_cell
    else:
        prolog_fn, cell_fn = prolog, cell

    # One-slot memo keyed on the staged genotype tensor's identity (see
    # build_dense_step).
    memo: dict[str, Any] = {"g": None, "out": None}

    def step(g_raw, rotation, qhat, y_std) -> dict[str, torch.Tensor]:
        if memo["g"] is not g_raw:
            memo["out"] = prolog_fn(g_raw, rotation, qhat)
            memo["g"] = g_raw
        return cell_fn(*memo["out"], y_std)

    step.reset = lambda: memo.update(g=None, out=None)
    return step


# ------------------------------------------------------------------- engines


@register_engine("dense")
class DenseEngine(ScanEngine):
    """Standardized dosages and a PyTorch GEMM — the paper-faithful engine
    and the engine of the multivariate screen.  On a card under packed
    staging with the paper's dof the product runs in the hand-written
    ``gwas_dot`` over the staged codes (``dense_product_route``): there
    packed and dense staging agree to the fp32 contract (r 2e-6); on the CPU
    they agree bit for bit.  Under dense staging it keeps the library GEMM
    and is the port's cross-check of the ``gwas_dot`` kernel."""

    def build_step(self, ctx: EngineContext) -> Callable[..., dict[str, torch.Tensor]]:
        return build_dense_step(
            n_samples=ctx.n_samples,
            n_covariates=ctx.n_covariates,
            options=ctx.options,
            mesh=ctx.mesh,
            mode=ctx.mode,
            hit_threshold=ctx.hit_threshold,
            maf_min=ctx.maf_min,
            q_basis=ctx.q_basis,
            multivariate=ctx.multivariate,
            n_traits_eff=ctx.n_traits_eff,
            whitening=ctx.whitening,
            trait_tile=ctx.block_p,
            sparse_epilogue=ctx.sparse_epilogue,
            hit_capacity=ctx.hit_capacity,
            packed_input=ctx.genotype_staging == "packed",
            block_n=ctx.block_n,
        )

    def prepare_batch(self, source: Any, batch: MarkerBatch, ctx: EngineContext) -> HostBatch:
        if ctx.genotype_staging == "packed":
            from repro_torch.io.packed_cache import read_packed_cached

            return HostBatch(batch, (read_packed_cached(source, batch.lo, batch.hi),))
        dosages = source.read_dosages(batch.lo, batch.hi)
        if ctx.excluded_samples:
            dosages = dosages[:, ctx.keep]
        return HostBatch(batch, (np.asarray(dosages, np.float32),))


@register_engine("fused")
class FusedEngine(ScanEngine):
    """2-bit engine on the hand-written CUDA ``gwas_dot`` kernel: packed
    slabs stay packed until the kernel's inner loop; marker stats come from
    the host packed pass, so the device sees N/4 bytes per marker."""

    def validate(self, ctx: EngineContext) -> None:
        if ctx.mode != "mp":
            raise ValueError("fused engine supports marker x phenotype sharding only")
        if ctx.multivariate:
            # The reference's fused engine never computes the omnibus, yet
            # its sinks write an all-zero omnibus track for the flag; the
            # port refuses instead of writing that column.
            raise ValueError(
                "the multivariate omnibus screen runs on the dense engine "
                "(--engine dense); the fused engine does not compute it"
            )

    def build_step(self, ctx: EngineContext) -> Callable[..., dict[str, torch.Tensor]]:
        return build_fused_step(
            n_samples=ctx.n_samples,
            n_covariates=ctx.n_covariates,
            options=ctx.options,
            mesh=ctx.mesh,
            hit_threshold=ctx.hit_threshold,
            block_m=ctx.block_m,
            block_n=ctx.block_n,
            block_p=ctx.block_p,
            # "bf16" forces the kernel's low-precision GEMM; the default
            # defers to options.precision.
            input_dtype="bf16" if ctx.input_dtype == "bf16" else None,
            sparse_epilogue=ctx.sparse_epilogue,
            hit_capacity=ctx.hit_capacity,
            packed_input=ctx.genotype_staging == "packed",
        )

    def prepare_batch(self, source: Any, batch: MarkerBatch, ctx: EngineContext) -> HostBatch:
        from repro_torch.kernels.gwas_dot import ops as kops

        m_batch = batch.n_markers
        if ctx.genotype_staging == "packed":
            # Host prep at memcpy cost: cached raw slab + LUT marker stats.
            # The byte shuffle into the kernel layout runs on the device;
            # stat vectors still pad to the block_m geometry the device
            # repack pads its rows to.
            from repro_torch.io.packed_cache import read_packed_cached

            plink_packed = read_packed_cached(source, batch.lo, batch.hi)
            mean, inv_std, valid = kops.marker_stats_from_packed(
                plink_packed, ctx.n_samples
            )
            if ctx.maf_min > 0:
                af = mean / 2.0
                maf = np.minimum(af, 1.0 - af)
                valid &= maf >= ctx.maf_min
                inv_std = np.where(valid, inv_std, 0.0).astype(np.float32)
            pad_m = (-m_batch) % ctx.block_m
            if pad_m:
                mean = np.pad(mean, (0, pad_m))
                inv_std = np.pad(inv_std, (0, pad_m))
                valid = np.pad(valid, (0, pad_m))
            maf = np.minimum(mean / 2.0, 1.0 - mean / 2.0)
            return HostBatch(
                batch,
                (plink_packed, mean.reshape(-1, 1), inv_std.reshape(-1, 1), valid),
                host_maf=maf[:m_batch],
                host_valid=valid[:m_batch],
            )
        n_total = len(ctx.keep) if ctx.keep is not None else ctx.n_samples
        plink_packed = source.read_packed(batch.lo, batch.hi)
        codes = kops.unpack_plink_to_codes(plink_packed, n_total)
        if ctx.excluded_samples:
            codes = codes[:, ctx.keep]
        mean, inv_std, valid = kops.marker_stats_from_codes(codes)
        if ctx.maf_min > 0:
            af = mean / 2.0
            maf = np.minimum(af, 1.0 - af)
            valid &= maf >= ctx.maf_min
            inv_std = np.where(valid, inv_std, 0.0).astype(np.float32)
        packed = kops.pack_tiled(codes, ctx.block_n)
        pad_m = (-packed.shape[0]) % ctx.block_m
        if pad_m:
            packed = np.pad(packed, ((0, pad_m), (0, 0)), constant_values=0b01)
            mean = np.pad(mean, (0, pad_m))
            inv_std = np.pad(inv_std, (0, pad_m))
            valid = np.pad(valid, (0, pad_m))
        maf = np.minimum(mean / 2.0, 1.0 - mean / 2.0)
        return HostBatch(
            batch,
            (packed, mean.reshape(-1, 1), inv_std.reshape(-1, 1), valid),
            host_maf=maf[:m_batch],
            host_valid=valid[:m_batch],
        )




class _LMMDeviceState(EngineDeviceState):
    """One device's share of the lmm engine: the staged per-scope
    (rotation, qhat) pair and the per-(scope, trait-block) rotated panel
    slices, each LRU-bounded per slot.  The host float32 panels live on the
    engine, shared by every slot; each slot stages its own copies onto its
    own device, so a multi-device LOCO scan holds at most
    ``_DEV_SCOPES_MAX`` rotations per device."""

    def __init__(self, engine: "LMMEngine", ctx: EngineContext,
                 *, device: torch.device | None = None,
                 step: Callable[..., dict] | None = None):
        super().__init__(engine, ctx, device=device, step=step)
        # scope -> staged (rotation, qhat); evicting a scope drops its
        # resident panel blocks with it
        self._dev = DeviceLRU(
            engine._DEV_SCOPES_MAX,
            lambda sid: (
                self.put(engine._scopes[sid].rotation),
                self.put(engine._scopes[sid].qhat),
            ),
            on_evict=lambda sid: self._dev_y.drop_if(lambda k: k[0] == sid),
        )
        # (scope, block) -> staged panel slice
        self._dev_y = DeviceLRU(max(1, ctx.panel_resident_blocks), self._load_panel_block)

    def _load_panel_block(self, key: tuple[int, int]) -> torch.Tensor:
        sid, block_index = key
        blk = self.engine._trait_blocks[block_index]
        return self.put(self.engine._scopes[sid].y_block(blk.lo, blk.hi))

    def _scope(self, batch: MarkerBatch) -> int:
        return batch.source_id if self.engine._loco else -1

    def stage(self, host_batch: HostBatch) -> tuple:
        """(genotypes, rotation, qhat): the genotype copy is fresh per batch,
        the scope pair comes from the LRU, staged once per scope."""
        rotation, qhat = self._dev.get(self._scope(host_batch.batch))
        return (self.put(host_batch.device_args[0]), rotation, qhat)

    def panel_block(self, batch: MarkerBatch, block: TraitBlock) -> torch.Tensor:
        """Rotated-panel slice for one grid cell, sliced from the scope's host
        float32 panel (whitened panel-wide at setup), which keeps the blocked
        scan bitwise-identical to the unblocked one."""
        return self._dev_y.get((self._scope(batch), block.index))

    def reset(self) -> None:
        """Teardown: the step memo plus the staged rotation pairs and panel
        blocks, so a closed scan pins nothing on the device."""
        super().reset()
        self._dev_y.clear()
        self._dev.clear()


@register_engine("lmm")
class LMMEngine(ScanEngine):
    """Linear mixed model: streamed GRM + one-time rotation (``core.grm``,
    ``core.lmm``).  ``setup_scan`` amortizes the expensive work — the GRM
    pass and the eigendecomposition on the scan's device, REML and the panel
    rotation on the host — once per scan (per LOCO chromosome);
    ``prepare_batch`` then only reads genotypes, so the per-batch device cost
    is one extra (M, N) x (N, N) GEMM on top of the OLS scan."""

    uses_global_panel = False

    # Scopes arrive shard-sequentially, but the prefetch window may straddle
    # one boundary: two resident scopes bound device memory at ~2 (N, N)
    # rotations, not one per chromosome.
    _DEV_SCOPES_MAX = 2

    def __init__(self) -> None:
        self._scopes: dict[int, Any] = {}       # scope -> core.lmm.RotatedPanel
        self._trait_blocks: tuple[TraitBlock, ...] = ()
        self._loco = False
        self._fingerprint: str | None = None
        self._dof: int | None = None
        self._n_cov: int | None = None

    def validate(self, ctx: EngineContext) -> None:
        if ctx.mode != "mp":
            raise ValueError("lmm engine supports marker x phenotype sharding only")
        if ctx.multivariate:
            raise ValueError("lmm engine and the multivariate screen are exclusive")
        if ctx.lmm_epilogue not in ("dense", "fused"):
            raise ValueError(f"unknown lmm epilogue {ctx.lmm_epilogue!r}")

    def setup_scan(self, source, phenotypes, covariates, ctx: EngineContext):
        from repro_torch.core.grm import spectrum_fingerprint

        self._trait_blocks = ctx.trait_blocks
        if ctx.mesh is None:
            grm_method, spectra, setup_s = self._compute_setup(
                source, phenotypes, covariates, ctx
            )
        else:
            grm_method, spectra, setup_s = self._mesh_setup(
                source, phenotypes, covariates, ctx
            )
        self._loco = ctx.loco
        scopes = list(self._scopes)
        first = next(iter(self._scopes.values()))
        self._dof = first.dof
        self._n_cov = first.n_covariates
        deltas = {sid: p.delta for sid, p in self._scopes.items()}
        # Deltas enter the fingerprint rounded to the spectrum hash's
        # significant-digit budget, so last-bit REML jitter is not refused.
        delta_sig = [(sid, f"{d:.6g}") for sid, d in sorted(deltas.items())]
        self._fingerprint = f"{spectrum_fingerprint(spectra)}:{delta_sig}"
        info: dict[str, Any] = {
            "grm_method": grm_method,
            "scopes": len(scopes),
            "loco": ctx.loco,
            "delta": deltas if ctx.loco else first.delta,
            "spectrum_hash": spectrum_fingerprint(spectra),
            "setup_s": setup_s,
        }
        if first.reml is not None:
            info["h2"] = first.reml.h2
            info["delta_per_trait"] = first.reml.delta
        return {"dof": self._dof, "info": info}

    def _mesh_setup(self, source, phenotypes, covariates, ctx: EngineContext):
        """Under a mesh, rank 0 computes the GRM, spectra, REML and rotated
        panels and every rank receives its bits: two cards' ``eigh`` of one
        matrix need not agree bit for bit, and ranks holding different
        rotations would write one scan from two."""
        from repro_torch.runtime.sharding import broadcast_array, broadcast_object, is_lead

        mesh, device = ctx.mesh, ctx.device
        lead = is_lead(mesh)
        spectra: dict[int, np.ndarray] = {}
        head = None
        if lead:
            try:
                grm_method, spectra, setup_s = self._compute_setup(
                    source, phenotypes, covariates, ctx
                )
            except Exception as e:
                # every rank waits on the broadcast: fail them all with it
                broadcast_object(("error", f"{type(e).__name__}: {e}"))
                raise
            head = ("ok", grm_method, setup_s, {
                sid: dataclasses.replace(p, rotation=None, qhat=None, y=None, trait_valid=None)
                for sid, p in self._scopes.items()
            })
        head = broadcast_object(head)
        if head[0] == "error":
            raise RuntimeError(f"rank 0 failed the mixed-model set-up: {head[1]}")
        _, grm_method, setup_s, bare = head
        own = self._scopes if lead else {}
        out_spectra: dict[int, np.ndarray] = {}
        for sid, p in bare.items():
            out_spectra[sid] = broadcast_array(spectra[sid] if lead else None, device)
            arrays = {
                k: broadcast_array(getattr(own[sid], k) if lead else None, device)
                for k in ("rotation", "qhat", "y", "trait_valid")
            }
            self._scopes[sid] = dataclasses.replace(p, **arrays)
        return grm_method, out_spectra, setup_s

    def _compute_setup(self, source, phenotypes, covariates, ctx: EngineContext):
        """The GRM pass, each scope's spectrum on the scan's device, and REML
        and the panel rotation on the host; fills ``self._scopes``.  Returns
        ``(grm_method, spectra, setup_s)``."""
        from repro_torch.core.grm import grm_spectrum, stream_grm
        from repro_torch.core.lmm import rotate_panel

        # host seconds per setup stage, summed over scopes (each stage ends
        # in a device-to-host copy, so the host clock covers its device work)
        setup_s = {"grm": 0.0, "spectrum": 0.0, "rotate": 0.0}
        t0 = time.perf_counter()
        grm = stream_grm(
            source,
            keep=ctx.keep if ctx.excluded_samples else None,
            batch_markers=ctx.grm_batch_markers,
            method=ctx.grm_method,
            maf_min=ctx.maf_min,
            io_workers=ctx.io_workers,
            # Same currency as the scan: packed batches flow through the
            # shared slab cache + device decode.
            staging=ctx.genotype_staging,
            device=ctx.device,
        )
        setup_s["grm"] = time.perf_counter() - t0
        if ctx.loco and grm.n_shards < 2:
            raise ValueError(
                "loco=True needs a per-chromosome fileset (>= 2 genotype shards)"
            )
        scopes = list(range(grm.n_shards)) if ctx.loco else [-1]
        spectra: dict[int, np.ndarray] = {}
        for sid in scopes:
            t0 = time.perf_counter()
            k = grm.loco(sid) if ctx.loco else grm.full()
            s, u = grm_spectrum(k, device=ctx.device)
            del k
            t1 = time.perf_counter()
            spectra[sid] = s
            self._scopes[sid] = rotate_panel(phenotypes, covariates, s, u, delta=ctx.lmm_delta)
            setup_s["spectrum"] += t1 - t0
            setup_s["rotate"] += time.perf_counter() - t1
        return grm.method, spectra, setup_s

    def state_fingerprint(self) -> str | None:
        return self._fingerprint

    def build_step(self, ctx: EngineContext) -> Callable[..., dict[str, torch.Tensor]]:
        if self._dof is None:
            raise RuntimeError("setup_scan must run before build_step")
        return build_lmm_step(
            n_samples=ctx.n_samples,
            n_covariates=self._n_cov,
            options=ctx.options,
            mesh=ctx.mesh,
            hit_threshold=ctx.hit_threshold,
            maf_min=ctx.maf_min,
            epilogue=ctx.lmm_epilogue,
            block_m=ctx.block_m,
            block_p=ctx.block_p,
            sparse_epilogue=ctx.sparse_epilogue,
            hit_capacity=ctx.hit_capacity,
            packed_input=ctx.genotype_staging == "packed",
        )

    def make_device_state(
        self, ctx: EngineContext, *, device: torch.device | None = None,
        step: Callable[..., dict] | None = None,
    ) -> EngineDeviceState:
        return _LMMDeviceState(self, ctx, device=device, step=step)

    def prepare_batch(self, source: Any, batch: MarkerBatch, ctx: EngineContext) -> HostBatch:
        """Host side only: read and subset genotypes.  The scope's rotation
        pair is attached at staging time by the device state."""
        if ctx.genotype_staging == "packed":
            from repro_torch.io.packed_cache import read_packed_cached

            return HostBatch(batch, (read_packed_cached(source, batch.lo, batch.hi),))
        dosages = source.read_dosages(batch.lo, batch.hi)
        if ctx.excluded_samples:
            dosages = dosages[:, ctx.keep]
        return HostBatch(batch, (np.asarray(dosages, np.float32),))
