"""Fault-tolerant checkpointing for both wings.

``ScanCheckpoint`` — the GWAS scan is a deterministic stream of
(marker-batch x trait-block) grid cells; each completed cell commits a
result shard plus an atomic manifest update (write-tmp, fsync, rename).
Restart resumes from the manifest — mid-panel if the cut landed between
trait blocks of one batch; the grid decomposition is independent of the
device mesh, so a resume may use a *different* mesh/host count (elastic
scaling) — remaining cells are simply re-partitioned.

``TrainCheckpoint`` — step-granular pytree checkpoints for the LM wing:
flat ``{path: ndarray}`` .npz shards plus a JSON manifest, same atomic
rename discipline.  (No orbax dependency by design: the container is
offline, and the format must stay greppable in production triage.)
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import threading
import time
import zipfile
from dataclasses import dataclass

import numpy as np

try:
    import fcntl
except ImportError:  # non-POSIX: merge still runs, just without the advisory lock
    fcntl = None

__all__ = ["ScanCheckpoint", "TrainCheckpoint", "config_fingerprint"]


def config_fingerprint(payload: dict) -> str:
    """Stable hash of scan-defining config (mesh EXCLUDED: elastic restarts
    must accept a different topology)."""
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _atomic_write_json(path: str, payload: dict) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class ScanCheckpoint:
    """Grid-cell-granular scan progress under ``root/``:

        manifest.json                    {fingerprint, n_batches, n_blocks,
                                          completed, failed, created, updated}
        batch_<idx>.npz                  committed result shard (n_blocks == 1)
        cell_<idx>_<blk>.npz             committed result shard (blocked scan)

    The unit of progress is one (marker-batch, trait-block) cell of the 2-D
    scan grid (DESIGN.md §10).  Unblocked scans have ``n_blocks == 1`` and
    keep the historical batch-keyed shard layout; blocked scans key every
    shard and manifest entry by cell, so a resume can pick up mid-panel —
    some trait blocks of a marker batch committed, the rest recomputed.
    (Checkpoints written by pre-grid versions are refused by the config
    fingerprint — ``trait_block`` is scan identity, and the grid version
    also changed the step's GEMM tiling — the same strictness as any other
    scan-defining config change.)
    """

    MANIFEST = "manifest.json"

    def __init__(self, root: str, *, fingerprint: str, n_batches: int, n_blocks: int = 1):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.fingerprint = fingerprint
        self.n_batches = n_batches
        self.n_blocks = n_blocks
        self._manifest_path = os.path.join(root, self.MANIFEST)
        # Process-local serialization of manifest state: the distributed
        # executor commits from N worker threads while the scheduler's
        # done-lease verification refreshes from another; the flock below
        # only covers cross-process writers (and not even those on
        # flock-less mounts).
        self._tlock = threading.Lock()
        existing = self._load_manifest()
        if existing is None:
            self._manifest = {
                "fingerprint": fingerprint,
                "n_batches": n_batches,
                "n_blocks": n_blocks,
                "completed": {},
                "failed": {},
                "created": time.time(),
                "updated": time.time(),
            }
            _atomic_write_json(self._manifest_path, self._manifest)
        else:
            if existing["fingerprint"] != fingerprint:
                raise ValueError(
                    f"checkpoint at {root} belongs to a different scan "
                    f"({existing['fingerprint']} != {fingerprint}); refusing to resume"
                )
            if existing["n_batches"] != n_batches:
                raise ValueError(
                    f"batch decomposition changed ({existing['n_batches']} -> {n_batches}); "
                    "keep batch size stable across restarts"
                )
            # Manifests written before the 2-D grid carry no n_blocks: they
            # are unblocked scans by construction.
            if existing.get("n_blocks", 1) != n_blocks:
                raise ValueError(
                    f"trait-block decomposition changed "
                    f"({existing.get('n_blocks', 1)} -> {n_blocks}); "
                    "keep trait_block stable across restarts"
                )
            existing.setdefault("n_blocks", n_blocks)
            self._manifest = existing

    @classmethod
    def open_existing(cls, root: str) -> "ScanCheckpoint":
        """Open a checkpoint directory as-is, trusting its own manifest for
        the fingerprint and grid decomposition.  This is the *read* path
        (``repro_torch.api.session.CheckpointReplay``, the CLI ``merge``
        subcommand): no scan config is available to re-derive the identity,
        and none is needed — nothing is committed through a replay."""
        manifest_path = os.path.join(root, cls.MANIFEST)
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(f"no checkpoint manifest under {root}")
        with open(manifest_path) as f:
            m = json.load(f)
        return cls(
            root,
            fingerprint=m["fingerprint"],
            n_batches=m["n_batches"],
            n_blocks=m.get("n_blocks", 1),
        )

    def _load_manifest(self) -> dict | None:
        if not os.path.exists(self._manifest_path):
            return None
        with open(self._manifest_path) as f:
            return json.load(f)

    # ------------------------------------------------------------- cell keys

    def _key(self, batch: int, block: int) -> str:
        return str(batch) if self.n_blocks == 1 else f"{batch}.{block}"

    def _shard_name(self, batch: int, block: int) -> str:
        if self.n_blocks == 1:
            return f"batch_{batch:06d}.npz"
        return f"cell_{batch:06d}_{block:04d}.npz"

    @property
    def completed(self) -> set[int]:
        """Batch indices with at least one committed cell (all cells, when
        unblocked).  Prefer ``completed_cells`` for grid-aware callers."""
        return {b for b, _ in self.completed_cells()}

    def completed_cells(self) -> set[tuple[int, int]]:
        out: set[tuple[int, int]] = set()
        for k in self._manifest["completed"]:
            if "." in k:
                b, blk = k.split(".", 1)
                out.add((int(b), int(blk)))
            else:
                out.add((int(k), 0))
        return out

    def pending_cells(self) -> list[tuple[int, int]]:
        done = self.completed_cells()
        return [
            (b, k)
            for b in range(self.n_batches)
            for k in range(self.n_blocks)
            if (b, k) not in done
        ]

    def pending_batches(self) -> list[int]:
        """Batches with any pending cell (every pending batch, unblocked)."""
        pending = {b for b, _ in self.pending_cells()}
        return sorted(pending)

    # --------------------------------------------------------------- commits

    @contextlib.contextmanager
    def _commit_lock(self):
        """Advisory flock serializing manifest read-merge-write on one host
        (and across hosts where the shared FS honors flock).  Best-effort:
        where locking is unavailable the atomic-rename merge below still
        converges — concurrent writers can each see the other's entries via
        re-read, and a lost race costs at most a recomputed idempotent cell,
        never a corrupt manifest."""
        if fcntl is None:
            yield
            return
        lock_path = os.path.join(self.root, ".manifest.lock")
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            yield
            return
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
            except OSError:
                pass  # FS without flock support (some NFS mounts)
            yield
        finally:
            os.close(fd)

    def _locked_manifest_update(self, mutate) -> None:
        """Re-read, merge, mutate, atomically publish the manifest.

        ``commit_cell`` used to rewrite the file from the process-local
        dict, so two processes sharing a checkpoint dir dropped each
        other's ``completed`` entries (classic lost update).  Now every
        manifest write folds the on-disk state in first: ``completed`` is
        the union (shard payloads are deterministic, so colliding keys
        agree), ``failed`` is the union minus anything since completed."""
        with self._tlock, self._commit_lock():
            disk = self._load_manifest()
            if disk is not None:
                merged_completed = {**disk.get("completed", {}), **self._manifest["completed"]}
                merged_failed = {**disk.get("failed", {}), **self._manifest["failed"]}
                self._manifest["completed"] = merged_completed
                self._manifest["failed"] = {
                    k: v for k, v in merged_failed.items() if k not in merged_completed
                }
            mutate(self._manifest)
            self._manifest["updated"] = time.time()
            _atomic_write_json(self._manifest_path, self._manifest)

    def refresh(self) -> None:
        """Fold the on-disk manifest into memory without writing — lets a
        shared-fs host see cells its peers committed (pending computation,
        final replay) without racing a write of its own."""
        with self._tlock:
            disk = self._load_manifest()
            if disk is None:
                return
            completed = {**disk.get("completed", {}), **self._manifest["completed"]}
            failed = {**disk.get("failed", {}), **self._manifest["failed"]}
            self._manifest["completed"] = completed
            self._manifest["failed"] = {k: v for k, v in failed.items() if k not in completed}

    def has_cell(self, batch: int, block: int) -> bool:
        """True iff the cell is in the freshly re-read manifest — the
        shared-fs queue's arbiter for whether a peer's done lease can be
        trusted (DESIGN.md §14): a done marker whose commit lost the
        manifest merge must be recomputed, not skipped forever."""
        self.refresh()
        with self._tlock:
            return self._key(batch, block) in self._manifest["completed"]

    def commit_cell(self, batch: int, block: int, arrays: dict[str, np.ndarray]) -> str:
        """Write the shard, then the manifest — in that order, so a crash
        between the two just re-does one grid cell.  The manifest write is
        a read-merge-write (see ``_locked_manifest_update``), so concurrent
        committers in different processes never drop each other's cells."""
        shard = os.path.join(self.root, self._shard_name(batch, block))
        # Unique tmp (same idiom as _atomic_write_json): double completion
        # of one cell across processes is a SUPPORTED race (lease steal,
        # TTL expiry), and a fixed ``shard + ".tmp"`` path would let one
        # committer truncate the file the other is about to publish —
        # worst case a torn shard recorded completed.
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp.npz")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, shard)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        key = self._key(batch, block)
        base = os.path.basename(shard)

        def mutate(m):
            m["completed"][key] = base
            m["failed"].pop(key, None)

        self._locked_manifest_update(mutate)
        return shard

    def commit_batch(self, idx: int, arrays: dict[str, np.ndarray]) -> str:
        return self.commit_cell(idx, 0, arrays)

    def record_failure(self, idx: int, err: str, block: int = 0) -> None:
        key = self._key(idx, block)
        msg = err[:500]

        def mutate(m):
            if key not in m["completed"]:
                m["failed"][key] = msg

        self._locked_manifest_update(mutate)

    def load_cell(self, batch: int, block: int) -> dict[str, np.ndarray]:
        name = self._manifest["completed"][self._key(batch, block)]
        with np.load(os.path.join(self.root, name)) as z:
            return {k: z[k] for k in z.files}

    def load_batch(self, idx: int) -> dict[str, np.ndarray]:
        return self.load_cell(idx, 0)

    def is_complete(self) -> bool:
        return len(self._manifest["completed"]) == self.n_batches * self.n_blocks


class TrainCheckpoint:
    """Step-granular pytree checkpoints: ``step_<n>/arrays.npz`` + manifest."""

    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")

    def latest_step(self) -> int | None:
        if not os.path.exists(self._manifest_path):
            return None
        with open(self._manifest_path) as f:
            steps = json.load(f).get("steps", [])
        return max(steps) if steps else None

    def save(self, step: int, flat_state, extra: dict | None = None) -> None:
        """``flat_state`` maps keys to arrays, or yields (key, array) pairs:
        each array is written as it comes (the ``np.savez`` format), so a
        state larger than host memory can be streamed."""
        d = os.path.join(self.root, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "arrays.tmp.npz")
        items = flat_state.items() if isinstance(flat_state, dict) else flat_state
        with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
            for key, value in items:
                with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(value), allow_pickle=False)
        os.replace(tmp, os.path.join(d, "arrays.npz"))
        if extra:
            _atomic_write_json(os.path.join(d, "extra.json"), extra)
        steps = []
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                steps = json.load(f).get("steps", [])
        steps = sorted(set(steps) | {step})
        _atomic_write_json(self._manifest_path, {"steps": steps})
        # Retention: drop oldest beyond keep_last.
        for old in steps[: -self.keep_last]:
            od = os.path.join(self.root, f"step_{old:08d}")
            if os.path.isdir(od):
                for name in os.listdir(od):
                    os.unlink(os.path.join(od, name))
                os.rmdir(od)
        _atomic_write_json(self._manifest_path, {"steps": steps[-self.keep_last :]})

    @contextlib.contextmanager
    def open(self, step: int | None = None):
        """Yields (step, the open ``np.load`` file): each key is read from
        disk when it is indexed, so a caller can restore one array at a
        time."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        with np.load(os.path.join(self.root, f"step_{step:08d}", "arrays.npz")) as z:
            yield step, z

    def restore(self, step: int | None = None) -> tuple[int, dict[str, np.ndarray]]:
        with self.open(step) as (step, z):
            return step, {k: z[k] for k in z.files}
