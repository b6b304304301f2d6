"""Cluster layout marker + epoch-versioned worker namespaces.

The root-level ``cluster`` marker pins the persisted layout:
``{"n_workers": N, "epoch": E}`` (``epoch`` absent = 0, the seed layout).
Worker namespaces are

- epoch 0:  ``worker-{i}/`` for N > 1, the backend root for N == 1
  (byte-compatible with pre-rescale layouts);
- epoch E > 0: ``epoch-{E}/worker-{i}/`` (``epoch-{E}/`` for N == 1).

Epoch versioning is what makes ``pathway-tpu rescale`` atomic: the
resharder writes a COMPLETE new layout under the next epoch's namespaces
(fresh keys — the old layout is never touched), then flips the marker in
one ``put_value`` (atomic-by-rename on the filesystem backend). A crash
at any earlier point leaves the old marker pointing at the old, intact
layout; stale staging/epoch keys are garbage collected by the next
successful rescale.

Copy of ``pathway_tpu/persistence/layout.py``. The port has no resharder
(``rescale/`` is not ported), so it only ever writes epoch 0 itself; it reads
any epoch a marker names.
"""

from __future__ import annotations

import json

from .backends import PersistenceBackend

__all__ = [
    "MARKER_KEY",
    "STAGING_PREFIX",
    "UPGRADE_STAGING_PREFIX",
    "read_marker",
    "write_marker",
    "epoch_prefix",
    "worker_namespace",
    "layout_keys",
    "has_layout_meta",
]

MARKER_KEY = "cluster"
#: where a rescale stages the next epoch's layout before promotion
STAGING_PREFIX = "rescale-tmp/"
#: where a graph-version upgrade stages the migrated layout before its
#: atomic marker flip (upgrade/migrator.py) — same discipline as rescale:
#: everything under here is scratch, never part of a bootable layout
UPGRADE_STAGING_PREFIX = "upgrade-tmp/"


def read_marker(root: PersistenceBackend) -> tuple[int, int] | None:
    """(n_workers, epoch) from the ``cluster`` marker, or None when the
    store has none. ONLY a genuinely-missing key maps to None: since the
    marker now selects which epoch namespace gets mounted, treating a
    transient I/O error (or a corrupt marker) as "empty store" would boot
    blank state over a live layout — and a later rescale's cleanup sweep
    would then delete the orphaned real data. Such errors must propagate
    and fail the boot loudly instead."""
    try:
        raw = root.get_value(MARKER_KEY)
    except (KeyError, FileNotFoundError):
        return None
    doc = json.loads(raw)
    return int(doc.get("n_workers", 1)), int(doc.get("epoch", 0))


def write_marker(root: PersistenceBackend, n_workers: int, epoch: int) -> None:
    doc: dict = {"n_workers": int(n_workers)}
    if epoch:
        # epoch 0 markers stay byte-identical to pre-rescale layouts
        doc["epoch"] = int(epoch)
    root.put_value(MARKER_KEY, json.dumps(doc).encode())


def epoch_prefix(epoch: int) -> str:
    return "" if epoch == 0 else f"epoch-{epoch}/"


def worker_namespace(epoch: int, n_workers: int, worker_id: int) -> str:
    """Key prefix of one worker's persistence namespace ("" = the root)."""
    base = epoch_prefix(epoch)
    if n_workers > 1:
        return f"{base}worker-{worker_id}/"
    return base


def layout_keys(root: PersistenceBackend, epoch: int, n_workers: int) -> list[str]:
    """Every key belonging to the (epoch, n_workers) layout — the keys a
    post-promotion cleanup deletes. Epoch-0 root layouts own only the
    ``meta/``/``chunks/``/``ops/`` (or ``worker-*/``) trees, never the
    marker, staging keys or other epochs."""
    out: list[str] = []
    base = epoch_prefix(epoch)
    for key in root.list_keys():
        if key == MARKER_KEY or key.startswith(
            (STAGING_PREFIX, UPGRADE_STAGING_PREFIX)
        ):
            continue
        if epoch == 0 and key.startswith("epoch-"):
            continue
        if not key.startswith(base):
            continue
        rel = key[len(base):]
        if n_workers > 1:
            if rel.startswith("worker-"):
                out.append(key)
        elif rel.startswith(("meta/", "chunks/", "ops/")):
            out.append(key)
    return out


def has_layout_meta(root: PersistenceBackend, epoch: int, n_workers: int) -> bool:
    """True when the marker's layout has at least one committed metadata
    version behind it (i.e. there is real state to reshard)."""
    return any("meta/" in k for k in layout_keys(root, epoch, n_workers))
