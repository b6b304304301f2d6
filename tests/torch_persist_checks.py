"""Helpers of the port's persistence tests: a guard on every operator-snapshot blob, and the
in-memory boto3-surface S3 client that ``tests/test_persistence.py`` fakes the object store with.

The guard wraps the port's ``OperatorSnapshots.write`` and ``write_parts`` (for a test, or for
the rest of a child process): before a state is written it is pickled once more through a
pickler that fails on any ``torch.Tensor`` (a CUDA tensor, the encoder's weights) or
``torch.nn.Module``. A snapshot holds host arrays only; the
index engines drop their device mirror and their embedder before pickling.
"""

from __future__ import annotations

import io
import pickle

import torch


class _TensorRefusingPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, (torch.Tensor, torch.nn.Module)):
            raise AssertionError(
                f"an operator snapshot holds a {type(obj).__name__}"
                + (f" on {obj.device}" if isinstance(obj, torch.Tensor) else "")
            )
        return NotImplemented


def assert_host_only(state) -> None:
    """Pickle ``state`` and fail if it reaches a tensor or a module."""
    _TensorRefusingPickler(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL).dump(state)


def _checking(write, write_parts, checked: list):
    def checked_write(self, rank, at, state):
        assert_host_only(state)
        checked.append((rank, at))
        return write(self, rank, at, state)

    def checked_write_parts(self, rank, at, parts):
        def each():
            for part in parts:
                assert_host_only(part)
                checked.append((rank, at))
                yield part

        return write_parts(self, rank, at, each())

    return checked_write, checked_write_parts


def guard_snapshot_blobs(monkeypatch) -> list:
    """Check every state the port's ``OperatorSnapshots`` writes from now on; returns a list
    that collects one entry a checked state (tests assert it is not empty)."""
    from pathway_tpu_torch.persistence.snapshots import OperatorSnapshots

    checked: list = []
    write, write_parts = _checking(OperatorSnapshots.write, OperatorSnapshots.write_parts,
                                   checked)
    monkeypatch.setattr(OperatorSnapshots, "write", write)
    monkeypatch.setattr(OperatorSnapshots, "write_parts", write_parts)
    return checked


def install_guard() -> list:
    """The same check for the rest of a process (the child programs of the recovery tests)."""
    from pathway_tpu_torch.persistence.snapshots import OperatorSnapshots

    checked: list = []
    OperatorSnapshots.write, OperatorSnapshots.write_parts = _checking(
        OperatorSnapshots.write, OperatorSnapshots.write_parts, checked)
    return checked


class FakeS3Client:
    """In-memory boto3-surface S3: get/put/delete/list_objects_v2 with
    pagination, so the backend's continuation-token loop is exercised."""

    def __init__(self, page_size=2):
        self.objects: dict[tuple[str, str], bytes] = {}
        self.page_size = page_size

    def put_object(self, Bucket, Key, Body):
        self.objects[(Bucket, Key)] = bytes(Body)

    def get_object(self, Bucket, Key):
        if (Bucket, Key) not in self.objects:
            raise KeyError(Key)
        return {"Body": io.BytesIO(self.objects[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):
        self.objects.pop((Bucket, Key), None)

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        keys = sorted(k for (b, k) in self.objects if b == Bucket and k.startswith(Prefix))
        start = int(ContinuationToken) if ContinuationToken else 0
        page = keys[start:start + self.page_size]
        truncated = start + self.page_size < len(keys)
        resp = {"Contents": [{"Key": k} for k in page], "IsTruncated": truncated}
        if truncated:
            resp["NextContinuationToken"] = str(start + self.page_size)
        return resp
