"""Bounded runs of a streaming dataflow for the port's file-connector tests: ``pw.run`` on a
thread of its own, file events applied one at a time, each awaited until its updates have
arrived. A run that does not finish, or an event whose updates do not arrive, fails its test
within its own time limit instead of hanging the suite."""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable


def _start(p, run_kwargs: dict) -> tuple[threading.Thread, list]:
    errors: list[BaseException] = []

    def target() -> None:
        try:
            p.run(**run_kwargs)
        except BaseException as e:  # surfaced by the caller
            errors.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    return th, errors


def _finish(p, th: threading.Thread, errors: list, timeout_s: float) -> None:
    th.join(timeout_s)
    if th.is_alive():
        p.request_stop()
        th.join(10)
        raise AssertionError(f"pw.run did not finish within {timeout_s} s")
    if errors:
        raise errors[0]


def run_bounded(p, timeout_s: float = 60.0, **run_kwargs: Any) -> None:
    """``p.run(**run_kwargs)``, failing after ``timeout_s``."""
    th, errors = _start(p, run_kwargs)
    _finish(p, th, errors, timeout_s)


class Recorder:
    """``on_change`` of ``pw.io.subscribe``: each update as (key, row tuple, diff), in the bucket
    of the file event in effect when it arrived."""

    def __init__(self, names: list[str], drop: tuple[str, ...] = ()):
        self.names = [n for n in names if n not in drop]
        self.events: list[list[tuple]] = [[]]
        self.lock = threading.Lock()

    def __call__(self, key, row, time, is_addition) -> None:
        with self.lock:
            self.events[-1].append(
                (int(key), tuple(row[n] for n in self.names), 1 if is_addition else -1))

    def count(self) -> int:
        with self.lock:
            return len(self.events[-1])

    def next_event(self) -> None:
        with self.lock:
            self.events.append([])

    def multisets(self) -> list[Counter]:
        return [Counter(e) for e in self.events]


def drive_events(p, recorder: Recorder, events: list[tuple[Callable[[], None], int]],
                 timeout_s: float = 60.0, **run_kwargs: Any) -> list[Counter]:
    """Run ``p``'s registered graph; for each (action, n_updates) apply the action and wait until
    ``n_updates`` updates of it arrived; then stop the run. Returns the updates by event."""
    th, errors = _start(p, run_kwargs)
    deadline = time.monotonic() + timeout_s
    try:
        for i, (action, n_updates) in enumerate(events):
            if i:
                recorder.next_event()
            action()
            while recorder.count() < n_updates:
                if errors or not th.is_alive():
                    raise AssertionError(f"the run ended during event {i}: {errors}")
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"event {i}: {recorder.count()} of {n_updates} updates in {timeout_s} s")
                time.sleep(0.01)
            time.sleep(0.2)  # anything past the expected updates lands in this event's bucket
    finally:
        p.request_stop()
        _finish(p, th, errors, max(1.0, deadline - time.monotonic()) + 10)
    return recorder.multisets()
