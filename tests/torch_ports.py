"""TCP ports for the port's cluster tests, below the ephemeral range.

The reference's own smokes pick their ports by binding port 0 and releasing it, which lands in
the host's ephemeral range (32768 and up on Linux). The port's cluster tests take fixed blocks
below it instead, keyed by the xdist worker, so that a test of one never draws a port another
is about to bind: worker ``gwN`` owns ``[BASE + N * SPAN, BASE + (N + 1) * SPAN)``, and each call
of :func:`port_block` takes the next ``BLOCK`` ports of its lower part. A block's first port serves as a
cluster's ``first_port`` (process p listens on ``first_port + p``), and ``first_port +
COORDINATOR_OFFSET`` (``parallel/distributed.py``'s rendezvous) falls in the same worker's span.
"""

from __future__ import annotations

import itertools
import os
import socket

BASE = 16000
SPAN = 1600
BLOCK = 8
#: ``init_from_env``'s default rendezvous: ``first_port + 1000``
COORDINATOR_OFFSET = 1000
#: blocks a span holds: their ports below ``SPAN - COORDINATOR_OFFSET``, their rendezvous above
_BLOCKS = (SPAN - COORDINATOR_OFFSET) // BLOCK

_next = itertools.count()


def _worker() -> int:
    name = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    return int(name[2:]) if name.startswith("gw") and name[2:].isdigit() else 0


def _free(port: int) -> bool:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def port_block() -> int:
    """The first of ``BLOCK`` ports, all free now, with the rendezvous port above them free too;
    the next call gives the next block of this worker's span."""
    base = BASE + _worker() * SPAN
    for _ in range(_BLOCKS):
        first = base + (next(_next) % _BLOCKS) * BLOCK
        ports = [*range(first, first + BLOCK), first + COORDINATOR_OFFSET]
        if all(_free(p) for p in ports):
            return first
    raise RuntimeError(f"no free block of {BLOCK} ports in [{base}, {base + SPAN})")


def free_port() -> int:
    """One port: the first of a fresh block (a drop-in for a test's bind-0 ``_free_port``)."""
    return port_block()
