"""Helper for connectors whose client libraries are not in this
environment: full reference API surface, informative failure at call time
(mirrors how the reference degrades when an optional extra is missing).

Copy of ``pathway_tpu/io/_gated.py``. The reference's ``require`` imports a
module by name; the port imports no module by name at run time, so here
``require`` is a context manager around the connector's own plain ``import``
statement, and an ``ImportError`` inside it becomes the reference's message::

    with require("confluent-kafka", "pw.io.kafka"):
        import confluent_kafka
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, NoReturn


@contextmanager
def require(pip_name: str, feature: str) -> Iterator[None]:
    try:
        yield
    except ImportError as e:
        raise ImportError(
            f"{feature} requires the {pip_name!r} package, which is not "
            "installed in this environment (no network egress). The "
            "connector API matches the reference; install the client "
            "library to activate it."
        ) from e


def unavailable(feature: str, pip_name: str) -> NoReturn:
    raise ImportError(
        f"{feature} requires the {pip_name!r} package, which is not "
        "installed in this environment (no network egress)."
    )
