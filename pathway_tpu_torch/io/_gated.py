"""Helper for connectors whose client libraries are not in this
environment: full reference API surface, informative failure at call time
(mirrors how the reference degrades when an optional extra is missing).

Copy of ``pathway_tpu/io/_gated.py`` with ``unavailable`` only: no ported
connector calls ``require``, and the port imports no module by name at run
time.
"""

from __future__ import annotations

from typing import NoReturn


def unavailable(feature: str, pip_name: str) -> NoReturn:
    raise ImportError(
        f"{feature} requires the {pip_name!r} package, which is not "
        "installed in this environment (no network egress)."
    )
