"""``pw.io.csv`` — thin wrapper over ``pw.io.fs`` with format=csv
(reference ``python/pathway/io/csv``).

Copy of ``pathway_tpu/io/csv.py``."""

from __future__ import annotations

from typing import Any

from . import fs


class CsvParserSettings:
    def __init__(self, delimiter: str = ",", quote: str = '"', escape: str | None = None,
                 enable_double_quote_escapes: bool = True, enable_quoting: bool = True,
                 comment_character: str | None = None):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape


def read(path, *, schema=None, mode: str = "streaming", csv_settings: CsvParserSettings | None = None, **kwargs: Any):
    return fs.read(path, format="csv", schema=schema, mode=mode, csv_settings=csv_settings, **kwargs)


def write(table, filename, **kwargs: Any) -> None:
    fs.write(table, filename, format="csv", **kwargs)
