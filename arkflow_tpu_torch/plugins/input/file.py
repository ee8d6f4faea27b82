"""File input: scan CSV / NDJSON / Avro files, optionally SQL-filtered.

Counterpart of ``arkflow_tpu/plugins/input/file.py`` for local paths: the
format by config or extension, the files of ``path`` in turn, streamed as
batches of at most ``batch_rows`` rows, an optional ``query`` over each
batch (the ``SELECT ... FROM flow`` contract, on the port's SQL engine with
a fresh context a batch; a batch the query filters to nothing is skipped),
then ``EndOfInput``. Each batch carries ``__meta_source`` ``file`` and the
ingest stamp.

The readers are the port's own, with JAX's batch boundaries
(``utils/tabular.py``): CSV in 1 MiB blocks, each block split by
``batch_rows``; NDJSON read whole, each 1 MiB chunk split; Avro through
``utils/avro.py``, ``batch_rows`` records a batch. The scan runs on an
executor thread, so a large file never stalls the event loop.

Not ported yet, refused with ``not yet ported`` at ``--validate`` and at
build wherever the format is known then, at connect otherwise: Parquet and
Arrow IPC (``parquet``, ``arrow``, ``ipc``, ``feather``, by key or by
extension), object-store URIs (``s3://`` and the like) and the keys
``fs``, ``remote_url`` and ``max_frame``.

Config:

    type: file
    path: /data/events.csv         # a local path or a list of them
    format: csv                    # optional; inferred from extension
    query: "SELECT * FROM flow WHERE x > 1"   # optional
    batch_rows: 8192
"""

from __future__ import annotations

import asyncio
from pathlib import Path
from typing import Iterator, Optional

from arkflow_tpu_torch.batch import DEFAULT_RECORD_BATCH_ROWS, MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, ReadError, not_ported
from arkflow_tpu_torch.sql import SessionContext

_FORMATS = {"csv", "json", "parquet", "arrow", "ipc", "feather", "avro"}
#: formats whose readers the port does not have yet
UNPORTED_FORMATS = ("parquet", "arrow", "ipc", "feather")
_STORE_SCHEMES = ("s3://", "gs://", "gcs://", "hdfs://", "abfs://", "abfss://")


def _infer_format(path: Path) -> str:
    ext = path.suffix.lower().lstrip(".")
    if ext in ("yml", "yaml"):
        raise ConfigError(f"unsupported file format {ext!r}")
    if ext in ("jsonl", "ndjson"):
        return "json"
    if ext in ("feather", "ipc"):
        return "arrow"
    if ext in _FORMATS:
        return ext
    raise ConfigError(f"cannot infer format from {path.name!r}; set 'format'")


def is_store_uri(path: str) -> bool:
    return str(path).startswith(_STORE_SCHEMES)


def _check_ported(path: str, fmt: Optional[str]) -> str:
    """The format of one path; raises where the port cannot read it."""
    if is_store_uri(path):
        raise not_ported(f"input 'file' object-store path {path!r}")
    fmt = fmt or _infer_format(Path(path))
    if fmt in UNPORTED_FORMATS:
        raise not_ported(f"input 'file' format {fmt!r} ({path})")
    if fmt not in _FORMATS:
        raise ConfigError(f"unsupported file format {fmt!r}")
    return fmt


def _scan(path: Path, fmt: str, batch_rows: int) -> Iterator[MessageBatch]:
    if fmt == "csv":
        from arkflow_tpu_torch.utils.tabular import read_csv_blocks

        with open(path, "rb") as f:
            for block in read_csv_blocks(f):
                yield from block.split(batch_rows)
        return
    if fmt == "json":
        from arkflow_tpu_torch.utils.tabular import read_ndjson_blocks

        with open(path, "rb") as f:
            chunks = read_ndjson_blocks(f)
        for chunk in chunks:
            yield from chunk.split(batch_rows)
        return
    from arkflow_tpu_torch.utils.avro import read_container, records_to_batch

    with open(path, "rb") as f:
        schema, records = read_container(f)
        rows: list[dict] = []
        for rec in records:
            rows.append(rec)
            if len(rows) >= batch_rows:
                # schema-driven types: an all-null chunk of a nullable column
                # must not emit a null-typed batch that clashes downstream
                yield records_to_batch(schema, rows)
                rows = []
        if rows:
            yield records_to_batch(schema, rows)


class FileInput(Input):
    def __init__(self, paths: list, fmt: Optional[str], query: Optional[str],
                 batch_rows: int):
        self.paths = paths
        self.fmt = fmt
        self.query = query
        self.batch_rows = batch_rows
        self._iter: Optional[Iterator[MessageBatch]] = None

    async def connect(self) -> None:
        formats = []
        for p in self.paths:
            formats.append(_check_ported(str(p), self.fmt))
            if not Path(p).exists():
                raise ConfigError(f"file input: {p} does not exist")
        self._iter = self._scan_all(formats)

    def _scan_all(self, formats: list[str]) -> Iterator[MessageBatch]:
        for p, fmt in zip(self.paths, formats):
            yield from _scan(Path(p), fmt, self.batch_rows)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._iter is None:
            raise ReadError("file input not connected")
        loop = asyncio.get_running_loop()
        while True:  # loop (not recurse) past fully-filtered chunks
            # off-loop: a scan blocks on disk and on parsing
            batch = await loop.run_in_executor(None, lambda: next(self._iter, None))
            if batch is None:
                raise EndOfInput()
            if self.query:
                ctx = SessionContext()
                ctx.register_batch("flow", batch)
                batch = ctx.sql(self.query)
                if batch.num_rows == 0:
                    continue
            return batch.with_source("file").with_ingest_time(), NoopAck()


def _paths(config: dict) -> list[str]:
    raw = config.get("path")
    if not raw:
        raise ConfigError("file input requires 'path'")
    return [str(p) for p in (raw if isinstance(raw, list) else [raw])]


def _check(config: dict) -> None:
    """Refuse an object-store path or an unported format wherever the
    config names it (a ``format`` or a known extension); a name whose
    format cannot be inferred is refused at connect, as JAX refuses it at
    the first read."""
    fmt = config.get("format")
    for p in _paths(config):
        if is_store_uri(p) or fmt in UNPORTED_FORMATS:
            _check_ported(p, fmt)
        elif fmt is None:
            try:
                inferred = _infer_format(Path(p))
            except ConfigError:
                continue
            if inferred in UNPORTED_FORMATS:
                _check_ported(p, inferred)


@register_input("file", keys=("path", "format", "query", "batch_rows"), check=_check)
def _build(config: dict, resource: Resource) -> FileInput:
    return FileInput(
        paths=_paths(config),
        fmt=config.get("format"),
        query=config.get("query"),
        batch_rows=int(config.get("batch_rows", DEFAULT_RECORD_BATCH_ROWS)),
    )
