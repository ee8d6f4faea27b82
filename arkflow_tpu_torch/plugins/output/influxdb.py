"""InfluxDB output: line protocol over the v2 write API.

Counterpart of ``arkflow_tpu/plugins/output/influxdb.py``, on the stdlib
client ``utils/http1.HttpClient`` in place of aiohttp. ``encode_lines``
writes JAX's line protocol byte for byte (tag and field mappings, escaping,
field types, the optional timestamp column). Lines accumulate until
``batch_size`` of them are pending or the ``flush_interval`` flusher task
fires; a flush POSTs them with ``Authorization: Token <token>``, retries
``retries`` times with backoff ``min(2**attempt * 0.2, 5)`` s, and on
failure re-queues the lines (at most ``MAX_PENDING``) and raises
``WriteError``. ``close`` cancels the flusher and flushes what is pending.

One flush runs at a time: a write or the flusher that reaches a flush while
another is in its retries waits for it, so a retry goes out before any later
line and the lines keep their order. JAX's output has no such lock there,
and a later flush can overtake a retry (ROADMAP Queue C).

Config:

    type: influxdb
    url: http://localhost:8086
    org: myorg
    bucket: metrics
    token: "${INFLUX_TOKEN}"
    measurement: sensors        # literal or {value: ...}
    tags: {station: station}    # line tag -> column name
    fields: {value: value}      # line field -> column name
    timestamp_column: ts        # optional (epoch ns/ms/s int column)
    batch_size: 1000
    flush_interval: 1s
    retries: 3

An ``{expr: ...}`` measurement is evaluated on the batch, its first row.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.utils.auth import resolve_secret
from arkflow_tpu_torch.utils.duration import parse_duration
from arkflow_tpu_torch.utils.expr import DynValue, check_dyn_value
from arkflow_tpu_torch.utils.http1 import HttpClient, HttpClientError

logger = logging.getLogger("arkflow_torch.influxdb")


def _escape_tag(v: str) -> str:
    return v.replace("\\", "\\\\").replace(",", "\\,").replace(" ", "\\ ").replace("=", "\\=")


def _field_value(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return f"{v}i"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, bytes):
        v = v.decode("utf-8", "replace")
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'


def encode_lines(batch: MessageBatch, measurement: str, tags: dict[str, str],
                 fields: dict[str, str], timestamp_column: Optional[str]) -> list[str]:
    """Line protocol for one batch; a row with no field value writes no line."""
    lines = []
    for row in batch.to_pylist():
        parts = [_escape_tag(measurement)]
        for tag_name, col in tags.items():
            v = row.get(col)
            if v is not None:
                parts.append(f"{_escape_tag(tag_name)}={_escape_tag(str(v))}")
        fvals = []
        for field_name, col in fields.items():
            fv = _field_value(row.get(col))
            if fv is not None:
                fvals.append(f"{_escape_tag(field_name)}={fv}")
        if not fvals:
            continue  # influx requires at least one field
        line = ",".join(parts) + " " + ",".join(fvals)
        if timestamp_column and row.get(timestamp_column) is not None:
            line += f" {int(row[timestamp_column])}"
        lines.append(line)
    return lines


class InfluxDbOutput(Output):
    #: pending-line cap: past it a failing server sheds the oldest lines
    MAX_PENDING = 100_000

    def __init__(self, url: str, org: str, bucket: str, token: str,
                 measurement: DynValue, tags: dict, fields: dict,
                 timestamp_column: Optional[str], batch_size: int,
                 flush_interval_s: float, retries: int):
        self.write_url = f"{url.rstrip('/')}/api/v2/write?org={org}&bucket={bucket}"
        self.token = token
        self.measurement = measurement
        self.tags = tags
        self.fields = fields
        self.timestamp_column = timestamp_column
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.retries = retries
        self._pending: list[str] = []
        self._client: Optional[HttpClient] = None
        self._flusher: Optional[asyncio.Task] = None
        #: held for a whole flush, retries included
        self._flushing = asyncio.Lock()

    async def connect(self) -> None:
        self._client = HttpClient(headers={"Authorization": f"Token {self.token}"},
                                  timeout_s=30.0)
        self._flusher = asyncio.create_task(self._flush_loop())

    async def _flush_loop(self) -> None:
        while True:
            try:
                await asyncio.sleep(self.flush_interval_s)
                await self._flush()
            except asyncio.CancelledError:
                raise
            except WriteError as e:
                # the flusher stays alive; _flush re-queued the lines
                logger.warning("%s", e)

    async def _flush(self) -> None:
        async with self._flushing:
            if not self._pending:
                return
            lines = self._pending
            self._pending = []
            body = "\n".join(lines).encode()
            last: Optional[Exception] = None
            for attempt in range(self.retries + 1):
                try:
                    resp = await self._client.request("POST", self.write_url, body)
                    if resp.status < 300:
                        return
                    last = WriteError(f"influxdb {resp.status}: {resp.text()[:200]}")
                except HttpClientError as e:
                    last = e
                await asyncio.sleep(min(2.0 ** attempt * 0.2, 5.0))
            # re-queued so the lines survive a transient outage (bounded)
            self._pending = (lines + self._pending)[-self.MAX_PENDING:]
            raise WriteError(
                f"influxdb write failed after {self.retries + 1} attempts: {last}")

    async def write(self, batch: MessageBatch) -> None:
        measurement = str(self.measurement.eval_scalar(batch))
        self._pending.extend(
            encode_lines(batch, measurement, self.tags, self.fields, self.timestamp_column))
        if len(self._pending) >= self.batch_size:
            await self._flush()

    async def close(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except (asyncio.CancelledError, Exception):
                pass
            self._flusher = None
        try:
            if self._client is not None:
                await self._flush()
        finally:
            if self._client is not None:
                await self._client.close()
                self._client = None


def _check(config: dict) -> None:
    """JAX's builder's refusals, in its order."""
    for req in ("url", "org", "bucket", "token", "measurement", "fields"):
        if not config.get(req):
            raise ConfigError(f"influxdb output requires {req!r}")
    resolve_secret(str(config["token"]))
    check_dyn_value(config["measurement"], "measurement")
    parse_duration(config.get("flush_interval", "1s"))


@register_output("influxdb", keys=("url", "org", "bucket", "token", "measurement", "tags",
                                   "fields", "timestamp_column", "batch_size",
                                   "flush_interval", "retries"), check=_check)
def _build(config: dict, resource: Resource) -> InfluxDbOutput:
    return InfluxDbOutput(
        url=str(config["url"]),
        org=str(config["org"]),
        bucket=str(config["bucket"]),
        token=resolve_secret(str(config["token"])),
        measurement=DynValue.from_config(config["measurement"], "measurement"),
        tags=dict(config.get("tags") or {}),
        fields=dict(config["fields"]),
        timestamp_column=config.get("timestamp_column"),
        batch_size=int(config.get("batch_size", 1000)),
        flush_interval_s=parse_duration(config.get("flush_interval", "1s")),
        retries=int(config.get("retries", 3)),
    )
