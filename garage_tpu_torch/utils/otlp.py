"""Copy of garage_tpu/utils/otlp.py: import paths rewritten, issue and PR tags dropped.

OTLP/HTTP span export: ship finished spans to a standard collector.

Ref parity: src/garage/tracing_setup.rs:13-37 — the reference installs
an opentelemetry-otlp pipeline (service.name=garage,
service.instance.id=first 8 bytes of the node id, batch export). This
build exports the same span topology over OTLP/HTTP **JSON**
(`POST {endpoint}/v1/traces`, Content-Type application/json), the
dependency-free encoding of the OTLP protocol, from a background
thread so a slow or dead collector never touches the data path.

Internal span ids are 8-hex trace / 8-hex span tokens
(utils/tracing.py); OTLP requires 16-byte trace ids and 8-byte span
ids, so ids are left-zero-padded to wire width.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import urllib.request
from typing import Optional

log = logging.getLogger("garage_tpu_torch.otlp")

_BATCH = 256          # spans per POST
_FLUSH_SECS = 3.0     # max latency before a partial batch ships
_QUEUE_MAX = 8192     # drop-oldest beyond this: never block producers


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def span_to_otlp(rec: dict) -> dict:
    """One tracer ring/JSONL record -> an OTLP Span object."""
    start_ns = rec["start_us"] * 1000
    end_ns = (rec["start_us"] + rec["dur_us"]) * 1000
    out = {
        "traceId": rec["trace"].rjust(32, "0"),
        "spanId": rec["span"].rjust(16, "0"),
        "name": rec["name"],
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
    }
    if rec.get("parent"):
        out["parentSpanId"] = rec["parent"].rjust(16, "0")
    attrs = [_attr(k, v) for k, v in (rec.get("attrs") or {}).items()]
    if attrs:
        out["attributes"] = attrs
    if rec.get("error"):
        out["status"] = {"code": 2, "message": rec["error"]}  # ERROR
    return out


class OtlpExporter:
    """Background OTLP/HTTP JSON exporter fed by a tracer sink."""

    def __init__(self, endpoint: str, instance_id: str,
                 service_name: str = "garage"):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.resource = {
            "attributes": [
                _attr("service.name", service_name),
                _attr("service.instance.id", instance_id),
            ]
        }
        self._q: queue.Queue = queue.Queue(maxsize=_QUEUE_MAX)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="otlp-export")
        self.sent_spans = 0
        self.dropped_spans = 0
        self.failed_posts = 0

    # ---- producer side (called from Tracer.emit) -----------------------

    def sink(self, rec: dict) -> None:
        try:
            self._q.put_nowait(rec)
        except queue.Full:
            self.dropped_spans += 1

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> "OtlpExporter":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the drain loop
        except queue.Full:
            pass  # the drain loop's flush tick notices _stop itself
        self._thread.join(timeout)

    # ---- consumer ------------------------------------------------------

    def _run(self) -> None:
        batch: list[dict] = []
        while True:
            try:
                rec = self._q.get(timeout=_FLUSH_SECS)
            except queue.Empty:
                rec = False  # timeout tick: flush partial batch
            if rec:
                batch.append(rec)
            if batch and (len(batch) >= _BATCH or not rec):
                self._post(batch)
                batch = []
            if rec is None or (self._stop.is_set() and self._q.empty()):
                if batch:
                    self._post(batch)
                return

    def _post(self, batch: list[dict]) -> None:
        payload = json.dumps({
            "resourceSpans": [{
                "resource": self.resource,
                "scopeSpans": [{
                    "scope": {"name": "garage_tpu"},
                    "spans": [span_to_otlp(r) for r in batch],
                }],
            }],
        }).encode()
        req = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=3.0) as resp:
                resp.read()
            self.sent_spans += len(batch)
        except Exception as e:  # collector down: drop, never propagate
            self.failed_posts += 1
            if self.failed_posts in (1, 10, 100):
                log.warning("OTLP export to %s failing (%s: %s)",
                            self.url, type(e).__name__, e)


_active: Optional[OtlpExporter] = None


def setup_otlp(endpoint: str, node_id: bytes) -> OtlpExporter:
    """Wire an exporter into the process tracer (ref:
    tracing_setup.rs init_tracing: instance id = first 8 node-id
    bytes). Enables span recording if it wasn't already."""
    global _active
    from .tracing import tracer

    exp = OtlpExporter(endpoint, node_id[:8].hex()).start()
    tracer.sinks.append(exp.sink)
    tracer.enabled = True
    _active = exp
    return exp
