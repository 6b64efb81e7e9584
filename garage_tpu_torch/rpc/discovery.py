"""Copy of garage_tpu/rpc/discovery.py: import paths rewritten, issue and PR tags dropped.

External peer discovery: Consul catalog and Kubernetes CRD.

Ref parity: src/rpc/consul.rs:230 (agent service registration +
catalog lookup) and src/rpc/kubernetes.rs:114 (GarageNode custom
resources). Providers publish this node's (id, rpc addr) and return the
set of advertised peers; System's discovery loop merges them into the
peering manager alongside bootstrap peers, so nodes find each other on
elastic platforms without static peer lists.

HTTP is stdlib urllib driven through asyncio.to_thread — discovery is
low-rate control traffic and must not add client library dependencies.
"""

from __future__ import annotations

import asyncio
import json
import logging
import ssl
import urllib.request
from typing import Optional

log = logging.getLogger("garage_tpu_torch.rpc.discovery")

Peer = tuple[tuple[str, int], Optional[bytes]]


class DiscoveryProvider:
    async def register(self, node_id: bytes, addr: tuple[str, int]) -> None:
        raise NotImplementedError

    async def get_peers(self) -> list[Peer]:
        raise NotImplementedError


def _http(method: str, url: str, body: Optional[dict] = None,
          headers: Optional[dict] = None,
          ctx: Optional[ssl.SSLContext] = None,
          timeout: float = 10.0) -> tuple[int, bytes]:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("content-type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=ctx) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class ConsulDiscovery(DiscoveryProvider):
    """ref: rpc/consul.rs — agent service register + catalog service
    lookup; the node id travels in the service meta."""

    def __init__(self, consul_http_addr: str, service_name: str,
                 tags: Optional[list[str]] = None):
        self.base = consul_http_addr.rstrip("/")
        if not self.base.startswith("http"):
            self.base = "http://" + self.base
        self.service_name = service_name
        self.tags = tags or []

    async def register(self, node_id: bytes, addr: tuple[str, int]) -> None:
        payload = {
            "Name": self.service_name,
            "ID": f"{self.service_name}-{node_id.hex()[:16]}",
            "Address": addr[0],
            "Port": addr[1],
            "Tags": self.tags,
            "Meta": {"node_id": node_id.hex()},
        }
        status, body = await asyncio.to_thread(
            _http, "PUT", f"{self.base}/v1/agent/service/register", payload)
        if status != 200:
            raise RuntimeError(
                f"consul register failed: {status} {body[:200]!r}")

    async def get_peers(self) -> list[Peer]:
        status, body = await asyncio.to_thread(
            _http, "GET",
            f"{self.base}/v1/catalog/service/{self.service_name}")
        if status != 200:
            raise RuntimeError(
                f"consul catalog failed: {status} {body[:200]!r}")
        out: list[Peer] = []
        for svc in json.loads(body.decode()):
            host = svc.get("ServiceAddress") or svc.get("Address")
            port = svc.get("ServicePort")
            if not host or not port:
                continue
            nid = None
            meta = svc.get("ServiceMeta") or {}
            if meta.get("node_id"):
                try:
                    nid = bytes.fromhex(meta["node_id"])
                except ValueError:
                    pass
            out.append(((host, int(port)), nid))
        return out


class KubernetesDiscovery(DiscoveryProvider):
    """ref: rpc/kubernetes.rs — GarageNode custom resources in a
    namespace; each node upserts its own CR and lists the others. Runs
    with the in-pod service account by default."""

    GROUP = "deuxfleurs.fr"
    VERSION = "v1"
    PLURAL = "garagenodes"

    def __init__(self, namespace: str, service_name: str,
                 api_server: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_cert: Optional[str] = None):
        self.namespace = namespace
        self.service_name = service_name
        self.api = (api_server or
                    "https://kubernetes.default.svc").rstrip("/")
        self._token = token
        self._ca = ca_cert
        self._ctx: Optional[ssl.SSLContext] = None

    def _headers(self) -> dict:
        token = self._token
        if token is None:
            try:
                with open("/var/run/secrets/kubernetes.io/serviceaccount"
                          "/token") as f:
                    token = f.read().strip()
            except OSError:
                token = ""
        return {"authorization": f"Bearer {token}"} if token else {}

    def _ssl(self) -> Optional[ssl.SSLContext]:
        if not self.api.startswith("https"):
            return None
        if self._ctx is None:
            ca = self._ca or ("/var/run/secrets/kubernetes.io/"
                              "serviceaccount/ca.crt")
            try:
                self._ctx = ssl.create_default_context(cafile=ca)
            except (OSError, ssl.SSLError):
                self._ctx = ssl.create_default_context()
        return self._ctx

    def _url(self, name: str = "") -> str:
        base = (f"{self.api}/apis/{self.GROUP}/{self.VERSION}"
                f"/namespaces/{self.namespace}/{self.PLURAL}")
        return f"{base}/{name}" if name else base

    async def register(self, node_id: bytes, addr: tuple[str, int]) -> None:
        name = f"{self.service_name}-{node_id.hex()[:16]}"
        cr = {
            "apiVersion": f"{self.GROUP}/{self.VERSION}",
            "kind": "GarageNode",
            "metadata": {"name": name},
            "spec": {"hostname": addr[0], "port": addr[1],
                     "nodeId": node_id.hex()},
        }
        # _headers() reads the service-account token file — build it
        # INSIDE the worker thread (as a to_thread argument it would
        # evaluate on the loop before the hop)
        status, body = await asyncio.to_thread(
            lambda: _http("PUT", self._url(name), cr, self._headers(),
                          self._ssl()))
        if status == 404:  # CR does not exist yet: create
            status, body = await asyncio.to_thread(
                lambda: _http("POST", self._url(), cr, self._headers(),
                              self._ssl()))
        if status not in (200, 201):
            raise RuntimeError(
                f"kubernetes register failed: {status} {body[:200]!r}")

    async def get_peers(self) -> list[Peer]:
        status, body = await asyncio.to_thread(
            lambda: _http("GET", self._url(), None, self._headers(),
                          self._ssl()))
        if status != 200:
            raise RuntimeError(
                f"kubernetes list failed: {status} {body[:200]!r}")
        out: list[Peer] = []
        for item in json.loads(body.decode()).get("items", []):
            spec = item.get("spec") or {}
            host, port = spec.get("hostname"), spec.get("port")
            if not host or not port:
                continue
            nid = None
            if spec.get("nodeId"):
                try:
                    nid = bytes.fromhex(spec["nodeId"])
                except ValueError:
                    pass
            out.append(((host, int(port)), nid))
        return out


def providers_from_config(config) -> list[DiscoveryProvider]:
    out: list[DiscoveryProvider] = []
    if getattr(config, "consul_http_addr", None):
        out.append(ConsulDiscovery(
            config.consul_http_addr,
            getattr(config, "consul_service_name", None) or "garage",
        ))
    if getattr(config, "kubernetes_namespace", None):
        out.append(KubernetesDiscovery(
            config.kubernetes_namespace,
            getattr(config, "kubernetes_service_name", None) or "garage",
        ))
    return out
