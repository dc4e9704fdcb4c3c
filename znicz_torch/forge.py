"""The model forge (port of ``znicz_tpu/forge.py``): a registry of
packaged models, served over HTTP.

  - :class:`Forge`: the registry, a local directory with one directory a
    package (``model.pickle.gz`` and ``manifest.json``);
  - :class:`ForgeServer`: serves a registry over HTTP (the standard
    library's ``ThreadingHTTPServer``, as ``web_status``);
  - :class:`RemoteForge`: the client, with ``Forge``'s ``upload``,
    ``download``, ``manifest``, ``list`` and ``delete``, against a
    server's URL.

::

    forge = Forge()                      # root.common.dirs.forge
    forge.upload(workflow, "mnist-mlp", metadata={...})
    snap = forge.download("mnist-mlp")   # a snapshot dict: restore() it
    server = ForgeServer(port=0).start()
    remote = RemoteForge(server.url)

A package is :func:`pack`'s gzipped pickle of ``snapshotter.collect``'s
dict (numpy leaves, the host-pickle format) with the config tree; a
package the reference packed unpickles into the same layout, which
``snapshotter.restore`` applies.  Packages are pickles, so a
``RemoteForge`` talks to a loopback URL only unless told otherwise, and a
name that would leave the registry is refused.  The client never goes
through a proxy.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import time
from typing import Dict, List, Optional

from znicz_torch.core.config import root

root.common.dirs.defaults({"forge": "forge_registry"})


class Forge:
    def __init__(self, registry: Optional[str] = None):
        self.registry = registry or root.common.dirs.get("forge",
                                                         "forge_registry")
        os.makedirs(self.registry, exist_ok=True)

    def _pkg_dir(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in name)
        if not safe.strip("_"):
            raise ValueError(f"invalid package name {name!r}")
        path = os.path.join(self.registry, safe)
        # never resolve outside the registry
        if not os.path.realpath(path).startswith(
                os.path.realpath(self.registry) + os.sep):
            raise ValueError(f"package name {name!r} escapes the registry")
        return path

    def upload(self, workflow, name: str,
               metadata: Optional[Dict] = None) -> str:
        blob, manifest = pack(workflow, name, metadata)
        return self.put_package(name, blob, manifest)

    def put_package(self, name: str, blob: bytes, manifest: Dict) -> str:
        """Store an already packed model (the server's upload path)."""
        d = self._pkg_dir(name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "model.pickle.gz"), "wb") as f:
            f.write(blob)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return name

    def get_blob(self, name: str) -> bytes:
        with open(os.path.join(self._pkg_dir(name),
                               "model.pickle.gz"), "rb") as f:
            return f.read()

    def download(self, name: str) -> Dict:
        with gzip.open(os.path.join(self._pkg_dir(name),
                                    "model.pickle.gz"), "rb") as f:
            return pickle.load(f)

    def manifest(self, name: str) -> Dict:
        with open(os.path.join(self._pkg_dir(name), "manifest.json")) as f:
            return json.load(f)

    def list(self) -> List[Dict]:
        out = []
        for entry in sorted(os.listdir(self.registry)):
            path = os.path.join(self.registry, entry, "manifest.json")
            if os.path.exists(path):
                with open(path) as f:
                    out.append(json.load(f))
        return out

    def delete(self, name: str) -> None:
        import shutil

        d = self._pkg_dir(name)
        if os.path.isdir(d):
            shutil.rmtree(d)


def pack(workflow, name: str, metadata: Optional[Dict] = None):
    """A workflow packed: (gzipped pickle blob, manifest dict).  The
    parameters and velocities are pulled from the device."""
    from znicz_torch import snapshotter

    snap = snapshotter.collect(workflow)
    snap["config"] = root.to_dict()
    blob = gzip.compress(pickle.dumps(snap,
                                      protocol=pickle.HIGHEST_PROTOCOL))
    manifest = {"name": name, "workflow": workflow.name,
                "time": time.time(), "metadata": metadata or {}}
    return blob, manifest


class ForgeServer:
    """A :class:`Forge` registry over HTTP.

      GET    /list                -> the manifests, as JSON
      GET    /pkg/<name>/manifest -> a manifest
      GET    /pkg/<name>/model    -> the package's blob
      POST   /pkg/<name>          -> upload: the manifest's JSON, then the
                                     blob (``X-Forge-Manifest-Length``
                                     gives the manifest's bytes)
      DELETE /pkg/<name>          -> remove the package
    """

    def __init__(self, registry: Optional[str] = None, port: int = 0,
                 host: str = "127.0.0.1"):
        self.forge = Forge(registry)
        self.host, self.port = host, int(port)
        self._server = None
        self._thread = None

    def _make_handler(self):
        from http.server import BaseHTTPRequestHandler

        forge = self.forge

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _pkg_name(self):
                parts = self.path.strip("/").split("/")
                return parts[1] if len(parts) >= 2 and parts[0] == "pkg" \
                    else None

            def do_GET(self):
                try:
                    if self.path == "/list":
                        return self._reply(
                            200, json.dumps(forge.list()).encode())
                    name = self._pkg_name()
                    if name and self.path.endswith("/manifest"):
                        return self._reply(
                            200, json.dumps(forge.manifest(name)).encode())
                    if name and self.path.endswith("/model"):
                        return self._reply(200, forge.get_blob(name),
                                           "application/octet-stream")
                    self._reply(404, b'{"error": "not found"}')
                except (FileNotFoundError, ValueError) as exc:
                    self._reply(404, json.dumps(
                        {"error": str(exc)}).encode())

            def do_POST(self):
                try:
                    name = self._pkg_name()
                    if not name:
                        return self._reply(404, b'{"error": "not found"}')
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    # the manifest leads the body: user metadata may be
                    # larger than a header line may be
                    mlen = int(self.headers.get("X-Forge-Manifest-Length",
                                                0))
                    manifest = json.loads(body[:mlen]) if mlen else {}
                    manifest.setdefault("name", name)
                    forge.put_package(name, body[mlen:], manifest)
                    self._reply(200, b'{"ok": true}')
                except (ValueError, OSError) as exc:
                    self._reply(400, json.dumps(
                        {"error": str(exc)}).encode())

            def do_DELETE(self):
                try:
                    name = self._pkg_name()
                    if not name:
                        return self._reply(404, b'{"error": "not found"}')
                    forge.delete(name)
                    self._reply(200, b'{"ok": true}')
                except (ValueError, OSError) as exc:
                    self._reply(400, json.dumps(
                        {"error": str(exc)}).encode())

        return Handler

    def start(self) -> "ForgeServer":
        import threading
        from http.server import ThreadingHTTPServer

        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class RemoteForge:
    """The client of a :class:`ForgeServer`, with :class:`Forge`'s API.
    A download is a pickle from the registry, so a URL that is not on a
    loopback host needs ``allow_remote=True``."""

    def __init__(self, url: str, allow_remote: bool = False):
        from urllib.parse import urlparse

        from znicz_torch.network_common import is_loopback_host

        self.url = url.rstrip("/")
        host = urlparse(self.url).hostname or ""
        if not allow_remote and not is_loopback_host(host):
            raise ValueError(
                f"refusing non-loopback forge {host!r}: packages are "
                f"pickled code — pass allow_remote=True only for a "
                f"registry you trust")

    def _request(self, path: str, data: Optional[bytes] = None,
                 method: Optional[str] = None, headers: Optional[Dict] = None):
        from urllib.request import ProxyHandler, Request, build_opener

        req = Request(self.url + path, data=data, method=method,
                      headers=headers or {})
        # straight to the registry: no proxy of the environment
        with build_opener(ProxyHandler({})).open(req, timeout=30) as resp:
            return resp.read()

    def upload(self, workflow, name: str,
               metadata: Optional[Dict] = None) -> str:
        blob, manifest = pack(workflow, name, metadata)
        return self.put_package(name, blob, manifest)

    def put_package(self, name: str, blob: bytes, manifest: Dict) -> str:
        """Upload an already packed model."""
        mbytes = json.dumps(manifest).encode()
        self._request(
            f"/pkg/{name}", data=mbytes + blob, method="POST",
            headers={"X-Forge-Manifest-Length": str(len(mbytes)),
                     "Content-Type": "application/octet-stream"})
        return name

    def get_blob(self, name: str) -> bytes:
        return self._request(f"/pkg/{name}/model")

    def download(self, name: str) -> Dict:
        return pickle.loads(gzip.decompress(self.get_blob(name)))

    def manifest(self, name: str) -> Dict:
        return json.loads(self._request(f"/pkg/{name}/manifest"))

    def list(self) -> List[Dict]:
        return json.loads(self._request("/list"))

    def delete(self, name: str) -> None:
        self._request(f"/pkg/{name}", method="DELETE")
