"""The served forward's build cache (port of
``znicz_tpu/serving/aot_cache.py``): what a restarted replica would
build again is kept on disk next to its snapshot, so the replica loads
it instead.

**What the family is.**  The reference caches XLA executables, one for
each ladder rung, serialised whole.  The port's served forward has two
parts, and only one of them can be kept:

  - *the kernel libraries* its forward launches (``_build.py`` compiles
    ``csrc/*.cu`` with ``nvcc`` into ``build/kernels/<name>-<sha1>.so`` at
    first use).  A library is a file: it is cached, one entry a library;
  - *one CUDA graph a rung* (``serving/model.py``).  A graph holds this
    process's device addresses and its memory pool, so it cannot be
    written to disk: every boot captures each rung again.

**Keys.**  One file an entry, named by ``sha256(canonical JSON of
{family, entry})``:

  - the FAMILY key (:func:`family_key`) is the reference's structural
    fingerprint (each unit's parameter shapes and dtypes, the sample
    shape, the staging dtype, the mesh, the donation flag), so a canary
    of new weights and the same architecture hits, with the toolchain in
    place of jax's versions: torch, its CUDA, ``nvcc``'s version, the
    device's name and compute capability;
  - the ENTRY key names one library: its name, the digest of its source,
    the shared headers and the flags, and the flags
    (``_build.library_entry``).

A changed toolchain, device or source therefore never loads a stale
library: the file name diverges.  An entry that resolves but cannot be
trusted (a truncated file, a foreign pickle, a tampered key, an image
whose digest is not the one stored with it, a library that does not load
or lacks one of its C functions) is **refused**:
counted, logged with its reason, removed, and the library is built and
stored again.  The cache is advisory, never trusted.

**Counting.**  The counters are the reference's
``warmup_cache_{hits,misses,stores,refusals,store_failures}``, the
``warmup`` scope's registry counters (process-wide, the latest cache
wins), beside each cache's own tallies under a lock, which the proofs
read.  A library is loaded once a process, and every
runner in it shares it: each runner counts the libraries its own warmup
asked for by where the process got them (the cache: a hit; ``nvcc`` or
the build directory: a miss), so two replicas in one process both count
the shared libraries, with the same origin.

Wire-in: ``ModelRunner.enable_aot_cache`` (``serving/model.py``) arms
one :class:`ExecutableCache` for the process's builder
(``_build.set_library_cache``) before the warmup; the frontend arms it
from ``root.common.serving.aot_cache.{enabled,dir}`` and refuses to
become ready on a failed warm proof (``ModelRunner.warm_proof``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import pickle
import threading
import uuid
from typing import Dict, Iterable

log = logging.getLogger("znicz_torch.serving")


def available() -> bool:
    """True: the cache keeps files, which every build of the port can
    write (the reference's depends on its jax build)."""
    return True


def dir_for_snapshot(snapshot_path: str) -> str:
    """The cache directory of a snapshot: ``aot_cache/`` next to it, so
    the cache travels with the weights it warms."""
    return os.path.join(
        os.path.dirname(os.path.abspath(snapshot_path)), "aot_cache")


def family_key(runner) -> Dict:
    """The structural fingerprint of a runner's family: parameter shapes
    and dtypes a unit, never the weights, and the toolchain and device
    that built the libraries."""
    import torch

    from znicz_torch import _build

    units = {name: {k: [list(map(int, t.shape)),
                        str(t.dtype).replace("torch.", "")]
                    for k, t in sorted(leaves.items())}
             for name, leaves in sorted(runner._active.tree.items())}
    dev = runner.device
    if dev.type == "cuda":
        device = torch.cuda.get_device_name(dev)
        capability = list(torch.cuda.get_device_capability(dev))
    else:
        device, capability = dev.type, None
    return {"units": units,
            "sample_shape": list(map(int, runner.sample_shape)),
            "dtype": str(runner.dtype),
            "mesh": runner.mesh_shape,
            "donate": False,
            "torch": str(torch.__version__),
            "cuda": torch.version.cuda,
            "nvcc": _build.nvcc_version() if dev.type == "cuda" else "",
            "device": device,
            "capability": capability}


class ExecutableCache:
    """One snapshot directory's cache for one family.  ``load_library`` /
    ``store_library`` move single entries; ``hit`` / ``miss`` are ticked
    by the runner once its warmup knows where each library came from.
    ``fetch`` / ``keep`` are the builder's hooks (``_build.build``)."""

    COUNTERS = {
        "warmup_cache_hits": "executables loaded from the AOT cache "
                             "instead of compiled",
        "warmup_cache_misses": "executables compiled (absent or refused "
                               "cache entry)",
        "warmup_cache_stores": "freshly compiled executables serialized "
                               "into the cache",
        "warmup_cache_refusals": "cache entries refused (corrupt/stale/"
                                 "version-mismatched/failed validation) "
                                 "— recompiled, never trusted",
        "warmup_cache_store_failures": "serialize/write failures (cache "
                                       "stays cold for that entry; "
                                       "serving unaffected)",
    }

    def __init__(self, directory: str, family: Dict):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.family = family
        self._lock = threading.Lock()
        # the process-wide counters of the ``warmup`` scope (latest
        # cache wins), beside this cache's own tallies, which the proofs
        # read
        from znicz_torch import telemetry

        _sc = telemetry.scope("warmup")
        self._m = {name: _sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        self._n = {"hits": 0, "misses": 0, "stores": 0, "refusals": 0,
                   "store_failures": 0}

    def _inc(self, name: str) -> None:
        self._m[f"warmup_cache_{name}"].inc()
        with self._lock:
            self._n[name] += 1

    def _key(self, entry: Dict) -> Dict:
        return {"family": self.family, "entry": entry}

    def path(self, entry: Dict) -> str:
        digest = hashlib.sha256(
            json.dumps(self._key(entry), sort_keys=True,
                       separators=(",", ":")).encode()).hexdigest()
        return os.path.join(self.directory, digest[:32] + ".aot")

    def load_library(self, entry: Dict, target: str,
                     symbols: Iterable[str]) -> bool:
        """Install entry's library at ``target`` and check it: it loads,
        and every C function of ``symbols`` resolves.  False when the
        entry is absent, or refused (counted here: an undecodable file, a
        key that is not the entry's, a library that does not load or
        lacks a function); a refused entry is removed, and ``target``
        too."""
        path = self.path(entry)
        if not os.path.exists(path):
            return False
        # checked under a name of its own (the loader keeps one copy of a
        # file however it is named, and a name loaded before would be
        # answered without reading the file), then renamed into place
        tmp = f"{target}.check-{uuid.uuid4().hex}"
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            if not isinstance(blob, dict) or \
                    blob.get("key") != self._key(entry):
                raise ValueError("cached key does not match the requested "
                                 "entry (stale or tampered)")
            payload = blob["payload"]
            if not isinstance(payload, bytes) or hashlib.sha256(
                    payload).hexdigest() != blob.get("sha256"):
                # checked before the loader maps it: a cut image would
                # fault the process, not raise
                raise ValueError("library image does not match its "
                                 "digest (truncated or altered)")
            with open(tmp, "wb") as f:
                f.write(payload)
            lib = ctypes.CDLL(os.path.abspath(tmp))
            for sym in symbols:
                getattr(lib, sym)
            os.replace(tmp, target)
        except Exception as exc:
            for p in (tmp, target, path):
                try:
                    os.remove(p)
                except OSError:
                    pass
            self.refuse(entry, exc)
            return False
        return True

    def store_library(self, entry: Dict, source: str) -> bool:
        """Keep the library file ``source`` as the entry (an atomic write:
        a half-written entry never survives a crash).  A failure leaves
        the cache cold for the entry and serving untouched."""
        try:
            with open(source, "rb") as f:
                payload = f.read()
            _atomic_write(self.path(entry), pickle.dumps(
                {"key": self._key(entry), "payload": payload,
                 "sha256": hashlib.sha256(payload).hexdigest()},
                protocol=pickle.HIGHEST_PROTOCOL))
        except Exception as exc:
            self._inc("store_failures")
            log.warning("aot cache: store failed for %s: %s", entry, exc)
            return False
        self._inc("stores")
        return True

    def holds(self, entry: Dict) -> bool:
        return os.path.exists(self.path(entry))

    # -- the builder's hooks ---------------------------------------------------

    def fetch(self, name: str, target) -> bool:
        """Kernel library ``name`` into ``target`` from the cache."""
        from znicz_torch import _build

        return self.load_library(_build.library_entry(name), str(target),
                                 _build.library_symbols(name))

    def keep(self, name: str, path) -> bool:
        """Kernel library ``name``, built at ``path``, into the cache."""
        from znicz_torch import _build

        return self.store_library(_build.library_entry(name), str(path))

    # -- counters --------------------------------------------------------------

    def hit(self) -> None:
        self._inc("hits")

    def miss(self) -> None:
        self._inc("misses")

    def refuse(self, entry: Dict, exc: BaseException) -> None:
        """A readable refusal: the entry exists but cannot be trusted; the
        caller builds the library and stores it over the entry."""
        self._inc("refusals")
        log.warning("aot cache: refused entry %s (%s: %s) — recompiling",
                    entry, type(exc).__name__, exc)

    @property
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)

    def stats(self) -> Dict:
        return {"directory": self.directory, **self.counts}


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)

