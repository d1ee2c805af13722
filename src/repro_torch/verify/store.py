"""Persistent on-disk warm-start cache (content-addressed verify store).

A :class:`repro_torch.verify.Session` dies with its process, so a CI fleet
or a model-dev inner loop re-pays tracing, fingerprinting and the full rule
fixpoint on every invocation — and the roofline rows show tracing dominates
those cold verifies end-to-end.  :class:`DiskCache` makes the session's
warm state survive restarts: after a cold clean verify the traced
:class:`~repro_torch.core.ir.Graph` pair and its
:class:`~repro_torch.core.partition.TemplateCache` (per-layer fact templates +
structural parts) are serialized under a **content address**, and a fresh
process pointed at the same ``--cache-dir`` replays them instead of
re-tracing.

Key layout
----------
The entry filename is ``sha256(repr((store schema, rules hash, session
key)))``, where the session key already encodes (arch, config hash,
scenario name/size, plan layers/batch/seq/max_len/stages/tp, axes, stamp
mode) — i.e. everything that determines the traced pair — and the **rules
hash** digests the rule registry's full description (names, op coverage,
consumed/produced kinds), the fact-kind universe, the report schema, the
:class:`~repro_torch.core.ir.Node` field layout and the torch version.  Any change
to the rule set or the serialized structures changes the address: a stale
entry is simply never *found*, and a clean run repopulates it.

Safety
------
Loads are belt-and-braces: magic + payload digest (torn/truncated writes),
schema + rules-hash + key re-check inside the payload (address collisions),
and ``stable_digest`` re-verification of both graphs after unpickling.
*Any* failure — corrupt zlib stream, unpickling error, digest mismatch —
returns ``None`` and the caller falls back to a cold verify: a damaged
cache can cost time, never a wrong verdict.  Writes go through a temp file
+ ``os.replace`` so concurrent processes sharing a cache dir see either the
old entry or the new one, never a torn write.

Structural fingerprints (``Graph.fingerprint``) are Python ``hash()``
values and therefore process-local (PYTHONHASHSEED): a persisted
``TemplateCache`` stays internally consistent across processes because the
``struct`` cache — keyed on stable plan keys — *stores* the fingerprints
that the ``memo`` keys embed.  A load into a fresh process serves both from
the same pickle, so lookups agree; at worst a struct miss degrades to a
recomputed (differently-salted) fingerprint and a memo miss — slower,
never wrong.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import zlib
from typing import Optional

# bump when the on-disk layout or any pickled structure changes shape
STORE_SCHEMA_VERSION = 1

_MAGIC = b"RVCACHE1"

_rules_hash: Optional[str] = None


def rules_schema_hash() -> str:
    """Digest of everything a cache entry's validity depends on besides the
    session key: rule registry description, fact kinds, store + report
    schema versions, Node field layout, torch version."""
    global _rules_hash
    if _rules_hash is None:
        import dataclasses

        import torch

        from repro_torch.core.ir import Node
        from repro_torch.core.relations import KINDS
        from repro_torch.core.report import JSON_SCHEMA_VERSION
        from repro_torch.core.rules import DEFAULT_REGISTRY

        h = hashlib.sha256()
        h.update(str(STORE_SCHEMA_VERSION).encode())
        h.update(str(JSON_SCHEMA_VERSION).encode())
        h.update(repr(KINDS).encode())
        h.update(DEFAULT_REGISTRY.describe().encode())
        h.update(repr([f.name for f in dataclasses.fields(Node)]).encode())
        h.update(torch.__version__.encode())
        _rules_hash = h.hexdigest()
    return _rules_hash


class DiskCache:
    """Content-addressed store of (GraphPair, TemplateCache) entries."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.saves = 0

    # ----------------------------------------------------------------- paths
    def _path(self, key: tuple) -> str:
        addr = hashlib.sha256(
            repr((STORE_SCHEMA_VERSION, rules_schema_hash(), key)).encode()
        ).hexdigest()
        return os.path.join(self.root, addr + ".pkl")

    # ------------------------------------------------------------------ load
    def load(self, key: tuple):
        """``(pair, templates)`` for ``key``, or ``None`` on any miss,
        mismatch or corruption (cold-fallback contract)."""
        path = self._path(key)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
            if raw[: len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic")
            digest, blob = raw[len(_MAGIC):len(_MAGIC) + 32], raw[len(_MAGIC) + 32:]
            if hashlib.sha256(blob).digest() != digest:
                raise ValueError("payload digest mismatch")
            entry = pickle.loads(zlib.decompress(blob))
            if (entry["schema"] != STORE_SCHEMA_VERSION
                    or entry["rules"] != rules_schema_hash()
                    or entry["key"] != repr(key)):
                raise ValueError("stale entry")
            pair, templates = entry["data"]
            if (pair.base.stable_digest(), pair.dist.stable_digest()) != entry["digests"]:
                raise ValueError("graph digest mismatch")
        except Exception:
            self.misses += 1
            return None
        self.hits += 1
        return pair, templates

    # ------------------------------------------------------------------ save
    def save(self, key: tuple, pair, templates) -> bool:
        """Persist an entry atomically; returns False (and leaves no partial
        file) if anything in it refuses to pickle."""
        path = self._path(key)
        try:
            blob = zlib.compress(pickle.dumps(
                {
                    "schema": STORE_SCHEMA_VERSION,
                    "rules": rules_schema_hash(),
                    "key": repr(key),
                    "digests": (pair.base.stable_digest(),
                                pair.dist.stable_digest()),
                    "data": (pair, templates),
                },
                protocol=pickle.HIGHEST_PROTOCOL), 1)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(hashlib.sha256(blob).digest())
                fh.write(blob)
            os.replace(tmp, path)
        except Exception:
            return False
        self.saves += 1
        return True
