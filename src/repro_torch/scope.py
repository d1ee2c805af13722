"""Named scopes for traced nodes, the counterpart of ``jax.named_scope``.

``named_scope("layer3")`` nests its name under the enclosing scope path and
puts the path on every fx node traced inside it, as
``node.meta["custom"]["scope"]`` (through ``torch.fx.traceback.annotate``;
fx copies it onto nodes created under ``preserve_node_meta()``).  The
verifier's tracer turns ``layer<i>`` paths into layer tags and meta rules
match regions such as ``vp_embed`` by scope.  Outside a trace (no
``preserve_node_meta()``, which the tracer sets) it does nothing, so model
code keeps it on its run-time path at no cost.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch.fx.traceback as fx_traceback


def current_scope() -> str:
    return fx_traceback.current_meta.get("custom", {}).get("scope", "")


@contextmanager
def named_scope(name: str):
    if not fx_traceback.has_preserved_node_meta():
        yield
        return
    parent = current_scope()
    with fx_traceback.annotate({"scope": f"{parent}/{name}" if parent else name}):
        yield
