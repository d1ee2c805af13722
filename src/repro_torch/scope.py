"""Named scopes for traced nodes, the counterpart of ``jax.named_scope``.

``named_scope("layer3")`` nests its name under the enclosing scope path and
puts the path on every fx node traced inside it, as
``node.meta["custom"]["scope"]`` (through ``torch.fx.traceback.annotate``;
fx copies it onto nodes created under ``preserve_node_meta()``).  The
verifier's tracer turns ``layer<i>`` paths into layer tags and meta rules
match regions such as ``vp_embed`` by scope.  Outside a trace (no
``preserve_node_meta()``, which the tracer sets) it does nothing, so model
code keeps it on its run-time path at no cost.

``span(name)`` is the run-time counterpart: inside :func:`spans` it opens a
``record_function`` range, which a kineto trace (``torch.profiler``) records
on the host beside the launches and kernels it encloses; elsewhere, and in
every verifier or dry-run trace, it does nothing.
"""
from __future__ import annotations

import contextlib
import math
from contextlib import contextmanager

import torch.fx.traceback as fx_traceback
from torch.autograd import profiler as _profiler


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


# -- run-time spans: the layers of a forward, for a profiler to record
SPANS = ("model.forward", "model.embed", "model.head",
         "attn.qkv", "attn.rope", "attn.core", "attn.out", "mlp",
         "moe.router", "moe.positions", "moe.gather", "moe.experts", "moe.combine",
         "ssm.proj", "ssm.conv", "ssm.scan", "ssm.norm", "ssm.out")
_spans_on = False
_OFF = contextlib.nullcontext()


@contextmanager
def spans():
    """Turn the run-time spans on for the block (they are off by default),
    then back to what they were."""
    global _spans_on
    prev, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = prev


def span(name: str):
    """A ``record_function(name)`` range inside :func:`spans`, outside any
    verifier trace (where it would land in the graph as profiler nodes);
    a shared no-op context otherwise."""
    if not _spans_on or fx_traceback.has_preserved_node_meta():
        return _OFF
    return _profiler.record_function(name)


# -- count mode: the dry run's loops traced once, each op counted as often as
# the loop would run it (the JAX tracer's ``scan_inline`` and its ``mult``)
_counting: frozenset = frozenset()
_keep = 1
_mults: list = []


@contextmanager
def counting(loops=("micro", "layer", "chunk", "ssd_chunk"), keep: int = 1):
    """Inside, each loop named in ``loops`` runs its first iteration only
    (:func:`trips`), and every op traced in that iteration carries
    ``mult``, the product of the trip counts of the counted loops around it,
    as ``node.meta["custom"]["mult"]`` (:func:`counted`).  The loops' carried
    values keep their shapes, so the program traces whole; what it computes
    is not the program's value, only its op counts are.  ``keep``: run that
    many iterations instead (an untraced run, whose memory repeats after
    them)."""
    global _counting, _keep
    prev, _counting, _keep = (_counting, _keep), frozenset(loops), keep
    try:
        yield
    finally:
        _counting, _keep = prev


def trips(n: int, loop: str) -> int:
    """How many iterations of ``loop`` (``n`` of them) to run: at most
    ``keep`` (1) in count mode, else ``n``."""
    return min(n, _keep) if loop in _counting else n


@contextmanager
def counted(n: int, loop: str):
    """Ops traced inside stand for ``n`` iterations of ``loop`` in count
    mode (nested counted regions multiply); a no-op otherwise.  A region
    that a checkpoint recomputes in the backward pass must open this
    inside the recomputed function, so its recomputation is counted too."""
    if loop not in _counting or n <= 1 or not fx_traceback.has_preserved_node_meta():
        yield
        return
    _mults.append(n)
    try:
        with fx_traceback.annotate({"mult": math.prod(_mults)}):
            yield
    finally:
        _mults.pop()


def loop(n: int, name: str):
    """``range(n)`` of a loop named ``name``: in count mode its first
    iteration, counted ``n`` times."""
    with counted(n, name):
        yield from range(trips(n, name))


# -- checkpoint recomputation under the verifier's tracer
_recompute_modes: list = []


@contextmanager
def recompute_under(mode):
    """Inside, a function that :func:`traced_recompute` wraps runs under
    ``mode`` (the tracer's ``TorchFunctionMode``) when ``mode`` is off, as
    it is while the backward pass runs inside its ``torch.autograd.grad``:
    a checkpoint's recomputation of its forward then traces as the forward
    did."""
    _recompute_modes.append(mode)
    try:
        yield
    finally:
        _recompute_modes.pop()


def traced_recompute(fn):
    """``fn`` for ``torch.utils.checkpoint``: run under the innermost
    :func:`recompute_under` mode where that mode is not on."""
    import torch.overrides

    def run(*args, **kwargs):
        mode = _recompute_modes[-1] if _recompute_modes else None
        if mode is None or mode in torch.overrides._get_current_function_mode_stack():
            return fn(*args, **kwargs)
        with mode:
            return fn(*args, **kwargs)
    return run
