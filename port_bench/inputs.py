"""Weights and prompts made from the seed, on the device, by the benchmark.

The weights take the program's parameter layout (the tree that
``Model.init`` returns, its shapes and dtypes), but every value is drawn
here, over the program's own draw, so the reference and the program get the
same tensors and neither depends on the program's initialiser.  Every leaf
is one ``torch.randn`` call of the leaf's whole (layer-stacked) shape on
the card: a norm scale is 1 + N(0, 0.1^2) and a bias N(0, 0.1^2), so a
missing scale or bias shows in the comparison; the embedding and every
matrix are N(0, 1 / d_in), which keeps activations and logits of order 1.
"""
from __future__ import annotations

import torch


def leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def key(path: tuple) -> str:
    """A leaf's path as one name: ``blocks/0/attn/wq/w``."""
    return "/".join(map(str, path))


def rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _draw_leaf(gen: torch.Generator, path: tuple, x: torch.Tensor, d_model: int) -> None:
    torch.randn(x.shape, generator=gen, out=x)
    name = path[-1]
    if name == "s":  # a norm's scale
        x.mul_(0.1).add_(1.0)
    elif name == "b":
        x.mul_(0.1)
    else:
        x.mul_((d_model if path[:2] == ("embed", "w") else x.shape[-2]) ** -0.5)


def draw_weights(model, gen: torch.Generator):
    """The program's parameter tree for ``model``, every leaf drawn anew
    from ``gen`` in sorted path order."""
    params = model.init(torch.Generator(device=gen.device))
    for path, leaf in leaves(params):
        _draw_leaf(gen, path, leaf, model.cfg.d_model)
    return params


def token_pool(gen: torch.Generator, vocab: int, n: int) -> torch.Tensor:
    """``n`` token ids uniform over the published vocabulary, on the card."""
    return torch.randint(0, vocab, (n,), generator=gen, device=gen.device)
