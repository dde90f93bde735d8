"""Param-tree layout conversion between scanned and unrolled layer stacks,
the port's copy of ``kubeflow_tpu.models.layout`` on numpy trees.

The JAX package's Llama stores its decoder stack either scanned
(``scan_layers=True``: one ``"layers"`` subtree whose leaves are stacked
``[L, ...]``) or unrolled (``"layer_0" .. "layer_{L-1}"``). Training writes
the scanned form, serving reads the unrolled one; these helpers convert a
tree (nested dicts of arrays, as ``jax.device_get`` yields them) between
the two, so ``models/convert.py`` takes either.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np


def _tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def to_layer_layout(params: Dict[str, Any],
                    num_layers: int) -> Dict[str, Any]:
    """Scanned {'layers': [L, ...]} -> unrolled {'layer_i': ...}.
    Identity when already unrolled (or no layer stack at all)."""
    if "layers" not in params:
        return params
    for leaf in _leaves(params["layers"]):
        if np.shape(leaf)[0] != num_layers:
            raise ValueError(
                f"scanned checkpoint has {np.shape(leaf)[0]} stacked layers, "
                f"model expects {num_layers}"
            )
    out = {k: v for k, v in params.items() if k != "layers"}
    for i in range(num_layers):
        out[f"layer_{i}"] = _tree_map(lambda x, i=i: np.asarray(x)[i],
                                      params["layers"])
    return out


def to_scanned_layout(params: Dict[str, Any],
                      num_layers: int) -> Dict[str, Any]:
    """Unrolled {'layer_i': ...} -> scanned {'layers': [L, ...]}.
    Identity when already scanned (or no layer stack at all)."""
    if "layers" in params or "layer_0" not in params:
        return params
    have = {int(k[6:]) for k in params
            if k.startswith("layer_") and k[6:].isdigit()}
    if have != set(range(num_layers)):
        raise ValueError(
            f"unrolled checkpoint has layers {sorted(have)}, model "
            f"expects 0..{num_layers - 1}"
        )
    out = {k: v for k, v in params.items()
           if not (k.startswith("layer_") and k[6:].isdigit())}
    stack = [params[f"layer_{i}"] for i in range(num_layers)]
    out["layers"] = _tree_map(lambda *xs: np.stack([np.asarray(x)
                                                    for x in xs]), *stack)
    return out


def adapt_layout(params: Dict[str, Any], num_layers: int,
                 scanned: bool) -> Dict[str, Any]:
    """Convert ``params`` to the layout a model with
    ``scan_layers=scanned`` expects."""
    return (to_scanned_layout if scanned else to_layer_layout)(
        params, num_layers)
