"""Param-tree layout conversion between scanned and unrolled layer stacks,
the port's copy of ``kubeflow_tpu.models.layout`` on numpy trees.

The JAX package's Llama stores its decoder stack either scanned
(``scan_layers=True``: one ``"layers"`` subtree whose leaves are stacked
``[L, ...]``) or unrolled (``"layer_0" .. "layer_{L-1}"``). Training writes
the scanned form, serving reads the unrolled one; these helpers convert a
tree (nested dicts of arrays, as ``jax.device_get`` yields them) between
the two, so ``models/convert.py`` takes either.

:func:`jax_leaves` maps each parameter of the port's ``Llama`` to the JAX
leaf it belongs to (:class:`JaxLeaf`): its path, its per-layer shape, the
view that takes the port's ``[out, in]`` weight to that shape and its
index on the stacked axis. Optimizers that act on whole leaves
(adafactor's factored moments and block RMS) read it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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


# ---------------------------------------------------------------- leaf map

#: adafactor's min_dim_size_to_factor (optax's default, which the JAX
#: trainer keeps).
MIN_DIM_TO_FACTOR = 128


def attn_inputs(cfg) -> Tuple[str, ...]:
    """The names of the q/k/v projections, as both models build them."""
    return (("qkv_proj",) if cfg.fuses_qkv
            else ("q_proj", "k_proj", "v_proj"))


def mlp_inputs(cfg) -> Tuple[str, ...]:
    return ("gate_up_proj",) if cfg.fused_gate_up else ("gate_proj",
                                                        "up_proj")


def kernel_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Each projection's flax DenseGeneral kernel shape (one layer's)."""
    H, Hkv, Dh, E, M = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.embed_dim, cfg.mlp_dim)
    return {"q_proj": (E, H, Dh), "k_proj": (E, Hkv, Dh),
            "v_proj": (E, Hkv, Dh),
            "qkv_proj": (E, Hkv, H // Hkv + 2, Dh),
            "o_proj": (H, Dh, E), "gate_proj": (E, M), "up_proj": (E, M),
            "gate_up_proj": (E, 2, M), "down_proj": (M, E)}


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """The JAX leaf a port tensor belongs to.

    ``path``: the leaf's path in the JAX tree ("layers/attn/q_proj/kernel"
    when stacked, "layer_3/attn/q_proj/kernel" when not); ``shape``: one
    layer's slice of it in the JAX layout; ``transposed``: the port holds
    the ``[out, in]`` transpose of a kernel, so :meth:`view` is
    ``w.T.view(shape)`` (``models/convert.py``'s conversion, without a
    copy); ``layer``: the index on the stacked axis, None when the leaf is
    not stacked; ``layers``: that axis' size."""

    path: str
    shape: Tuple[int, ...]
    transposed: bool = False
    layer: Optional[int] = None
    layers: int = 1

    def view(self, t):
        """``t`` (the port's tensor) seen in the JAX layout; shares its
        memory."""
        return (t.t() if self.transposed else t).view(self.shape)

    def factored_dims(self) -> Optional[Tuple[int, int]]:
        """optax's ``_factored_dims`` on the WHOLE leaf (stacked axis
        included), as (d1, d0) axes of ``shape``: d0 the largest axis, d1
        the second (ties in ``np.argsort``'s order); None when the second
        is under MIN_DIM_TO_FACTOR or the leaf has one axis. A factored
        stacked axis has no per-layer form, so it raises."""
        full = self.shape if self.layer is None else (self.layers,
                                                      *self.shape)
        if len(full) < 2:
            return None
        order = np.argsort(full)
        if full[order[-2]] < MIN_DIM_TO_FACTOR:
            return None
        d1, d0 = int(order[-2]), int(order[-1])
        if self.layer is None:
            return d1, d0
        if 0 in (d1, d0):
            raise ValueError(f"{self.path}: adafactor factors the stacked "
                             f"layer axis of {full}; the port keeps one "
                             "tensor a layer and cannot")
        return d1 - 1, d0 - 1


def jax_leaves(cfg) -> Dict[str, JaxLeaf]:
    """The JAX leaf of every parameter of the port's ``Llama(cfg)``, by
    state-dict name: stacked over the layers (``layers/...``) when
    ``cfg.scan_layers``, else one leaf a layer (``layer_{i}/...``)."""
    L = cfg.num_layers
    shapes = kernel_shapes(cfg)
    out = {"embed": JaxLeaf("embed", (cfg.vocab_size, cfg.embed_dim))}
    for i in range(L):
        def leaf(rest, shape, transposed=False):
            if cfg.scan_layers:
                return JaxLeaf(f"layers/{rest}", shape, transposed, i, L)
            return JaxLeaf(f"layer_{i}/{rest}", shape, transposed)

        pre = f"layers.{i}."
        for norm in ("input_norm", "post_attn_norm"):
            out[f"{pre}{norm}.weight"] = leaf(f"{norm}/weight",
                                              (cfg.embed_dim,))
        for block, names in (("attn", (*attn_inputs(cfg), "o_proj")),
                             ("mlp", (*mlp_inputs(cfg), "down_proj"))):
            for n in names:
                out[f"{pre}{block}.{n}.weight"] = leaf(
                    f"{block}/{n}/kernel", shapes[n], True)
    out["final_norm.weight"] = JaxLeaf("final_norm/weight",
                                       (cfg.embed_dim,))
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = JaxLeaf(
            "lm_head/kernel", (cfg.embed_dim, cfg.vocab_size), True)
    return out
