"""Weights between the JAX package's Llama param tree and the port's
``state_dict``.

The JAX tree (``{"params": {...}}`` or its inner dict, numpy arrays as
``jax.device_get`` yields them, unboxed) keeps flax DenseGeneral layouts;
the port keeps ``[out, in]`` matrices:

=============  =====================  ======================
parameter      JAX                    port
=============  =====================  ======================
q/k/v_proj     [E, H, Dh]             [H*Dh, E]
qkv_proj       [E, Hkv, G + 2, Dh]    [Hkv*(G+2)*Dh, E]
o_proj         [H, Dh, E]             [E, H*Dh]
gate/up_proj   [E, M]                 [M, E]
gate_up_proj   [E, 2, M]              [2*M, E]
down_proj      [M, E]                 [E, M]
lm_head        [E, V]                 [V, E]
embed, norms   as they are            as they are
=============  =====================  ======================

``qkv_proj`` (``fused_qkv`` with H % Hkv == 0, G = H / Hkv) and
``gate_up_proj`` (``fused_gate_up``) take the place of the projections
they fuse; their rows keep the JAX kernel's output order.

Both layer layouts convert: unrolled (``layer_{i}`` subtrees) and scanned
(one ``layers`` subtree stacked over depth, as ``scan_layers=True``
training writes it). ``llama_params_to_jax`` writes the layout that
``cfg.scan_layers`` names. Gradients have the params' tree, so they convert
with the same functions. ``quantized_params_from_jax`` carries the JAX
engine's int8 weights and their scales across (unrolled trees only).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kubeflow_tpu_torch.models.layout import adapt_layout, to_layer_layout
from kubeflow_tpu_torch.models.llama import LlamaConfig


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":            # ml_dtypes bf16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:             # numpy has no bf16: exact upcast
        t = t.float()
    return t.numpy()


def _attn_inputs(cfg: LlamaConfig):
    """The names of the q/k/v projections, as both models build them."""
    return (("qkv_proj",) if cfg.fuses_qkv
            else ("q_proj", "k_proj", "v_proj"))


def _mlp_inputs(cfg: LlamaConfig):
    return ("gate_up_proj",) if cfg.fused_gate_up else ("gate_proj",
                                                        "up_proj")


def llama_params_from_jax(tree, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """JAX Llama param tree (scanned or unrolled) -> the port's state_dict
    (CPU tensors)."""
    p = to_layer_layout(tree["params"] if "params" in tree else tree,
                        cfg.num_layers)
    E = cfg.embed_dim
    sd = {"embed": _tensor(p["embed"])}
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"layers.{i}."
        attn, mlp = lp["attn"], lp["mlp"]
        sd[pre + "input_norm.weight"] = _tensor(lp["input_norm"]["weight"])
        for n in _attn_inputs(cfg):
            kern = np.asarray(attn[n]["kernel"])
            sd[pre + f"attn.{n}.weight"] = _tensor(kern.reshape(E, -1).T)
        o = np.asarray(attn["o_proj"]["kernel"])
        sd[pre + "attn.o_proj.weight"] = _tensor(o.reshape(-1, E).T)
        sd[pre + "post_attn_norm.weight"] = _tensor(
            lp["post_attn_norm"]["weight"])
        for n in (*_mlp_inputs(cfg), "down_proj"):
            kern = np.asarray(mlp[n]["kernel"])
            sd[pre + f"mlp.{n}.weight"] = _tensor(
                kern.T if n == "down_proj" else kern.reshape(E, -1).T)
    sd["final_norm.weight"] = _tensor(p["final_norm"]["weight"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _tensor(np.asarray(p["lm_head"]["kernel"]).T)
    return sd


def llama_params_to_jax(state_dict: Dict[str, torch.Tensor],
                        cfg: LlamaConfig) -> dict:
    """The port's state_dict -> ``{"params": ...}`` in the JAX layouts,
    scanned when ``cfg.scan_layers`` (numpy; bf16 tensors come back as f32,
    which holds them exactly)."""
    H, Hkv, Dh, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.embed_dim)
    sd = {k: _array(v) for k, v in state_dict.items()}
    M = cfg.mlp_dim
    shapes = {"q_proj": (E, H, Dh), "k_proj": (E, Hkv, Dh),
              "v_proj": (E, Hkv, Dh), "qkv_proj": (E, Hkv, -1, Dh),
              "o_proj": (H, Dh, E), "gate_proj": (E, M), "up_proj": (E, M),
              "gate_up_proj": (E, 2, M), "down_proj": (M, E)}

    def kernels(prefix, names):
        return {n: {"kernel": np.ascontiguousarray(
            sd[f"{prefix}{n}.weight"].T.reshape(shapes[n]))} for n in names}

    p = {"embed": sd["embed"]}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        p[f"layer_{i}"] = {
            "input_norm": {"weight": sd[pre + "input_norm.weight"]},
            "attn": kernels(pre + "attn.", (*_attn_inputs(cfg), "o_proj")),
            "post_attn_norm": {"weight": sd[pre + "post_attn_norm.weight"]},
            "mlp": kernels(pre + "mlp.", (*_mlp_inputs(cfg), "down_proj")),
        }
    p["final_norm"] = {"weight": sd["final_norm.weight"]}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": np.ascontiguousarray(
            sd["lm_head.weight"].T)}
    return {"params": adapt_layout(p, cfg.num_layers, cfg.scan_layers)}


def _projections(p, cfg: LlamaConfig):
    """(port module name, JAX subtree) of every projection of an unrolled
    tree."""
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        for n in (*_attn_inputs(cfg), "o_proj"):
            yield f"layers.{i}.attn.{n}", lp["attn"][n]
        for n in (*_mlp_inputs(cfg), "down_proj"):
            yield f"layers.{i}.mlp.{n}", lp["mlp"][n]
    if not cfg.tie_embeddings:
        yield "lm_head", p["lm_head"]


def quantized_params_from_jax(q_tree, scale_tree,
                              cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The JAX engine's int8 weights (``(eng.params, eng._scales)``, the
    trees ``_quantize_int8`` returns) -> the port's: every leaf as
    :func:`llama_params_from_jax` converts it (an int8 kernel becomes the
    int8 ``<name>.weight`` [out, in]), plus ``<name>.scale`` bf16 [out, S]
    for each quantized projection, the weights an ``Int8Dense`` holds.
    JAX's scales [1, out...] are one an output row (S = 1; the fused
    ``qkv_proj`` [1, Hkv, G + 2, Dh] and ``gate_up_proj`` [1, 2, M] too, in
    the fused rows' order) except o_proj's [1, Dh, E], one a (head dim,
    output row) pair, which becomes [E, Dh]: weight column h * Dh + d takes
    scale[:, d].

    Only the unrolled tree the JAX server builds (``scan_layers=False``)
    converts: a stacked tree's [L, E] norm leaves were quantized across
    layers, which no port module holds, so it raises."""
    p = q_tree["params"] if "params" in q_tree else q_tree
    s = scale_tree["params"] if "params" in scale_tree else scale_tree
    if "layers" in p:
        raise ValueError("a stacked (scan_layers=True) quantized tree does "
                         "not convert: its norms were quantized across "
                         "layers; quantize the unrolled tree")
    sd = llama_params_from_jax(q_tree, cfg)
    scales = dict(_projections(s, cfg))
    for name, _ in _projections(p, cfg):
        sc = np.asarray(scales[name]["kernel"])
        if sc.size == 0:                          # not quantized
            continue
        sc = sc[0].T if name.endswith("o_proj") else sc.reshape(-1, 1)
        sd[f"{name}.scale"] = _tensor(np.ascontiguousarray(sc))
    return sd
