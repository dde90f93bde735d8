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
router         [E, X]                 [X, E]
w_gate, w_up   [X, E, M]              as they are
w_down         [X, M, E]              as they are
embed, norms   as they are            as they are
=============  =====================  ======================

(X: Mixtral's experts.) A Mixtral layer's expert bank is the JAX
subtree ``moe`` and the port's module ``mlp`` (``MoeMlp``):
:func:`mixtral_params_from_jax` and :func:`mixtral_params_to_jax`.

The image models keep the JAX module names (``stage0_block0.conv1``,
``block_0.q``, ...) and convert leaf by leaf
(:func:`resnet_params_from_jax`, :func:`vit_params_from_jax` and their
inverses):

=================  =====================  ======================
parameter          JAX                    port
=================  =====================  ======================
conv kernels       [kh, kw, in, out]      [out, in, kh, kw]
Dense kernels      [in, out]              [out, in]
ViT q/k/v          [E, H, Dh]             [H*Dh, E]; bias [H*Dh]
ViT out            [H, Dh, E]             [E, H*Dh]
BN scale, bias     [C]                    parameters [C]
BN mean, var       batch_stats [C]        buffers [C]
cls, pos_embed     as they are            as they are
=================  =====================  ======================

``qkv_proj`` (``fused_qkv`` with H % Hkv == 0, G = H / Hkv) and
``gate_up_proj`` (``fused_gate_up``) take the place of the projections
they fuse; their rows keep the JAX kernel's output order.

Both layer layouts convert: unrolled (``layer_{i}`` subtrees) and scanned
(one ``layers`` subtree stacked over depth, as ``scan_layers=True``
training writes it). ``llama_params_to_jax`` writes the layout that
``cfg.scan_layers`` names. Gradients have the params' tree, so they convert
with the same functions. ``quantized_params_from_jax`` carries the JAX
engine's int8 weights and their scales across (unrolled trees only; a
Mixtral's expert leaves transposed to the port's int8 layout).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kubeflow_tpu_torch.models.layout import (
    adapt_layout,
    attn_inputs,
    kernel_shapes,
    mlp_inputs,
    to_layer_layout,
)
from kubeflow_tpu_torch.models.llama import LlamaConfig
from kubeflow_tpu_torch.models.mixtral import EXPERT_LEAVES, MixtralConfig


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


def _mlp_from_jax(mlp, pre: str, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    E = cfg.embed_dim
    return {pre + f"mlp.{n}.weight": _tensor(
        np.asarray(mlp[n]["kernel"]).T if n == "down_proj"
        else np.asarray(mlp[n]["kernel"]).reshape(E, -1).T)
        for n in (*mlp_inputs(cfg), "down_proj")}


def _moe_from_jax(moe, pre: str, cfg) -> Dict[str, torch.Tensor]:
    sd = {pre + "mlp.router.weight": _tensor(
        np.asarray(moe["router"]["kernel"]).T)}
    sd.update({pre + f"mlp.{n}": _tensor(moe[n]) for n in EXPERT_LEAVES})
    return sd


def _from_jax(tree, cfg: LlamaConfig, ffn: str,
              ffn_from_jax) -> Dict[str, torch.Tensor]:
    p = to_layer_layout(tree["params"] if "params" in tree else tree,
                        cfg.num_layers)
    E = cfg.embed_dim
    sd = {"embed": _tensor(p["embed"])}
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"layers.{i}."
        attn = lp["attn"]
        sd[pre + "input_norm.weight"] = _tensor(lp["input_norm"]["weight"])
        for n in attn_inputs(cfg):
            kern = np.asarray(attn[n]["kernel"])
            sd[pre + f"attn.{n}.weight"] = _tensor(kern.reshape(E, -1).T)
        o = np.asarray(attn["o_proj"]["kernel"])
        sd[pre + "attn.o_proj.weight"] = _tensor(o.reshape(-1, E).T)
        sd[pre + "post_attn_norm.weight"] = _tensor(
            lp["post_attn_norm"]["weight"])
        sd.update(ffn_from_jax(lp[ffn], pre, cfg))
    sd["final_norm.weight"] = _tensor(p["final_norm"]["weight"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _tensor(np.asarray(p["lm_head"]["kernel"]).T)
    return sd


def llama_params_from_jax(tree, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """JAX Llama param tree (scanned or unrolled) -> the port's state_dict
    (CPU tensors)."""
    return _from_jax(tree, cfg, "mlp", _mlp_from_jax)


def mixtral_params_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    """JAX Mixtral param tree (scanned or unrolled) -> the port's
    state_dict (CPU tensors)."""
    return _from_jax(tree, cfg, "moe", _moe_from_jax)


def _to_jax(state_dict: Dict[str, torch.Tensor], cfg: LlamaConfig,
            ffn: str, ffn_to_jax) -> dict:
    sd = {k: _array(v) for k, v in state_dict.items()}
    shapes = kernel_shapes(cfg)

    def kernels(prefix, names):
        return {n: {"kernel": np.ascontiguousarray(
            sd[f"{prefix}{n}.weight"].T.reshape(shapes[n]))} for n in names}

    p = {"embed": sd["embed"]}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        p[f"layer_{i}"] = {
            "input_norm": {"weight": sd[pre + "input_norm.weight"]},
            "attn": kernels(pre + "attn.", (*attn_inputs(cfg), "o_proj")),
            "post_attn_norm": {"weight": sd[pre + "post_attn_norm.weight"]},
            ffn: ffn_to_jax(sd, pre + "mlp.", kernels),
        }
    p["final_norm"] = {"weight": sd["final_norm.weight"]}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": np.ascontiguousarray(
            sd["lm_head.weight"].T)}
    return {"params": adapt_layout(p, cfg.num_layers, cfg.scan_layers)}


def llama_params_to_jax(state_dict: Dict[str, torch.Tensor],
                        cfg: LlamaConfig) -> dict:
    """The port's state_dict -> ``{"params": ...}`` in the JAX layouts,
    scanned when ``cfg.scan_layers`` (numpy; bf16 tensors come back as f32,
    which holds them exactly)."""
    return _to_jax(state_dict, cfg, "mlp", lambda sd, pre, kernels: kernels(
        pre, (*mlp_inputs(cfg), "down_proj")))


def mixtral_params_to_jax(state_dict: Dict[str, torch.Tensor], cfg) -> dict:
    """The port's Mixtral state_dict -> ``{"params": ...}`` in the JAX
    layouts (the expert bank under ``moe``), as
    :func:`llama_params_to_jax` writes them."""
    def moe(sd, pre, kernels):
        return {"router": {"kernel": np.ascontiguousarray(
            sd[pre + "router.weight"].T)},
            **{n: sd[pre + n] for n in EXPERT_LEAVES}}

    return _to_jax(state_dict, cfg, "moe", moe)


def _projections(p, cfg: LlamaConfig):
    """(port module name, JAX subtree) of every projection of an unrolled
    tree (a Mixtral's router among them, its expert leaves not)."""
    moe = isinstance(cfg, MixtralConfig)
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        for n in (*attn_inputs(cfg), "o_proj"):
            yield f"layers.{i}.attn.{n}", lp["attn"][n]
        if moe:
            yield f"layers.{i}.mlp.router", lp["moe"]["router"]
            continue
        for n in (*mlp_inputs(cfg), "down_proj"):
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
    scale[:, d]. A Mixtral's quantized expert leaf [X, K, N] and its scales
    [1, K, N] (one an element, over the experts) become the
    ``Int8Experts`` buffers ``<leaf>.weight`` [X, N, K] and ``<leaf>.scale``
    [1, N, K], transposed (K contiguous); its router converts as a
    projection.

    Only the unrolled tree the JAX server builds (``scan_layers=False``)
    converts: a stacked tree's [L, E] norm leaves were quantized across
    layers, which no port module holds, so it raises."""
    p = q_tree["params"] if "params" in q_tree else q_tree
    s = scale_tree["params"] if "params" in scale_tree else scale_tree
    if "layers" in p:
        raise ValueError("a stacked (scan_layers=True) quantized tree does "
                         "not convert: its norms were quantized across "
                         "layers; quantize the unrolled tree")
    moe = isinstance(cfg, MixtralConfig)
    sd = (mixtral_params_from_jax if moe else llama_params_from_jax)(
        q_tree, cfg)
    scales = dict(_projections(s, cfg))
    for name, _ in _projections(p, cfg):
        sc = np.asarray(scales[name]["kernel"])
        if sc.size == 0:                          # not quantized
            continue
        sc = sc[0].T if name.endswith("o_proj") else sc.reshape(-1, 1)
        sd[f"{name}.scale"] = _tensor(np.ascontiguousarray(sc))
    for i in range(cfg.num_layers if moe else 0):
        for n in EXPERT_LEAVES:
            sc = np.asarray(s[f"layer_{i}"]["moe"][n])
            if sc.size == 0:                      # not quantized
                continue
            name = f"layers.{i}.mlp.{n}"
            del sd[name]
            for key, a in (("weight", p[f"layer_{i}"]["moe"][n]),
                           ("scale", sc)):
                sd[f"{name}.{key}"] = _tensor(
                    np.ascontiguousarray(np.swapaxes(np.asarray(a), 1, 2)))
    return sd


def _flat(tree, prefix=()):
    """(path, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat) -> dict:
    out: dict = {}
    for path, v in flat:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _image_leaf(module: str, leaf: str, a: np.ndarray) -> np.ndarray:
    """A JAX image-model leaf in the port's layout (the table above)."""
    if leaf == "kernel":
        if a.ndim == 4:                                   # conv
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 3 and module.endswith("out"):        # [H, Dh, E]
            return a.reshape(-1, a.shape[-1]).T
        return a.reshape(a.shape[0], -1).T                # [E, ...]
    if leaf == "bias":
        return a.reshape(-1)
    return a


def _image_from_jax(tree, stats=None) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, a in _flat(tree["params"] if "params" in tree else tree):
        module, leaf = ".".join(path[:-1]), path[-1]
        name = (f"{module}.weight" if leaf == "kernel" else
                ".".join(path))
        sd[name] = _tensor(np.ascontiguousarray(
            _image_leaf(module, leaf, np.asarray(a))))
    if stats is not None:
        for path, a in _flat(stats.get("batch_stats", stats)):
            sd[".".join(path)] = _tensor(np.asarray(a))
    return sd


def resnet_params_from_jax(params, batch_stats=None
                           ) -> Dict[str, torch.Tensor]:
    """JAX ResNet ``params`` (and ``batch_stats``) trees -> the port's
    state_dict (CPU tensors; the running statistics as buffers)."""
    return _image_from_jax(params, batch_stats)


def vit_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ViT ``params`` tree -> the port's state_dict (CPU tensors)."""
    return _image_from_jax(params)


def resnet_params_to_jax(state_dict: Dict[str, torch.Tensor]):
    """The port's ResNet state_dict -> ({"params": ...}, {"batch_stats":
    ...}) in the JAX layouts (numpy)."""
    params, stats = [], []
    for name, t in state_dict.items():
        a = _array(t)
        *module, leaf = name.split(".")
        if leaf in ("mean", "var"):
            stats.append((tuple(name.split(".")), a))
        elif leaf == "weight":
            params.append((tuple(module) + ("kernel",), np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)))
        else:
            params.append((tuple(module) + (leaf,), a))
    return {"params": _nest(params)}, {"batch_stats": _nest(stats)}


def vit_params_to_jax(state_dict: Dict[str, torch.Tensor], cfg) -> dict:
    """The port's ViT state_dict -> {"params": ...} in the JAX layouts
    (numpy; ``cfg`` gives the heads of the DenseGeneral kernels)."""
    H, E = cfg.num_heads, cfg.embed_dim
    heads = {"q", "k", "v"}
    params = []
    for name, t in state_dict.items():
        a = _array(t)
        *module, leaf = name.split(".")
        last = module[-1] if module else ""
        if leaf == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif last in heads:
                a = a.T.reshape(E, H, -1)
            elif last == "out":
                a = a.T.reshape(H, -1, E)
            else:
                a = a.T
            leaf = "kernel"
        elif leaf == "bias" and last in heads:
            a = a.reshape(H, -1)
        params.append((tuple(module) + (leaf,), np.ascontiguousarray(a)))
    return {"params": _nest(params)}
