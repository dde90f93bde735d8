"""Weights between the JAX package's Llama param tree and the port's
``state_dict``.

The JAX tree (``{"params": {...}}`` or its inner dict, numpy arrays as
``jax.device_get`` yields them, unboxed) keeps flax DenseGeneral layouts;
the port keeps ``[out, in]`` matrices:

=============  =================  ======================
parameter      JAX                port
=============  =================  ======================
q/k/v_proj     [E, H, Dh]         [H*Dh, E]
o_proj         [H, Dh, E]         [E, H*Dh]
gate/up_proj   [E, M]             [M, E]
down_proj      [M, E]             [E, M]
lm_head        [E, V]             [V, E]
embed, norms   as they are        as they are
=============  =================  ======================

Only the unrolled layout (``layer_{i}`` subtrees) converts; a scanned
tree (one ``layers`` subtree stacked over depth) raises for now.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


def llama_params_from_jax(tree, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """JAX Llama param tree -> the port's state_dict (CPU tensors)."""
    p = tree["params"] if "params" in tree else tree
    if "layers" in p:
        raise NotImplementedError(
            "scanned (layers-stacked) Llama params do not convert yet; "
            "unroll them to layer_{i} subtrees first")
    E = cfg.embed_dim
    sd = {"embed": _tensor(p["embed"])}
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"layers.{i}."
        attn, mlp = lp["attn"], lp["mlp"]
        sd[pre + "input_norm.weight"] = _tensor(lp["input_norm"]["weight"])
        for n in ("q_proj", "k_proj", "v_proj"):
            kern = np.asarray(attn[n]["kernel"])
            sd[pre + f"attn.{n}.weight"] = _tensor(kern.reshape(E, -1).T)
        o = np.asarray(attn["o_proj"]["kernel"])
        sd[pre + "attn.o_proj.weight"] = _tensor(o.reshape(-1, E).T)
        sd[pre + "post_attn_norm.weight"] = _tensor(
            lp["post_attn_norm"]["weight"])
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd[pre + f"mlp.{n}.weight"] = _tensor(
                np.asarray(mlp[n]["kernel"]).T)
    sd["final_norm.weight"] = _tensor(p["final_norm"]["weight"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _tensor(np.asarray(p["lm_head"]["kernel"]).T)
    return sd


def llama_params_to_jax(state_dict: Dict[str, torch.Tensor],
                        cfg: LlamaConfig) -> dict:
    """The port's state_dict -> ``{"params": ...}`` in the JAX layouts
    (numpy; bf16 tensors come back as f32, which holds them exactly)."""
    H, Hkv, Dh, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.embed_dim)
    sd = {k: _array(v) for k, v in state_dict.items()}
    p = {"embed": sd["embed"]}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        heads = {"q_proj": H, "k_proj": Hkv, "v_proj": Hkv}
        p[f"layer_{i}"] = {
            "input_norm": {"weight": sd[pre + "input_norm.weight"]},
            "attn": {
                **{n: {"kernel": np.ascontiguousarray(
                    sd[pre + f"attn.{n}.weight"].T.reshape(E, h, Dh))}
                   for n, h in heads.items()},
                "o_proj": {"kernel": np.ascontiguousarray(
                    sd[pre + "attn.o_proj.weight"].T.reshape(H, Dh, E))},
            },
            "post_attn_norm": {"weight": sd[pre + "post_attn_norm.weight"]},
            "mlp": {n: {"kernel": np.ascontiguousarray(
                sd[pre + f"mlp.{n}.weight"].T)}
                for n in ("gate_proj", "up_proj", "down_proj")},
        }
    p["final_norm"] = {"weight": sd["final_norm.weight"]}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"kernel": np.ascontiguousarray(
            sd["lm_head.weight"].T)}
    return {"params": p}
