"""Move the reference's parameters into the port's modules.

The reference keeps a model's parameters as a nested dict of arrays whose
per-layer entries are stacked along a leading L dimension (``lax.scan``
over layers): ``{"embed": {"tokens"}, "layers": {"ln1", "ln2", "attn":
{"wq", "wk", "wv", "wo"}, "mlp": {"wi", "wg", "wo"}}, "final_norm",
"head"?}`` for the dense family; the moe family has ``"moe": {"router",
"wi", "wg", "wo", "shared_wi"?, "shared_wg"?, "shared_wo"?}`` in place of
``"mlp"``, an MLA config ``"attn": {"wq", "wkv_a", "wkv_b", "wo"}``; the
ssm family has ``"block": {"mu_r", ..., "cr"}`` in place of ``"attn"`` and
``"mlp"``.
:func:`params_from_numpy` takes that tree as numpy arrays and returns the
state dict of :class:`transformer.Transformer` for the same weights, each
layer its own slice; :func:`params_to_tree` and :func:`params_to_numpy`
go the other way (a checkpoint is written in the reference's tree, and
AdamW's moment dicts, keyed as the parameters, stack the same way), and
:func:`params_from_tree` takes a tree of tensors back.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .transformer import check_family

_GROUPS = ("attn", "mlp", "moe", "block")


def tensor_from_numpy(a: Any, device: Union[str, torch.device]
                      ) -> torch.Tensor:
    """A numpy array as a tensor on ``device``.  ``torch.from_numpy``
    refuses bfloat16 (``ml_dtypes.bfloat16``), so its bits go across as
    uint16 and are reinterpreted."""
    a = np.array(a, order="C")  # a writable copy: the tensor owns it
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: Union[str, torch.device]
                      ) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves, layers stacked) as the
    port's state dict on ``device``."""
    check_family(cfg)
    out = {"embed": tensor_from_numpy(tree["embed"]["tokens"], device),
           "final_norm": tensor_from_numpy(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        out["head"] = tensor_from_numpy(tree["head"], device)
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        out[pre + "ln1"] = tensor_from_numpy(layers["ln1"][i], device)
        out[pre + "ln2"] = tensor_from_numpy(layers["ln2"][i], device)
        for group in _GROUPS:
            for name, stacked in layers.get(group, {}).items():
                out[f"{pre}{group}.{name}"] = tensor_from_numpy(stacked[i],
                                                                device)
    return out


def params_to_tree(state: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The port's state dict (or a dict keyed like it, e.g. AdamW's ``m``)
    as the reference's tree of tensors: per-layer entries stacked along a
    leading L dimension (copies, on the tensors' device)."""
    check_family(cfg)
    tree: Dict[str, Any] = {"embed": {"tokens": state["embed"]},
                            "final_norm": state["final_norm"]}
    if not cfg.tie_embeddings:
        tree["head"] = state["head"]
    per = [f"blocks.{i}." for i in range(cfg.n_layers)]
    layers: Dict[str, Any] = {}
    for name in ("ln1", "ln2"):
        layers[name] = torch.stack([state[pre + name] for pre in per])
    for key in state:
        parts = key.split(".")
        if key.startswith("blocks.0.") and parts[2] in _GROUPS:
            group, name = parts[2], parts[3]
            layers.setdefault(group, {})[name] = torch.stack(
                [state[f"{pre}{group}.{name}"] for pre in per])
    tree["layers"] = layers
    return tree


def params_from_tree(tree: Dict[str, Any], cfg: ModelConfig
                     ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`params_to_tree`: the reference's tree of
    tensors as the port's state dict (each layer a view of its slice)."""
    check_family(cfg)
    out = {"embed": tree["embed"]["tokens"],
           "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        out["head"] = tree["head"]
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        out[pre + "ln1"] = layers["ln1"][i]
        out[pre + "ln2"] = layers["ln2"][i]
        for group in _GROUPS:
            for name, stacked in layers.get(group, {}).items():
                out[f"{pre}{group}.{name}"] = stacked[i]
    return out


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 goes across as its
    uint16 bits, reinterpreted as ``ml_dtypes.bfloat16`` (numpy has no
    bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(state: Dict[str, torch.Tensor], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the port's state dict (or
    AdamW's ``m`` / ``v``, keyed alike) as the reference's tree of numpy
    arrays, layers stacked."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tensor_to_numpy(node)
    return walk(params_to_tree(state, cfg))
