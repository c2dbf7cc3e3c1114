"""Move the reference's parameters into the port's modules.

The reference keeps a model's parameters as a nested dict of arrays whose
per-layer entries are stacked along a leading dimension (``lax.scan``
over layers).  The dense-block and ssm families stack theirs under
``"layers"`` (``{"embed": {"tokens"}, "layers": {"ln1", "ln2", "attn":
{"wq", "wk", "wv", "wo"}, "mlp": {"wi", "wg", "wo"}}, "final_norm",
"head"?, "vis_proj"?}``; the moe family has ``"moe": {"router", "wi",
"wg", "wo", "shared_*"?}`` in place of ``"mlp"``, an MLA config ``"attn":
{"wq", "wkv_a", "wkv_b", "wo"}``, the ssm family ``"block": {"mu_r", ...,
"cr"}`` in place of both).  The hybrid family stacks its pattern's blocks
under ``"blocks"`` (``{"sub{i}": {"ln1", "ln2", "mix", "mlp"}}``, ``mix``
an RG-LRU block or an attention block) and keeps a ``"tail"`` of unstacked
``sub{i}``; the encdec family stacks ``"enc_layers"`` (``ln1``, ``ln2``,
``attn``, ``mlp``) and ``"dec_layers"`` (``ln1``–``ln3``, ``self_attn``,
``cross_attn``, ``mlp``) and adds ``"enc_norm"``.

The port's state dict names the same leaves with dots, each stacked
entry split into one key a layer (``layers`` -> ``blocks.{i}``, the
others keep their names: ``blocks.{i}``, ``enc_layers.{i}``,
``dec_layers.{i}``), and ``embed.tokens`` -> ``embed``.
:func:`params_from_numpy` takes the tree as numpy arrays and returns the
state dict for the same weights, each layer its own slice;
:func:`params_to_tree` and :func:`params_to_numpy` go the other way (a
checkpoint is written in the reference's tree, and AdamW's moment dicts,
keyed as the parameters, stack the same way), and
:func:`params_from_tree` takes a tree of tensors back.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .transformer import check_family


def _stacks(cfg: ModelConfig) -> Dict[str, str]:
    """The reference's stacked subtrees -> the port's layer lists."""
    check_family(cfg)
    if cfg.family == "encdec":
        return {"enc_layers": "enc_layers", "dec_layers": "dec_layers"}
    if cfg.family == "hybrid":
        return {"blocks": "blocks"}
    return {"layers": "blocks"}


def _leaves(tree: Dict[str, Any], prefix: str = ""
            ) -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict, in its key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


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


def params_from_tree(tree: Dict[str, Any], cfg: ModelConfig
                     ) -> Dict[str, Any]:
    """The reference's tree (layers stacked; tensors or numpy arrays) as
    the port's state dict, each layer a view of its slice."""
    stacks = _stacks(cfg)
    out: Dict[str, Any] = {}
    for path, leaf in _leaves(tree):
        top, _, rest = path.partition(".")
        if top in stacks:
            for i in range(leaf.shape[0]):
                out[f"{stacks[top]}.{i}.{rest}"] = leaf[i]
        else:
            out["embed" if path == "embed.tokens" else path] = leaf
    return out


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: Union[str, torch.device]
                      ) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves, layers stacked) as the
    port's state dict on ``device``."""
    return {k: tensor_from_numpy(a, device)
            for k, a in params_from_tree(tree, cfg).items()}


def params_to_tree(state: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The port's state dict (or a dict keyed like it, e.g. AdamW's ``m``)
    as the reference's tree of tensors: per-layer entries stacked along a
    leading dimension (copies, on the tensors' device)."""
    stacks = {port: ref for ref, port in _stacks(cfg).items()}
    tree: Dict[str, Any] = {}
    stacked: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}

    def put(path: str, value: Any) -> None:
        *heads, last = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value

    for key, t in state.items():
        top, _, rest = key.partition(".")
        i, _, leaf = rest.partition(".")
        if top in stacks and i.isdigit():
            stacked.setdefault((stacks[top], leaf), {})[int(i)] = t
        elif key == "embed":
            put("embed.tokens", t)
        else:
            put(key, t)
    for (ref, leaf), per in stacked.items():
        put(f"{ref}.{leaf}", torch.stack([per[i] for i in range(len(per))]))
    return tree


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
