"""Move the reference's parameters into the port's modules.

The reference keeps a model's parameters as a nested dict of arrays whose
per-layer entries are stacked along a leading L dimension (``lax.scan``
over layers): ``{"embed": {"tokens"}, "layers": {"ln1", "ln2", "attn":
{"wq", "wk", "wv", "wo"}, "mlp": {"wi", "wg", "wo"}}, "final_norm",
"head"?}`` for the dense family, with ``"block": {"mu_r", ..., "cr"}`` in
place of ``"attn"`` and ``"mlp"`` for the ssm family.
:func:`params_from_numpy` takes that tree as numpy arrays and returns the
state dict of :class:`transformer.Transformer` for the same weights, each
layer its own slice.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .transformer import check_family


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
        for group in ("attn", "mlp", "block"):
            for name, stacked in layers.get(group, {}).items():
                out[f"{pre}{group}.{name}"] = tensor_from_numpy(stacked[i],
                                                                device)
    return out
