"""Where the port's entry points run: the card unless the caller asks for
the CPU."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The torch device an entry point runs on: ``None`` means the card
    (``cuda``), and asking for a card that is absent raises — there is no
    silent fallback to the CPU; a caller that wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's kernels run on the card; pass "
            "device='cpu' to run their plain versions on the host")
    return dev
