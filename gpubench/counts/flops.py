"""The model FLOPs an evaluation needs, counted by ``FlopCounterMode`` on the
reference (built on the meta device, so nothing is computed): the
convolutions' and matrix products' multiply-adds, twice. The
configurations' files hold these numbers; a test recounts them."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.models import family


def forward_flops(spec: dict, image_size: int, timestep: bool) -> int:
    """FLOPs of one forward of ``spec``'s reference at batch 1."""
    model = family(spec["family"]).reference(spec["args"])
    x = torch.empty(1, 3, image_size, image_size, device="meta")
    t = torch.zeros(1, device="meta", dtype=torch.int32 if spec["family"] == "adm"
                    else torch.float32)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x, t) if timestep else model(x)
    return counter.get_total_flops()
