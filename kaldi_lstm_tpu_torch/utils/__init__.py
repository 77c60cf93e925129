import sys

import torch

from kaldi_lstm_tpu_torch.utils.logging import (
    ERROR,
    LOG,
    VLOG,
    WARN,
    get_verbose_level,
    set_verbose_level,
)
from kaldi_lstm_tpu_torch.utils.timer import Timer


def device_from_arg(name: str, tool: str) -> torch.device | None:
    """Resolve a CLI ``--device`` value. Returns None (after a stderr
    message) when CUDA is asked for but missing: the tools never move
    to the CPU on their own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: --device {name} but CUDA is not available "
              f"(pass --device cpu to run on the CPU)", file=sys.stderr)
        return None
    return device
