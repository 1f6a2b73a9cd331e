"""What the port's CLIs share: the device each runs on, and frames moved
to it in their storage dtype."""

from __future__ import annotations

import argparse

import numpy as np
import torch


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card, an error where torch finds none; "
                        "'cpu' runs the kernels' plain torch versions)")


def resolve_device(name: str) -> torch.device:
    """The torch device a CLI runs on; the CUDA card where torch finds none
    raises RuntimeError, as the object API does: there is no fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch finds no CUDA card; pass --device cpu to run on the CPU"
        )
    return device


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the device in its own dtype (uint8 intensity and
    uint16 depth counts are converted there); a read-only array (a raw
    replay's memmap view) is copied on the host first, since torch wants
    writable memory."""
    array = np.asarray(array)
    if not array.flags.writeable or not array.flags.c_contiguous:
        array = np.array(array, order="C")
    return torch.from_numpy(array).to(device)

