"""Device helpers for runs that must happen on a CUDA GPU.

``require_cuda`` is the gate for every GPU measurement path: it raises
when no card is visible instead of quietly running on the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """Return ``cuda:0``, or raise RuntimeError when no CUDA device is
    available. Never substitutes the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA GPU is required (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def gpu_identity() -> str:
    """The card's name and power limit, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first line: the card this process uses by default)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
