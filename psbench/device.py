"""The card: its published peaks and the record every run reports."""

from __future__ import annotations

import subprocess
from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    """Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
    at the full 700 W power limit)."""

    hbm_bytes_per_s: float = 3.35e12
    f32_flops_per_s: float = 67e12
    bf16_flops_per_s: float = 989e12


H100 = Peaks()


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> None:
    """Raise unless CUDA sees at least ``count`` cards; nothing falls back
    to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell needs {count} cards, CUDA sees {have}")


def power_limit() -> str | None:
    """``nvidia-smi``'s power limit of card 0, or None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def record(count: int, memory_peak_bytes: int, device: str = "cuda") -> dict:
    """The result line's ``device``: the card's name, the cards used, the
    peak of allocated memory and the power limit."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(memory_peak_bytes)}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(memory_peak_bytes),
        "power_limit": power_limit(),
    }
