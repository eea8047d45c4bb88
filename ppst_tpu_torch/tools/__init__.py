"""Measurement and validation scripts of the port that run on the card."""

import subprocess

import torch


def card(device="cuda") -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" for a
    CPU ``device``)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
