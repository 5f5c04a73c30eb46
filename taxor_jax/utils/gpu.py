"""The NVIDIA card's name and power limit, for every reported number.

A card may be capped below its maximum power and then runs slower under
load, so measurements carry the limit beside them.
"""

from __future__ import annotations

import subprocess

QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]


def card_info() -> str:
    """`name, power.limit` of each visible card (one line per card), as
    nvidia-smi reports them; raises when nvidia-smi is unavailable."""
    out = subprocess.run(QUERY, check=True, capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()
