"""What every cell's run shares: the device line, the check for JAX in the
process, the stand-in for a tail that never arrived, and the result line."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "midi_model_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``midi_model_tpu_torch`` is not
    ``midi_model_tpu``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def quantile(values: List[float], q: float) -> Optional[float]:
    """The ``q`` quantile (``statistics.quantiles``, inclusive method, in
    hundredths), or None without values."""
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[round(q * 100) - 1])


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_info(device, chips: int, trace=None) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                  if device.type == "cuda" else 0)}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


def checked(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit (a number passes at or under it)."""
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}


def passes(check: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in check.values())


def emit(result: dict, check: Dict[str, dict]) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output with ``checked`` last."""
    for k, v in check.items():
        print(f"checked {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checked"] = check
    print(json.dumps(result), flush=True)
