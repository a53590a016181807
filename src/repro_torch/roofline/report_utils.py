"""Generic report and formatting helpers of the performance tooling.

Counterpart of ``repro.roofline.report_utils``: the plain JSON-report
directory reader and the human-unit formatters, for the port's reports
(``chip_smoke.py``'s and the performance model's).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List


def load_reports(d: str) -> List[Dict]:
    """Every ``*.json`` in ``d``, parsed, in sorted filename order."""
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b) -> str:
    """1536 -> '1.5KB'; None -> '-'."""
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_float(x, digits: int = 4) -> str:
    """Fixed-point float, '-' for anything non-numeric."""
    return f"{x:.{digits}f}" if isinstance(x, (int, float)) else "-"


def fmt_rate(x, unit: str = "", digits: int = 1) -> str:
    """Scaled SI rate: 1234567 -> '1.2M<unit>'; None -> '-'."""
    if x is None:
        return "-"
    for prefix, scale in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(x) >= scale:
            return f"{x / scale:.{digits}f}{prefix}{unit}"
    return f"{x:.{digits}f}{unit}"
