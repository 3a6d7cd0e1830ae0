"""What the per-layer readers share: a kernel file's roofline share over
the recorded calls, a device share by kernel name, an engine statistic.
Each reader returns None when its run recorded nothing to read."""
from __future__ import annotations

from typing import Optional

from . import peaks, trace, window


def roofline(rec, kernel: str) -> Optional[float]:
    """Sum over the recorded calls into ``counts/<kernel>.py``'s entries of
    their least time, over the device time of its kernels, in %."""
    mod = rec.get("counts", {}).get(kernel)
    if mod is None or "kernel_s" not in rec:
        return None
    least = 0.0
    for entry in mod.ENTRIES:
        for call in rec.get("calls", {}).get(entry, []):
            f, b = mod.cost(call)
            least += peaks.least_time(f, b, call["dtype"])
    spent = trace.kernel_seconds(rec["kernel_s"], mod.KERNELS)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


def device_share(rec, pattern: str) -> Optional[float]:
    if not rec.get("busy_s"):
        return None
    return 100.0 * trace.kernel_seconds(rec["kernel_s"], pattern) \
        / rec["busy_s"]


def idle(rec) -> Optional[float]:
    if not rec.get("window_s") or "busy_s" not in rec or \
            not rec.get("device_events"):
        return None
    return window.idle_share(rec["busy_s"], rec["window_s"])


def mfu(rec) -> Optional[float]:
    run = rec.get("run", {})
    if not run.get("model_flops") or not run.get("window_s"):
        return None
    return 100.0 * run["model_flops"] / (run["window_s"] * peaks.MFU_PEAK)
