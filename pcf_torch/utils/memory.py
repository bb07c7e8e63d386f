"""Device-memory observability, the port of pcf_tpu/utils/memory.py on the
CUDA caching allocator.

The reference logs torch.cuda.max_memory_reserved per print-freq
(train_ScanNet_DDP_WarmUP.py:471). hbm_stats reads torch.cuda.memory_stats
beside mem_get_info's limit; hbm_summary and hbm_peak_gib are pcf_tpu's
one-liners on it, and all three give None or "" off the card. The peak is the
allocator's high-water mark since the last torch.cuda.reset_peak_memory_stats.

pcf_tpu's compiled_memory_gib read an XLA executable's static footprint. Its
counterpart here is a captured step's pool: graph_pool_bytes sums, over the
graphs a step function holds (parallel/graphs.StepGraphs), the memory
reserved across each capture and the bytes still allocated in it.
"""

from __future__ import annotations

import torch


def hbm_stats(device=None) -> dict | None:
    """bytes_in_use, peak_bytes_in_use, bytes_reserved and bytes_limit of a
    CUDA device (the current one by default); None off the card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    s = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "bytes_limit": total}


def hbm_summary(device=None) -> str:
    """'in_use/peak/limit' GiB one-liner for logs; '' off the card."""
    s = hbm_stats(device)
    if not s:
        return ""
    gib = 1024 ** 3
    return (f"HBM {s['bytes_in_use'] / gib:.2f}/{s['peak_bytes_in_use'] / gib:.2f}/"
            f"{s['bytes_limit'] / gib:.2f} GiB (in-use/peak/limit)")


def hbm_peak_gib(device=None) -> float | None:
    s = hbm_stats(device)
    return None if s is None else s["peak_bytes_in_use"] / 1024 ** 3


def graph_pool_bytes(graphs) -> dict:
    """{"graphs", "pool_bytes", "live_bytes"} over the captured graphs that a
    StepGraphs holds now."""
    return {"graphs": len(graphs.entries), "pool_bytes": graphs.pool_bytes(),
            "live_bytes": sum(e.live_bytes for e in graphs.entries.values())}
