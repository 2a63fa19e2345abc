from of_spmm.utils.config import FLAGS, enable_compile_cache
from of_spmm.utils.roofline import (
    PEAKS,
    SpmmTraffic,
    device_peaks,
    spmm_report,
    time_fn,
)
from of_spmm.utils.checkpoint import (
    load_checkpoint,
    load_sharded,
    save_checkpoint,
    save_sharded,
)
from of_spmm.utils import profiler
from of_spmm.utils.summary import SummaryWriter, read_events

__all__ = [
    "FLAGS",
    "enable_compile_cache",
    "PEAKS",
    "SpmmTraffic",
    "device_peaks",
    "spmm_report",
    "time_fn",
    "load_checkpoint",
    "load_sharded",
    "save_sharded",
    "profiler",
    "SummaryWriter",
    "read_events",
    "save_checkpoint",
]
