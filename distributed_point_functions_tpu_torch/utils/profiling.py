"""Profiling hooks on `torch.profiler`.

The JAX package wraps `jax.profiler` here. The port's `trace(log_dir)`
captures a `torch.profiler` trace of the enclosed block (the host's
operators and, where there is a CUDA device, the card's kernels) and
writes it to `log_dir/trace.json` in the Chrome trace format (Perfetto
and `chrome://tracing` read it); `/profilez` and the auto-profiler call
it. Only one trace can run at a time in a process. `annotate` is
`torch.profiler.record_function`: a named range inside an active trace,
a cheap no-op outside one, so library code calls it unconditionally:

    with trace("/tmp/dpf-trace"):
        server.handle_request(request)

    with annotate("expand"):
        selections = evaluate_selection_blocks_planes(...)
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block into `log_dir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named sub-region inside an active trace."""
    return torch.profiler.record_function(name)
