"""The traced run's device trace (``torch.profiler`` over the whole
window), reduced on each rank to a summary the per-layer metrics read:
the device's busy time (the union of its kernels' and copies' intervals,
so overlapping streams such as NCCL's count once), the launches, each
operation's total, each hand-written kernel's time, and the longest idle
gaps labelled by the harness's span that was open on the host."""

from __future__ import annotations

import bisect

import torch

from .kernels import KERNELS, is_kernel

#: entries kept of each breakdown list
TOP = 10


def profiler(device):
    """The card's activity only: the host's operators are not recorded,
    which keeps the profiler's cost on the host small (a CPU rehearsal
    records the host's, for want of a card)."""
    from torch.profiler import ProfilerActivity, profile

    activity = (ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU)
    return profile(activities=[activity], record_shapes=False,
                   with_stack=False, profile_memory=False)


def _short(name, width=120):
    name = name.replace("(anonymous namespace)::", "")
    return name if len(name) <= width else name[:width - 3] + "..."


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def summarize(prof, host_spans):
    """The window's device summary from a finished profile and the
    harness's spans on the host's clock (``time.time_ns``, the clock the
    profiler's timestamps are on)."""
    events = list(prof.profiler.kineto_results.events())
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation()]
    spans = list(host_spans)
    busy = _union([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name = {}
    kernel_s = {k: [0, 0.0] for k in KERNELS}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        for key, kernel in KERNELS.items():
            if is_kernel(kernel, name):
                kernel_s[key][0] += 1
                kernel_s[key][1] += (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        gaps.append((start - end, end, start))
    gaps.sort(reverse=True)
    spans.sort()
    starts = [s[0] for s in spans]
    idle = {}
    for length, a, b in gaps:
        mid = (a + b) // 2
        label = "no span"
        i = bisect.bisect_right(starts, mid)
        # the innermost (latest-starting) span that holds the gap's middle
        for s0, s1, name in reversed(spans[max(0, i - 64):i]):
            if s1 >= mid:
                label = name
                break
        idle[label] = idle.get(label, 0.0) + length / 1e9
    longest = [[f"{_short(name)}", s] for name, s in
               sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": busy_s,
        "launches": len(device),
        "device_ops": [[_short(n), s] for n, s in ops],
        "idle_gaps": longest,
        "kernels": kernel_s,
    }
