"""The traced run's profile: ``torch.profiler`` over CPU and CUDA for a
bounded part of the window (no chrome trace is written), reduced to the
device's busy time, the device time by kernel group, the kernels that took
most time and the longest idle gaps of the device, each named by what the
host was doing then."""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Dict, List, Optional

GROUPS = ("strip", "bsa", "gemm", "other")
_STRIP = re.compile(r"\bstrip_\w*kernel")
_BSA = re.compile(r"\bbsa_\w*kernel")
_GEMM = ("gemm", "nvjet", "xmma", "cutlass", "matmul")


def group(name: str) -> str:
    """A device kernel's group: B.1 (``strip``), B.2 (``bsa``), a cuBLAS
    product (``gemm``; the MoE's one-hot dispatch and combine are products
    too) or ``other``."""
    low = name.lower()
    if _STRIP.search(low):
        return "strip"
    if _BSA.search(low):
        return "bsa"
    if any(t in low for t in _GEMM):
        return "gemm"
    return "other"


@dataclasses.dataclass
class Summary:
    window_s: float                       # host clock, start to stop
    busy_s: float                         # union of device intervals
    group_s: Dict[str, float]             # device seconds by group
    device_ops: List[list]                # [[name, seconds]] top kernels
    idle_gaps: List[list]                 # [[host op, seconds]] longest
    t0: float                             # host clock at start and stop
    t1: float


class Tracer:
    """One profiler session, started and stopped at model-call boundaries
    (the serving engine synchronises the device there)."""

    def __init__(self):
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        self.prof = None
        self.running = self.done = False
        self.t0 = self.t1 = 0.0

    def warm(self) -> None:
        """One short session in set-up, so that starting the real one in
        the window does not pay the tracer's own start-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1024, device="cuda").sum().item()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.running = True

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.running, self.done = False, True

    def summary(self, top: int = 10) -> Optional[Summary]:
        if not self.done:
            return None
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith("bench."):     # spans, not kernels
                    dev.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        dev.sort()
        group_s = {g: 0.0 for g in GROUPS}
        by_name: Dict[str, float] = {}
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, name in dev:
            d = (e - s) / 1e6
            group_s[group(name)] += d
            by_name[name] = by_name.get(name, 0.0) + d
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += (cur_e - cur_s) / 1e6
                    gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += (cur_e - cur_s) / 1e6
        gaps.sort(reverse=True)
        named = []
        for g, a, b in gaps[:top]:
            mid = (a + b) / 2
            inner = [h for h in host if h[0] <= mid <= h[1]]
            label = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                     else "no host op")
            named.append([label[:120], g / 1e6])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        groups = [[f"group:{g}", group_s[g]] for g in GROUPS]
        device_ops = groups + [[n[:120], s] for n, s in ops[:top - len(groups)]]
        return Summary(self.t1 - self.t0, busy, group_s, device_ops, named,
                       self.t0, self.t1)
