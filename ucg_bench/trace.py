"""Reading a ``torch.profiler`` trace of a sub-window, from its Chrome
trace: the device's busy time (the union of every kernel, copy and fill
interval), the device time under each of the benchmark's spans, the
heaviest device operations, and the idle gaps by what the host was doing.

A device operation belongs to a span when the runtime or driver call that
launched it (matched by CUPTI's correlation id) ran inside the span.  That
counts the kernels the program launches through ``ctypes`` as well as
PyTorch's own, which the profiler's per-operator sums leave out."""

from __future__ import annotations

import bisect
import json
import os
import tempfile

from ucg_bench.spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def read(prof) -> dict:
    """Times in seconds: ``busy`` (the union of the device operations),
    ``span`` {name: (calls, device seconds)}, ``pack_in_pair`` (device
    seconds of the pack spans inside pair spans), ``unlaunched`` (device
    seconds whose launch was not found), ``device_ops`` and ``idle_gaps``
    (at most 10 [name, seconds] each)."""
    evs = [e for e in chrome_events(prof) if e.get("ph") == "X"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in evs
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = [e for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    # each device operation at the time of its launch
    launched, unlaunched = [], 0.0
    for e in dev:
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            unlaunched += float(e["dur"]) * 1e-6
        else:
            launched.append((t, float(e["dur"]) * 1e-6))
    launched.sort()
    lt = [t for t, _ in launched]
    cum = [0.0]
    for _, d in launched:
        cum.append(cum[-1] + d)

    def device_in(a, b):
        return cum[bisect.bisect_right(lt, b)] - cum[bisect.bisect_left(lt, a)]

    span, pack_in_pair = {}, 0.0
    iv = {}
    for e in spans:
        iv.setdefault(e["name"][len(PREFIX):], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    pairs = iv.get("pair", [])
    for e in spans:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        name = e["name"][len(PREFIX):]
        if any(pa <= a and b <= pb and (pa, pb) != (a, b)
               for pa, pb in iv[name]):
            continue                    # inside a span of its own name
        calls, t = span.get(name, (0, 0.0))
        d = device_in(a, b)
        span[name] = (calls + 1, t + d)
        if name == "pack" and any(pa <= a and b <= pb for pa, pb in pairs):
            pack_in_pair += d
    ops = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    device_ops = sorted(([k[:120], v] for k, v in ops.items()),
                        key=lambda kv: -kv[1])[:10]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in evs if e.get("cat") in HOST_CATS)
    starts = [h[0] for h in host]
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:500]
    by_name = {}
    for a, b in gaps:
        # the innermost host operation running at the gap's middle: going
        # back from the last one begun, the first that has not ended
        mid = 0.5 * (a + b)
        name = "(python, no operation)"
        k0 = bisect.bisect_right(starts, mid) - 1
        for k in range(k0, max(-1, k0 - 5000), -1):
            if host[k][1] >= mid:
                name = host[k][2][:120]
                break
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    idle_gaps = sorted(([k, v] for k, v in by_name.items()),
                       key=lambda kv: -kv[1])[:10]
    return {"busy": busy_s, "span": span, "pack_in_pair": pack_in_pair,
            "unlaunched": unlaunched, "device_ops": device_ops,
            "idle_gaps": idle_gaps}
