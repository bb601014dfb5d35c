"""Reading a ``torch.profiler`` Chrome trace of the profiled slice: the
device's busy time, its operations by name, its idle gaps labelled by what
the host was doing, and the kernels of each iteration."""

from __future__ import annotations

import json

#: Trace categories of operations that run on the device.
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
#: The harness's range around each profiled iteration.
ITERATION_PREFIX = "portbench_iteration_"


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: list[dict], top: int = 10) -> dict:
    """The slice's numbers (seconds): ``window_s`` (first iteration's start
    to last iteration's end), ``busy_s`` (device operations' merged
    intervals inside it), ``device_ops`` and ``idle_gaps`` (the ``top``
    largest, as [name, seconds]), ``kernels_per_iteration``, and
    ``kernel_s`` (device seconds by name, summed over the slice)."""
    iters = sorted((e for e in events
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(ITERATION_PREFIX)),
                   key=lambda e: e["ts"])
    if not iters:
        return {}
    lo = iters[0]["ts"]
    hi = max(e["ts"] + e["dur"] for e in iters)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in dev]
    busy = merge([(s, e) for s, e in spans if e > s])
    busy_us = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    per_iter = [sum(1 for k in kernels
                    if it["ts"] <= k["ts"] <= it["ts"] + it["dur"])
                for it in iters]
    # Idle gaps, each named by the host phase that covers most of it.
    phases = [(p["name"], p["ts"], p["ts"] + p["dur"]) for p in events
              if p.get("cat") == "user_annotation"
              and not str(p.get("name", "")).startswith(ITERATION_PREFIX)]
    gaps = []
    edges = [lo] + [x for se in busy for x in se] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e - s <= 0:
            continue
        cover: dict[str, float] = {}
        for name, ps, pe in phases:
            o = min(e, pe) - max(s, ps)
            if o > 0:
                cover[name] = cover.get(name, 0.0) + o
        name = max(cover, key=cover.get) if cover else "outside_phases"
        if sum(cover.values()) < 0.5 * (e - s):
            name = "outside_phases"
        gaps.append([name, (e - s) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "iterations": len(iters), "kernels_per_iteration": per_iter,
            "kernel_s": by_name,
            "device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": gaps[:top]}
