"""Reading a ``torch.profiler`` trace of the card: the device's busy time as
the union of its kernel intervals, the idle gaps between them named by what
the host was doing, the device time by kernel name and by hand kernel.
The arithmetic follows the program's ``step_breakdown.profiled`` and
``device_busy``; the kernel names are those of its ``KERNEL_PARTS``,
copied into ``perfbench/roofline/``, so that the yardstick does not move
with the program."""

from __future__ import annotations


def intervals(events):
    """[(start_us, end_us)] of the device events, sorted."""
    return sorted((e.time_range.start, e.time_range.end) for e in events)


def union(ivs):
    """[(start, end)] of the merged intervals of sorted ``ivs``."""
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(ivs) -> float:
    return sum(e - s for s, e in union(ivs))


def gaps(merged):
    """[(start, end)] between consecutive merged intervals."""
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def host_at(cpu, s, e):
    """The name of the host event that covers most of (s, e), or
    ``"host (no event)"``.  ``cpu``: [(start, end, name)] sorted."""
    best, name = 0.0, "host (no event)"
    for cs, ce, n in cpu:
        if cs >= e:
            break
        cover = min(ce, e) - max(cs, s)
        if cover > best:
            best, name = cover, n
    return name


def read(prof, kernel_of):
    """The trace's numbers: busy and window-independent sums.  Returns
    dict(kernels, busy_s, by_name {name: s}, by_kernel {K: s},
    idle {host event: s})."""
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    ivs = intervals(dev)
    merged = union(ivs)
    by_name, by_kernel = {}, {}
    for e in dev:
        t = e.time_range.elapsed_us() * 1e-6
        by_name[e.name] = by_name.get(e.name, 0.0) + t
        k = kernel_of(e.name)
        if k is not None:
            by_kernel[k] = by_kernel.get(k, 0.0) + t
    cpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type.name == "CPU"
                 and e.name.startswith("cuda"))
    idle = {}
    j = 0
    for s, e in gaps(merged):
        while j < len(cpu) and cpu[j][1] < s:
            j += 1
        n = host_at(cpu[j:], s, e)
        idle[n] = idle.get(n, 0.0) + (e - s) * 1e-6
    return dict(kernels=len(dev), busy_s=busy_us(ivs) * 1e-6,
                by_name=by_name, by_kernel=by_kernel, idle=idle)


def top(d, n=10):
    """The ``n`` largest entries of {name: seconds} as [[name, s]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def kernel_of(name, parts):
    """The hand kernel a device kernel of that name belongs to, by the
    longest name part of ``parts`` ({kernel: parts}) it contains, or
    None."""
    best = (0, None)
    for key, ps in parts.items():
        for p in ps:
            if p in name and len(p) > best[0]:
                best = (len(p), key)
    return best[1]
