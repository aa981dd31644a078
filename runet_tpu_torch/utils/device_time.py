"""Device time per kind of work from a ``torch.profiler`` trace, as the
profile scripts (``profile_serve``, ``profile_train``) report it."""

from __future__ import annotations


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_rows(prof) -> list[tuple[str, float, int]]:
    """(name, device µs, calls) of every device-side event with time
    (kernels, memcpy/memset). The CPU ops' own device totals are left out:
    they would count the same kernels twice."""
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return [r for r in rows if r[1] > 0]


def group_device_time(rows, groups, other: str = "other"):
    """Sum ``rows`` into ``groups`` ([(group, (substring, ...)), ...]; the
    first group with a substring of the event's name wins, else ``other``).
    Returns ({group: µs}, {group: [(µs, calls, name), ...]})."""
    us_by = {g: 0.0 for g, _ in groups}
    us_by[other] = 0.0
    members: dict[str, list] = {g: [] for g in us_by}
    for key, us, n in rows:
        group = next((g for g, subs in groups if any(s in key for s in subs)), other)
        us_by[group] += us
        members[group].append((us, n, key))
    return us_by, members
