"""The program's own spans joined with the traced window's device operations.

The program records its spans on the host clock of ``benchmark/trace.py``
(``time.perf_counter_ns``) into a bounded ring
(``runet_tpu_torch/utils/timing.py``: ``spans()``, ``dropped()``). Each
span is ``(name, start_ns, end_ns, span_id, parent_id, trace_id,
thread_id, counters)``; the prefix of its name before the first dot is its
layer, and ``wait.*`` spans are the host waiting on the card.

The clocks are tied as ``trace.py`` ties them: the window's first device
operation (the ``Tracer``'s marker) against the start of the benchmark's
first span of the window. The window on the host clock then runs from that
span's start for ``window_s``. Only spans that overlap it are kept, and
nothing is read when the ring overwrote spans of the window. Where the
program keeps no spans (a checkout from before the recorder), every reader
here returns ``None``.

Idle time is charged so: at each instant of the window when no device
operation runs, take the innermost open span of each lane thread (a
thread that holds a ``serving.run``), within its ``serving.run``. The
instant goes in equal parts to the layers of the lanes whose innermost
span is host work (not ``wait.*``), or to ``outside`` when there are none.
A span whose name is of no layer (a phase timer's) counts as its parent's.
So the layers and ``outside`` add up to ``device_idle``.
"""

from __future__ import annotations

from collections import defaultdict

WAIT = "wait."
SERVE_LAYERS = (("preprocess.", "Preprocess"), ("case.", "Case"), ("host_post.", "Host post"),
                ("serving.run", "Case"))
OUTSIDE = "outside"


def recorder(ctx):
    """``ctx.recorder`` (the tests' stand-in), else the program's own span
    recorder, else None."""
    rec = getattr(ctx, "recorder", None)
    if rec is not None:
        return rec
    try:
        from runet_tpu_torch.utils import timing
    except ImportError:
        return None
    if not (hasattr(timing, "spans") and hasattr(timing, "dropped")):
        return None
    return timing


def host_window(ctx):
    """(start_ns, end_ns, offset_ns) of the traced window on the host clock;
    ``offset_ns`` is device time minus host time. None without a device
    operation or a benchmark span."""
    items = getattr(ctx.run, "spans", None)
    items = getattr(items, "items", None)
    if not ctx.ops or not items:
        return None
    start = int(items[0][1])
    return start, start + int(round(ctx.window_s * 1e9)), ctx.ops[0].start_ns - start


def window_spans(ctx):
    """The program's spans that overlap the window, or None (no recorder, no
    window, or spans of the window overwritten in the ring)."""
    rec = recorder(ctx)
    win = host_window(ctx)
    if rec is None or win is None:
        return None
    start, end, _ = win
    snap = rec.spans()
    # The ring drops its oldest first: spans of the window are lost only if
    # something was dropped after the window began.
    if rec.dropped() and (not snap or snap[0].end_ns >= start):
        return None
    return [s for s in snap if s.end_ns >= start and s.start_ns <= end]


def idle_intervals(ctx) -> list[tuple[int, int]]:
    """The window's stretches with no device operation, on the host clock:
    from the first operation's start for ``window_s``, so they add up to
    ``window_s`` less the union of the operations."""
    start, end, offset = host_window(ctx)
    out, cur = [], start
    for o in ctx.ops:
        s, e = o.start_ns - offset, o.end_ns - offset
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
    if cur < end:
        out.append((cur, end))
    return [(a, b) for a, b in out if b > a]


def _layer_of(span, by_id, layers):
    """The layer of ``span`` (None for ``wait.*``); a span of no layer takes
    its parent's, and a root of no layer is ``None``."""
    while span is not None:
        if span.name.startswith(WAIT):
            return None
        for prefix, layer in layers:
            if span.name.startswith(prefix):
                return layer
        span = by_id.get(span.parent_id)
    return None


def innermost(spans, label) -> list[tuple[int, int, object]]:
    """(start, end, label(span)) of the innermost open span over time, for
    the properly nested spans of one thread; stretches whose label is None
    are left out."""
    out = []

    def emit(a, b, s):
        lab = label(s)
        if b > a and lab is not None:
            out.append((a, b, lab))

    stack, t = [], None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            emit(t, top.end_ns, top)
            t = top.end_ns
        if stack:
            emit(t, s.start_ns, stack[-1])
        stack.append(s)
        t = s.start_ns
    while stack:
        top = stack.pop()
        emit(t, top.end_ns, top)
        t = top.end_ns
    return out


def _subtrees(spans, root_name) -> dict[int, list]:
    """Per thread, the spans of that thread in the subtrees of its
    ``root_name`` spans (the roots included)."""
    by_id = {s.span_id: s for s in spans}
    inside: dict[int, bool] = {}

    def within(s):
        path = []
        while s is not None and s.span_id not in inside:
            if s.name == root_name:
                inside[s.span_id] = True
                break
            path.append(s)
            s = by_id.get(s.parent_id)
        hit = s is not None and inside[s.span_id]
        for p in path:
            inside[p.span_id] = hit
        return hit

    out: dict[int, list] = defaultdict(list)
    for s in spans:
        if within(s):
            out[s.thread_id].append(s)
    return out


def charge_idle(idle, lanes) -> dict[str, float]:
    """Nanoseconds of ``idle`` charged per layer and to ``outside``.
    ``lanes``: per lane, sorted disjoint (start, end, layer) stretches of
    host work."""
    out: dict[str, float] = defaultdict(float)
    ptr = [0] * len(lanes)
    for a, b in idle:
        cuts = {a, b}
        for li, segs in enumerate(lanes):
            i = ptr[li]
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            ptr[li] = i
            while i < len(segs) and segs[i][0] < b:
                cuts.add(max(segs[i][0], a))
                cuts.add(min(segs[i][1], b))
                i += 1
        cuts = sorted(cuts)
        for p, q in zip(cuts, cuts[1:]):
            here = []
            for li, segs in enumerate(lanes):
                i = ptr[li]
                while i < len(segs) and segs[i][0] <= p:
                    if p < segs[i][1]:
                        here.append(segs[i][2])
                        break
                    i += 1
            if here:
                for layer in here:
                    out[layer] += (q - p) / len(here)
            else:
                out[OUTSIDE] += q - p
    return dict(out)


def serve_idle(ctx) -> dict[str, float] | None:
    """Per layer (and ``outside``), the share of the window in %, of idle
    time charged to the serving lanes; computed once per ``ctx``."""
    memo = getattr(ctx, "_serve_idle", False)
    if memo is not False:
        return memo
    spans = window_spans(ctx)
    result = None
    if spans:
        by_id = {s.span_id: s for s in spans}
        lanes = [innermost(ss, lambda s: _layer_of(s, by_id, SERVE_LAYERS))
                 for ss in _subtrees(spans, "serving.run").values()]
        if lanes:
            charged = charge_idle(idle_intervals(ctx), lanes)
            total = ctx.window_s * 1e9
            result = {k: 100.0 * v / total for k, v in charged.items()}
            for _, layer in SERVE_LAYERS:
                result.setdefault(layer, 0.0)
            result.setdefault(OUTSIDE, 0.0)
    ctx._serve_idle = result
    return result


def serve_idle_layer(ctx, layer: str):
    charged = serve_idle(ctx)
    return None if charged is None else charged[layer]


def window_roots(spans, name, ctx):
    """The ``name`` spans that lie wholly inside the window."""
    start, end, _ = host_window(ctx)
    return [s for s in spans if s.name == name and s.start_ns >= start and s.end_ns <= end]


def lane_wait_share(ctx):
    """Σ ``serving.queue`` / Σ ``serving.case`` over the window's cases, %."""
    spans = window_spans(ctx)
    if not spans:
        return None
    cases = {s.span_id: s for s in window_roots(spans, "serving.case", ctx)}
    case_ns = sum(s.end_ns - s.start_ns for s in cases.values())
    if case_ns <= 0:
        return None
    queue_ns = sum(s.end_ns - s.start_ns for s in spans
                   if s.name == "serving.queue" and s.parent_id in cases)
    return 100.0 * queue_ns / case_ns


def step_idle(ctx, name: str):
    """Device-idle time while the step thread (the one holding
    ``train_step.step``) is inside a ``name`` span, % of the window."""
    spans = window_spans(ctx)
    if not spans:
        return None
    step_threads = {s.thread_id for s in spans if s.name == "train_step.step"}
    if not step_threads:
        return None
    held = sorted((s.start_ns, s.end_ns) for s in spans
                  if s.name == name and s.thread_id in step_threads)
    total, j = 0, 0
    for a, b in idle_intervals(ctx):
        while j < len(held) and held[j][1] <= a:
            j += 1
        k = j
        while k < len(held) and held[k][0] < b:
            total += min(b, held[k][1]) - max(a, held[k][0])
            k += 1
    return 100.0 * total / (ctx.window_s * 1e9)


def per_step_counter(ctx, counter: str):
    """Σ ``counter`` over the window's ``train_step.step`` trees / steps."""
    spans = window_spans(ctx)
    if not spans:
        return None
    roots = window_roots(spans, "train_step.step", ctx)
    if not roots:
        return None
    by_id = {s.span_id: s for s in spans}
    root_ids = {s.span_id for s in roots}
    total = 0
    for s in spans:
        if not s.counters or counter not in s.counters:
            continue
        p = s
        while p is not None and p.span_id not in root_ids:
            p = by_id.get(p.parent_id)
        if p is not None:
            total += s.counters[counter]
    return total / len(roots)
