"""Cross-daemon trace assembly — span trees, critical paths, Chrome
trace export.

``utils/trace.py`` records flat spans: every span carries a process-
unique ``span_id``, its ``parent_id`` (which crosses the wire on
OSDOp/ECSubWrite/ECSubRead messages), and the end-to-end ``trace_id``
one client op's spans share across the client, the primary, and every
replica.  This module turns a merged pile of span dumps (one process's
``dump_historic_ops``, or several processes' dumps concatenated — the
DCN hosts' admin sockets serve the same format) back into per-trace
span TREES, finds each tree's critical path with per-stage
attribution, and emits:

- a top-N-slowest text report (``format_report``),
- Chrome trace-event JSON (``chrome_trace``) loadable in Perfetto /
  chrome://tracing, one lane per daemon, and
- the per-name host accounting of the tracer's ``trace`` perf set
  (``span_totals``, ``format_span_totals``): every span's and timer's
  count, wall, self and CPU seconds, the spans the ring has dropped
  included.

Live ops from ``dump_ops_in_flight`` join as synthetic open-ended
spans (duration = current age), so a trace wedged RIGHT NOW assembles
next to completed ones — the forensics-bundle view of the 167 s
convergence outlier this plane was built to explain.

Interval arithmetic uses the spans' monotonic starts where available
(same process — ``Span.start_mono``) and wall-clock starts otherwise
(cross-process merges), mirroring how the tracer records both.

The loadgen driver's ``--trace-capture`` and the forensics bundle
call :func:`capture_traces` directly. The output is the JAX package's
(same spans in, same trees, paths and Chrome JSON out, its ``ceph_tpu``
event category included), so dumps of either package merge.
"""

from __future__ import annotations

import json


def _end(span: dict) -> float:
    return span["start"] + (span.get("duration") or 0.0)


def _lane(span: dict, inherited: "str | None" = None) -> str:
    """Which daemon's timeline a span belongs on: osd spans tag their
    id; untagged spans ride their parent's lane (an ec_write inside an
    osd_op belongs to that OSD); everything else is the client lane."""
    tags = span.get("tags") or {}
    if "osd" in tags:
        return f"osd.{tags['osd']}"
    if "daemon" in tags:
        return str(tags["daemon"])
    return inherited or "client"


def live_ops_as_spans(ops: "list[dict] | None" = None) -> list[dict]:
    """Convert ``dump_ops_in_flight`` entries into synthetic spans
    (ids outside the tracer's namespace; open-ended duration = age).
    Defaults to the process tracker's current live set."""
    if ops is None:
        from .optracker import op_tracker

        ops = op_tracker.dump_ops_in_flight()["ops"]
    spans = []
    for op in ops:
        spans.append({
            "span_id": f"live-{op['seq']}",
            "parent_id": None,
            "name": f"live:{op['type']}",
            "start": op["started"],
            "start_mono": None,
            "duration": op["age"],
            "tags": {
                "daemon": op["daemon"],
                "live": True,
                "slow": op.get("slow", False),
                "events": [e["event"] for e in op.get("events", [])],
                **{k: v for k, v in op.get("description", {}).items()},
            },
            "trace_id": op.get("trace_id"),
        })
    return spans


def assemble_traces(
    spans: list[dict], live_ops: "list[dict] | None" = None,
) -> list[dict]:
    """Group spans by trace id and rebuild the parent/child trees.

    Returns one dict per trace, sorted by duration (slowest first):

    - ``trace_id``, ``n_spans``, ``start``, ``end``, ``duration``
    - ``roots``: list of nested node dicts (span fields + "children",
      children ordered by start)
    - ``complete``: exactly one root and every non-root span's parent
      resolved — the well-formedness bit the capture contract pins
    - ``orphans``: spans whose parent id is missing from the trace
      (counted; they surface as extra roots)
    """
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid is None:
            continue
        by_trace.setdefault(tid, []).append(dict(s))
    if live_ops:
        for s in live_ops_as_spans(live_ops):
            if s.get("trace_id") in by_trace:
                by_trace[s["trace_id"]].append(s)
    trees = []
    for tid, members in by_trace.items():
        ids = {s["span_id"] for s in members}
        nodes = {s["span_id"]: {**s, "children": []} for s in members}
        roots, orphans = [], 0
        for s in members:
            parent = s.get("parent_id")
            node = nodes[s["span_id"]]
            if parent is None:
                roots.append(node)
            elif parent in ids:
                nodes[parent]["children"].append(node)
            else:
                orphans += 1
                roots.append(node)

        def _sort(node: dict) -> None:
            node["children"].sort(
                key=lambda c: (
                    c.get("start_mono")
                    if c.get("start_mono") is not None else c["start"]
                )
            )
            for c in node["children"]:
                _sort(c)

        roots.sort(key=lambda r: r["start"])
        for r in roots:
            _sort(r)
        start = min(s["start"] for s in members)
        end = max(_end(s) for s in members)
        trees.append({
            "trace_id": tid,
            "n_spans": len(members),
            "start": start,
            "end": end,
            "duration": end - start,
            "roots": roots,
            "complete": len(roots) == 1 and orphans == 0,
            "orphans": orphans,
        })
    trees.sort(key=lambda t: -t["duration"])
    return trees


def critical_path(tree: dict) -> dict:
    """The root-to-leaf chain that bounds the trace's wall time, with
    per-stage attribution: each on-path span's SELF time (duration not
    covered by its on-path child) plus explicit gap stages where the
    child starts after the parent ends — the client-queue/wire waits
    between a client op closing and the primary picking it up, or
    between the primary's dispatch and a peer's sub-write."""
    if not tree["roots"]:
        return {"total_s": 0.0, "stages": []}
    node = tree["roots"][0]
    path = [node]
    while node["children"]:
        node = max(node["children"], key=_end)
        path.append(node)
    total = max(_end(n) for n in path) - path[0]["start"]
    stages = []
    lane = None
    for i, n in enumerate(path):
        dur = n.get("duration") or 0.0
        child = path[i + 1] if i + 1 < len(path) else None
        self_t = dur
        if child is not None:
            overlap = max(
                0.0,
                min(_end(n), _end(child))
                - max(n["start"], child["start"]),
            )
            self_t = max(dur - overlap, 0.0)
        lane = _lane(n, lane)
        stages.append({
            "name": n["name"],
            "lane": lane,
            "start": n["start"],
            "self_s": round(self_t, 9),
        })
        if child is not None and child["start"] > _end(n):
            # dead air between parent close and child open: queue
            # wait + wire time, attributable to neither span
            stages.append({
                "name": f"gap:{n['name']}->{child['name']}",
                "lane": "wire/queue",
                "start": _end(n),
                "self_s": round(child["start"] - _end(n), 9),
            })
    return {"total_s": round(total, 9), "stages": stages}


def chrome_trace(trees: list[dict]) -> dict:
    """Chrome trace-event JSON (the Perfetto/chrome://tracing format):
    one complete ("X") event per span, pid 1, one tid lane per daemon,
    thread-name metadata so lanes read osd.N/client."""
    lanes: dict[str, int] = {}
    events: list[dict] = []

    def lane_tid(lane: str) -> int:
        if lane not in lanes:
            lanes[lane] = len(lanes) + 1
        return lanes[lane]

    def emit(node: dict, trace_id: str,
             inherited: "str | None") -> None:
        tags = {
            k: v for k, v in (node.get("tags") or {}).items()
        }
        lane = _lane(node, inherited)
        events.append({
            "name": node["name"],
            "cat": "ceph_tpu",
            "ph": "X",
            "ts": node["start"] * 1e6,
            "dur": (node.get("duration") or 0.0) * 1e6,
            "pid": 1,
            "tid": lane_tid(lane),
            "args": {"trace_id": trace_id, **tags},
        })
        for c in node["children"]:
            emit(c, trace_id, lane)

    for tree in trees:
        for root in tree["roots"]:
            emit(root, tree["trace_id"], None)
    for lane, tid in lanes.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": lane},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _render_node(node: dict, depth: int, out: list[str]) -> None:
    dur = node.get("duration")
    dur_s = f"{dur * 1e3:9.3f} ms" if dur is not None else "      open"
    tags = node.get("tags") or {}
    brief = " ".join(
        f"{k}={tags[k]}" for k in ("op", "oid", "osd", "shard", "tid")
        if k in tags
    )
    out.append(
        f"  {dur_s}  {'  ' * depth}{node['name']}"
        + (f"  [{brief}]" if brief else "")
    )
    for c in node["children"]:
        _render_node(c, depth + 1, out)


def format_report(trees: list[dict], top: int = 10) -> str:
    """Top-N slowest traces as text: the span tree plus the critical
    path's stage attribution."""
    out: list[str] = []
    for i, tree in enumerate(trees[:top]):
        out.append(
            f"== trace {i + 1}/{min(top, len(trees))} "
            f"{tree['trace_id']}  total {tree['duration'] * 1e3:.3f} ms"
            f"  spans {tree['n_spans']}"
            + ("" if tree["complete"]
               else f"  (INCOMPLETE: {len(tree['roots'])} roots, "
                    f"{tree['orphans']} orphans)")
        )
        for root in tree["roots"]:
            _render_node(root, 0, out)
        cp = critical_path(tree)
        out.append(f"  critical path ({cp['total_s'] * 1e3:.3f} ms):")
        for st in cp["stages"]:
            out.append(
                f"    {st['self_s'] * 1e3:9.3f} ms  {st['name']}"
                f"  @{st['lane']}"
            )
    if not trees:
        out.append("(no traces)")
    return "\n".join(out)


def span_totals(counters: "dict | None" = None) -> list[dict]:
    """One row per name of ``SPAN_NAMES`` that closed at least once in
    ``counters`` (the ``trace`` section of a ``perf dump``, or the
    delta of two; default: the process tracer's set now): ``count``,
    ``wall_s``, ``self_s`` and ``cpu_s``, largest self time first."""
    from .trace import SPAN_NAMES, SPAN_STATS, tracer

    if counters is None:
        counters = tracer.counters.dump()
    rows = []
    for name in SPAN_NAMES:
        row = {"name": name}
        row.update(
            (stat, counters.get(f"{name}.{stat}", 0)) for stat in SPAN_STATS
        )
        if row["count"]:
            rows.append(row)
    rows.sort(key=lambda r: -r["self_s"])
    return rows


def format_span_totals(rows: list[dict]) -> str:
    """``span_totals`` as a text table, milliseconds per close."""
    out = [f"{'name':<16}{'count':>10}{'wall ms':>12}{'self ms':>12}"
           f"{'cpu ms':>12}"]
    for r in rows:
        n = r["count"]
        out.append(
            f"{r['name']:<16}{n:>10}{r['wall_s'] * 1e3 / n:>12.4f}"
            f"{r['self_s'] * 1e3 / n:>12.4f}{r['cpu_s'] * 1e3 / n:>12.4f}"
        )
    return "\n".join(out)


def capture_traces(
    limit: int = 8,
    spans: "list[dict] | None" = None,
    live_ops: "list[dict] | None" = None,
) -> dict:
    """Snapshot the process's trace state and assemble the ``limit``
    slowest traces — the loadgen ``--trace-capture`` / forensics-
    bundle entry point.  Everything returned is JSON-serializable."""
    if spans is None:
        from .trace import tracer

        spans = tracer.dump_historic()
    if live_ops is None:
        from .optracker import op_tracker

        live_ops = op_tracker.dump_ops_in_flight()["ops"]
    trees = assemble_traces(spans, live_ops)
    sel = trees[:limit]
    return {
        "captured": len(sel),
        "total_traces": len(trees),
        "trees": sel,
        "critical_paths": [critical_path(t) for t in sel],
        "chrome_json": json.dumps(chrome_trace(sel)),
        "text": format_report(sel, top=limit),
    }
