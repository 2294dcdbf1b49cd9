"""Fleet-wide distributed tracing: one trace id per fleet request, ONE
merged Perfetto file per fleet.

Copy of ``deepspeed_tpu/observability/fleet_trace.py`` for the PyTorch
port.  Every serving request has a ``trace_id`` and a per-engine
waterfall; in a fleet (disaggregated prefill/decode + failover) a
request crosses a prefill worker, the shared KV fabric, a decode replica
and possibly a failover sibling, and each leg records its own timeline.
This module restores the single narrative:

  - ``FleetTraceContext`` mints fleet-scoped trace ids. The router
    stamps one onto every ``FleetRequest`` at submit; ``SubmitSpec``
    carries it into each replica's ``ServingEngine.submit``, where the
    request-trace recorder HONOURS the preset id instead of minting its
    own (``RequestTraceRecorder.on_submit``). Every leg — prefill,
    decode, failover replay — therefore stamps its segments under the
    SAME trace id, each on its own timeline track.
  - ``FleetTraceAssembler`` merges per-replica/-process trace exports
    into one Chrome trace-event document and synthesizes **flow arrows**
    (ph ``s``/``t``/``f`` sharing an id) chaining the legs of each
    trace chronologically: prefill leg → ``fabric_publish`` segment →
    ``promote`` (fabric claim) → decode leg → failover replay. Loaded in
    Perfetto the fleet request renders as one waterfall with arrows
    hopping across replica tracks.
  - ``validate_fleet_trace`` is the acceptance check (used by tests,
    also from a separate process):
    trace-id continuity, flow-arrow endpoints resolving to real slices,
    and no orphan legs.

Everything here is stdlib-only, export-time code — nothing on the hot
path. The hot-path cost of fleet tracing is the request tracer's
existing contract (one attribute check when disabled).
"""
from __future__ import annotations

import itertools
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

#: category + name for synthesized flow events — namespaced so the
#: validator (and Perfetto queries) can find the fleet chains
FLOW_CAT = "fleet"
FLOW_NAME = "fleet_handoff"

#: pid stride between merged sources so per-process tracks never collide
SOURCE_PID_STRIDE = 1_000_000

#: X-segment names that anchor a flow hop *inside* a leg (in addition to
#: the leg's first/last slices): the fabric publish window on the
#: prefill leg and the claim/promote window on the decode leg
_INNER_ANCHORS = ("fabric_publish", "promote")


class FleetTraceContext:
    """Mints fleet-scoped trace ids (``fleet-<origin>-<seq>``).

    One per router. The id format is deliberately distinct from the
    per-rank ``r<rank>-<seq>`` ids the request tracer mints for
    non-fleet requests, so a trace file self-describes which requests
    crossed the fleet.
    """

    def __init__(self, origin: str = "0"):
        self.origin = str(origin)
        self._seq = itertools.count()

    def mint(self) -> str:
        return f"fleet-{self.origin}-{next(self._seq):06x}"


def _x_events_by_track(events: List[Dict[str, Any]]
                       ) -> Dict[Tuple[Any, Any], List[Dict[str, Any]]]:
    by_track: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "request":
            by_track.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for xs in by_track.values():
        xs.sort(key=lambda e: (e.get("ts", 0.0), -e.get("dur", 0.0)))
    return by_track


class FleetTraceAssembler:
    """Merge per-replica trace exports and draw the fleet flow arrows.

    Sources are whole Chrome trace documents (``add_file``/``add_doc``)
    or bare event lists (``add_events``). With more than one source,
    pids are remapped onto disjoint ranges (``SOURCE_PID_STRIDE`` apart)
    so two rank-0 exports don't merge their tracks; the in-process fleet
    (one tracer, one file) passes through unchanged.
    """

    def __init__(self):
        self._sources: List[Tuple[str, List[Dict[str, Any]],
                                  Dict[str, Any]]] = []

    # -- intake ------------------------------------------------------------
    def add_events(self, events: List[Dict[str, Any]],
                   label: Optional[str] = None) -> "FleetTraceAssembler":
        self._sources.append((label or f"source{len(self._sources)}",
                              list(events), {}))
        return self

    def add_doc(self, doc: Dict[str, Any],
                label: Optional[str] = None) -> "FleetTraceAssembler":
        self._sources.append((label or f"source{len(self._sources)}",
                              list(doc.get("traceEvents", [])),
                              dict(doc.get("otherData", {}))))
        return self

    def add_file(self, path: str,
                 label: Optional[str] = None) -> "FleetTraceAssembler":
        with open(path) as f:
            return self.add_doc(json.load(f), label=label or path)

    # -- assembly ----------------------------------------------------------
    def _merged_events(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        remap = len(self._sources) > 1
        for idx, (_label, events, _meta) in enumerate(self._sources):
            base = idx * SOURCE_PID_STRIDE if remap else 0
            for e in events:
                if base and "pid" in e:
                    e = dict(e)
                    e["pid"] = base + e["pid"]
                out.append(e)
        return out

    def _flow_events(self, events: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
        """Synthesize one flow chain per multi-leg trace id."""
        by_track = _x_events_by_track(events)
        # trace_id -> (pid, tid) -> ordered X events of that leg
        legs: Dict[str, Dict[Tuple[Any, Any], List[Dict[str, Any]]]] = {}
        for track, xs in by_track.items():
            for e in xs:
                tid = (e.get("args") or {}).get("trace_id")
                if tid:
                    legs.setdefault(tid, {}).setdefault(track, []).append(e)
        flows: List[Dict[str, Any]] = []
        for trace_id in sorted(legs):
            tracks = legs[trace_id]
            if len(tracks) < 2:
                continue            # single-leg request: nothing to chain
            anchors: List[Dict[str, Any]] = []
            for track_xs in tracks.values():
                chosen = {id(track_xs[0]): track_xs[0],
                          id(track_xs[-1]): track_xs[-1]}
                for e in track_xs:
                    if e.get("name") in _INNER_ANCHORS:
                        chosen[id(e)] = e
                anchors.extend(chosen.values())
            anchors.sort(key=lambda e: (e.get("ts", 0.0),
                                        -e.get("dur", 0.0)))
            fid = zlib.crc32(trace_id.encode("utf-8")) & 0xFFFFFFFF
            last = len(anchors) - 1
            for i, a in enumerate(anchors):
                ev = {"ph": "s" if i == 0 else ("f" if i == last else "t"),
                      "cat": FLOW_CAT, "name": FLOW_NAME, "id": fid,
                      "pid": a.get("pid"), "tid": a.get("tid"),
                      "ts": a.get("ts", 0.0),
                      "args": {"trace_id": trace_id, "hop": i}}
                if ev["ph"] == "f":
                    ev["bp"] = "e"
                flows.append(ev)
        return flows

    def assemble(self) -> Dict[str, Any]:
        events = self._merged_events()
        events.extend(self._flow_events(events))
        dropped = 0
        for _label, _events, meta in self._sources:
            dropped += int(meta.get("dropped", meta.get("dropped_spans", 0))
                           or 0)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "deepspeed_tpu_torch.observability.fleet_trace",
                "sources": [label for label, _e, _m in self._sources],
                "dropped": dropped,
            },
        }

    def write(self, path: str) -> str:
        doc = self.assemble()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def validate_fleet_trace(doc: Any) -> Dict[str, Dict[str, int]]:
    """Validate a merged fleet trace document (or event list).

    Checks, raising ``ValueError`` on the first violation:
      - **continuity**: every multi-leg trace id has a flow chain;
      - **endpoints resolve**: each flow event's ``(pid, tid, ts)``
        lands inside an ``X`` slice of the same track carrying the same
        trace id;
      - **no orphan segments**: every leg of a multi-leg trace hosts at
        least one flow-chain node.

    Returns ``{trace_id: {"legs": n, "flow_events": n}}`` for reporting.
    Designed to be runnable from a separate process against the JSON
    artifact alone.
    """
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    by_track = _x_events_by_track(events)
    legs_by_trace: Dict[str, set] = {}
    for track, xs in by_track.items():
        for e in xs:
            tid = (e.get("args") or {}).get("trace_id")
            if tid:
                legs_by_trace.setdefault(tid, set()).add(track)
    flows_by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("cat") == FLOW_CAT and e.get("ph") in ("s", "t", "f"):
            tid = (e.get("args") or {}).get("trace_id")
            if not tid:
                raise ValueError(f"flow event without trace_id: {e}")
            flows_by_trace.setdefault(tid, []).append(e)
    report: Dict[str, Dict[str, int]] = {}
    for trace_id, tracks in sorted(legs_by_trace.items()):
        flows = flows_by_trace.get(trace_id, [])
        if len(tracks) > 1 and not flows:
            raise ValueError(
                f"trace {trace_id!r} spans {len(tracks)} legs but has no "
                f"flow chain (continuity broken)")
        covered = set()
        for f in flows:
            track = (f.get("pid"), f.get("tid"))
            ts = f.get("ts", 0.0)
            slices = by_track.get(track, [])
            if not any(e.get("ts", 0.0) <= ts
                       <= e.get("ts", 0.0) + e.get("dur", 0.0)
                       and (e.get("args") or {}).get("trace_id") == trace_id
                       for e in slices):
                raise ValueError(
                    f"flow endpoint for trace {trace_id!r} at "
                    f"pid={f.get('pid')} tid={f.get('tid')} ts={ts} does "
                    f"not resolve to any slice of that leg")
            covered.add(track)
        if len(tracks) > 1 and covered != tracks:
            raise ValueError(
                f"orphan segments in trace {trace_id!r}: legs "
                f"{sorted(tracks - covered)} are not on the flow chain")
        report[trace_id] = {"legs": len(tracks), "flow_events": len(flows)}
    return report
