"""Cross-process trace aggregation: graftrace shards -> one timeline.

The port's own copy of the JAX package's `obs.aggregate`, the merge half
of graftrace (`obs/graftrace.py`): every worker process drains its
tracer ring into `trace-<pid>-<gen>.json` shards stamped with a
monotonic<->epoch clock pair. This module merges a directory of those
shards into ONE Perfetto/chrome://tracing JSON:

* **Clock alignment** — each shard's event timestamps are
  `perf_counter` microseconds, meaningless across processes; the stamp
  maps them onto the shared epoch timeline
  (`ts + (epoch_ns - perf_ns)/1e3`).
* **Causal skew correction** — wall clocks skew between hosts. A
  single correction pass walks the causal edges (`parent_id`/`links`
  in event args) and shifts any process whose causally-downstream
  events would otherwise start BEFORE their upstream source — the
  distributed-tracing happened-before repair, enough for the bounded
  skews NTP leaves behind (tests inject seconds of deliberate skew).
* **Flow synthesis** — Perfetto flow events ("s"/"f" pairs) are
  synthesized centrally here from the args ids, one per causal edge
  (request -> batch dispatch, session tick -> session batch).

Tolerant by contract (the runlog reader discipline): a corrupt,
truncated or foreign JSON file is counted and skipped, never raised —
a timeline over a crashed run is exactly when this tool matters.
Stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["discover_shards", "load_shard", "merge_timeline",
           "write_timeline", "has_causal_chain",
           "discover_metrics_shards", "load_metrics_shard",
           "latest_metrics_shards", "sum_snapshots"]

_NS_PER_US = 1000.0


def discover_shards(root: str) -> List[str]:
  """Every graftrace trace shard under `root`, recursively (a run may
  scatter shards across model_dir subtrees)."""
  return sorted(glob.glob(os.path.join(root, "**", "trace-*.json"),
                          recursive=True))


def load_shard(path: str) -> Optional[Dict[str, Any]]:
  """One parsed shard, or None for anything that is not a well-formed
  graftrace v1 shard (tolerant-reader contract)."""
  try:
    with open(path, "r") as f:
      payload = json.load(f)
  except (OSError, ValueError):
    return None
  if not isinstance(payload, dict) or payload.get("graftrace") != "v1":
    return None
  clock = payload.get("clock")
  if (not isinstance(clock, dict) or "perf_ns" not in clock
      or "epoch_ns" not in clock):
    return None
  if not isinstance(payload.get("traceEvents"), list):
    return None
  return payload


def discover_metrics_shards(root: str) -> List[str]:
  """Every graftrace METRICS shard under `root`, recursively (the
  snapshot-carrying twin `graftrace.flush` writes beside each trace
  shard — the data plane of `graftscope watch`)."""
  return sorted(glob.glob(os.path.join(root, "**", "metrics-*.json"),
                          recursive=True))


def load_metrics_shard(path: str) -> Optional[Dict[str, Any]]:
  """One parsed metrics shard, or None for anything that is not a
  well-formed graftrace v1 metrics shard (tolerant-reader contract —
  a half-written or foreign file is skipped, never raised; the watch
  over a crashed run is exactly when this matters). The paired clock
  stamp is optional: shards written before the stamp landed still
  render, they just report staleness as unknown."""
  try:
    with open(path, "r") as f:
      payload = json.load(f)
  except (OSError, ValueError):
    return None
  if not isinstance(payload, dict) or payload.get("graftrace") != "v1":
    return None
  if not isinstance(payload.get("snapshot"), dict):
    return None
  return payload


def latest_metrics_shards(root: str) -> Dict[str, Any]:
  """{"shards": [payload...], "skipped": n}: the NEWEST generation per
  worker pid (earlier generations are superseded windows of the same
  registry — summing them would double-count every cumulative
  counter), with unreadable files counted, not hidden."""
  newest: Dict[Any, Dict[str, Any]] = {}
  skipped = 0
  for path in discover_metrics_shards(root):
    shard = load_metrics_shard(path)
    if shard is None:
      skipped += 1
      continue
    pid = shard.get("pid")
    held = newest.get(pid)
    if held is None or shard.get("gen", 0) >= held.get("gen", 0):
      newest[pid] = shard
  shards = sorted(newest.values(),
                  key=lambda s: (str(s.get("role")), s.get("pid") or 0))
  return {"shards": shards, "skipped": skipped}


def sum_snapshots(shards: Sequence[Dict[str, Any]]) -> Dict[str, float]:
  """One fleet-wide flat snapshot from per-worker shards: counters SUM
  across workers (cumulative event counts compose), gauges and
  histogram stats take the per-key MAX (point-in-time levels don't sum;
  max is the conservative read for every shipped gauge/stat — worst
  staleness, worst p99, highest watermark)."""
  out: Dict[str, float] = {}
  for shard in shards:
    for key, value in shard.get("snapshot", {}).items():
      if not isinstance(value, (int, float)):
        continue
      value = float(value)
      if key.startswith("counter/"):
        out[key] = out.get(key, 0.0) + value
      else:
        out[key] = max(out.get(key, value), value)
  return out


def _event_args(event: Dict[str, Any]) -> Dict[str, Any]:
  args = event.get("args")
  return args if isinstance(args, dict) else {}


def _causal_sources(event: Dict[str, Any]) -> List[str]:
  """The span_ids this event causally follows (parent + links)."""
  args = _event_args(event)
  sources: List[str] = []
  parent = args.get("parent_id")
  if isinstance(parent, str):
    sources.append(parent)
  links = args.get("links")
  if isinstance(links, (list, tuple)):
    sources.extend(l for l in links if isinstance(l, str))
  return sources


def _span_index(events: Sequence[Dict[str, Any]]
                ) -> Dict[str, Dict[str, Any]]:
  """span_id -> earliest timed event carrying it (the flow anchor).
  Many events can share one span_id (everything recorded under one
  context activation); the earliest is the span's birth."""
  index: Dict[str, Dict[str, Any]] = {}
  for event in events:
    if event.get("ph") not in ("X", "i"):
      continue
    span_id = _event_args(event).get("span_id")
    if not isinstance(span_id, str):
      continue
    held = index.get(span_id)
    if held is None or event.get("ts", 0.0) < held.get("ts", 0.0):
      index[span_id] = event
  return index


def _correct_skew(events: List[Dict[str, Any]]) -> Dict[int, float]:
  """Single happened-before repair pass: for every causal edge whose
  source and destination live in different processes, the destination
  process is shifted forward just enough that no event starts before
  its cause. Returns {pid: shift_us} for the shifted processes."""
  index = _span_index(events)
  shift_us: Dict[int, float] = {}
  for event in events:
    if event.get("ph") not in ("X", "i"):
      continue
    dst_pid = event.get("pid")
    for source_id in _causal_sources(event):
      source = index.get(source_id)
      if source is None or source.get("pid") == dst_pid:
        continue
      needed = float(source.get("ts", 0.0)) - float(event.get("ts", 0.0))
      if needed > shift_us.get(dst_pid, 0.0):
        shift_us[dst_pid] = needed
  for event in events:
    delta = shift_us.get(event.get("pid"))
    if delta and "ts" in event:
      event["ts"] = float(event["ts"]) + delta
  return shift_us


def _synthesize_flows(events: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
  """One Perfetto flow ("s" at the source span, "f" at the follower)
  per causal edge recoverable from the args ids."""
  index = _span_index(events)
  flows: List[Dict[str, Any]] = []
  flow_id = 0
  for event in events:
    if event.get("ph") not in ("X", "i"):
      continue
    for source_id in _causal_sources(event):
      source = index.get(source_id)
      if source is None or source is event:
        continue
      flow_id += 1
      src_ts = float(source.get("ts", 0.0)) + float(source.get("dur",
                                                               0.0))
      dst_ts = float(event.get("ts", 0.0))
      flows.append({"name": "graftrace", "cat": "graftrace", "ph": "s",
                    "id": flow_id, "pid": source.get("pid"),
                    "tid": source.get("tid"),
                    "ts": min(src_ts, dst_ts)})
      flows.append({"name": "graftrace", "cat": "graftrace", "ph": "f",
                    "bp": "e", "id": flow_id, "pid": event.get("pid"),
                    "tid": event.get("tid"), "ts": dst_ts})
  return flows


def merge_timeline(root: str) -> Dict[str, Any]:
  """Merges every shard under `root` into one clock-aligned timeline.

  Returns {"payload": <Perfetto JSON object>, "stats": {...}}. The
  stats block reports what was covered AND what was dropped (`skipped`
  counts unreadable shards — silent truncation would read as "covered
  everything" when it didn't).
  """
  paths = discover_shards(root)
  timed: List[Dict[str, Any]] = []
  meta: List[Dict[str, Any]] = []
  roles: Dict[int, str] = {}
  shards_used = 0
  skipped = 0
  for path in paths:
    shard = load_shard(path)
    if shard is None:
      skipped += 1
      continue
    shards_used += 1
    clock = shard["clock"]
    offset_us = (float(clock["epoch_ns"]) - float(clock["perf_ns"])
                 ) / _NS_PER_US
    pid = shard.get("pid")
    if isinstance(pid, int):
      roles.setdefault(pid, str(shard.get("role", "worker")))
    for event in shard["traceEvents"]:
      if not isinstance(event, dict):
        continue
      event = dict(event)
      if event.get("ph") == "M":
        meta.append(event)
        continue
      if "ts" in event:
        event["ts"] = float(event["ts"]) + offset_us
      timed.append(event)
  shift_us = _correct_skew(timed)
  flows = _synthesize_flows(timed)
  timed.sort(key=lambda e: e.get("ts", 0.0))
  process_meta = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": f"{role} (pid {pid})"}}
                  for pid, role in sorted(roles.items())]
  payload = {"traceEvents": process_meta + meta + timed + flows,
             "displayTimeUnit": "ms"}
  return {
      "payload": payload,
      "stats": {
          "shards": shards_used,
          "skipped": skipped,
          "events": len(timed),
          "flow_links": len(flows) // 2,
          "processes": len(roles),
          "skew_corrected_pids": {str(pid): round(us / 1e3, 3)
                                  for pid, us in shift_us.items()},
      },
  }


def write_timeline(root: str, out_path: str) -> Dict[str, Any]:
  """merge_timeline + atomic write; returns the stats block."""
  merged = merge_timeline(root)
  os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
  tmp = out_path + ".tmp"
  with open(tmp, "w") as f:
    json.dump(merged["payload"], f)
  os.replace(tmp, out_path)
  stats = dict(merged["stats"])
  stats["path"] = out_path
  return stats


def has_causal_chain(events: Sequence[Dict[str, Any]],
                     names: Sequence[str]) -> bool:
  """Whether some single chain of causal edges walks events named
  `names[0] -> names[1] -> ... -> names[-1]` (each hop a parent/links
  edge): e.g. a request's span flow-linked to the batch dispatch that
  served it."""
  if not names:
    return True
  by_source: Dict[str, List[Dict[str, Any]]] = {}
  for event in events:
    for source_id in _causal_sources(event):
      by_source.setdefault(source_id, []).append(event)
  frontier = [e for e in events if e.get("name") == names[0]
              and isinstance(_event_args(e).get("span_id"), str)]
  for name in names[1:]:
    next_frontier: List[Dict[str, Any]] = []
    seen = set()
    for event in frontier:
      span_id = _event_args(event).get("span_id")
      for follower in by_source.get(span_id, ()):
        if follower.get("name") != name:
          continue
        follower_span = _event_args(follower).get("span_id")
        if follower_span in seen:
          continue
        seen.add(follower_span)
        next_frontier.append(follower)
    if not next_frontier:
      return False
    frontier = next_frontier
  # Single-name chains still require at least one matching anchor event
  # (an empty frontier never walked anything).
  return bool(frontier)
